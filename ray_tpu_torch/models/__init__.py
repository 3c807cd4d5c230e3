from ray_tpu_torch.models.llama import (LlamaConfig, cross_entropy_loss, llama_forward,
                                       llama_init, llama_loss, params_from_jax)

__all__ = ["LlamaConfig", "cross_entropy_loss", "llama_forward", "llama_init", "llama_loss",
           "params_from_jax"]
