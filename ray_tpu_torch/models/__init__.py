from ray_tpu_torch.models.llama import LlamaConfig, llama_forward, llama_init, params_from_jax

__all__ = ["LlamaConfig", "llama_forward", "llama_init", "params_from_jax"]
