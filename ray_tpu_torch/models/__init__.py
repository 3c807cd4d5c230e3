from ray_tpu_torch.models.llama import (LlamaConfig, cross_entropy_loss, llama_forward,
                                       llama_init, llama_loss, params_from_jax)
from ray_tpu_torch.models.vit import (ViTConfig, make_vit_train_step, patchify, vit_forward,
                                     vit_init, vit_loss)

__all__ = ["LlamaConfig", "ViTConfig", "cross_entropy_loss", "llama_forward", "llama_init",
           "llama_loss", "make_vit_train_step", "params_from_jax", "patchify", "vit_forward",
           "vit_init", "vit_loss"]
