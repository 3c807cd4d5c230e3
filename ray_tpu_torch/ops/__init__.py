"""Ops: attention (with the flash forward and backward kernels), RMSNorm,
RoPE, the fused LM-head cross-entropy.

Import from the submodules (``ray_tpu_torch.ops.attention`` and so on): a
re-exported ``attention`` function here would shadow the ``attention``
submodule."""
