"""Ops: attention (with the flash-forward kernel), RMSNorm, RoPE.

Import from the submodules (``ray_tpu_torch.ops.attention`` and so on): a
re-exported ``attention`` function here would shadow the ``attention``
submodule."""
