"""RMSNorm forward with fp32 statistics (port of ray_tpu/ops/norms.py).

The custom backward of the JAX version comes with the training slice."""

from __future__ import annotations

import torch


def rms_norm(x, weight, eps: float = 1e-6):
    x32 = x.float()
    r = torch.rsqrt(x32.pow(2).mean(dim=-1, keepdim=True) + eps)
    return (x32 * r * weight.float()).to(x.dtype)
