"""RMSNorm with fp32 statistics and a custom backward (port of
ray_tpu/ops/norms.py).

The backward saves only ``x`` and ``weight`` in their storage dtype and
recomputes ``xhat`` and ``r`` in fp32, as ``_rms_norm_bwd`` does: plain
autograd would keep the fp32 upcast and the fp32 normalized tensor, two
full [B, S, H] fp32 tensors per call. The forward is unchanged from the
serving slice, so inference keeps its numbers."""

from __future__ import annotations

import torch


def _rms_forward(x, eps: float):
    x32 = x.float()
    r = torch.rsqrt(x32.pow(2).mean(dim=-1, keepdim=True) + eps)
    return x32 * r, r


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, eps):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        xhat, _ = _rms_forward(x, eps)
        return (xhat * weight.float()).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        xhat, r = _rms_forward(x, ctx.eps)
        g32 = g.float()
        # out = xhat * w: dw sums over every leading dim; dxhat = g * w
        dw = (g32 * xhat).reshape(-1, weight.numel()).sum(0).reshape(weight.shape)
        dxhat = g32 * weight.float()
        # xhat = x * r, r = rsqrt(mean(x^2) + eps):
        # dx = r * (dxhat - xhat * mean(dxhat * xhat, -1))
        m = (dxhat * xhat).mean(dim=-1, keepdim=True)
        dx = r * (dxhat - xhat * m)
        return dx.to(x.dtype), dw.to(weight.dtype), None


def rms_norm(x, weight, eps: float = 1e-6):
    return _RMSNorm.apply(x, weight, eps)
