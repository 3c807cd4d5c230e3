"""Model weights made from ``--seed`` on the device, in the type they are
served in, one call a stacked leaf (eleven in all). The program and the
reference are handed these same tensors."""

from __future__ import annotations

import torch

from perfbench.reference.llama import Dims


def make(d: Dims, seed: int, device, dtype=torch.bfloat16) -> dict:
    """Scaled normal weights (fan-in ** -0.5) and unit norm gains, in the
    program's layout: ``x @ W``, per-layer weights stacked on a leading [L]
    axis under ``layers``, an untied ``lm_head``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    h, f, hd, L = d.hidden, d.inter, d.head_dim, d.layers

    def normal(shape, fan_in):
        return torch.empty(shape, dtype=dtype, device=device).normal_(
            0.0, fan_in ** -0.5, generator=gen)

    def ones(shape):
        return torch.ones(shape, dtype=dtype, device=device)

    return {
        "embed_tokens": normal((d.vocab, h), h),
        "layers": {
            "attn_norm": ones((L, h)),
            "wq": normal((L, h, d.heads * hd), h),
            "wk": normal((L, h, d.kv_heads * hd), h),
            "wv": normal((L, h, d.kv_heads * hd), h),
            "wo": normal((L, d.heads * hd, h), d.heads * hd),
            "mlp_norm": ones((L, h)),
            "w_gate": normal((L, h, f), h),
            "w_up": normal((L, h, f), h),
            "w_down": normal((L, f, h), f),
        },
        "final_norm": ones((h,)),
        "lm_head": normal((h, d.vocab), h),
    }
