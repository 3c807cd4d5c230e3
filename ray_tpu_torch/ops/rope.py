"""Rotary position embeddings (RoPE), half-rotation layout.

Port of ray_tpu/ops/rope.py."""

from __future__ import annotations

import torch


def rope_frequencies(head_dim: int, max_seq: int, theta: float = 10000.0,
                     device=None):
    """Precompute cos/sin tables: [max_seq, head_dim//2] each (fp32)."""
    inv_freq = 1.0 / (theta ** (
        torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim))
    t = torch.arange(max_seq, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    return torch.cos(freqs), torch.sin(freqs)


def apply_rope(x, cos, sin, positions=None):
    """x: [..., seq, n_heads, head_dim]; cos/sin: [max_seq, head_dim//2];
    positions: optional [..., seq] integer tensor (decode with offsets).

    Positions index the table as JAX's gather does: a negative one counts
    from the end, and one past either end is clamped into the table. A slot
    that finishes mid-chunk keeps ticking past the table's end, and on the
    card an out-of-range index would be a device-side assert."""
    seq = x.shape[-3]
    if positions is None:
        c = cos[:seq][:, None, :]
        s = sin[:seq][:, None, :]
    else:
        n = cos.shape[0]
        idx = positions.long()
        idx = torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)
        c = cos[idx][..., None, :]
        s = sin[idx][..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)
