"""Attention ops: hand-written CUDA flash-attention forward + plain version.

Port of ray_tpu/ops/attention.py (forward only; the backward kernels come
with the training slice).

- ``reference_attention`` is the plain PyTorch version, in fp32: the CPU path
  and the yardstick the kernel is held against on the card.
- ``flash_attention`` is the kernel's wrapper. On a CUDA tensor it launches
  ``csrc/flash_fwd.cu`` (bf16, head_dim 64 or 128) and raises on input the
  kernel does not take; it never falls back. The kernel masks ragged edges
  itself, so nothing is padded to block multiples. On a CPU tensor it runs
  the plain version.
- ``attention(impl=...)`` dispatches: ``"auto"`` and ``"flash"`` go through
  the wrapper (kernel on the card, plain on the CPU); ``"reference"`` is the
  explicit plain path.

Layouts follow the JAX package: q [B, Sq, Hq, D], k/v [B, Skv, Hkv, D].
Causal masking is bottom-right aligned: query row i sits at absolute
position Skv - Sq + i (the queries come after the cached keys).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ray_tpu_torch import _kernels

NEG_INF = -1e30
KERNEL = "flash_fwd"


def reference_attention(q, k, v, causal: bool = True, scale: Optional[float] = None):
    """q: [B, Sq, Hq, D]; k/v: [B, Skv, Hkv, D]. Returns [B, Sq, Hq, D]."""
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    if scale is None:
        scale = d ** -0.5
    if hq != hkv:
        rep = hq // hkv
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
        kpos = torch.arange(skv, device=q.device)[None, :]
        logits = torch.where((qpos >= kpos)[None, None], logits,
                             torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.to(q.dtype)


def flash_attention(q, k, v, causal: bool = True, scale: Optional[float] = None,
                    lse: Optional[torch.Tensor] = None):
    """Kernel wrapper. q: [B, Sq, Hq, D]; k/v: [B, Skv, Hkv, D], Hq % Hkv == 0.

    On the card, ``lse`` may be a preallocated fp32 [B, Hq, Sq] tensor that
    receives the row log-sum-exp (the residual a backward needs)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    if hq % hkv:
        raise ValueError(f"Hq={hq} must be a multiple of Hkv={hkv}")
    if causal and skv < sq:
        raise ValueError(f"causal attention requires Skv >= Sq, got {skv} < {sq}")
    if q.device.type == "cpu":
        if lse is not None:
            raise ValueError("lse output is produced by the CUDA kernel only")
        return reference_attention(q, k, v, causal, scale)
    _check_cuda_inputs(q, k, v, lse)
    out = torch.empty_like(q)
    lib = _kernels.library(KERNEL)
    fn = lib.flash_fwd_bf16
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(_kernels.ptr(q), _kernels.ptr(k), _kernels.ptr(v), _kernels.ptr(out),
             ctypes.c_void_p(lse.data_ptr() if lse is not None else None),
             b, sq, skv, hq, hkv, d, int(causal), float(scale), _kernels.stream_of(q))
    _kernels.check(lib, err, KERNEL)
    _kernels.launch_counts[KERNEL] += 1
    return out


def _check_cuda_inputs(q, k, v, lse) -> None:
    b, sq, hq, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do not fit q {tuple(q.shape)}")
    if d not in (64, 128):
        raise ValueError(f"flash_fwd kernel takes head_dim 64 or 128, got {d}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} must lie on {q.device}, got {t.device}")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"flash_fwd kernel takes bfloat16, got {name}.dtype={t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if lse is not None and (lse.dtype != torch.float32 or lse.shape != (b, hq, sq)
                            or not lse.is_contiguous() or lse.device != q.device):
        raise ValueError("lse must be a contiguous float32 [B, Hq, Sq] tensor on q's device")


def attention(q, k, v, causal: bool = True, scale: Optional[float] = None, impl: str = "auto"):
    """Dispatch. impl: "auto" | "flash" | "reference"."""
    if impl == "reference":
        return reference_attention(q, k, v, causal, scale)
    if impl in ("auto", "flash"):
        return flash_attention(q, k, v, causal, scale)
    raise ValueError(f"unknown attention impl {impl!r}; options: auto, flash, reference")
