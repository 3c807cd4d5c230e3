"""Attention ops: hand-written CUDA flash attention, forward and backward, with
the plain versions beside the kernels.

Port of ray_tpu/ops/attention.py.

- ``reference_attention`` and ``reference_attention_lse`` are the plain
  PyTorch forward in fp32 (the second also returns the row log-sum-exp and
  the output's rounding residual);
  ``flash_bwd_reference`` is the backward recurrence of the two backward
  kernels written out in fp32. They are the CPU path and the yardsticks the
  kernels are held against on the card.
- ``flash_attention`` wraps the forward kernel (``csrc/flash_fwd.cu``): bf16,
  head_dim 64 or 128; ``flash_attention_lse`` runs the same kernel for the
  training path, which also writes the row log-sum-exp and ``out_lo``, the
  rounding residual ``o - bf16(o)`` of the output. The two count apart, as
  ``flash_fwd`` and ``flash_fwd_lse``.
- ``flash_bwd`` wraps the two backward kernels (``csrc/flash_bwd.cu``): dQ
  (``flash_bwd_dq``) and dK/dV (``flash_bwd_dkv``), bf16, head_dim 64 or 128,
  any number of q heads per kv head. ``delta = rowsum(dO * O)`` is computed
  here in fp32, outside the kernels, as the JAX package computes it, but
  from ``out + out_lo``: ``delta`` has to equal the sum over keys of
  ``p * dP`` that the backward's own ``p`` and ``dP`` carry, and the bf16
  output alone misses it by its rounding. Keys that share a large common
  part multiply that miss into dq and dk: in a bf16 ViT-L/16 train step on
  an H100 (224 px, batch 32, random weights) it moved the wq and wk
  gradients by 6.1-6.6% of their largest element against fp32; with the
  residual they are 1.1% off, as close as autograd through the plain
  softmax (1.1-1.3%; chip_smoke.py's vit phase prints each path).
- ``flash_attention_with_grad`` is the op with a gradient: the custom op
  ``ray_tpu_torch::flash_attn`` returns (out, lse, out_lo), and its
  registered autograd saves exactly ``q, k, v, out, lse, out_lo`` (the JAX
  package's ``_flash_attention_fwd`` residuals and the output's rounding
  residual) and runs ``flash_bwd``. Being a dispatcher op, it is what selective
  checkpointing can pin (``models/llama.py`` ``remat="save_attn"``), so the
  backward never re-runs the forward kernel.
- ``attention(impl=...)`` dispatches: ``"auto"`` and ``"flash"`` go through
  the op with a gradient when autograd records (training) and through the
  plain forward wrapper otherwise (serving); ``"reference"`` is the plain path.

The dispatch rule of ``"auto"`` on the card is ``flash_tiles``, decided
before any launch from the head dim alone, as the JAX package takes its
reference path for what its kernel does not tile: CUDA tensors of a head dim
the kernels tile go to the wrappers; CUDA tensors of another head dim (the
forward and backward kernels both tile 64 and 128) go to
``reference_attention``, with autograd through it, and each such call adds
one to ``launch_counts["attention_plain"]``. A head dim the kernels tile in
a dtype or layout they do not take raises in the wrapper, as it does under
``"flash"``, which means the kernel or an error. This is no fallback on
failure: a kernel that fails to build or to launch raises. On a CUDA tensor
each wrapper launches its kernel or raises on input the kernel does not
take; on a CPU tensor it runs the plain version.
The kernels mask ragged edges themselves, so nothing is padded.

Layouts follow the JAX package: q [B, Sq, Hq, D], k/v [B, Skv, Hkv, D].
Causal masking is bottom-right aligned: query row i sits at absolute
position Skv - Sq + i. ``lse`` is [B, Hq, Sq] fp32, without the JAX
package's trailing singleton: that 1 exists only so the TPU's (8, 128)
block tiling accepts the lse blocks, and the card has no such rule.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ray_tpu_torch import _kernels

NEG_INF = -1e30
FWD_LIB, BWD_LIB = "flash_fwd", "flash_bwd"
# The head dims the kernels take, forward and backward alike, at any GQA
# group (Hq % Hkv == 0); bf16 only.
KERNEL_DIMS = (64, 128)
PLAIN = "attention_plain"


# --------------------------------------------------------------------------- #
# Plain versions
# --------------------------------------------------------------------------- #
def _masked_logits(q, k, causal: bool, scale: float):
    """fp32 scaled logits [B, Hq, Sq, Skv], masked to NEG_INF, with kv heads
    repeated onto their q heads."""
    sq, hq = q.shape[1], q.shape[2]
    skv, hkv = k.shape[1], k.shape[2]
    k = k.float().repeat_interleave(hq // hkv, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k) * scale
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
        kpos = torch.arange(skv, device=q.device)[None, :]
        logits = torch.where((qpos >= kpos)[None, None], logits,
                             torch.full_like(logits, NEG_INF))
    return logits


def reference_attention(q, k, v, causal: bool = True, scale: Optional[float] = None):
    """q: [B, Sq, Hq, D]; k/v: [B, Skv, Hkv, D]. Returns [B, Sq, Hq, D]."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    probs = torch.softmax(_masked_logits(q, k, causal, scale), dim=-1)
    v = v.float().repeat_interleave(q.shape[2] // k.shape[2], dim=2)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v).to(q.dtype)


def reference_attention_lse(q, k, v, causal: bool = True, scale: Optional[float] = None):
    """The plain forward that also returns lse [B, Hq, Sq] (fp32) and out_lo,
    the rounding residual of out (0 in fp32): (out, lse, out_lo)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = _masked_logits(q, k, causal, scale)
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.exp(logits - lse[..., None])
    v = v.float().repeat_interleave(q.shape[2] // k.shape[2], dim=2)
    out32 = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    out = out32.to(q.dtype)
    return out, lse, (out32 - out.float()).to(q.dtype)


def _delta(out, dout, out_lo=None):
    """delta[b, h, i] = sum_d dO * O in fp32 (the softmax-Jacobian row term),
    O = out + out_lo when the forward's rounding residual is given."""
    o = out.float() if out_lo is None else out.float() + out_lo.float()
    return (dout.float() * o).sum(-1).transpose(1, 2).contiguous()


def _ds_and_p(q, k, v, lse, delta, dout, causal: bool, scale: float):
    logits = _masked_logits(q, k, causal, scale)
    p = torch.exp(logits - lse[..., None].float())
    v = v.float().repeat_interleave(q.shape[2] // k.shape[2], dim=2)
    dp = torch.einsum("bqhd,bkhd->bhqk", dout.float(), v)
    return p * (dp - delta[..., None]) * scale, p


def flash_bwd_dq_reference(q, k, v, dout, lse, delta, causal: bool, scale: float):
    """The plain version of K2: dq = (p * (dO.V^T - delta) * scale) . K."""
    ds, _ = _ds_and_p(q, k, v, lse, delta, dout, causal, scale)
    k = k.float().repeat_interleave(q.shape[2] // k.shape[2], dim=2)
    return torch.einsum("bhqk,bkhd->bqhd", ds, k).to(q.dtype)


def flash_bwd_dkv_reference(q, k, v, dout, lse, delta, causal: bool, scale: float):
    """The plain version of K3: dv = p^T . dO and dk = ds^T . Q per q head,
    then summed onto the kv heads."""
    b, _, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    ds, p = _ds_and_p(q, k, v, lse, delta, dout, causal, scale)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dout.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    dv = dv.reshape(b, skv, hkv, hq // hkv, d).sum(3)
    dk = dk.reshape(b, skv, hkv, hq // hkv, d).sum(3)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_reference(q, k, v, out, lse, dout, causal: bool = True,
                        scale: Optional[float] = None, out_lo=None):
    """The plain backward, in fp32: (dq, dk, dv) from the forward's residuals
    and the output gradient. lse: [B, Hq, Sq]; out_lo: out's rounding
    residual (None: delta from out alone, as the JAX package takes it)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    delta = _delta(out, dout, out_lo)
    dq = flash_bwd_dq_reference(q, k, v, dout, lse, delta, causal, scale)
    dk, dv = flash_bwd_dkv_reference(q, k, v, dout, lse, delta, causal, scale)
    return dq, dk, dv


# --------------------------------------------------------------------------- #
# Kernel wrappers
# --------------------------------------------------------------------------- #
def _check_shapes(q, k, v, causal: bool) -> None:
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do not fit q {tuple(q.shape)}")
    if hq % hkv:
        raise ValueError(f"Hq={hq} must be a multiple of Hkv={hkv}")
    if causal and skv < sq:
        raise ValueError(f"causal attention requires Skv >= Sq, got {skv} < {sq}")


def _launch_fwd(q, k, v, causal: bool, scale: float, training: bool):
    """One launch of the forward kernel on CUDA tensors: (out, lse, out_lo),
    the last two None unless ``training``."""
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    _check_cuda_inputs("flash_fwd", KERNEL_DIMS, q=q, k=k, v=v)
    out = torch.empty_like(q)
    lse = out_lo = None
    if training:
        lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
        out_lo = torch.empty_like(q)
    lib = _kernels.library(FWD_LIB)
    fn = lib.flash_fwd_bf16
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(_kernels.ptr(q), _kernels.ptr(k), _kernels.ptr(v), _kernels.ptr(out),
             ctypes.c_void_p(lse.data_ptr() if training else None),
             ctypes.c_void_p(out_lo.data_ptr() if training else None),
             b, sq, skv, hq, hkv, d, int(causal), float(scale), _kernels.stream_of(q))
    name = "flash_fwd_lse" if training else "flash_fwd"
    _kernels.check(lib, err, name)
    _kernels.launch_counts[name] += 1
    return out, lse, out_lo


def flash_attention(q, k, v, causal: bool = True, scale: Optional[float] = None):
    """Forward kernel wrapper (K1): out [B, Sq, Hq, D]. q: [B, Sq, Hq, D];
    k/v: [B, Skv, Hkv, D], Hq % Hkv == 0."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    _check_shapes(q, k, v, causal)
    if q.device.type == "cpu":
        return reference_attention(q, k, v, causal, scale)
    return _launch_fwd(q, k, v, causal, scale, training=False)[0]


def flash_attention_lse(q, k, v, causal: bool = True, scale: Optional[float] = None):
    """The training forward (K1'): (out, lse [B, Hq, Sq] fp32, out_lo), the
    kernel on the card and the plain forward on the CPU. out_lo (out's shape
    and dtype) is out's rounding residual, from which the backward takes
    delta."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    _check_shapes(q, k, v, causal)
    if q.device.type == "cpu":
        return reference_attention_lse(q, k, v, causal, scale)
    return _launch_fwd(q, k, v, causal, scale, training=True)


def _check_cuda_inputs(kernel: str, dims, **tensors) -> None:
    q = tensors["q"]
    d = q.shape[-1]
    if d not in dims:
        raise ValueError(f"{kernel} kernel takes head_dim {' or '.join(map(str, dims))}, got {d}")
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} must lie on {q.device}, got {t.device}")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{kernel} kernel takes bfloat16, got {name}.dtype={t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _check_rows(b: int, hq: int, sq: int, device, **rows) -> None:
    for name, t in rows.items():
        if (t.dtype != torch.float32 or tuple(t.shape) != (b, hq, sq)
                or not t.is_contiguous() or t.device != device):
            raise ValueError(f"{name} must be a contiguous float32 [B, Hq, Sq] tensor on {device}")


_BWD_ARGTYPES = {
    "flash_bwd_dq_bf16": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
    + [ctypes.c_float, ctypes.c_void_p],
    "flash_bwd_dkv_bf16": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
    + [ctypes.c_float, ctypes.c_void_p],
}


def _launch_bwd(name: str, symbol: str, tensors, q, k, causal: bool, scale: float) -> None:
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    lib = _kernels.library(BWD_LIB)
    fn = getattr(lib, symbol)
    fn.argtypes = _BWD_ARGTYPES[symbol]
    fn.restype = ctypes.c_int
    err = fn(*(_kernels.ptr(t) for t in tensors), b, sq, skv, hq, hkv, d, int(causal),
             float(scale), _kernels.stream_of(q))
    _kernels.check(lib, err, name)
    _kernels.launch_counts[name] += 1


def _check_bwd_inputs(q, k, v, dout, lse, delta, causal: bool) -> None:
    _check_shapes(q, k, v, causal)
    if dout.shape != q.shape:
        raise ValueError(f"dout shape {tuple(dout.shape)} != q shape {tuple(q.shape)}")
    _check_cuda_inputs("flash_bwd", KERNEL_DIMS, q=q, k=k, v=v, dout=dout)
    b, sq, hq, _ = q.shape
    _check_rows(b, hq, sq, q.device, lse=lse, delta=delta)


def flash_bwd_dq(q, k, v, dout, lse, delta, causal: bool, scale: float):
    """K2's wrapper: dq [B, Sq, Hq, D] bf16."""
    _check_bwd_inputs(q, k, v, dout, lse, delta, causal)
    dq = torch.empty_like(q)
    _launch_bwd("flash_bwd_dq", "flash_bwd_dq_bf16", (q, k, v, dout, lse, delta, dq),
                q, k, causal, scale)
    return dq


def flash_bwd_dkv(q, k, v, dout, lse, delta, causal: bool, scale: float):
    """K3's wrapper: (dk, dv), each [B, Skv, Hkv, D] bf16, the GQA group
    summed inside the kernel."""
    _check_bwd_inputs(q, k, v, dout, lse, delta, causal)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch_bwd("flash_bwd_dkv", "flash_bwd_dkv_bf16", (q, k, v, dout, lse, delta, dk, dv),
                q, k, causal, scale)
    return dk, dv


def flash_bwd(q, k, v, out, lse, dout, causal: bool = True, scale: Optional[float] = None,
              out_lo=None):
    """Backward kernels' wrapper: (dq, dk, dv). On the card it launches K2 and
    K3; on the CPU it runs the plain backward. out_lo: out's rounding
    residual from flash_attention_lse (None: delta from out alone)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        _check_shapes(q, k, v, causal)
        return flash_bwd_reference(q, k, v, out, lse, dout, causal, scale, out_lo)
    if out.shape != q.shape or (out_lo is not None and out_lo.shape != q.shape):
        raise ValueError(f"out shape {tuple(out.shape)} != q shape {tuple(q.shape)}")
    delta = _delta(out, dout, out_lo)
    dq = flash_bwd_dq(q, k, v, dout, lse, delta, causal, scale)
    dk, dv = flash_bwd_dkv(q, k, v, dout, lse, delta, causal, scale)
    return dq, dk, dv


# --------------------------------------------------------------------------- #
# The op with a gradient
# --------------------------------------------------------------------------- #
@torch.library.custom_op("ray_tpu_torch::flash_attn", mutates_args=())
def _flash_attn_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                   scale: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return flash_attention_lse(q, k, v, causal, scale)


def _setup_context(ctx, inputs, output):
    q, k, v, causal, scale = inputs
    ctx.save_for_backward(q, k, v, *output)
    ctx.causal, ctx.scale = causal, scale


def _backward(ctx, dout, _dlse, _dlo):
    # lse and out_lo feed only this op's own backward, so their gradients are ignored
    q, k, v, out, lse, out_lo = ctx.saved_tensors
    dq, dk, dv = flash_bwd(q, k, v, out, lse, dout.contiguous(), ctx.causal, ctx.scale, out_lo)
    return dq, dk, dv, None, None


_flash_attn_op.register_autograd(_backward, setup_context=_setup_context)

# The op that save_attn pins: its outputs are the layer's only saved residuals.
FLASH_ATTN_OP = torch.ops.ray_tpu_torch.flash_attn.default


def flash_attention_with_grad(q, k, v, causal: bool = True, scale: Optional[float] = None):
    """Flash attention with a gradient (kernels on the card, plain versions on
    the CPU). Returns out [B, Sq, Hq, D]."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _flash_attn_op(q, k, v, causal, float(scale))[0]


def flash_tiles(head_dim: int, grad: bool) -> bool:
    """The dispatch rule of ``attention(impl="auto")`` on the card: whether
    the kernels tile this head dim, without a gradient (the forward kernel)
    or with one (``grad``: the backward kernels run too). Both directions
    tile 64 and 128. Group, dtype and layout are no part of the rule: the
    wrappers raise on those they do not take."""
    return head_dim in KERNEL_DIMS


def attention(q, k, v, causal: bool = True, scale: Optional[float] = None, impl: str = "auto"):
    """Dispatch. impl: "auto" | "flash" | "reference"."""
    if impl == "reference":
        return reference_attention(q, k, v, causal, scale)
    if impl not in ("auto", "flash"):
        raise ValueError(f"unknown attention impl {impl!r}; options: auto, flash, reference")
    grad = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad)
    if impl == "auto" and q.device.type == "cuda" and not flash_tiles(q.shape[-1], grad):
        _kernels.launch_counts[PLAIN] += 1
        return reference_attention(q, k, v, causal, scale)
    if grad:
        return flash_attention_with_grad(q, k, v, causal, scale)
    return flash_attention(q, k, v, causal, scale)
