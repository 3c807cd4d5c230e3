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
  head_dim 64, 128 or 256; ``flash_attention_lse`` runs the same kernel for the
  training path, which also writes the row log-sum-exp and ``out_lo``, the
  rounding residual ``o - bf16(o)`` of the output. The two count apart, as
  ``flash_fwd`` and ``flash_fwd_lse``.
- ``flash_bwd`` wraps the two backward kernels (``csrc/flash_bwd.cu``): dQ
  (``flash_bwd_dq``) and dK/dV (``flash_bwd_dkv``), bf16, head_dim 64, 128
  or 256, any number of q heads per kv head.
- The same wrappers send fp32 at head dim 64, 128 or 256 to the
  tensor-core kernels of ``csrc/flash_fwd_f32.cu`` (the forward) and
  ``csrc/flash_bwd_f32.cu`` (dQ and dK/dV), whose products are 3xTF32
  (fp32-accurate); they count under their own names with ``_tf32x3``
  appended (``flash_fwd_tf32x3``, ``flash_fwd_lse_tf32x3``,
  ``flash_bwd_dq_tf32x3``, ``flash_bwd_dkv_tf32x3``). ``kernel_route``
  names the kernel family a call goes to, by kernel, dtype and head dim.
  In fp32 ``out_lo`` is zeros. ``delta = rowsum(dO * O)`` is computed
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
forward and backward kernels together tile 64, 128 and 256) go to
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
import functools
from typing import Optional, Tuple

import torch

from ray_tpu_torch import _kernels

NEG_INF = -1e30
# The head dims the kernels take, forward and backward alike, at any GQA
# group (Hq % Hkv == 0), and the kernel family of each dtype: in bf16 the
# wgmma kernels of csrc/flash_fwd.cu and csrc/flash_bwd.cu, in fp32 the
# 3xTF32 mma.sync kernels of csrc/flash_fwd_f32.cu and csrc/flash_bwd_f32.cu
# (each family's library, by kernel: ROUTE_LIBS[route][kernel]).
KERNEL_DIMS = (64, 128, 256)
ROUTES = {torch.bfloat16: "wgmma", torch.float32: "tf32x3"}
ROUTE_LIBS = {"wgmma": {"flash_fwd": "flash_fwd", "flash_bwd_dq": "flash_bwd",
                        "flash_bwd_dkv": "flash_bwd"},
              "tf32x3": {"flash_fwd": "flash_fwd_f32", "flash_bwd_dq": "flash_bwd_f32",
                         "flash_bwd_dkv": "flash_bwd_f32"}}
F32_DKV_KEYS = 64  # keys a block of the fp32 dK/dV kernel owns (ROWS of flash_bwd_f32.cu)
PLAIN = "attention_plain"


# --------------------------------------------------------------------------- #
# Plain versions
# --------------------------------------------------------------------------- #
def _masked_logits(q, k, causal: bool, scale: float, einsum=torch.einsum):
    """fp32 scaled logits [B, Hq, Sq, Skv], masked to NEG_INF, with kv heads
    repeated onto their q heads."""
    sq, hq = q.shape[1], q.shape[2]
    skv, hkv = k.shape[1], k.shape[2]
    k = k.float().repeat_interleave(hq // hkv, dim=2)
    logits = einsum("bqhd,bkhd->bhqk", q.float(), k) * scale
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
        kpos = torch.arange(skv, device=q.device)[None, :]
        logits = torch.where((qpos >= kpos)[None, None], logits,
                             torch.full_like(logits, NEG_INF))
    return logits


def reference_attention(q, k, v, causal: bool = True, scale: Optional[float] = None,
                        einsum=torch.einsum):
    """q: [B, Sq, Hq, D]; k/v: [B, Skv, Hkv, D]. Returns [B, Sq, Hq, D].
    ``einsum`` computes its products (tests pass an emulation of the
    kernels' 3xTF32 ones)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    probs = torch.softmax(_masked_logits(q, k, causal, scale, einsum), dim=-1)
    v = v.float().repeat_interleave(q.shape[2] // k.shape[2], dim=2)
    return einsum("bhqk,bkhd->bqhd", probs, v).to(q.dtype)


def reference_attention_lse(q, k, v, causal: bool = True, scale: Optional[float] = None,
                            einsum=torch.einsum):
    """The plain forward that also returns lse [B, Hq, Sq] (fp32) and out_lo,
    the rounding residual of out (0 in fp32): (out, lse, out_lo). ``einsum``
    as in ``reference_attention``."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = _masked_logits(q, k, causal, scale, einsum)
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.exp(logits - lse[..., None])
    v = v.float().repeat_interleave(q.shape[2] // k.shape[2], dim=2)
    out32 = einsum("bhqk,bkhd->bqhd", probs, v)
    out = out32.to(q.dtype)
    return out, lse, (out32 - out.float()).to(q.dtype)


def _delta(out, dout, out_lo=None):
    """delta[b, h, i] = sum_d dO * O in fp32 (the softmax-Jacobian row term),
    O = out + out_lo when the forward's rounding residual is given."""
    o = out.float() if out_lo is None else out.float() + out_lo.float()
    return (dout.float() * o).sum(-1).transpose(1, 2).contiguous()


def _ds_and_p(q, k, v, lse, delta, dout, causal: bool, scale: float, einsum=torch.einsum):
    logits = _masked_logits(q, k, causal, scale, einsum)
    p = torch.exp(logits - lse[..., None].float())
    v = v.float().repeat_interleave(q.shape[2] // k.shape[2], dim=2)
    dp = einsum("bqhd,bkhd->bhqk", dout.float(), v)
    return p * (dp - delta[..., None]) * scale, p


def flash_bwd_dq_reference(q, k, v, dout, lse, delta, causal: bool, scale: float,
                           einsum=torch.einsum):
    """The plain version of K2: dq = (p * (dO.V^T - delta) * scale) . K.
    ``einsum`` computes its products (tests pass an emulation of the
    kernels' 3xTF32 ones)."""
    ds, _ = _ds_and_p(q, k, v, lse, delta, dout, causal, scale, einsum)
    k = k.float().repeat_interleave(q.shape[2] // k.shape[2], dim=2)
    return einsum("bhqk,bkhd->bqhd", ds, k).to(q.dtype)


def flash_bwd_dkv_reference(q, k, v, dout, lse, delta, causal: bool, scale: float,
                            einsum=torch.einsum):
    """The plain version of K3: dv = p^T . dO and dk = ds^T . Q per q head,
    then summed onto the kv heads (``einsum`` as in K2's)."""
    b, _, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    ds, p = _ds_and_p(q, k, v, lse, delta, dout, causal, scale, einsum)
    dv = einsum("bhqk,bqhd->bkhd", p, dout.float())
    dk = einsum("bhqk,bqhd->bkhd", ds, q.float())
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


def kernel_route(kernel: str, dtype, head_dim: int) -> str:
    """The kernel family a CUDA call of ``kernel`` ("flash_fwd",
    "flash_bwd_dq" or "flash_bwd_dkv") in this dtype and head dim goes to:
    "wgmma" (bf16: ``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``) or "tf32x3"
    (fp32 on the tensor cores in 3xTF32: ``csrc/flash_fwd_f32.cu``,
    ``csrc/flash_bwd_f32.cu``), both at every head dim of KERNEL_DIMS.
    Anything else raises."""
    if head_dim not in KERNEL_DIMS:
        raise ValueError(f"{kernel} kernel takes head_dim "
                         f"{' or '.join(map(str, KERNEL_DIMS))}, got {head_dim}")
    if dtype not in ROUTES:
        raise ValueError(f"{kernel} kernel takes bfloat16 or float32, got {dtype}")
    return ROUTES[dtype]


def dkv_split_count(b: int, skv: int, hkv: int, group: int, sms: int) -> int:
    """Blocks the fp32 dK/dV kernel gives each (key tile, kv head, batch):
    the smallest divisor of the GQA group that brings the grid to two
    blocks an SM (each block then takes group / splits q heads, and a
    second pass sums the partials in split order), else the whole group."""
    base = -(-skv // F32_DKV_KEYS) * hkv * b
    for splits in range(1, group + 1):
        if group % splits == 0 and base * splits >= 2 * sms:
            return splits
    return group


# The C entry points' argument types, by symbol (pointers, ints, the scale,
# for dK/dV in fp32 the split count, then the stream).
_ARGTYPES = {
    "flash_fwd_bf16": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
    + [ctypes.c_float, ctypes.c_void_p],
    "flash_fwd_tf32x3": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
    + [ctypes.c_float, ctypes.c_void_p],
    "flash_bwd_dq_bf16": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
    + [ctypes.c_float, ctypes.c_void_p],
    "flash_bwd_dkv_bf16": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
    + [ctypes.c_float, ctypes.c_void_p],
    "flash_bwd_dq_tf32x3": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
    + [ctypes.c_float, ctypes.c_void_p],
    "flash_bwd_dkv_tf32x3": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
}


@functools.lru_cache(maxsize=None)
def _entry(kernel: str, route: str):
    """(library, C entry point, its symbol) of ``kernel`` on ``route``,
    argument types set once. The symbol is ``<kernel>_bf16`` on the wgmma
    route and ``<kernel>_tf32x3`` on the 3xTF32 one."""
    lib = _kernels.library(ROUTE_LIBS[route][kernel])
    symbol = f"{kernel}_{'bf16' if route == 'wgmma' else route}"
    fn = getattr(lib, symbol)
    fn.argtypes = _ARGTYPES[symbol]
    fn.restype = ctypes.c_int
    return lib, fn, symbol


def _launch_fwd(q, k, v, causal: bool, scale: float, training: bool):
    """One launch of the forward kernel on CUDA tensors: (out, lse, out_lo),
    the last two None unless ``training``."""
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    _check_cuda_inputs("flash_fwd", q=q, k=k, v=v)
    route = kernel_route("flash_fwd", q.dtype, d)
    out = torch.empty_like(q)
    lse = out_lo = None
    if training:
        lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
        out_lo = torch.empty_like(q)
    lib, fn, _ = _entry("flash_fwd", route)
    err = fn(_kernels.ptr(q), _kernels.ptr(k), _kernels.ptr(v), _kernels.ptr(out),
             ctypes.c_void_p(lse.data_ptr() if training else None),
             ctypes.c_void_p(out_lo.data_ptr() if training else None),
             b, sq, skv, hq, hkv, d, int(causal), float(scale), _kernels.stream_of(q))
    name = ("flash_fwd_lse" if training else "flash_fwd") + ("_tf32x3" if route == "tf32x3"
                                                            else "")
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


def _check_cuda_inputs(kernel: str, **tensors) -> None:
    """Device, dtype (one for all: q's), contiguity and alignment; the head
    dim and the dtype's route are ``kernel_route``'s."""
    q = tensors["q"]
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} must lie on {q.device}, got {t.device}")
        if t.dtype not in ROUTES or t.dtype != q.dtype:
            raise ValueError(f"{kernel} kernel takes bfloat16 or float32, all of one dtype; "
                             f"got {name}.dtype={t.dtype}, q.dtype={q.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _check_rows(b: int, hq: int, sq: int, device, **rows) -> None:
    for name, t in rows.items():
        if (t.dtype != torch.float32 or tuple(t.shape) != (b, hq, sq)
                or not t.is_contiguous() or t.device != device):
            raise ValueError(f"{name} must be a contiguous float32 [B, Hq, Sq] tensor on {device}")


def _launch_bwd(name: str, tensors, q, k, causal: bool, scale: float, splits=None) -> None:
    """One launch of K2 (``name`` "flash_bwd_dq") or K3 ("flash_bwd_dkv"):
    bf16 on the wgmma kernels, fp32 on the 3xTF32 ones (``splits``: K3's
    blocks along the group, whose ``tensors`` end with the workspace)."""
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    route = kernel_route(name, q.dtype, d)  # raises on a head dim or dtype no kernel takes
    args = [*(ctypes.c_void_p(None if t is None else t.data_ptr()) for t in tensors),
            b, sq, skv, hq, hkv, d, int(causal), float(scale)]
    lib, fn, symbol = _entry(name, route)
    if route == "tf32x3":
        args += [] if splits is None else [splits]
        name = symbol  # the launch count's name
    err = fn(*args, _kernels.stream_of(q))
    _kernels.check(lib, err, name)
    _kernels.launch_counts[name] += 1


def _check_bwd_inputs(q, k, v, dout, lse, delta, causal: bool) -> None:
    _check_shapes(q, k, v, causal)
    if dout.shape != q.shape:
        raise ValueError(f"dout shape {tuple(dout.shape)} != q shape {tuple(q.shape)}")
    _check_cuda_inputs("flash_bwd", q=q, k=k, v=v, dout=dout)
    b, sq, hq, _ = q.shape
    _check_rows(b, hq, sq, q.device, lse=lse, delta=delta)


def flash_bwd_dq(q, k, v, dout, lse, delta, causal: bool, scale: float):
    """K2's wrapper: dq [B, Sq, Hq, D] in q's dtype."""
    _check_bwd_inputs(q, k, v, dout, lse, delta, causal)
    dq = torch.empty_like(q)
    _launch_bwd("flash_bwd_dq", (q, k, v, dout, lse, delta, dq), q, k, causal, scale)
    return dq


def flash_bwd_dkv(q, k, v, dout, lse, delta, causal: bool, scale: float):
    """K3's wrapper: (dk, dv), each [B, Skv, Hkv, D] in k's dtype, the GQA
    group summed inside the kernel (in fp32, where the grid would not fill
    the card, over ``dkv_split_count`` blocks and a second pass)."""
    _check_bwd_inputs(q, k, v, dout, lse, delta, causal)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if q.dtype != torch.float32:
        _launch_bwd("flash_bwd_dkv", (q, k, v, dout, lse, delta, dk, dv), q, k, causal, scale)
        return dk, dv
    b, skv, hkv, _ = k.shape
    splits = dkv_split_count(b, skv, hkv, q.shape[2] // hkv, _sm_count(q.device))
    ws = torch.empty((2, splits, *k.shape), dtype=torch.float32,
                     device=q.device) if splits > 1 else None
    _launch_bwd("flash_bwd_dkv", (q, k, v, dout, lse, delta, dk, dv, ws), q, k, causal, scale,
                splits)
    return dk, dv


@functools.lru_cache(maxsize=None)
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


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
    tile 64, 128 and 256. Group, dtype and layout are no part of the rule:
    the wrappers raise on those they do not take."""
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
