"""Ring attention: context parallelism over the ``cp`` mesh axis (port of
ray_tpu/parallel/ring_attention.py).

- the sequence is sharded over the ``cp`` axis; K and V, stacked into one
  block, rotate around the ring, one neighbour hop a step (the JAX
  package's ``ppermute``), as an all-to-all whose only non-empty split goes
  to the right neighbour: ``all_to_all_single_autograd``'s backward is the
  same exchange the other way, so the cotangents rotate back. Autograd runs
  a collective's backward only on a rank whose loss depends on its output,
  and the causal skip leaves a rank's later blocks unused, so the last block
  is tied into the graph with a zero gradient (``_Tie``): every rank then
  runs the same chain of backward rotations;
- softmax uses the online (running max / normalizer) recurrence across ring
  steps, in fp32, as plain torch products (the JAX package's are jnp, not a
  Pallas kernel), so each rank only ever holds one K/V shard;
- causal masking is resolved at block granularity: a rank skips K/V shards
  entirely in its causal future, and applies the elementwise triangle on
  the diagonal shard.

Layout contract: ``ring_attention`` runs per rank on local ``[B, S/cp, H, D]``
blocks; ``ring_attention_sharded`` takes global tensors or DTensors and
enters it through ``local_map`` with the q and kv specs.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.distributed._functional_collectives import all_to_all_single_autograd
from torch.distributed.tensor.experimental import local_map

from ray_tpu_torch.parallel.mesh import group_position
from ray_tpu_torch.parallel.sharding import shard_tensor, spec_placements

NEG_INF = -1e30


def _local_attention_stats(q, k, v, scale, mask=None):
    """One block: returns (m, l, acc) online-softmax stats.
    q: [B, Sq, H, D]; k/v: [B, Sk, Hkv, D]."""
    hq, hkv = q.shape[2], k.shape[2]
    if hq != hkv:
        k = k.repeat_interleave(hq // hkv, dim=2)
        v = v.repeat_interleave(hq // hkv, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)  # [B,H,Sq,1]
    # guard fully-masked rows
    m = torch.clamp(m, min=NEG_INF / 2)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhqk,bkhd->bhqd", p, v.float())
    return m, l, acc


def shift(x, group, idx: int, n: int, step: int = 1):
    """Send ``x`` to the rank ``step`` places further along the group's ring
    and return what arrives from the rank ``step`` places before:
    differentiable, its backward shifts the cotangent the other way."""
    rows = x.shape[0]
    send = [0] * n
    recv = [0] * n
    send[(idx + step) % n] = rows
    recv[(idx - step) % n] = rows
    return all_to_all_single_autograd(x.contiguous(), recv, send, group)


class _Tie(torch.autograd.Function):
    """Returns ``x`` and hands ``anchor`` a zero gradient."""

    @staticmethod
    def forward(ctx, x, anchor):
        ctx.anchor = (anchor.shape, anchor.dtype, anchor.device)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        shape, dtype, device = ctx.anchor
        return g, torch.zeros(shape, dtype=dtype, device=device)


def ring_attention(q, k, v, mesh, axis_name: str = "cp", causal: bool = True,
                   scale: Optional[float] = None):
    """Per rank, on local blocks. q/k/v: [B, S_local, H(_kv), D]
    (seq-sharded over ``axis_name`` of ``mesh``)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    group, my_idx, axis_n = group_position(mesh, axis_name)
    b, s_local, hq, d = q.shape

    m = torch.full((b, hq, s_local, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, hq, s_local, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hq, s_local, d), dtype=torch.float32, device=q.device)
    kv = torch.stack([k, v])
    # ring: at step t, this rank holds the K/V shard originally from rank
    # (my_idx - t) mod cp; each step sends it to the right neighbour
    for t in range(axis_n):
        k_cur, v_cur = kv[0], kv[1]
        src = (my_idx - t) % axis_n
        # block causality: src > my_idx => the entire shard is in the future
        if not (causal and src > my_idx):
            mask = None
            if causal:
                q_pos = my_idx * s_local + torch.arange(s_local, device=q.device)[:, None]
                k_pos = src * s_local + torch.arange(k_cur.shape[1], device=q.device)[None, :]
                mask = (q_pos >= k_pos)[None, None]
            m_new, l_new, acc_new = _local_attention_stats(q, k_cur, v_cur, scale, mask)
            m_tot = torch.maximum(m, m_new)
            alpha_old = torch.exp(m - m_tot)
            alpha_new = torch.exp(m_new - m_tot)
            m, l, acc = (m_tot, l * alpha_old + l_new * alpha_new,
                         acc * alpha_old + acc_new * alpha_new)
        if t + 1 < axis_n:
            kv = shift(kv, group, my_idx, axis_n)
    if axis_n > 1 and kv.requires_grad:
        acc = _Tie.apply(acc, kv)
    out = acc / torch.clamp(l, min=1e-30)
    return torch.einsum("bhqd->bqhd", out).to(q.dtype)


def ring_attention_sharded(q, k, v, mesh, causal: bool = True, scale: Optional[float] = None,
                           axis_name: str = "cp", q_spec=None, kv_spec=None):
    """q/k/v: GLOBAL [B, S, H, D] tensors (the same values on every rank) or
    DTensors; the sequence is split over the cp axis inside. Returns a DTensor
    laid out by ``q_spec``.

    ``q_spec``/``kv_spec`` carry the FULL layout as mesh axes per dim (batch
    over dp/fsdp, heads over tp, seq over cp). Attention is independent
    across batch and heads, so only the cp axis takes part in the ring;
    passing the real specs keeps dp/tp sharding instead of replicating."""
    if q_spec is None:
        q_spec = (None, axis_name, None, None)
    if kv_spec is None:
        kv_spec = q_spec
    q_pl, kv_pl = spec_placements(mesh, q_spec), spec_placements(mesh, kv_spec)
    q, k, v = shard_tensor(q, mesh, q_pl), shard_tensor(k, mesh, kv_pl), shard_tensor(v, mesh, kv_pl)

    def fn(q, k, v):
        return ring_attention(q, k, v, mesh, axis_name=axis_name, causal=causal, scale=scale)

    return local_map(fn, out_placements=list(q_pl), in_placements=(q_pl, kv_pl, kv_pl),
                     device_mesh=mesh)(q, k, v)
