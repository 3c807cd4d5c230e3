"""Ulysses sequence parallelism: all-to-all head scattering on the ``sp`` axis
(port of ray_tpu/parallel/ulysses.py).

Ring attention (``ring_attention.py``) keeps the sequence sharded and
rotates K/V; Ulysses instead re-shards *heads*: each rank exchanges its
sequence shard for a head shard with one all-to-all, runs ordinary
full-sequence attention on ``H/sp`` heads, and all-to-alls back. The
all-to-alls are ``all_to_all_single_autograd``, whose backward is the
reverse exchange.

Layout contract:
- ``ulysses_attention`` runs per rank on q/k/v sharded ``[B, S/sp, H, D]``
  over the sp axis, or pass GLOBAL tensors (or DTensors) to
  ``ulysses_attention_sharded``, which enters it through ``local_map``;
- requires ``H % sp == 0`` for queries and ``Hkv % sp == 0`` for K/V (GQA
  with fewer KV heads than sp would need KV replication: rejected loudly).
"""

from __future__ import annotations

from typing import Callable, Optional

from torch.distributed._functional_collectives import all_to_all_single_autograd
from torch.distributed.tensor.experimental import local_map

from ray_tpu_torch.ops.attention import reference_attention
from ray_tpu_torch.parallel.mesh import group_position
from ray_tpu_torch.parallel.sharding import shard_tensor, spec_placements


def _all_to_all(x, group, sp: int, split_axis: int, concat_axis: int):
    """Tiled all-to-all over the group: dim ``split_axis`` shrinks sp-fold
    (chunk j goes to rank j), dim ``concat_axis`` grows sp-fold (the chunks
    arrive in rank order), as ``jax.lax.all_to_all(..., tiled=True)``."""
    shape = list(x.shape)
    parts = x.reshape(shape[:split_axis] + [sp, shape[split_axis] // sp]
                      + shape[split_axis + 1:]).movedim(split_axis, 0).contiguous()
    got = all_to_all_single_autograd(parts, None, None, group)
    got = got.movedim(0, concat_axis)
    shape[split_axis] //= sp
    shape[concat_axis] *= sp
    return got.reshape(shape)


def ulysses_attention(q, k, v, mesh, axis_name: str = "sp", causal: bool = True,
                      scale: Optional[float] = None, attn_fn: Callable = reference_attention):
    """Per rank. q: [B, S/sp, H, D]; k/v: [B, S/sp, Hkv, D].

    attn_fn(q, k, v, causal=..., scale=...) runs the full-sequence local
    attention on the head shard: pass ``ops.attention.attention`` on the
    card (the flash kernel); the default plain path keeps CPU tests exact.
    """
    group, _, sp = group_position(mesh, axis_name)
    hq, hkv = q.shape[2], k.shape[2]
    if hq % sp or hkv % sp:
        raise ValueError(
            f"Ulysses SP needs heads divisible by sp={sp} (got Hq={hq}, Hkv={hkv}); "
            "use ring attention (parallel/ring_attention.py) for head-poor configs"
        )
    if sp == 1:
        return attn_fn(q, k, v, causal=causal, scale=scale)
    # [B, S/sp, H, D] -> [B, S, H/sp, D]: scatter heads, gather sequence
    q, k, v = (_all_to_all(t, group, sp, split_axis=2, concat_axis=1) for t in (q, k, v))
    out = attn_fn(q, k, v, causal=causal, scale=scale)
    # [B, S, H/sp, D] -> [B, S/sp, H, D]: back to sequence sharding
    return _all_to_all(out, group, sp, split_axis=1, concat_axis=2)


def ulysses_attention_sharded(q, k, v, mesh, causal: bool = True, scale: Optional[float] = None,
                              axis_name: str = "sp", q_spec=None, kv_spec=None,
                              attn_fn: Callable = reference_attention):
    """GLOBAL [B, S, H, D] tensors (or DTensors), sequence split on the sp
    axis. Like ring_attention_sharded, optional q_spec/kv_spec carry the
    full layout as mesh axes per dim. Returns a DTensor laid out by q_spec."""
    if q_spec is None:
        q_spec = (None, axis_name, None, None)
    if kv_spec is None:
        kv_spec = q_spec
    q_pl, kv_pl = spec_placements(mesh, q_spec), spec_placements(mesh, kv_spec)
    q, k, v = shard_tensor(q, mesh, q_pl), shard_tensor(k, mesh, kv_pl), shard_tensor(v, mesh, kv_pl)

    def fn(q, k, v):
        return ulysses_attention(q, k, v, mesh, axis_name=axis_name, causal=causal,
                                 scale=scale, attn_fn=attn_fn)

    return local_map(fn, out_placements=list(q_pl), in_placements=(q_pl, kv_pl, kv_pl),
                     device_mesh=mesh)(q, k, v)
