"""Pipeline parallelism: GPipe and 1F1B schedules over the ``pp`` mesh axis
(port of ray_tpu/parallel/pipeline.py).

- layers are grouped into ``pp`` stages; the stage parameters are stacked
  along a leading [pp] axis (logical axis "stage") and each rank runs its
  own stage's slice;
- every tick runs each stage on its current microbatch and shifts
  activations to the next stage (the JAX package's ``ppermute``, here one
  neighbour exchange on the pp group, ``ring_attention.shift``), with the
  same tick formulas as the JAX package's single program.

Two training schedules (``pipeline_train_step``):

- ``gpipe``: all forwards, then all backwards: activation stash depth M
  (every microbatch's stage input is live until its backward);
- ``1f1b``: backwards interleave with forwards as soon as the cotangent
  arrives from the right neighbour: stash depth min(M, 2*pp - 1), the 1F1B
  memory bound, letting M scale without scaling activation memory.

Constraint: every stage maps activations of one shape to the same shape
(true for transformer blocks); the final projection/loss fold into
``loss_fn`` on the last stage. ``stage_params`` are plain tensors with the
same global [pp, ...] values on every rank.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_nn
from torch.distributed.tensor import DTensor

from ray_tpu_torch.parallel.mesh import group_position
from ray_tpu_torch.parallel.ring_attention import shift
from ray_tpu_torch.parallel.sharding import spec_placements


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _tree_leaves(tree):
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _tree_leaves(tree[k])]
    return [tree]


def _tree_unflatten(tree, leaves):
    it = iter(leaves)

    def take(tree):
        if isinstance(tree, dict):
            return {k: take(tree[k]) for k in sorted(tree)}
        return next(it)

    return take(tree)


def _microbatches(x, num_microbatches: int):
    b = x.shape[0]
    if b % num_microbatches:
        raise ValueError(f"batch {b} not divisible by num_microbatches={num_microbatches}")
    return x.reshape((num_microbatches, b // num_microbatches) + tuple(x.shape[1:]))


def pipeline_apply(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stage_params: Any,
    x: torch.Tensor,
    mesh,
    num_microbatches: int,
    axis_name: str = "pp",
):
    """Run a pp-stage pipeline.

    stage_fn(params_for_one_stage, activation[mb, ...]) -> activation
    stage_params: dict tree, leaves with leading dim == pp (stage-stacked)
    x: [B, ...] with B % num_microbatches == 0, the same on every rank
    Returns [B, ...] outputs, the same on every rank of the pp group.
    """
    group, d, pp = group_position(mesh, axis_name)
    M = num_microbatches
    mbs = _microbatches(x, M)
    params_here = _tree_map(lambda p: p[d], stage_params)
    state = torch.zeros_like(mbs[0])
    outputs = []
    for t in range(M + pp - 1):
        mb_idx = t - d
        if 0 <= mb_idx < M:
            out = stage_fn(params_here, mbs[min(t, M - 1)] if d == 0 else state)
            if d == pp - 1:
                outputs.append(out)
        else:
            out = torch.zeros_like(mbs[0])
        if pp > 1:
            state = shift(out, group, d, pp)
    outputs = torch.stack(outputs) if outputs else torch.zeros_like(mbs)
    if pp > 1:
        # replicate the last stage's outputs to all pp members (a psum, whose
        # backward sums the cotangents)
        outputs = dist_nn.all_reduce(outputs, group=group)
    return outputs.reshape(x.shape)


# --------------------------------------------------------------------------- #
# Schedule accounting (asserted by tests/test_torch_parallel.py)
# --------------------------------------------------------------------------- #
def schedule_ticks(schedule: str, pp: int, num_microbatches: int) -> int:
    """Total pipeline ticks for one fwd+bwd step."""
    m = num_microbatches
    if schedule == "gpipe":
        return 2 * (m + pp - 1)
    if schedule == "1f1b":
        return m + 2 * (pp - 1)
    raise ValueError(f"unknown schedule {schedule!r}")


def stash_depth(schedule: str, pp: int, num_microbatches: int) -> int:
    """Activation-stash entries a stage must hold (the 1F1B win)."""
    if schedule == "gpipe":
        return num_microbatches
    if schedule == "1f1b":
        return min(num_microbatches, 2 * pp - 1)
    raise ValueError(f"unknown schedule {schedule!r}")


def bubble_fraction(schedule: str, pp: int, num_microbatches: int) -> float:
    """Idle fraction of the tick x stage grid. Both schedules amortize the
    (pp-1)-tick fill/drain over num_microbatches; 1f1b ticks carry a fwd AND
    a bwd work slot, gpipe ticks carry one."""
    m = num_microbatches
    t = schedule_ticks(schedule, pp, m)
    slots_per_tick = 2 if schedule == "1f1b" else 1
    return 1.0 - (2 * m) / (t * slots_per_tick)


# --------------------------------------------------------------------------- #
# Training step: fwd + bwd under a pipeline schedule
# --------------------------------------------------------------------------- #
def pipeline_train_step(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    loss_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    stage_params: Any,
    x: torch.Tensor,
    targets: torch.Tensor,
    mesh,
    num_microbatches: int,
    axis_name: str = "pp",
    schedule: str = "1f1b",
    stats: Optional[dict] = None,
):
    """One fwd+bwd pipeline step. Returns ``(loss, grads)``.

    stage_fn(params_for_one_stage, act[mb, ...]) -> act (same shape)
    loss_fn(final_act[mb, ...], target[mb, ...]) -> scalar (mean over mb)
    stage_params: dict tree, leaves stage-stacked [pp, ...]
    x, targets: [B, ...] with B % num_microbatches == 0 (the same on every rank)
    loss: an fp32 scalar, the same on every rank of the pp group.
    grads: fp32 DTensors stage-stacked like stage_params ([pp, ...], sharded
    over the pp axis).

    The backward recomputes each stage forward from the stashed stage INPUT
    (per-stage activation checkpointing: ``torch.autograd.grad`` at bwd
    time, the counterpart of ``jax.vjp``), so the stash holds inputs only;
    it is circular with ``stash_depth`` slots, and a slot is never written
    while its microbatch still waits for its backward. ``stats``, if given,
    receives ``peak_stash``: the most stash slots this stage held at once.
    """
    if schedule not in ("gpipe", "1f1b"):
        raise ValueError(f"unknown schedule {schedule!r}")
    group, d, pp = group_position(mesh, axis_name)
    m_total = num_microbatches
    mbs = _microbatches(x, m_total)
    tgts = _microbatches(targets, m_total)
    w = stash_depth(schedule, pp, m_total)
    ticks = schedule_ticks(schedule, pp, m_total)
    # first tick at which backwards may run: 1f1b interleaves as soon as the
    # cotangent can exist; gpipe waits for every forward to finish
    bwd_base = 2 * (pp - 1) + (m_total if schedule == "gpipe" else 0)

    params_here = _tree_map(lambda p: p[d].detach().requires_grad_(True), stage_params)
    leaves = _tree_leaves(params_here)
    g_params = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
    zero_act = torch.zeros_like(mbs[0])
    stash = [None] * w
    live, peak = set(), 0
    loss_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    state_f = state_b = zero_act
    for t in range(ticks):
        # ---- forward slot ----
        mf = t - d
        out_f = zero_act
        if 0 <= mf < m_total:
            inp = mbs[mf] if d == 0 else state_f
            slot = mf % w
            if slot in live:
                raise RuntimeError(f"stage {d}: stash slot {slot} overwritten before its backward")
            stash[slot] = inp
            live.add(slot)
            peak = max(peak, len(live))
            with torch.no_grad():
                out_f = stage_fn(params_here, inp)
        # ---- backward slot ----
        # stage d runs bwd of microbatch m at tick bwd_base + m - d: the
        # cotangent hops right-to-left one stage per tick
        m_b = t - bwd_base + d
        gx = zero_act
        if 0 <= m_b < m_total:
            slot = m_b % w
            x_in = stash[slot].detach().requires_grad_(True)
            live.remove(slot)
            with torch.enable_grad():
                y = stage_fn(params_here, x_in)
                if d == pp - 1:
                    # through loss_fn o stage_fn: the cotangent seed 1/M
                    # gives the mean over the batch
                    lm = loss_fn(y, tgts[m_b])
                    grads = torch.autograd.grad(lm, leaves + [x_in],
                                                torch.full_like(lm, 1.0 / m_total))
                    loss_sum = loss_sum + lm.detach().float() / m_total
                else:
                    grads = torch.autograd.grad(y, leaves + [x_in], state_b)
            g_params = [a + g.float() for a, g in zip(g_params, grads[:-1])]
            gx = grads[-1].to(x.dtype)
        # ---- shifts (uniform every tick; the ends' extra arrivals are unused) ----
        if pp > 1:
            state_f = shift(out_f, group, d, pp, 1)
            state_b = shift(gx, group, d, pp, -1)
    if pp > 1:
        dist.all_reduce(loss_sum, group=group)  # only the last stage's is nonzero
    if stats is not None:
        stats["peak_stash"] = peak
    placements = spec_placements(mesh, (axis_name,))
    grads = [DTensor.from_local(g[None], mesh, placements, run_check=False) for g in g_params]
    return loss_sum, _tree_unflatten(params_here, grads)
