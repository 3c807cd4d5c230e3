"""Arithmetic the metric readers share (``perfbench/metrics/``)."""

from __future__ import annotations

from typing import Optional

from perfbench import arith

K4 = ("paged_attention_split", "paged_attention_merge")
K1 = ("flash_fwd_kernel",)
TRAIN_KERNELS = {"k1l": "flash_fwd_kernel", "k2": "flash_bwd_dq", "k3": "flash_bwd_dkv"}


def traced_window(run):
    tr = run.trace
    return None if tr is None else (tr.t0_ns, tr.t1_ns)


def untraced_window(run):
    """A traced run's measured window up to the profiler's start: what the
    host-side record reads there is free of the profiler's own cost to the
    host."""
    tr = run.trace
    return None if tr is None else (run.window[0], tr.t0_ns)


def served_mfu(run) -> Optional[float]:
    """Model FLOPs of the prefill and decode tokens the engine was asked for
    in the untraced part of the window, over its seconds at the bf16 peak,
    in %."""
    if run.trace is None or run.recorder is None:
        return None
    d, (t0, t1) = run.ctx.dims, untraced_window(run)
    if t1 <= t0:
        return None
    prompts = [n for lens in run.recorder.prefills_in(t0, t1) for n in lens]
    contexts = [c for tick in run.recorder.ticks_in(t0, t1) for c in tick]
    if not prompts and not contexts:
        return None
    flops = arith.prefill_flops(d, prompts) + arith.decode_flops(d, contexts)
    return 100.0 * flops / ((t1 - t0) / 1e9 * arith.PEAK_BF16_FLOPS)


def device_idle(run) -> Optional[float]:
    tr = run.trace
    if tr is None or tr.window_s <= 0 or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def per_launch_share(run, names, bounds_per_call, calls_key) -> Optional[float]:
    """Σ bound over Σ device time, as a mean a call: ``bounds_per_call`` are
    the bounds (s) of the calls the host made in the traced window, and the
    trace's launches of ``calls_key`` over the layers give how many calls
    its device time covers."""
    tr = run.trace
    layers = run.ctx.dims.layers
    calls = tr.launches(calls_key) / layers
    dev = tr.seconds(*names)
    if not bounds_per_call or calls <= 0 or dev <= 0:
        return None
    mean_bound = sum(bounds_per_call) / len(bounds_per_call)
    return 100.0 * mean_bound / (dev / calls)
