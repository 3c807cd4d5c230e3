"""The engine's own spans, as the span readers (``perfbench/metrics/``) take
them: what ``ray_tpu_torch.serve.llm.LLMEngine`` records through
``ray_tpu_torch.profiling`` in the part of a traced run's window before the
profiler starts (``readers.untraced_window``), free of the profiler's cost to
the host.

An iteration of the engine loop is ``engine.step`` and its phases, which tile
it: ``engine.admit`` (holding each ``engine.prefill`` and its ``engine.h2d``
copies), ``engine.decode``, ``engine.d2h`` and ``engine.deliver``; every span
carries its engine and iteration (``step``). Spans are on ``time.time()`` in
seconds, the window in nanoseconds on the same clock.

A program that records no spans (one without ``profiling.snapshot``), or
that dropped any during the run, gives None: the metric then reads nothing
rather than too little."""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

from perfbench.readers import untraced_window


def recorded(run) -> Optional[List[dict]]:
    """Every span the process holds, or None (see the module's docstring)."""
    if run.trace is None:
        return None
    from ray_tpu_torch import profiling

    snapshot = getattr(profiling, "snapshot", None)
    dropped = getattr(profiling, "dropped", None)
    if snapshot is None or dropped is None or dropped():
        return None
    return snapshot()


def iterations(run) -> Optional[List[Dict[str, List[dict]]]]:
    """The loop iterations whose ``engine.step`` started in the untraced
    window, each as its spans by name; None where there is none."""
    spans = recorded(run)
    if spans is None:
        return None
    t0, t1 = untraced_window(run)
    by_step: Dict[tuple, Dict[str, List[dict]]] = {}
    for s in spans:
        if s["name"].startswith("engine."):
            key = (s["extra"]["engine"], s["extra"]["step"])
            by_step.setdefault(key, {}).setdefault(s["name"], []).append(s)
    out = [it for it in by_step.values()
           if "engine.step" in it and t0 <= it["engine.step"][0]["start"] * 1e9 < t1]
    return out or None


def wall(it: Dict[str, List[dict]], name: str) -> float:
    return sum(s["end"] - s["start"] for s in it.get(name, ()))


def per_tick_ms(run, part: Callable[[Dict[str, List[dict]]], float]) -> Optional[float]:
    """Σ ``part`` (seconds) over the window's iterations, per decode tick
    they ran, in ms."""
    its = iterations(run)
    if its is None:
        return None
    ticks = sum(it["engine.step"][0]["extra"]["ticks"] for it in its)
    return 1e3 * sum(part(it) for it in its) / ticks if ticks else None
