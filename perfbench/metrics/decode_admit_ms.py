"""Milliseconds a decode tick the engine loop spends admitting requests and
dispatching their prefill programs: ``engine.admit`` less its copies to the
card (``engine.h2d``, counted in ``decode_wait_ms``; ``perfbench/spans.py``)."""

from perfbench.spans import per_tick_ms, wall


def read(run):
    return per_tick_ms(run, lambda it: wall(it, "engine.admit") - wall(it, "engine.h2d"))
