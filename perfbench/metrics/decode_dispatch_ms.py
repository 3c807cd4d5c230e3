"""Milliseconds a decode tick the engine loop spends enqueueing the decode
chunk (``engine.decode``: the eager dispatch of every tick's layers), over
the iterations that started in the measured window before the profiler
(``perfbench/spans.py``)."""

from perfbench.spans import per_tick_ms, wall


def read(run):
    return per_tick_ms(run, lambda it: wall(it, "engine.decode"))
