"""Milliseconds a decode tick the engine loop waits on the card: the chunk's
copy to the host (``engine.d2h``) and the prefills' copies to the card
(``engine.h2d``), which wait on the stream (``perfbench/spans.py``)."""

from perfbench.spans import per_tick_ms, wall


def read(run):
    return per_tick_ms(run, lambda it: wall(it, "engine.d2h") + wall(it, "engine.h2d"))
