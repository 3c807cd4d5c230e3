"""Milliseconds a decode tick the engine loop spends handing the chunk's
tokens out (``engine.deliver``: first tokens, appends, stream pushes,
retires; ``perfbench/spans.py``)."""

from perfbench.spans import per_tick_ms, wall


def read(run):
    return per_tick_ms(run, lambda it: wall(it, "engine.deliver"))
