"""Model FLOPs of every prefill and decode token the engine was asked for in
the measured window before the profiler started (a token: 2 N, plus
attention over the context it sees), over those seconds at the bf16 peak,
in % (``readers.untraced_window``)."""

from perfbench.readers import served_mfu


def read(run):
    return served_mfu(run)
