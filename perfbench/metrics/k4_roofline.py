"""K4's share of its roofline in the traced window: the bound of each decode
tick's paged-attention calls (the rows each slot still needing a token read,
each byte once, at the peaks of ``arith.py``), over the device time of the
split and merge kernels a tick, in %."""

from perfbench import arith
from perfbench.readers import K4, per_launch_share, traced_window

# checked for launches in every traced run; the merge runs only where a slot's rows are split
KERNELS = ("paged_attention_split",)


def read(run):
    if run.trace is None or run.recorder is None:
        return None
    d = run.ctx.dims
    ticks = run.recorder.ticks_in(*traced_window(run))
    bounds = [d.layers * arith.bound_s(*arith.k4_work(d, rows)) for rows in ticks]
    return per_launch_share(run, K4, bounds, "paged_attention_split")
