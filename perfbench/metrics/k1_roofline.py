"""K1's share of its roofline in the traced window: the bound of each
prefill program's attention, counted on the unpadded prompt lengths, over
the device time of ``flash_fwd`` a program, in %."""

from perfbench import arith
from perfbench.readers import K1, per_launch_share, traced_window

KERNELS = K1  # checked for launches in every traced run


def read(run):
    if run.trace is None or run.recorder is None:
        return None
    d = run.ctx.dims
    programs = run.recorder.prefills_in(*traced_window(run))
    bounds = [d.layers * arith.bound_s(*arith.k1_work(d, lens)) for lens in programs]
    return per_launch_share(run, K1, bounds, "flash_fwd_kernel")
