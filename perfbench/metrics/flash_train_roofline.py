"""K1', K2 and K3 together against their roofline in the traced steps: the
bound of every launch at the step's shape, over the three kernels' device
time, in %."""

from perfbench import arith
from perfbench.readers import TRAIN_KERNELS

KERNELS = tuple(TRAIN_KERNELS.values())  # checked for launches in every traced run


def read(run):
    tr = run.trace
    if tr is None:
        return None
    st = run.ctx.workload["step"]
    work = arith.flash_train_work(run.ctx.dims, st["batch"], st["seq"])
    bound = sum(tr.launches(name) * arith.bound_s(*work[k]) for k, name in TRAIN_KERNELS.items())
    dev = tr.seconds(*TRAIN_KERNELS.values())
    return 100.0 * bound / dev if bound > 0 and dev > 0 else None
