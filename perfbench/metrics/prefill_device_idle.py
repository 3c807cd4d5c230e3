"""Share of the traced window in which no operation ran on the device, in %
(``torch.profiler``'s device activity)."""

from perfbench.readers import device_idle


def read(run):
    return device_idle(run)
