"""p95 of time to first token over every request due in the window, timed
from its scheduled send; a request that failed or never answered counts as
missing (infinite)."""

from perfbench.stats import percentile


def read(run):
    return percentile([r["ttft_sched_s"] * 1e3 for r in run.requests], 95)
