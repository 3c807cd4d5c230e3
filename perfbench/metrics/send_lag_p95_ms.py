"""p95 over the requests due in the window of how late the load generator
sent each, against its schedule (host clock)."""

from perfbench.stats import percentile


def read(run):
    return percentile([r["lag_s"] * 1e3 for r in run.requests], 95)
