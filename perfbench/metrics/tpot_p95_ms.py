"""p95, over the requests completed in the window, of (latency - time to
first token) / (tokens - 1): what a reader of a long answer waits a token,
other requests' prefills included."""

from perfbench.stats import percentile


def read(run):
    vals = [(r["latency_s"] - r["ttft_s"]) / (len(r["tokens"]) - 1) * 1e3
            for r in run.requests if len(r["tokens"]) > 1]
    return percentile(vals, 95)
