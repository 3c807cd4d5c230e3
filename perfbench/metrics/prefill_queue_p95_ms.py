"""p95 of the wait from a request's submission to the start of the prefill
program that takes it (``request.queue``), over the requests whose wait
ended in the measured window before the profiler, in ms
(``perfbench/spans.py``)."""

from perfbench.readers import untraced_window
from perfbench.spans import recorded
from perfbench.stats import percentile


def read(run):
    spans = recorded(run)
    if spans is None:
        return None
    t0, t1 = untraced_window(run)
    return percentile([1e3 * (s["end"] - s["start"]) for s in spans
                       if s["name"] == "request.queue" and t0 <= s["end"] * 1e9 < t1], 95)
