"""Percentiles and rates, as every metric reader takes them."""

from __future__ import annotations

import math
from typing import Optional, Sequence


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """The q-th percentile (0..100) by linear interpolation between the
    closest ranks (numpy's default); None for no values. A missing value
    (a failed request) is passed as ``math.inf`` and counts as missing any
    limit: it sorts last."""
    vals = sorted(values)
    if not vals:
        return None
    pos = (len(vals) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(vals) - 1)
    if vals[hi] == math.inf:
        return math.inf if pos > lo or vals[lo] == math.inf else vals[lo]
    return vals[lo] + (vals[hi] - vals[lo]) * (pos - lo)


def rate(amount: float, seconds: float) -> Optional[float]:
    return amount / seconds if seconds > 0 else None


def spread(values: Sequence[float]) -> float:
    """Distance between the first and third quartiles over the median
    (``statistics.quantiles(values, n=4)``): how the bounds are set."""
    import statistics

    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def produced_between(sent_ns: int, copies: Sequence[Sequence[int]], t0_ns: int,
                     t1_ns: int) -> float:
    """Tokens of one request produced in [t0, t1]: its cumulative count rises
    linearly from 0 at its send to each copy's count at that copy's time
    (``copies``: [time_ns, tokens so far] in order), and stays flat after the
    last copy."""
    def at(t):
        prev_t, prev_n = sent_ns, 0
        for ct, cn in copies:
            if t <= ct:
                if t <= prev_t:
                    return prev_n
                return prev_n + (cn - prev_n) * (t - prev_t) / (ct - prev_t)
            prev_t, prev_n = ct, cn
        return prev_n

    return at(t1_ns) - at(t0_ns)
