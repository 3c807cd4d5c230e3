"""Percentiles and rates on hand-worked samples, and the end-to-end readers
over a made-up run: a stall in the window moves the tail."""

import math
import types

import pytest

from perfbench import harness
from perfbench.stats import percentile, produced_between, rate, spread


def test_percentile_hand_worked():
    assert percentile([1, 2, 3, 4, 5], 50) == 3
    assert percentile([1, 2, 3, 4], 50) == 2.5
    # rank (10 - 1) * 0.95 = 8.55: 9 + 0.55 * (10 - 9)
    assert percentile(list(range(1, 11)), 95) == pytest.approx(9.55)
    assert percentile([], 95) is None
    assert percentile([1, 2, math.inf], 50) == 2
    assert percentile([1, 2, math.inf, math.inf], 95) == math.inf


def test_rate_and_spread():
    assert rate(300, 30) == 10 and rate(1, 0) is None
    # statistics.quantiles([1..8], n=4) -> 2.25, 4.5, 6.75
    assert spread([1, 2, 3, 4, 5, 6, 7, 8]) == pytest.approx((6.75 - 2.25) / 4.5)


def _run(requests, seconds=10.0, streams=None):
    ctx = types.SimpleNamespace()
    return harness.Run(ctx=ctx, setup_s=12.5, window=(0, int(seconds * 1e9)),
                       attempted=len(requests), failed=0, checks={}, memory_peak_bytes=0,
                       requests=requests, extra={"streams": streams or []})


S = 1_000_000_000


def test_produced_between_spreads_each_copy_over_its_interval():
    # sent at 0; 33 tokens copied at 2 s, 32 more at 4 s
    copies = [[2 * S, 33], [4 * S, 65]]
    assert produced_between(0, copies, 0, 4 * S) == 65
    assert produced_between(0, copies, 1 * S, 3 * S) == pytest.approx(16.5 + 16)
    assert produced_between(0, copies, 5 * S, 6 * S) == 0  # flat after the last copy
    assert produced_between(3 * S, copies, 0, 4 * S) == 65  # nothing before the send


def test_decode_rate_counts_tokens_produced_in_the_window():
    # 8 requests in flight through a 10 s window, each copying 32 tokens every 1.6 s from
    # 0.3 s before the window, so the count does not step with the copies
    streams = [(-int(0.3 * S), [[int((-0.3 + 1.6 * k) * S), 32 * k] for k in range(1, 9)])
               for _ in range(8)]
    rate = harness.reader("decode_tok_s")(_run([], streams=streams))
    assert rate == pytest.approx(8 * 32 / 1.6, rel=1e-9)


def _req(n, ttft, latency):
    return {"tokens": list(range(n)), "ttft_s": ttft, "latency_s": latency}


def test_decode_rate_and_tpot_tail():
    reqs = [_req(101, 0.5, 0.5 + 100 * 0.030) for _ in range(40)]
    run = _run(reqs)
    assert harness.reader("tpot_p95_ms")(run) == pytest.approx(30.0)
    assert harness.reader("setup_s")(run) == 12.5
    # a 2 s stall inside the window lands on the requests decoding through it
    stalled = [_req(101, 0.5, 0.5 + 100 * 0.030 + (2.0 if i % 8 == 0 else 0)) for i in range(40)]
    assert harness.reader("tpot_p95_ms")(_run(stalled)) > 45.0


def test_ttft_tail_counts_a_failed_request_as_missing():
    reqs = [{"ttft_sched_s": 0.2, "lag_s": 0.001} for _ in range(39)] + \
           [{"ttft_sched_s": math.inf, "lag_s": 0.001}]
    assert harness.reader("ttft_p95_ms")(_run(reqs)) == pytest.approx(200.0)
    reqs += [{"ttft_sched_s": math.inf, "lag_s": 0.001}] * 3
    assert harness.reader("ttft_p95_ms")(_run(reqs)) == math.inf
    assert harness.reader("send_lag_p95_ms")(_run(reqs)) == pytest.approx(1.0)


def test_decode_tick_is_the_loop_period_not_whole_chunks():
    """Chunks of 32 ticks launched every 2.6 s: a tick is 81.25 ms wherever
    the profiler starts, where counting the chunks inside an 8 s window
    would read 8000 / 96 or 8000 / 64."""
    from perfbench.serving import Recorder
    from perfbench.trace import Trace

    rec = Recorder.__new__(Recorder)
    rec.chunks = [(int(k * 2.6 * S), int((k * 2.6 + 1) * S), 32, []) for k in range(12)]
    rec.prefills = []
    for t0 in (8.0, 10.0, 13.0):
        run = _run([], seconds=30.0)
        run.recorder = rec
        run.trace = Trace(int(t0 * S), int((t0 + 8) * S), 1.0, {}, {}, [], [])
        assert harness.reader("decode_tick_ms")(run) == pytest.approx(81.25)
