"""The serving engine's spans (``ray_tpu_torch.serve.llm.LLMEngine`` through
``ray_tpu_torch.profiling``) and the benchmark's readers of them
(``perfbench/spans.py``, ``perfbench/metrics/``), on the CPU engine with the
tiny fp32 config, paged and dense.

One test is marked ``cuda``: on the card, under ``perfbench.trace.Tracer``,
every decode-attention launch lies inside its iteration's spans, which shows
the spans share the device trace's clock. It skips without a card. On a
machine with one (and without JAX, which tests/conftest.py imports):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_engine_spans.py
"""

import collections
import concurrent.futures as cf
import math
import time
from collections import deque
from types import SimpleNamespace

import pytest
import torch

from perfbench import harness, serving
from ray_tpu_torch import profiling
from ray_tpu_torch.models.llama import LlamaConfig, llama_init
from ray_tpu_torch.serve.llm import LLMEngine

ENGINE_KW = dict(num_slots=2, decode_chunk=4, max_seq_len=64, prefill_buckets=[16, 32],
                 page_size=16)
PROMPTS = [[3, 14, 15, 92, 65, 35], [1, 2, 3], [200, 17, 9, 9, 41, 5, 77, 3, 2, 8, 1, 90, 4],
           list(range(20, 45)), [7]]
MAX_TOKENS = [8, 6, 5, 7, 9]
PHASES = ("engine.admit", "engine.decode", "engine.d2h", "engine.deliver")
BOOKKEEPING_S = 1e-6  # phases share their boundary stamps; float rounding only
SPAN_READERS = ("decode_dispatch_ms", "decode_wait_ms", "decode_admit_ms", "decode_deliver_ms",
                "prefill_queue_p95_ms", "prefill_pad_share")
# what each span carries besides its engine and step: only what a reader reads
ATTRIBUTES = {"engine.step": {"ticks"}, "engine.prefill": {"bucket", "rows", "lengths"},
              "request.queue": {"request"}}


@pytest.fixture(scope="module", autouse=True)
def fresh_buffer():
    """A buffer of this module's own, so spans that other tests in the
    process recorded or dropped do not count here."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(profiling, "_spans", deque(maxlen=profiling._MAX_PENDING))
        mp.setattr(profiling, "_dropped", 0)
        yield


@pytest.fixture(scope="module")
def params():
    cfg = LlamaConfig.tiny(dtype=torch.float32)
    return cfg, llama_init(cfg, 1, "cpu")


def _engine_spans(engine):
    return [s for s in profiling.snapshot() if s["extra"].get("engine") == engine._id]


def _by_step(spans):
    steps = collections.defaultdict(lambda: collections.defaultdict(list))
    for s in spans:
        steps[s["extra"]["step"]][s["name"]].append(s)
    return steps


def _inside(child, parent, slack=0.0):
    return parent["start"] - slack <= child["start"] <= child["end"] <= parent["end"] + slack


def _disjoint(spans):
    spans = sorted(spans, key=lambda s: s["start"])
    return all(a["end"] <= b["start"] for a, b in zip(spans, spans[1:]))


@pytest.fixture(scope="module", params=[True, False], ids=["paged", "dense"])
def served(request, params):
    """One run of the tiny engine under the benchmark's recorder: its spans,
    the recorder, and time.time_ns() stamps around the run."""
    cfg, weights = params
    engine = LLMEngine(cfg, weights, device="cpu", paged=request.param, **ENGINE_KW)
    recorder = serving.Recorder(engine)
    t0 = time.time_ns()
    try:
        with cf.ThreadPoolExecutor(max_workers=len(PROMPTS)) as pool:
            futs = [pool.submit(engine.generate, p, n, None, 120)
                    for p, n in zip(PROMPTS, MAX_TOKENS)]
            tokens = [f.result()["tokens"] for f in futs]
    finally:
        engine.stop()
    t1 = time.time_ns()
    assert not engine._thread.is_alive()
    assert [len(t) for t in tokens] == MAX_TOKENS
    return SimpleNamespace(paged=request.param, engine=engine, spans=_engine_spans(engine),
                           recorder=recorder, t0_ns=t0, t1_ns=t1)


def test_each_iteration_is_one_step_tiled_by_its_phases(served):
    steps = _by_step([s for s in served.spans if s["name"].startswith("engine.")])
    assert sorted(steps) == list(range(1, len(steps) + 1))
    for it in steps.values():
        assert len(it["engine.step"]) == 1
        step = it["engine.step"][0]
        phases = [it[name] for name in PHASES]
        assert all(len(p) == 1 for p in phases), {n: len(it[n]) for n in PHASES}
        phases = [p[0] for p in phases]
        assert all(_inside(p, step) for p in phases)
        assert _disjoint(phases)
        total = sum(p["end"] - p["start"] for p in phases)
        assert abs(total - (step["end"] - step["start"])) <= BOOKKEEPING_S
        for prog in it["engine.prefill"]:
            assert _inside(prog, it["engine.admit"][0])
        assert _disjoint(it["engine.prefill"])
        for copy in it["engine.h2d"]:
            assert any(_inside(copy, prog) for prog in it["engine.prefill"])
        assert _disjoint(it["engine.h2d"])
        assert step["extra"]["ticks"] == ENGINE_KW["decode_chunk"]
    for s in served.spans:
        assert set(s["extra"]) == ATTRIBUTES.get(s["name"], set()) | {"engine", "step"}


def test_each_request_has_one_queue_and_one_prefill_span(served):
    """Each request waits in one ``request.queue`` span, which ends where
    the one ``engine.prefill`` program that takes it starts."""
    queue = collections.defaultdict(list)
    for s in served.spans:
        if s["name"] == "request.queue":
            queue[s["extra"]["request"]].append(s)
    assert len(queue) == len(PROMPTS) and all(len(q) == 1 for q in queue.values())
    steps = _by_step([s for s in served.spans if s["name"].startswith("engine.")])
    taken = collections.Counter()
    for (q,) in queue.values():
        assert q["start"] <= q["end"]
        (prog,) = [p for p in steps[q["extra"]["step"]]["engine.prefill"] if p["start"] == q["end"]]
        taken[id(prog)] += 1
    progs = [p for s in steps.values() for p in s["engine.prefill"]]
    assert sum(taken.values()) == sum(len(p["extra"]["lengths"]) for p in progs)
    assert all(taken[id(p)] == len(p["extra"]["lengths"]) for p in progs)


def test_spans_note_what_the_recorder_notes(served):
    steps = _by_step([s for s in served.spans if s["name"].startswith("engine.")])
    decodes = [steps[k]["engine.decode"][0] for k in sorted(steps)]
    assert len(decodes) == len(served.recorder.chunks)
    for d, (t0, t1, ticks, _slots) in zip(decodes, served.recorder.chunks):
        assert d["start"] * 1e9 <= t0 + 1e3 and t1 <= d["end"] * 1e9 + 1e3  # 1 us of rounding
        assert ticks == steps[d["extra"]["step"]]["engine.step"][0]["extra"]["ticks"]
    progs = sorted((s for s in served.spans if s["name"] == "engine.prefill"),
                   key=lambda s: s["start"])
    noted = [(s["extra"]["bucket"], s["extra"]["rows"], s["extra"]["lengths"]) for s in progs]
    if served.paged:
        assert noted == [(b, rows, lens) for _, b, rows, lens in served.recorder.prefills]
    else:  # the dense engine prefills one prompt a program, outside the recorder's hook
        assert not served.recorder.prefills
        assert sorted(n for _, _, (n,) in noted) == sorted(len(p) for p in PROMPTS)
        assert all(rows == 1 and b == served.engine._bucket_for(n) for b, rows, (n,) in noted)


def test_spans_lie_inside_the_run_on_the_profilers_clock(served):
    assert served.spans
    for s in served.spans:
        assert served.t0_ns <= s["start"] * 1e9 <= s["end"] * 1e9 <= served.t1_ns


def test_the_four_decode_shares_add_up_to_the_loop_period(served):
    run = SimpleNamespace(trace=SimpleNamespace(t0_ns=served.t1_ns), window=(served.t0_ns, 0))
    steps = _by_step([s for s in served.spans if s["name"].startswith("engine.")])
    period_ms = 1e3 * sum(it["engine.step"][0]["end"] - it["engine.step"][0]["start"]
                          for it in steps.values()) / (len(steps) * ENGINE_KW["decode_chunk"])
    parts = [harness.reader(name)(run) for name in SPAN_READERS[:4]]
    assert math.isclose(sum(parts), period_ms, rel_tol=1e-6)
    assert 0 <= harness.reader("prefill_pad_share")(run) < 100
    assert harness.reader("prefill_queue_p95_ms")(run) > 0


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_an_idle_engine_records_nothing(params, paged):
    cfg, weights = params
    engine = LLMEngine(cfg, weights, device="cpu", paged=paged, **ENGINE_KW)
    try:
        time.sleep(0.2)
        assert engine._thread.is_alive()
    finally:
        engine.stop()
    assert _engine_spans(engine) == []


@pytest.fixture
def small_buffer(monkeypatch):
    """``profiling``'s buffer at 5 spans, restored afterwards."""
    monkeypatch.setattr(profiling, "_MAX_PENDING", 5)
    monkeypatch.setattr(profiling, "_spans", deque(maxlen=5))
    monkeypatch.setattr(profiling, "_dropped", 0)
    monkeypatch.setattr(profiling, "_local_runtime_spans", deque(maxlen=5))


def test_profiling_keeps_the_newest_spans_and_counts_the_dropped(small_buffer):
    for i in range(8):
        profiling.record_external_span(f"s{i}", i, i + 1, extra={"i": i})
    with profiling.profile("s8"):
        pass
    assert profiling.dropped() == 4
    names = [s["name"] for s in profiling.snapshot()]
    assert names == ["s4", "s5", "s6", "s7", "s8"]
    assert [s["name"] for s in profiling.snapshot()] == names  # a snapshot drains nothing
    assert [s["name"] for s in profiling.drain()] == names
    assert profiling.snapshot() == [] and profiling.drain() == []
    for i in range(3):
        profiling.record_external_span(f"t{i}", i, i + 1)
    profiling.flush_local()
    assert profiling.snapshot() == []
    assert [s["name"] for s in profiling.local_spans()] == ["t0", "t1", "t2"]
    assert profiling.dropped() == 4


# ---- the readers on a synthetic run: two iterations and a request in the untraced
# window [100 s, 200 s), one iteration and a request after it

def _span(name, start, end, step, **extra):
    extra.update(engine=7, step=step)
    return {"name": name, "start": start, "end": end, "extra": extra}


def _iteration(step, t, ticks=4, admit=2.0, h2d=0.5, decode=3.0, d2h=1.0, deliver=0.25,
               bucket=16, rows=2, lengths=(5, 11)):
    """Spans of one iteration from ``t``: admit (with one prefill holding
    its copy), decode, d2h, deliver."""
    a, b, c, d = t + admit, t + admit + decode, t + admit + decode + d2h, \
        t + admit + decode + d2h + deliver
    return [
        _span("engine.step", t, d, step, ticks=ticks),
        _span("engine.admit", t, a, step),
        _span("engine.prefill", t, t + h2d * 2, step, bucket=bucket, rows=rows,
              lengths=list(lengths)),
        _span("engine.h2d", t, t + h2d, step),
        _span("engine.decode", a, b, step),
        _span("engine.d2h", b, c, step),
        _span("engine.deliver", c, d, step),
    ]


def _request(rid, submitted, prefill, step):
    return [_span("request.queue", submitted, prefill, step, request=rid)]


SYNTHETIC = (_iteration(1, 110.0) + _iteration(2, 120.0, ticks=4, admit=1.0, h2d=0.25,
                                               bucket=32, rows=1, lengths=(30,))
             + _iteration(3, 205.0) + _request(1, 99.0, 110.0, 1)
             + _request(2, 118.0, 120.0, 2) + _request(3, 190.0, 205.0, 3))
# hand-computed over iterations 1 and 2 (8 ticks): decode 3 + 3 s, d2h 1 + 1, h2d 0.5 + 0.25,
# admit 2 + 1, deliver 0.25 + 0.25; queues (ending in the window) 11 and 2 s; tokens run
# 2 x 16 + 1 x 32 for 5 + 11 + 30 real
EXPECTED = {
    "decode_dispatch_ms": 6000 / 8,
    "decode_wait_ms": 2750 / 8,
    "decode_admit_ms": 2250 / 8,
    "decode_deliver_ms": 500 / 8,
    "prefill_queue_p95_ms": 2000 + 0.95 * 9000,
    "prefill_pad_share": 100 * (64 - 46) / 64,
}


def _synthetic_run():
    return SimpleNamespace(trace=SimpleNamespace(t0_ns=200 * 10**9), window=(100 * 10**9, 0))


@pytest.mark.parametrize("name", SPAN_READERS)
def test_span_reader_on_a_synthetic_run(monkeypatch, name):
    read = harness.reader(name)
    monkeypatch.setattr(profiling, "snapshot", lambda: [dict(s) for s in SYNTHETIC])
    monkeypatch.setattr(profiling, "dropped", lambda: 0)
    assert math.isclose(read(_synthetic_run()), EXPECTED[name], rel_tol=1e-9)
    monkeypatch.setattr(profiling, "dropped", lambda: 1)
    assert read(_synthetic_run()) is None  # spans were lost: no under-reading
    monkeypatch.setattr(profiling, "dropped", lambda: 0)
    monkeypatch.setattr(profiling, "snapshot", lambda: [])
    assert read(_synthetic_run()) is None
    monkeypatch.setattr(profiling, "snapshot", lambda: [dict(s) for s in SYNTHETIC])
    assert read(SimpleNamespace(trace=None, window=(0, 0))) is None  # an untraced run
    monkeypatch.delattr(profiling, "snapshot")  # a program that records no spans
    assert read(_synthetic_run()) is None


# ---- on the card

@pytest.mark.cuda
def test_decode_launches_lie_inside_their_iterations_on_the_trace_clock():
    """Under the benchmark's Tracer, as it is used there, every K4 split
    launch's device interval lies inside an iteration's [engine.decode
    start, engine.d2h end], within 1 ms: the spans and the device trace
    share one clock."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the decode kernel has no CPU mode")
    from perfbench.trace import Tracer, _is_device

    dev = torch.device("cuda")
    cfg = LlamaConfig(vocab_size=256, hidden_size=512, intermediate_size=256, num_layers=2,
                      num_heads=4, num_kv_heads=1, max_seq_len=256, rope_theta=10000.0,
                      dtype=torch.bfloat16)
    engine = LLMEngine(cfg, llama_init(cfg, 0, dev), device=dev, num_slots=4, decode_chunk=4,
                       max_seq_len=256, prefill_buckets=[64], page_size=64)
    try:
        engine.generate([1, 2, 3], 2, timeout=600)  # builds the kernels
        tracer = Tracer(dev)
        tracer.start()
        with cf.ThreadPoolExecutor(max_workers=4) as pool:
            futs = [pool.submit(engine.generate, list(range(5, 15 + 7 * i)), 13, None, 120)
                    for i in range(4)]
            assert all(len(f.result()["tokens"]) == 13 for f in futs)
        tracer.stop()
        events = tracer._prof.profiler.kineto_results.events()
    finally:
        engine.stop()
    launches = [(int(e.start_ns()), int(e.start_ns()) + int(e.duration_ns())) for e in events
                if _is_device(e, "cuda") and "paged_attention_split" in e.name()]
    steps = _by_step([s for s in _engine_spans(engine) if s["name"].startswith("engine.")])
    windows = [(it["engine.decode"][0]["start"] * 1e9, it["engine.d2h"][0]["end"] * 1e9)
               for it in steps.values() if it["engine.d2h"][0]["end"] * 1e9 >= tracer.t0_ns]
    assert launches and windows
    slack_ns = 1e6
    outside = [(a, b) for a, b in launches
               if not any(w0 - slack_ns <= a and b <= w1 + slack_ns for w0, w1 in windows)]
    assert not outside, (len(outside), len(launches), outside[:3], windows[:3])
