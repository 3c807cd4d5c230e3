"""Every cell's driver end to end at a tiny size on the CPU (the rehearsal:
``run_cell(..., rehearsal=True)`` skips the look for a card and reports no
metric), the control, and the faults each kind of cell can have, planted in
the timed path underneath a run: each must turn ``correct`` false."""

import dataclasses
import json
import time
from pathlib import Path

import pytest
import torch

from conftest import TINY, shrink
from perfbench import harness, serving

HERE = Path(__file__).resolve().parents[1]
BENCH = json.loads((HERE.parent / "BENCHMARK.json").read_text())
SERVE_CELLS = [c["name"] for c in BENCH["workloads"]
               if json.loads((HERE / "workloads" / f"{c['name']}.json").read_text())["driver"]
               .startswith("serve")]
TRAIN_FILES = sorted(p.stem for p in (HERE / "workloads").glob("*.json")
                     if json.loads(p.read_text())["driver"] == "train")
CPU = torch.device("cpu")


def _run(cell, seed=2**31 + 11, config=None, limits=None, trace=False):
    wl = shrink(harness.load_json(HERE / "workloads" / f"{cell}.json"))
    limits = limits or harness.load_json(HERE / "limits" / f"{cell}.json")
    return harness.run_cell(cell, wl, config or dict(TINY), limits, seed, 2.0, trace, CPU,
                            time.perf_counter(), rehearsal=True)


@pytest.mark.parametrize("cell", SERVE_CELLS)
def test_serving_cell_end_to_end_on_the_cpu(cell):
    run = _run(cell, trace=True)
    result = harness.report(run, BENCH, 1)
    assert result["correct"], result["checks"]
    assert result["metrics"] == {} and result["device"]["platform"] == "cpu"
    assert list(result)[-1] == "checks" and run.attempted > 0 and run.failed == 0
    assert run.extra["sampled_tokens"] >= 40
    assert run.recorder.chunks and run.recorder.prefills


@pytest.mark.parametrize("cell", SERVE_CELLS)
def test_serving_control_is_not_correct(cell):
    """The reference in float8 in the program's place: the gap of the token
    it puts first, on the run's own sample, through the harness's verdict."""
    run = _run(cell)
    assert harness.passed(harness.verdict(run)), run.checks
    control = dataclasses.replace(run, checks=serving.control_checks(run))
    assert not harness.passed(harness.verdict(control)), control.checks
    assert control.checks["logit_gap"] > run.ctx.limits["logit_gap"]["limit"]


@pytest.mark.parametrize("cell", SERVE_CELLS)
def test_traced_run_refuses_what_its_metrics_cannot_read(cell):
    """A listed metric that reads nothing, a recorder that saw nothing and a
    named kernel with no launch each stop a traced run from reporting."""
    from perfbench.trace import Trace

    run = _run(cell, trace=True)
    metrics = harness.cell_metrics(BENCH, cell, True)
    roofline = [m["name"] for m in metrics if hasattr(harness.metric_module(m["name"]), "KERNELS")]
    assert roofline
    read = {m["name"]: {"value": 1.0} for m in metrics}
    kernels = {k: 3 for m in roofline for k in harness.metric_module(m).KERNELS}
    run.trace = Trace(0, 1, 1e-9, {k: 1e-9 for k in kernels}, kernels, [], [])
    assert harness.traced_problems(run, metrics, read) == []
    missing = dict(read)
    missing.pop(roofline[0])
    assert harness.traced_problems(run, metrics, missing) == [
        f"metric {roofline[0]} read nothing in {cell}"]
    run.trace = Trace(0, 1, 1e-9, {}, {}, [], [])
    assert len(harness.traced_problems(run, metrics, read)) == len(kernels)
    run.trace = Trace(0, 1, 1e-9, {k: 1e-9 for k in kernels}, kernels, [], [])
    run.recorder.prefills.clear()
    assert "no longer called" in harness.traced_problems(run, metrics, read)[0]


def _altered(logits, generator, temperature):
    return ((torch.argmax(logits, dim=-1) + 7) % logits.shape[-1]).to(torch.int32)


@pytest.mark.parametrize("cell", SERVE_CELLS)
def test_serving_faults_are_not_correct(cell, monkeypatch):
    import ray_tpu_torch.models.paged_decode as pd

    monkeypatch.setattr(pd, "sample_token", _altered)  # a token altered where it is produced
    run = _run(cell)
    assert not harness.passed(harness.verdict(run)), run.checks
    monkeypatch.undo()
    # the decode step leaves its state (the KV cache) unchanged
    monkeypatch.setattr(pd, "_scatter_token_rows", lambda pool, rows, pages, rownum: pool)
    run = _run(cell)
    assert not harness.passed(harness.verdict(run)), run.checks


F32 = {**TINY, "dtype": "float32"}
TRAIN_LIMITS = {k: {"limit": 1e-4} for k in ("loss_gap", "grad_gap", "change_gap")}
TRAIN_LIMITS["plain_launches"] = {"limit": 0}


@pytest.mark.parametrize("cell", TRAIN_FILES)
def test_train_cell_end_to_end_on_the_cpu(cell):
    """The program's fp32 path agrees with the reference to round-off."""
    run = _run(cell, config=F32, limits=TRAIN_LIMITS, trace=True)
    result = harness.report(run, BENCH, 1)
    assert result["correct"], result["checks"]
    assert run.steps > 0 and run.extra["traced_steps"] == 2
    assert all(v < 1e-5 for k, v in run.checks.items() if k != "plain_launches")


@pytest.mark.parametrize("cell", TRAIN_FILES[:1])
def test_train_faults_are_not_correct(cell, monkeypatch):
    from ray_tpu_torch.train import step as ts

    # a step that returns its state unchanged: the change reads 1
    monkeypatch.setattr(ts.AdamW, "update_", lambda self, grads, state, params:
                        ts.global_norm(grads))
    run = _run(cell, config=F32, limits=TRAIN_LIMITS)
    assert run.checks["change_gap"] == pytest.approx(1.0)
    assert not harness.passed(harness.verdict(run))
    monkeypatch.undo()
    # half of the batch left out, the mean taken over the rest
    loss = ts.llama_loss
    monkeypatch.setattr(ts, "llama_loss", lambda p, t, y, c, **kw:
                        loss(p, t[: t.shape[0] // 2], y[: y.shape[0] // 2], c, **kw))
    run = _run(cell, config=F32, limits=TRAIN_LIMITS)
    assert run.checks["loss_gap"] > 1e-3 or run.checks["grad_gap"] > 1e-2, run.checks
    assert not harness.passed(harness.verdict(run))
