"""The port's streaming Data executor (``ray_tpu_torch.data.execution``)
held against the JAX package's, scenario by scenario: backpressure under
the configured budgets, per-operator stats, limit's short circuit, the
memory-budget math, the downstream-capacity policy and the output split.

Each scenario keeps the assertions of its counterpart in
``tests/test_data_execution.py``, runs on ray_tpu's fresh in-process runtime
and then on ray_tpu_torch's (with the same ``RAY_TPU_*`` settings: one
environment configures both), and returns what both must agree on: rows,
the plan's operators and their block and row counts, the policies'
decisions. Peak block counts depend on thread timing, so each side is held
to the reference test's budget rather than to the other's peak."""

import importlib
import time

import pytest

import ray_tpu
import ray_tpu_torch
from test_torch_data import PACKAGES, _data, _shutdown_all, plain

SCENARIOS = {}


def scenario(fn):
    SCENARIOS[fn.__name__] = fn
    return fn


def _budget_blocks(num_task_ops: int, cap: int, queued: int, num_edges: int) -> int:
    """tests/test_data_execution.py's bound on blocks alive in a pipeline:
    per-op in-flight cap + per-edge queue cap + one block of slack an op."""
    return num_task_ops * cap + num_edges * queued + num_task_ops


@scenario
def slow_producer_fast_consumer_holds_budget(pkg, rd, monkeypatch):
    monkeypatch.setenv("RAY_TPU_DATA_DEFAULT_OP_CONCURRENCY", "2")
    monkeypatch.setenv("RAY_TPU_DATA_MAX_QUEUED_BLOCKS", "2")

    def slow(batch):
        time.sleep(0.03)
        return {"id": batch["id"] * 2}

    n_blocks = 24
    ds = rd.range(n_blocks * 4, parallelism=n_blocks).map_batches(slow) \
        .map_batches(lambda b: {"id": b["id"] + 1})
    out = sorted(r["id"] for r in ds.take_all())
    assert out == sorted(i * 2 + 1 for i in range(n_blocks * 4))
    peak = ds._last_executor.peak_total_blocks
    assert peak <= _budget_blocks(3, 2, 2, 3) and peak < n_blocks
    return out


@scenario
def fast_producer_slow_consumer_holds_budget(pkg, rd, monkeypatch):
    monkeypatch.setenv("RAY_TPU_DATA_DEFAULT_OP_CONCURRENCY", "2")
    monkeypatch.setenv("RAY_TPU_DATA_MAX_QUEUED_BLOCKS", "2")

    def slow(batch):
        time.sleep(0.03)
        return {"id": batch["id"]}

    n_blocks = 24
    ds = rd.range(n_blocks * 4, parallelism=n_blocks) \
        .map_batches(lambda b: {"id": b["id"]}).map_batches(slow)
    rows = sorted(r["id"] for r in ds.take_all())
    assert len(rows) == n_blocks * 4
    assert ds._last_executor.peak_total_blocks <= _budget_blocks(3, 2, 2, 3)
    return rows


@scenario
def actor_pool_bounded_under_stalled_consumer(pkg, rd, monkeypatch):
    monkeypatch.setenv("RAY_TPU_DATA_MAX_QUEUED_BLOCKS", "2")

    class Echo:
        def __call__(self, batch):
            return {"id": batch["id"]}

    n_blocks = 16
    executor = rd.range(n_blocks * 2, parallelism=n_blocks) \
        .map_batches(Echo, concurrency=2)._build_executor()
    gen = executor.execute()
    assert next(gen).ref is not None
    time.sleep(0.5)  # a stalled consumer: nothing may run meanwhile
    budget = _budget_blocks(2, 4, 2, 2)
    occupancy = sum(op.num_active_tasks() + len(op.input_queue) + len(op.output_queue)
                    for op in executor._ops)
    assert occupancy <= budget
    seen = 1 + sum(1 for _ in gen)
    assert seen == n_blocks and executor.peak_total_blocks <= budget
    assert executor._ops[-1].stats.queue_peak <= budget
    return seen, [type(op).__name__ for op in executor._ops]


@scenario
def stats_nonzero_rows_for_three_op_pipeline(pkg, rd, monkeypatch):
    ds = rd.range(64, parallelism=4).map_batches(lambda b: {"id": b["id"] + 1}) \
        .random_shuffle(seed=3)
    report = ds.stats()
    assert "wall_s" in report and "map_batches" in report and "random_shuffle" in report
    rows = ds.stats_rows()
    assert len(rows) == 4
    for row in rows:
        assert row["blocks_out"] > 0 and row["bytes_out"] > 0 and row["wall_s"] >= 0.0, row
        if "shuffle_map" not in row["operator"]:
            assert row["rows"] > 0, row
    map_row = next(r for r in rows if "map_batches" in r["operator"])
    assert map_row["tasks"] > 0 and map_row["task_s"] > 0 and map_row["in_flight_peak"] >= 1
    return [(r["operator"], r["blocks_out"], r["rows"], r["tasks"]) for r in rows]


@scenario
def limit_short_circuits_upstream_reads(pkg, rd, monkeypatch):
    ds = rd.range(1600, parallelism=16).limit(5)
    rows = ds.take_all()
    assert [r["id"] for r in rows] == [0, 1, 2, 3, 4]
    assert ds._last_executor.stats_rows()[0]["tasks"] < 16
    return rows


@scenario
def memory_budget_math(pkg, rd, monkeypatch):
    interfaces = importlib.import_module(pkg.__name__ + ".data.execution.interfaces")
    resource_manager = importlib.import_module(pkg.__name__ + ".data.execution.resource_manager")

    class FakeOp(interfaces.PhysicalOperator):
        def __init__(self, name, active=0, est=1 << 20):
            super().__init__(name)
            self.concurrency_cap = 4
            self._active = active
            self._est = est

        def num_active_tasks(self):
            return self._active

        def estimated_output_bytes_per_block(self):
            return self._est

        def internal_bytes(self):
            return self._active * self._est

    a, b = FakeOp("a"), FakeOp("b")
    rm = resource_manager.ResourceManager([a, b], memory_budget_bytes=8 << 20, cpu_total=64)
    decisions = [rm.can_submit(a)]
    a._active = 20  # 20 MiB in flight against an 8 MiB budget
    decisions.append(rm.can_submit(a))
    a._active = 0  # never below one task (the liveness valve)
    decisions.append(rm.can_submit(a))
    assert decisions == [True, False, True]
    return decisions


@scenario
def downstream_capacity_policy_blocks_full_queue(pkg, rd, monkeypatch):
    backpressure = importlib.import_module(pkg.__name__ + ".data.execution.backpressure")
    interfaces = importlib.import_module(pkg.__name__ + ".data.execution.interfaces")
    up, down = interfaces.PhysicalOperator("up"), interfaces.PhysicalOperator("down")
    up.downstream = down
    policy = backpressure.DownstreamCapacityBackpressurePolicy(max_queued_blocks=2)
    decisions = [policy.can_add_input(up)]
    for _ in range(2):
        down.input_queue.append(interfaces.RefBundle(object(), size_bytes=1))
    decisions.append(policy.can_add_input(up))
    assert decisions == [True, False]
    return decisions


@scenario
def output_split_round_robin_tags(pkg, rd, monkeypatch):
    tags = [b.output_split_idx for b in
            rd.range(64, parallelism=8)._build_executor(output_split=2).execute()]
    assert len(tags) == 8 and sorted(set(tags)) == [0, 1] and tags.count(0) == tags.count(1)
    return sorted(tags)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_executor_scenario_matches_ray_tpu(monkeypatch, name):
    _shutdown_all()
    out = []
    try:
        for pkg in PACKAGES:
            pkg.init(num_cpus=8)
            try:
                out.append(SCENARIOS[name](pkg, _data(pkg), monkeypatch))
            finally:
                pkg.shutdown()
    finally:
        _shutdown_all()
    ref, port = out
    assert plain(port) == plain(ref)


def test_the_port_config_reads_the_data_knobs(monkeypatch):
    """The Data entries of the port's config, with the JAX package's
    defaults and RAY_TPU_* / RTPU_* overrides."""
    from ray_tpu.core import config as jc
    from ray_tpu_torch.core import config as tc

    names = ("device_prefetch_depth", "data_memory_fraction", "data_default_op_concurrency",
             "data_max_queued_blocks", "streaming_shuffle_enabled",
             "shuffle_default_partitions", "shuffle_admission_memory_fraction",
             "columnar_exchange_enabled")
    assert {n: getattr(tc.config, n) for n in names} == {n: getattr(jc.config, n) for n in names}
    monkeypatch.setenv("RAY_TPU_DEVICE_PREFETCH_DEPTH", "5")
    monkeypatch.setenv("RTPU_STREAMING_SHUFFLE", "0")
    monkeypatch.setenv("RTPU_COLUMNAR_EXCHANGE", "off")
    assert tc.config.device_prefetch_depth == jc.config.device_prefetch_depth == 5
    assert tc.streaming_shuffle_enabled() is jc.streaming_shuffle_enabled() is False
    assert tc.columnar_exchange_enabled() is jc.columnar_exchange_enabled() is False
