"""The port's streaming shuffle (``ray_tpu_torch.data.shuffle``) held against
the JAX package's, in local mode, scenario by scenario.

Each scenario keeps the assertions of its counterpart in
``tests/test_data_shuffle.py``, runs on ray_tpu's fresh in-process runtime
and then on ray_tpu_torch's, and returns what both must agree on: streaming
equals barrier for all four exchanges (sort, seeded shuffle, repartition,
groupby), seeded determinism under out-of-order maps, empty partitions,
admission under a tiny budget, columnar A/B, sort skew under duplicate keys
and pyobj payloads. The cluster cases (spill, lineage recovery, the IPC
serializer, the multi-GB smoke) need the cluster runtime, which the port
does not have yet."""

import importlib
import time

import numpy as np
import pyarrow as pa
import pytest

import ray_tpu
import ray_tpu_torch
from test_torch_data import PACKAGES, _data, _shutdown_all, plain

SCENARIOS = {}


def scenario(fn):
    SCENARIOS[fn.__name__] = fn
    return fn


def _ids(rows):
    return [r["id"] for r in rows]


def _exchange_results(rd):
    sort = _ids(rd.range(300, parallelism=6).sort("id", descending=True).take_all())
    shuf = _ids(rd.range(300, parallelism=6).random_shuffle(seed=11).take_all())
    rep = _ids(rd.range(101, parallelism=4).repartition(7).take_all())
    grp = sorted((r["id"], r["count()"]) for r in
                 rd.from_items([{"id": i % 5} for i in range(60)]).groupby("id").count().take_all())
    return sort, shuf, rep, grp


@scenario
def streaming_matches_barrier_for_every_exchange(pkg, rd, monkeypatch):
    monkeypatch.setenv("RTPU_STREAMING_SHUFFLE", "1")
    streaming = _exchange_results(rd)
    monkeypatch.setenv("RTPU_STREAMING_SHUFFLE", "0")
    barrier = _exchange_results(rd)
    assert streaming == barrier
    assert streaming[0] == sorted(range(300), reverse=True) and streaming[2] == list(range(101))
    return streaming


@scenario
def seeded_shuffle_deterministic_under_out_of_order_maps(pkg, rd, monkeypatch):
    def jitter(b):
        time.sleep(0.001 * int(b["id"][0]) % 3)
        return b

    def run():
        return _ids(rd.range(400, parallelism=8).map_batches(jitter)
                    .random_shuffle(seed=13).take_all())

    a, b = run(), run()
    assert a == b and sorted(a) == list(range(400)) and a != list(range(400))
    return a


@scenario
def empty_partitions_preserve_schema(pkg, rd, monkeypatch):
    out = rd.from_items([{"a": 1, "b": "x"}, {"a": 2, "b": "y"}]).repartition(8).take_all()
    assert out == [{"a": 1, "b": "x"}, {"a": 2, "b": "y"}]
    schema = rd.from_items([{"a": 1, "b": "x"}]).repartition(4).schema()
    assert schema is not None and set(schema.names) == {"a", "b"}
    sorted_v = [r["v"] for r in rd.from_items([{"v": 3}, {"v": 1}]).sort("v").take_all()]
    assert sorted_v == [1, 3]
    assert rd.range(1, parallelism=1).random_shuffle(seed=0).count() == 1
    return out, sorted(schema.names), sorted_v


@scenario
def shuffle_stats_surface_in_dataset_stats(pkg, rd, monkeypatch):
    ds = rd.range(200, parallelism=4).random_shuffle(seed=5)
    assert ds.count() == 200
    report = ds.stats()
    for word in ("shuffle_map(random_shuffle)", "shuffle_reduce(random_shuffle)",
                 "exchange_bytes"):
        assert word in report
    extra = next(r for r in ds.stats_rows() if "shuffle_reduce" in r["operator"])["extra"]
    assert extra["maps"] == 4 and extra["reduces"] == 4 and extra["exchange_bytes"] > 0
    return extra["maps"], extra["reduces"], extra["exchange_bytes"]


@scenario
def reduce_admission_defers_under_tiny_budget(pkg, rd, monkeypatch):
    monkeypatch.setenv("RAY_TPU_SHUFFLE_ADMISSION_MEMORY_FRACTION", "1e-9")
    ds = rd.range(2000, parallelism=8).random_shuffle(seed=3)
    assert ds.count() == 2000
    extra = next(r for r in ds.stats_rows() if "shuffle_reduce" in r["operator"])["extra"]
    assert extra["admission_deferrals"] > 0 and extra["admission_stall_s"] > 0.0
    return _ids(ds.take_all())


@scenario
def exchange_ops_participate_in_memory_budget(pkg, rd, monkeypatch):
    operators = importlib.import_module(pkg.__name__ + ".data.execution.operators")
    planner = importlib.import_module(pkg.__name__ + ".data.execution.planner")
    resource_manager = importlib.import_module(pkg.__name__ + ".data.execution.resource_manager")
    shuffle_ops = importlib.import_module(pkg.__name__ + ".data.shuffle.operators")
    ds = rd.range(64, parallelism=4).random_shuffle(seed=1)
    ops = planner.build_physical_plan(ds._source_fn, ds._stages)
    assert any(isinstance(op, shuffle_ops.ShuffleMapOp) for op in ops)
    reduce_op = next(op for op in ops if isinstance(op, shuffle_ops.ShuffleReduceOp))
    rm = resource_manager.ResourceManager(ops, memory_budget_bytes=1 << 20, cpu_total=8)
    barrier = operators.AllToAllOp("x", lambda refs: iter(()))
    rm2 = resource_manager.ResourceManager([barrier], memory_budget_bytes=1 << 20, cpu_total=8)
    out = (id(reduce_op) in rm._reserved, barrier.in_memory_budget(), id(barrier) in rm2._reserved)
    assert out == (True, True, True)
    return out, [type(op).__name__ for op in ops]


@scenario
def streaming_shuffle_env_fallback_compiles_barrier(pkg, rd, monkeypatch):
    operators = importlib.import_module(pkg.__name__ + ".data.execution.operators")
    planner = importlib.import_module(pkg.__name__ + ".data.execution.planner")
    ds = rd.range(64, parallelism=4).sort("id")
    plans = []
    for flag in ("0", "1"):
        monkeypatch.setenv("RTPU_STREAMING_SHUFFLE", flag)
        ops = planner.build_physical_plan(ds._source_fn, ds._stages)
        plans.append([type(op).__name__ for op in ops])
        assert any(isinstance(op, operators.AllToAllOp) for op in ops) is (flag == "0")
    return plans


@scenario
def columnar_exchange_ab_identical_all_exchanges(pkg, rd, monkeypatch):
    out = {}
    for columnar in ("1", "0"):
        monkeypatch.setenv("RTPU_COLUMNAR_EXCHANGE", columnar)
        for streaming in ("1", "0"):
            monkeypatch.setenv("RTPU_STREAMING_SHUFFLE", streaming)
            out[(columnar, streaming)] = _exchange_results(rd)
    assert len(set(map(repr, out.values()))) == 1
    assert out[("1", "1")][0] == sorted(range(300), reverse=True)
    return out[("1", "1")]


@scenario
def sort_skew_bounded_under_duplicate_keys(pkg, rd, monkeypatch):
    rng = np.random.default_rng(0)
    n = 4000
    keys = np.where(rng.random(n) < 0.9, 7, rng.integers(0, 100, n))
    rows = [{"k": int(k), "i": i} for i, k in enumerate(keys)]
    out = []
    for columnar in ("1", "0"):
        monkeypatch.setenv("RTPU_COLUMNAR_EXCHANGE", columnar)
        sizes, ks = [], []
        for ref in rd.from_items(rows, parallelism=8).sort("k").iter_internal_refs():
            block = pkg.get(ref)
            sizes.append(block.num_rows)
            ks.extend(block.column("k").to_numpy().tolist())
        assert sum(sizes) == n and ks == sorted(ks) and max(sizes) < 0.5 * n, (columnar, sizes)
        out.append((sizes, ks))
    return out


@scenario
def iter_batches_through_empty_partitions(pkg, rd, monkeypatch):
    out = []
    for columnar in ("1", "0"):
        monkeypatch.setenv("RTPU_COLUMNAR_EXCHANGE", columnar)
        ds = rd.from_items([{"a": 1}, {"a": 2}, {"a": 3}]).repartition(8)
        got = sorted(int(v) for b in ds.iter_batches(batch_size=2, batch_format="numpy")
                     for v in b["a"])
        assert got == [1, 2, 3]
        out.append(got)
    return out


class Tag:
    def __init__(self, v):
        self.v = v


@scenario
def mixed_tensor_pyobj_block_through_columnar_sort(pkg, rd, monkeypatch):
    monkeypatch.setenv("RTPU_COLUMNAR_EXCHANGE", "1")
    rows = [{"k": (97 * i) % 50, "vec": np.arange(4) + i, "obj": Tag(i)} for i in range(120)]
    out = rd.from_items(rows, parallelism=5).sort("k").take_all()
    assert [r["k"] for r in out] == sorted(r["k"] for r in rows)
    for r in out:
        assert isinstance(r["obj"], Tag) and r["vec"][0] == r["obj"].v
    str_rows = [{"k": f"key-{i % 7}", "i": i} for i in range(40)]
    got = [r["k"] for r in rd.from_items(str_rows, parallelism=3).sort("k").take_all()]
    assert got == sorted(r["k"] for r in str_rows)
    return [(r["k"], plain(r["vec"]), r["obj"].v) for r in out], got


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_shuffle_scenario_matches_ray_tpu(monkeypatch, name):
    _shutdown_all()
    out = []
    try:
        for pkg in PACKAGES:
            pkg.init(num_cpus=8)
            try:
                out.append(SCENARIOS[name](pkg, _data(pkg), monkeypatch))
            finally:
                pkg.shutdown()
                for var in ("RTPU_STREAMING_SHUFFLE", "RTPU_COLUMNAR_EXCHANGE"):
                    monkeypatch.delenv(var, raising=False)
    finally:
        _shutdown_all()
    ref, port = out
    assert plain(port) == plain(ref)


def test_concat_blocks_empty_keeps_schema():
    """block.concat_blocks and the reduce side's schema-preserving concat,
    in both packages alike."""
    schema = pa.schema([("a", pa.int64()), ("b", pa.string())])
    real = pa.table({"a": [1], "b": ["x"]})
    results = []
    for pkg in PACKAGES:
        concat_blocks = importlib.import_module(pkg.__name__ + ".data.block").concat_blocks
        spec = importlib.import_module(pkg.__name__ + ".data.shuffle.spec")
        empty = concat_blocks([], schema=schema)
        assert empty.num_rows == 0 and empty.schema.equals(schema)
        assert concat_blocks([]).num_rows == 0
        assert spec._schema_preserving_concat([], schema=schema).schema.equals(schema)
        out = spec._schema_preserving_concat([pa.table({}), real])
        assert out.num_rows == 1 and out.schema.equals(schema)
        results.append(out.to_pylist())
    assert results[0] == results[1]


def test_pyobj_extension_types_stay_apart():
    """Each package registers its own Arrow extension for Python-object
    columns, so both can be imported in one process: the port's is
    ``ray_tpu_torch.pyobj``."""
    jb = importlib.import_module("ray_tpu.data.block")
    tb = importlib.import_module("ray_tpu_torch.data.block")
    assert tb._PYOBJ_TYPE.extension_name == "ray_tpu_torch.pyobj"
    assert jb._PYOBJ_TYPE.extension_name == "ray_tpu.pyobj"
    block = tb.block_from_batch({"o": [Tag(1), Tag(2)]})
    assert [r["o"].v for r in tb.BlockAccessor(block).iter_rows()] == [1, 2]
