"""The port's Data (``ray_tpu_torch.data``) held against the JAX package's
(``ray_tpu.data``), scenario by scenario, on each package's in-process
runtime.

Each scenario is written once, as a function of the package module and its
``data`` module, runs on ray_tpu's fresh ``LocalRuntime`` and then on
ray_tpu_torch's, keeps the assertions of its counterpart in
``tests/test_data.py``, and must return equal results in both: the same
rows in the same order (sorted where the reference's own test sorts, as for
concurrent actor pools), the same counts, aggregates and batch sizes. The
inputs are the reference test's, or seeded numpy. ``iter_torch_batches``
(``device="cpu"``) is held against ``iter_jax_batches`` on values and
dtypes, and ``GpuTrainer(datasets=...)`` against ``TpuTrainer``."""

import io
import json
import random
import tarfile

import jax
import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch

PACKAGES = (ray_tpu, ray_tpu_torch)
SCENARIOS = {}


def scenario(fn):
    SCENARIOS[fn.__name__] = fn
    return fn


def _shutdown_all():
    for pkg in PACKAGES:
        if pkg.is_initialized():
            pkg.shutdown()


def _data(pkg):
    import importlib

    return importlib.import_module(pkg.__name__ + ".data")


def plain(x):
    """Rows, batches and values as comparable Python: numpy arrays and
    scalars to lists and numbers, recursively."""
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return [str(x.dtype), x.tolist()]
    if isinstance(x, np.generic):
        return x.item()
    return x


@pytest.fixture
def on_both(tmp_path):
    """``run(fn)`` runs ``fn(pkg, rd, tmp_dir)`` on ray_tpu's runtime, then
    on ray_tpu_torch's (each with its own fresh directory), and returns both
    results."""
    _shutdown_all()

    def run(fn):
        out = []
        for pkg in PACKAGES:
            d = tmp_path / pkg.__name__
            d.mkdir()
            pkg.init(num_cpus=8)
            try:
                out.append(fn(pkg, _data(pkg), d))
            finally:
                pkg.shutdown()
        return out

    yield run
    _shutdown_all()


@scenario
def range_count_take(pkg, rd, tmp):
    ds = rd.range(100)
    assert ds.count() == 100
    rows = ds.take(5)
    assert [r["id"] for r in rows] == [0, 1, 2, 3, 4]
    return rows


@scenario
def from_items_and_map(pkg, rd, tmp):
    ds = rd.from_items([{"x": i} for i in range(10)]).map(lambda r: {"y": r["x"] * 2})
    out = [r["y"] for r in ds.take_all()]
    assert out == [i * 2 for i in range(10)]
    return out


@scenario
def map_batches_numpy(pkg, rd, tmp):
    ds = rd.range(64).map_batches(lambda b: {"id": b["id"] + 1})
    rows = ds.take_all()
    assert sum(r["id"] for r in rows) == sum(range(1, 65))
    return rows


@scenario
def map_batches_stateful_class(pkg, rd, tmp):
    class AddBias:
        def __init__(self, bias):
            self.bias = bias

        def __call__(self, batch):
            return {"id": batch["id"] + self.bias}

    ds = rd.range(32).map_batches(AddBias, fn_constructor_args=(100,), concurrency=2)
    values = sorted(r["id"] for r in ds.take_all())
    assert values == [i + 100 for i in range(32)]
    return values


@scenario
def filter_and_flat_map(pkg, rd, tmp):
    ds = rd.range(20).filter(lambda r: r["id"] % 2 == 0)
    ds2 = rd.from_items([{"x": 1}, {"x": 2}]).flat_map(lambda r: [r, r])
    out = (ds.count(), ds.take_all(), ds2.count(), ds2.take_all())
    assert out[0] == 10 and out[2] == 4
    return out


@scenario
def iter_batches_sizes_and_drop_last(pkg, rd, tmp):
    sizes = [len(b["id"]) for b in rd.range(100).iter_batches(batch_size=32)]
    assert sizes == [32, 32, 32, 4]
    dropped = [len(b["id"]) for b in rd.range(100).iter_batches(batch_size=32, drop_last=True)]
    assert dropped == [32, 32, 32]
    return sizes, dropped, list(rd.range(10).iter_batches(batch_size=4))


@scenario
def repartition_and_shuffle(pkg, rd, tmp):
    refs = list(rd.range(50).repartition(5).iter_internal_refs())
    assert len(refs) == 5
    ids = [r["id"] for r in rd.range(50).random_shuffle(seed=0).take_all()]
    assert sorted(ids) == list(range(50)) and ids != list(range(50))
    return [pkg.get(r).num_rows for r in refs], ids


@scenario
def repartition_empty_partitions_keep_schema(pkg, rd, tmp):
    refs = list(rd.range(2).repartition(5).iter_internal_refs())
    assert len(refs) == 5
    out = [r["id"] for r in rd.range(2).repartition(5).sort("id").take_all()]
    assert out == [0, 1]
    return [pkg.get(r).schema.names for r in refs], out


@scenario
def streaming_split(pkg, rd, tmp):
    its = rd.range(64).repartition(8).streaming_split(2)
    rows = [sorted(int(v) for b in it.iter_batches(batch_size=16) for v in b["id"])
            for it in its]
    assert sum(map(len, rows)) == 64 and all(rows)
    return sorted(v for r in rows for v in r), len(rows)


@scenario
def limit_and_union(pkg, rd, tmp):
    out = (rd.range(10).union(rd.range(10)).take_all(), rd.range(100).limit(7).take_all())
    assert len(out[0]) == 20 and len(out[1]) == 7
    return out


@scenario
def parquet_roundtrip(pkg, rd, tmp):
    path = str(tmp / "pq")
    rd.range(30).write_parquet(path)
    ds = rd.read_parquet(path)
    out = sorted(r["id"] for r in ds.take_all())
    assert ds.count() == 30 and out == list(range(30))
    return out


@scenario
def csv_json_roundtrip(pkg, rd, tmp):
    rd.range(10).write_csv(str(tmp / "csv"))
    rd.range(10).write_json(str(tmp / "json"))
    out = (rd.read_csv(str(tmp / "csv")).take_all(), rd.read_json(str(tmp / "json")).take_all())
    assert len(out[0]) == 10 and len(out[1]) == 10
    return out


@scenario
def tensor_columns(pkg, rd, tmp):
    arr = np.random.default_rng(0).standard_normal((10, 6)).astype(np.float32)
    batch = next(iter(rd.from_numpy({"feat": arr, "label": np.arange(10)})
                      .iter_batches(batch_size=10)))
    np.testing.assert_array_equal(batch["feat"], arr)
    return batch


@scenario
def pipeline_into_trainer(pkg, rd, tmp):
    """Data -> Train: per-worker shards via datasets= and get_dataset_shard,
    rows counted as tests/test_data.py::test_pipeline_into_trainer counts."""
    import importlib

    config = importlib.import_module(pkg.__name__ + ".train.config")
    trainer_mod = importlib.import_module(pkg.__name__ + ".train.trainer")
    trainer_cls = getattr(trainer_mod, "GpuTrainer" if pkg is ray_tpu_torch else "TpuTrainer")
    session = pkg.__name__ + ".train.session"

    def train_fn(cfg):
        s = importlib.import_module(session)
        it = s.get_dataset_shard("train")
        s.report({"rows": sum(len(b["id"]) for b in it.iter_batches(batch_size=8))})

    result = trainer_cls(
        train_fn,
        scaling_config=config.ScalingConfig(num_workers=2, cpus_per_worker=1),
        run_config=config.RunConfig(name="data_train", storage_path=str(tmp)),
        datasets={"train": rd.range(64).repartition(8)},
    ).fit()
    assert result.error is None and result.metrics["rows"] > 0
    return result.error is None


@scenario
def shuffle_deterministic_and_complete(pkg, rd, tmp):
    a = [r["id"] for r in rd.range(500, parallelism=5).random_shuffle(seed=7).take_all()]
    b = [r["id"] for r in rd.range(500, parallelism=5).random_shuffle(seed=7).take_all()]
    assert sorted(a) == list(range(500)) and a != list(range(500)) and a == b
    return a


@scenario
def stats_reports_stages(pkg, rd, tmp):
    ds = rd.range(200, parallelism=4).map(lambda r: {"id": r["id"] + 1}).random_shuffle(seed=0)
    assert ds.count() == 200
    report = ds.stats()
    assert "map" in report and "random_shuffle" in report and "wall_s" in report
    return [(r["operator"], r["blocks_out"], r["rows"]) for r in ds.stats_rows()]


@scenario
def sort_ascending_descending(pkg, rd, tmp):
    vals = list(range(200))
    random.Random(7).shuffle(vals)
    ds = rd.from_items([{"v": v} for v in vals]).repartition(8)
    out = ([r["v"] for r in ds.sort("v").take_all()],
           [r["v"] for r in ds.sort("v", descending=True).take_all()])
    assert out == (sorted(vals), sorted(vals, reverse=True))
    return out


@scenario
def sort_string_keys(pkg, rd, tmp):
    names = [f"row-{i:03d}" for i in range(50)]
    shuffled = names[:]
    random.Random(3).shuffle(shuffled)
    out = [r["name"] for r in rd.from_items([{"name": n} for n in shuffled]).repartition(4)
           .sort("name").take_all()]
    assert out == names
    return out


@scenario
def groupby_aggregates(pkg, rd, tmp):
    ds = rd.from_items([{"k": i % 3, "v": float(i)} for i in range(30)]).repartition(5)
    g = ds.groupby("k")
    out = [sorted(map(plain, t.take_all()), key=lambda r: r["k"])
           for t in (g.count(), g.sum("v"), g.mean("v"))]
    ds2 = rd.from_items([{"k": "a" if i < 10 else "b", "v": float(i)}
                         for i in range(20)]).repartition(3)
    g2 = ds2.groupby("k")
    out += [sorted(map(plain, t.take_all()), key=lambda r: r["k"])
            for t in (g2.min("v"), g2.max("v"), g2.std("v"))]
    assert {r["k"]: r["count()"] for r in out[0]} == {0: 10, 1: 10, 2: 10}
    assert {r["k"]: r["min(v)"] for r in out[3]} == {"a": 0.0, "b": 10.0}
    stds = {r["k"]: r["std(v)"] for r in out[5]}
    assert stds["a"] == pytest.approx(np.std(np.arange(10.0), ddof=1))
    return out


@scenario
def global_aggregates(pkg, rd, tmp):
    ds = rd.from_items([{"v": float(i)} for i in range(100)]).repartition(7)
    out = (ds.sum("v"), ds.min("v"), ds.max("v"), ds.mean("v"), ds.std("v"))
    assert out[0] == pytest.approx(4950.0) and out[1:3] == (0.0, 99.0)
    assert out[4] == pytest.approx(np.std(np.arange(100.0), ddof=1))
    return out


@scenario
def unique_and_map_groups(pkg, rd, tmp):
    ds = rd.from_items([{"k": i % 4, "v": i} for i in range(40)]).repartition(4)
    assert ds.unique("k") == [0, 1, 2, 3]

    def normalize(batch):
        v = batch["v"].astype(np.float64)
        return {"k": batch["k"], "v": v - v.mean()}

    out = ds.groupby("k").map_groups(normalize).take_all()
    assert len(out) == 40
    return ds.unique("k"), sorted((r["k"], r["v"]) for r in out)


@scenario
def zip_aligned_and_misaligned_blocks(pkg, rd, tmp):
    left = rd.from_items([{"a": i} for i in range(30)]).repartition(3)
    right = rd.from_items([{"b": i * 2} for i in range(30)]).repartition(5)
    out = left.zip(right).take_all()
    both = left.zip(rd.from_items([{"a": -i} for i in range(30)]).repartition(2)).take_all()
    assert len(out) == 30 and all(r["b"] == r["a"] * 2 for r in out)
    assert all(r["a_1"] == -r["a"] for r in both)
    with pytest.raises(ValueError):
        rd.from_items([{"a": i} for i in range(5)]).zip(
            rd.from_items([{"b": i} for i in range(6)])).take_all()
    return out, both


@scenario
def read_images(pkg, rd, tmp):
    from PIL import Image

    for i in range(6):
        Image.fromarray(np.full((10 + i, 8, 3), i * 20, dtype=np.uint8)).save(tmp / f"img{i}.png")
    rows = rd.read_images(str(tmp), include_paths=True).take_all()
    shapes = sorted(r["image"].shape[0] for r in rows)
    assert shapes == [10, 11, 12, 13, 14, 15]
    batch = next(iter(rd.read_images(str(tmp), size=(16, 16)).iter_batches(batch_size=6)))
    assert batch["image"].shape == (6, 16, 16, 3) and batch["image"].dtype == np.uint8
    return shapes, plain(batch["image"])


@scenario
def read_images_uniform_blocks_differing_globally(pkg, rd, tmp):
    from PIL import Image

    for i in range(4):
        Image.fromarray(np.zeros((10, 8, 3), np.uint8)).save(tmp / f"a{i}.png")
        Image.fromarray(np.zeros((12, 8, 3), np.uint8)).save(tmp / f"b{i}.png")
    batch = next(iter(rd.read_images(str(tmp), files_per_block=4).iter_batches(batch_size=8)))
    shapes = sorted(a.shape[0] for a in batch["image"])
    assert shapes == [10, 10, 10, 10, 12, 12, 12, 12]
    return shapes


@scenario
def read_tfrecords(pkg, rd, tmp):
    import importlib

    write_tfrecords = importlib.import_module(pkg.__name__ + ".data.tfrecord").write_tfrecords
    f1, f2 = str(tmp / "a.tfrecord"), str(tmp / "b.tfrecord")
    write_tfrecords(f1, [{"label": i, "name": f"x{i}".encode(),
                          "emb": [float(i), float(i) * 0.5]} for i in range(4)])
    write_tfrecords(f2, [{"label": 9, "name": b"y", "emb": [9.0, 4.5]}])
    rows = sorted(map(plain, rd.read_tfrecords([f1, f2]).take_all()), key=lambda r: r["label"])
    assert len(rows) == 5 and rows[2]["name"] == b"x2"
    f3 = str(tmp / "c.tfrecord")
    write_tfrecords(f3, [{"label": 1}])
    data = bytearray(open(f3, "rb").read())
    data[-5] ^= 0xFF  # flip a payload byte
    open(f3, "wb").write(bytes(data))
    with pytest.raises(Exception):
        rd.read_tfrecords(f3, verify_crc=True).take_all()
    return rows


@scenario
def read_webdataset(pkg, rd, tmp):
    from PIL import Image

    def add(tar, name, payload):
        info = tarfile.TarInfo(name)
        info.size = len(payload)
        tar.addfile(info, io.BytesIO(payload))

    tar_path = str(tmp / "shard0.tar")
    with tarfile.open(tar_path, "w") as tar:
        for i in range(3):
            buf = io.BytesIO()
            Image.fromarray(np.full((4, 4, 3), i, dtype=np.uint8)).save(buf, format="PNG")
            add(tar, f"sample{i}.png", buf.getvalue())
            add(tar, f"sample{i}.cls", str(i * 10).encode())
            add(tar, f"sample{i}.json", json.dumps({"idx": i}).encode())
    rows = sorted(rd.read_webdataset(tar_path).take_all(), key=lambda r: r["cls"])
    assert [r["cls"] for r in rows] == [0, 10, 20] and rows[1]["png"].shape == (4, 4, 3)
    keys_path = str(tmp / "s.tar")
    with tarfile.open(keys_path, "w") as tar:
        for split in ("train", "val"):
            add(tar, f"{split}/0001.txt", split.encode())
    keys = {r["__key__"] for r in rd.read_webdataset(keys_path).take_all()}
    assert keys == {"train/0001", "val/0001"}
    return plain(rows), sorted(keys)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_ray_tpu(on_both, name):
    ref, port = on_both(SCENARIOS[name])
    assert plain(port) == plain(ref)


# --------------------------------------------------------------------------- #
# iter_torch_batches against iter_jax_batches
# --------------------------------------------------------------------------- #
def _feature_ds(rd):
    rng = np.random.default_rng(5)
    return rd.from_numpy({"x": rng.standard_normal((50, 3, 4)).astype(np.float32),
                          "img": rng.integers(0, 256, (50, 8, 8, 3), dtype=np.uint8),
                          "label": np.arange(50, dtype=np.int64)})


@pytest.mark.parametrize("batch_size,drop_last,dtype", [(16, True, None), (16, False, None),
                                                        (7, True, np.float32)])
@pytest.mark.parametrize("split", [False, True])
def test_iter_torch_batches_matches_iter_jax_batches(on_both, batch_size, drop_last, dtype,
                                                     split):
    """Values, dtypes and batch shapes of ``iter_torch_batches(device="cpu")``
    equal ``iter_jax_batches``'s (dtypes up to JAX's int64 -> int32), on a
    Dataset and on a streaming_split shard; every batch is a CPU torch
    tensor."""
    def run(pkg, rd, tmp):
        ds = _feature_ds(rd)
        src = ds.streaming_split(1)[0] if split else ds
        kw = dict(batch_size=batch_size, drop_last=drop_last, dtype=dtype)
        if pkg is ray_tpu:
            return [{k: np.asarray(jax.device_get(v)) for k, v in b.items()}
                    for b in src.iter_jax_batches(**kw)]
        out = list(src.iter_torch_batches(device="cpu", **kw))
        assert all(isinstance(v, torch.Tensor) and v.device.type == "cpu"
                   for b in out for v in b.values())
        return [{k: v.numpy() for k, v in b.items()} for b in out]

    ref, port = on_both(run)
    assert len(port) == len(ref) > 0
    for got, want in zip(port, ref):
        assert got.keys() == want.keys()
        for k in want:
            # JAX without x64 narrows int64 to int32 on device_put; torch
            # keeps the host dtype
            assert jax.dtypes.canonicalize_dtype(got[k].dtype) == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k])


def test_iter_torch_batches_needs_a_card_without_a_device():
    """``device=None`` means the card: with none, the first batch raises
    instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None is the card")
    _shutdown_all()
    ray_tpu_torch.init(num_cpus=2)
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            next(iter(_data(ray_tpu_torch).range(8).iter_torch_batches(batch_size=4)))
    finally:
        ray_tpu_torch.shutdown()


# --------------------------------------------------------------------------- #
# ray_tpu_torch.bench_data_train, the counterpart of tools/bench_data_train.py
# --------------------------------------------------------------------------- #
REFERENCE_KEYS = {"metric", "value", "unit", "vs_baseline", "input_starved_fraction", "steps",
                  "batch", "model_params", "image_size", "on_tpu", "per_op_stats",
                  "peak_in_flight_blocks"}


def test_bench_data_train_rehearses_on_the_cpu():
    """The bench's pipeline and loop at ViTConfig.tiny() on the CPU: the
    reference bench's JSON keys (and the device), every timed step fed by
    iter_torch_batches across epochs, and the kept batches replaying the
    same losses bit for bit when fed to the step directly."""
    from ray_tpu_torch.bench_data_train import data_train
    from ray_tpu_torch.models.vit import ViTConfig, make_vit_train_step
    from ray_tpu_torch.train.step import adamw

    _shutdown_all()
    cfg = ViTConfig.tiny()
    result, extras = data_train(images=40, steps=6, batch=8, config=cfg, device="cpu", keep=2)
    assert set(result) == REFERENCE_KEYS | {"device"} and result["device"] == "cpu"
    assert result["steps"] == 6 and result["value"] > 0 and result["image_size"] == 32
    assert 0.0 <= result["input_starved_fraction"] <= 1.0
    assert [r["operator"] for r in result["per_op_stats"]][:2] == [
        "input::read_images[1]", "map_batches(normalize)"]
    warm, *timed = extras["batches"]
    assert len(timed) == 2 and warm["image"].shape == (8, 32, 32, 3)
    step, init = make_vit_train_step(cfg, adamw(1e-3))
    params, opt_state = init(seed=0, device="cpu")
    params, opt_state, _ = step(params, opt_state, warm["image"], warm["label"])
    for b, want in zip(timed, extras["losses"]):
        params, opt_state, loss = step(params, opt_state, b["image"], b["label"])
        assert torch.equal(loss, want)


def test_bench_data_train_skips_without_a_card(capsys, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the bench runs")
    from ray_tpu_torch import bench_data_train

    monkeypatch.setattr("sys.argv", ["bench_data_train"])
    assert bench_data_train.main() == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out == {"metric": "data_to_train_images_per_sec", "skipped": True,
                   "reason": "no CUDA device"}
