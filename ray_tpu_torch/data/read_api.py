"""Data sources (reference: python/ray/data/read_api.py — 19 read_* entry
points; the core family implemented here, each producing read tasks that
execute in parallel on the cluster)."""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, List, Optional

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data.block import block_from_batch, block_from_rows
from ray_tpu_torch.data.dataset import Dataset


def _parallel_read(make_tasks: List[Callable[[], Any]], name: str) -> Dataset:
    """Each thunk becomes a remote read task producing one block. The
    streaming executor's InputData operator owns submission pacing
    (concurrency cap + memory budget), so reads never race ahead of the
    consumer."""
    from ray_tpu_torch.data.execution.interfaces import ReadTaskSource

    return Dataset(ReadTaskSource(make_tasks, name))


def range(n: int, *, parallelism: int = 8) -> Dataset:  # noqa: A001
    import builtins

    parallelism = max(1, min(parallelism, n or 1))
    per = (n + parallelism - 1) // parallelism

    def make(lo: int, hi: int):
        return lambda: block_from_batch({"id": np.arange(lo, hi, dtype=np.int64)})

    tasks = [make(i * per, min((i + 1) * per, n))
             for i in builtins.range(parallelism) if i * per < n]
    return _parallel_read(tasks, "range")


def range_tensor(n: int, *, shape: tuple = (1,), parallelism: int = 8) -> Dataset:
    import builtins

    parallelism = max(1, min(parallelism, n or 1))
    per = (n + parallelism - 1) // parallelism

    def make(lo: int, hi: int):
        def thunk():
            count = hi - lo
            data = np.broadcast_to(
                np.arange(lo, hi, dtype=np.int64).reshape((count,) + (1,) * len(shape)),
                (count,) + shape,
            ).copy()
            return block_from_batch({"data": data})

        return thunk

    tasks = [make(i * per, min((i + 1) * per, n))
             for i in builtins.range(parallelism) if i * per < n]
    return _parallel_read(tasks, "range_tensor")


def from_items(items: List[Any], *, parallelism: int = 4) -> Dataset:
    import builtins

    parallelism = max(1, min(parallelism, len(items) or 1))
    per = (len(items) + parallelism - 1) // parallelism
    chunks = [items[i * per : (i + 1) * per] for i in builtins.range(parallelism)]
    chunks = [c for c in chunks if c]

    def make(chunk):
        return lambda: block_from_rows(chunk)

    return _parallel_read([make(c) for c in chunks], "items")


def from_numpy(arrays: Dict[str, np.ndarray]) -> Dataset:
    def thunk():
        return block_from_batch(arrays)

    return _parallel_read([thunk], "numpy")


def from_pandas(df) -> Dataset:
    import pyarrow as pa

    def thunk():
        return pa.Table.from_pandas(df, preserve_index=False)

    return _parallel_read([thunk], "pandas")


def from_arrow(table) -> Dataset:
    return _parallel_read([lambda: table], "arrow")


def _expand_paths(paths, suffixes: tuple) -> List[str]:
    if isinstance(paths, str):
        paths = [paths]
    files: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, _dirs, names in os.walk(p):
                files += [os.path.join(root, f) for f in sorted(names)
                          if f.endswith(suffixes)]
        else:
            files.append(p)
    if not files:
        raise FileNotFoundError(f"no files found under {paths}")
    return files


def read_parquet(paths, **kwargs) -> Dataset:
    files = _expand_paths(paths, (".parquet",))

    def make(f):
        def thunk():
            import pyarrow.parquet as pq

            return pq.read_table(f)

        return thunk

    return _parallel_read([make(f) for f in files], "parquet")


def read_csv(paths, **kwargs) -> Dataset:
    files = _expand_paths(paths, (".csv",))

    def make(f):
        def thunk():
            import pyarrow.csv as pacsv

            return pacsv.read_csv(f)

        return thunk

    return _parallel_read([make(f) for f in files], "csv")


def read_json(paths, **kwargs) -> Dataset:
    files = _expand_paths(paths, (".json", ".jsonl"))

    def make(f):
        def thunk():
            import pyarrow.json as pajson

            return pajson.read_json(f)

        return thunk

    return _parallel_read([make(f) for f in files], "json")


def read_text(paths, **kwargs) -> Dataset:
    files = _expand_paths(paths, (".txt",))

    def make(f):
        def thunk():
            with open(f) as fh:
                return block_from_batch({"text": np.asarray(fh.read().splitlines(), dtype=object)})

        return thunk

    return _parallel_read([make(f) for f in files], "text")


def read_numpy(paths, **kwargs) -> Dataset:
    files = _expand_paths(paths, (".npy", ".npz"))

    def make(f):
        def thunk():
            arr = np.load(f, allow_pickle=False)
            if hasattr(arr, "files"):  # npz
                return block_from_batch({k: arr[k] for k in arr.files})
            return block_from_batch({"data": arr})

        return thunk

    return _parallel_read([make(f) for f in files], "numpy")


def read_binary_files(paths, **kwargs) -> Dataset:
    files = _expand_paths(paths, ())

    def make(f):
        def thunk():
            with open(f, "rb") as fh:
                data = fh.read()
            return block_from_rows([{"path": f, "bytes": data}])

        return thunk

    return _parallel_read([make(f) for f in files], "binary")


IMAGE_SUFFIXES = (".png", ".jpg", ".jpeg", ".bmp", ".gif", ".webp", ".tif", ".tiff")


def read_images(paths, *, size: Optional[tuple] = None, mode: str = "RGB",
                include_paths: bool = False, files_per_block: int = 64,
                **kwargs) -> Dataset:
    """Decode image files into an "image" tensor column (reference:
    read_images / _internal/datasource/image_datasource.py). ``size=(h, w)``
    resizes (bilinear) so blocks stack into one [N, h, w, C] tensor — the
    shape contract the BASELINE image-pipeline → device config needs; without
    ``size`` images keep native shapes (object column)."""
    files = _expand_paths(paths, IMAGE_SUFFIXES)
    groups = _chunks(files, files_per_block)

    def make(group):
        def thunk():
            from PIL import Image

            arrays, names = [], []
            for f in group:
                img = Image.open(f)
                if mode:
                    img = img.convert(mode)
                if size is not None:
                    img = img.resize((size[1], size[0]), Image.BILINEAR)
                arrays.append(np.asarray(img))
                names.append(f)
            if size is not None:
                batch = {"image": np.stack(arrays)}
                if include_paths:
                    batch["path"] = np.asarray(names, dtype=object)
                return block_from_batch(batch)
            rows = [{"image": a} for a in arrays]
            if include_paths:
                for r, f in zip(rows, names):
                    r["path"] = f
            # native shapes: ALWAYS the pyobj layout — a coincidentally
            # shape-uniform block would otherwise become a tensor column
            # with a schema incompatible with its sibling blocks
            return block_from_rows(rows, object_columns={"image"})

        return thunk

    return _parallel_read([make(g) for g in groups], "images")


def _chunks(seq: List[Any], n: int) -> List[List[Any]]:
    import builtins

    return [seq[i : i + n] for i in builtins.range(0, len(seq), n)]


def read_tfrecords(paths, *, verify_crc: bool = False, **kwargs) -> Dataset:
    """TFRecord files of tf.train.Example records (reference: read_tfrecords
    / tfrecords_datasource.py), decoded by the native wire codec in
    ray_tpu_torch/data/tfrecord.py — no TensorFlow dependency. Scalar features
    unwrap to scalars; multi-value features stay lists."""
    files = _expand_paths(paths, (".tfrecord", ".tfrecords"))

    def make(f):
        def thunk():
            from ray_tpu_torch.data.tfrecord import decode_example, read_records

            rows = []
            for payload in read_records(f, verify_crc=verify_crc):
                row = {}
                for name, values in decode_example(payload).items():
                    row[name] = values[0] if len(values) == 1 else values
                rows.append(row)
            return block_from_rows(rows)

        return thunk

    return _parallel_read([make(f) for f in files], "tfrecords")


def read_webdataset(paths, *, decode: bool = True, **kwargs) -> Dataset:
    """WebDataset tar archives (reference: read_webdataset /
    webdataset_datasource.py): members sharing a basename form one sample;
    extensions become columns. With ``decode=True``, jpg/png decode to
    arrays, ``.cls`` to int, ``.json`` to dicts, ``.txt`` to str, ``.npy``
    to arrays; unknown extensions stay raw bytes."""
    files = _expand_paths(paths, (".tar",))

    def decode_member(ext: str, data: bytes) -> Any:
        if not decode:
            return data
        if ext in ("jpg", "jpeg", "png", "bmp", "webp"):
            import io

            from PIL import Image

            return np.asarray(Image.open(io.BytesIO(data)))
        if ext == "cls":
            return int(data)
        if ext == "json":
            import json

            return json.loads(data)
        if ext == "txt":
            return data.decode()
        if ext == "npy":
            import io

            return np.load(io.BytesIO(data), allow_pickle=False)
        return data

    def make(f):
        def thunk():
            import tarfile

            samples: Dict[str, Dict[str, Any]] = {}
            order: List[str] = []
            with tarfile.open(f) as tar:
                for member in tar:
                    if not member.isfile():
                        continue
                    # WebDataset convention: key = full member path up to the
                    # FIRST dot of the basename (directories stay part of the
                    # key, so train/0001.* and val/0001.* are distinct samples)
                    dirname, base = os.path.split(member.name.lstrip("./"))
                    stem, _dot, ext = base.partition(".")
                    key = os.path.join(dirname, stem) if dirname else stem
                    if key not in samples:
                        samples[key] = {"__key__": key}
                        order.append(key)
                    data = tar.extractfile(member).read()
                    samples[key][ext.lower()] = decode_member(ext.lower(), data)
            rows = [samples[k] for k in order]
            # decoded images vary in shape globally: force pyobj layout for
            # any column holding ndarrays (same schema-stability argument as
            # read_images without size)
            nd_cols = {k for r in rows for k, v in r.items()
                       if isinstance(v, np.ndarray)}
            return block_from_rows(rows, object_columns=nd_cols or None)

        return thunk

    return _parallel_read([make(f) for f in files], "webdataset")
