"""Dataset: lazy, streaming-executed distributed data.

Reference capability: python/ray/data/dataset.py (+ read_api.py,
iterator.py): lazy logical plan built by transformations, compiled by
``ray_tpu_torch.data.execution.planner`` into a physical operator DAG and run by
the pull-based ``execution.StreamingExecutor`` (per-op budgets,
backpressure, per-op stats — see data/execution/DESIGN.md) on
iteration/consumption; per-worker shards via streaming_split;
device-prefetching batch iteration for GPU input pipelines
(``iter_torch_batches``: host batches through pinned memory to the card on a
side stream, ``config.device_prefetch_depth`` batches ahead). Own copy of
ray_tpu.data.dataset, whose ``iter_jax_batches`` this port's
``iter_torch_batches`` replaces with the same arguments.
"""

from __future__ import annotations

import queue as _queue
import threading
from typing import Any, Callable, Dict, Iterator, List, Optional, Union

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.data.block import Batch, Block, BlockAccessor, block_from_batch, block_from_rows, concat_blocks
from ray_tpu_torch.data.execution.planner import build_physical_plan
from ray_tpu_torch.data.execution.streaming_executor import StreamingExecutor
from ray_tpu_torch.data.executor import (
    AggregateStage,
    LimitStage,
    MapStage,
    RepartitionStage,
    ShuffleStage,
    SortStage,
    Stage,
    ZipStage,
)
from ray_tpu_torch.utils.logging import get_logger

logger = get_logger("data")


class Dataset:
    def __init__(self, source_fn: Any, stages: Optional[List[Stage]] = None):
        # source_fn: callable returning an Iterator[ObjectRef], or a
        # ReadTaskSource (read_api) whose read tasks the executor paces
        self._source_fn = source_fn
        self._stages: List[Stage] = stages or []

    # ------------------------------------------------------------ transforms
    def _with_stage(self, stage: Stage) -> "Dataset":
        return Dataset(self._source_fn, self._stages + [stage])

    def map_batches(
        self,
        fn: Union[Callable[[Batch], Batch], type],
        *,
        batch_format: str = "numpy",
        batch_size: Optional[int] = None,
        num_cpus: float = 1.0,
        concurrency: Optional[int] = None,
        fn_constructor_args: tuple = (),
        **_ignored,
    ) -> "Dataset":
        if isinstance(fn, type):
            cls = fn

            def ctor():
                return cls(*fn_constructor_args)

            def block_fn(block: Block, callable_obj) -> Block:
                batch = BlockAccessor(block).to_batch(batch_format)
                return block_from_batch(callable_obj(batch))

            return self._with_stage(
                MapStage(f"map_batches({cls.__name__})", block_fn,
                         num_cpus=num_cpus, fn_constructor=ctor, concurrency=concurrency)
            )

        def block_fn(block: Block) -> Block:
            batch = BlockAccessor(block).to_batch(batch_format)
            return block_from_batch(fn(batch))

        return self._with_stage(
            MapStage(f"map_batches({getattr(fn, '__name__', 'fn')})", block_fn,
                     num_cpus=num_cpus, concurrency=concurrency)
        )

    def map(self, fn: Callable[[Dict], Dict], num_cpus: float = 1.0) -> "Dataset":
        def block_fn(block: Block) -> Block:
            rows = [fn(r) for r in BlockAccessor(block).iter_rows()]
            return block_from_rows(rows)

        return self._with_stage(MapStage(f"map({getattr(fn, '__name__', 'fn')})", block_fn, num_cpus=num_cpus))

    def flat_map(self, fn: Callable[[Dict], List[Dict]], num_cpus: float = 1.0) -> "Dataset":
        def block_fn(block: Block) -> Block:
            rows: List[Dict] = []
            for r in BlockAccessor(block).iter_rows():
                rows.extend(fn(r))
            return block_from_rows(rows)

        return self._with_stage(MapStage("flat_map", block_fn, num_cpus=num_cpus))

    def filter(self, fn: Callable[[Dict], bool], num_cpus: float = 1.0) -> "Dataset":
        def block_fn(block: Block) -> Block:
            import pyarrow as pa

            mask = pa.array([fn(r) for r in BlockAccessor(block).iter_rows()])
            return block.filter(mask)

        return self._with_stage(MapStage("filter", block_fn, num_cpus=num_cpus))

    def repartition(self, num_blocks: int) -> "Dataset":
        return self._with_stage(RepartitionStage(num_blocks))

    def random_shuffle(self, seed: Optional[int] = None) -> "Dataset":
        return self._with_stage(ShuffleStage(seed))

    def sort(self, key: str, descending: bool = False) -> "Dataset":
        """Distributed range-partition sort by a column (reference:
        dataset.py Dataset.sort -> planner/exchange/sort_task_spec.py)."""
        return self._with_stage(SortStage(key, descending))

    def groupby(self, key: Union[str, List[str]]) -> "GroupedData":
        """Group rows by key column(s) (reference: Dataset.groupby ->
        grouped_data.py). Aggregations run as a hash exchange with map-side
        combine."""
        keys = [key] if isinstance(key, str) else list(key)
        return GroupedData(self, keys)

    def aggregate(self, *aggs) -> Dict[str, Any]:
        """Global aggregation; returns {agg_name: value} (reference:
        Dataset.aggregate)."""
        out = self._with_stage(AggregateStage([], list(aggs))).take_all()
        return out[0] if out else {}

    def sum(self, on: str):
        from ray_tpu_torch.data.aggregate import Sum

        return self.aggregate(Sum(on)).get(f"sum({on})")

    def min(self, on: str):
        from ray_tpu_torch.data.aggregate import Min

        return self.aggregate(Min(on)).get(f"min({on})")

    def max(self, on: str):
        from ray_tpu_torch.data.aggregate import Max

        return self.aggregate(Max(on)).get(f"max({on})")

    def mean(self, on: str):
        from ray_tpu_torch.data.aggregate import Mean

        return self.aggregate(Mean(on)).get(f"mean({on})")

    def std(self, on: str, ddof: int = 1):
        from ray_tpu_torch.data.aggregate import Std

        return self.aggregate(Std(on, ddof)).get(f"std({on})")

    def unique(self, column: str) -> List[Any]:
        rows = self.groupby(column).count().take_all()
        return sorted(r[column] for r in rows)

    def zip(self, other: "Dataset") -> "Dataset":
        """Column-wise zip of two datasets with equal row counts (reference:
        Dataset.zip; right-side column-name collisions get a _1 suffix)."""
        return self._with_stage(ZipStage(lambda: other._execute()))

    def union(self, *others: "Dataset") -> "Dataset":
        selves = [self, *others]

        def source() -> Iterator[ObjectRef]:
            for ds in selves:
                yield from ds._execute()

        return Dataset(source)

    def limit(self, n: int) -> "Dataset":
        """First n rows; compiles to a LimitOp that short-circuits upstream
        operators (reads stop submitting once the limit is satisfied)."""
        return self._with_stage(LimitStage(n))

    # ----------------------------------------------------------- consumption
    def _build_executor(self, collect_rows: bool = False,
                        output_split: Optional[int] = None,
                        equal_split: bool = True) -> StreamingExecutor:
        ops = build_physical_plan(self._source_fn, self._stages,
                                  output_split=output_split,
                                  equal_split=equal_split)
        executor = StreamingExecutor(ops, collect_rows=collect_rows)
        self._last_executor = executor
        return executor

    def _execute(self, collect_rows: bool = False) -> Iterator[ObjectRef]:
        executor = self._build_executor(collect_rows=collect_rows)
        return (bundle.ref for bundle in executor.execute())

    def iter_internal_refs(self) -> Iterator[ObjectRef]:
        return self._execute()

    def take(self, limit: int = 20) -> List[Dict[str, Any]]:
        out: List[Dict[str, Any]] = []
        for ref in self._execute():
            for row in BlockAccessor(ray_tpu_torch.get(ref)).iter_rows():
                out.append(row)
                if len(out) >= limit:
                    return out
        return out

    def take_all(self) -> List[Dict[str, Any]]:
        return [r for ref in self._execute() for r in BlockAccessor(ray_tpu_torch.get(ref)).iter_rows()]

    def count(self) -> int:
        return sum(ray_tpu_torch.get(ref).num_rows for ref in self._execute())

    def schema(self):
        for ref in self._execute():
            return ray_tpu_torch.get(ref).schema
        return None

    def materialize(self) -> "Dataset":
        refs = list(self._execute())

        def source() -> Iterator[ObjectRef]:
            return iter(refs)

        return Dataset(source)

    def iter_rows(self) -> Iterator[Dict[str, Any]]:
        for ref in self._execute():
            yield from BlockAccessor(ray_tpu_torch.get(ref)).iter_rows()

    def iter_batches(
        self,
        *,
        batch_size: int = 256,
        batch_format: str = "numpy",
        prefetch_batches: int = 2,
        drop_last: bool = False,
    ) -> Iterator[Batch]:
        return _batch_iterator(self._execute(), batch_size, batch_format,
                               prefetch_batches, drop_last)

    def iter_torch_batches(
        self,
        *,
        batch_size: int = 256,
        prefetch_batches: int = 2,
        drop_last: bool = True,
        sharding=None,
        dtype=None,
        device=None,
    ) -> Iterator[Dict[str, Any]]:
        """Device-side prefetch: batches are transferred to the card ahead of
        consumption (config.device_prefetch_depth deep); see
        ``_device_batches`` for ``device``, ``sharding`` and ``dtype``."""
        host_iter = self.iter_batches(
            batch_size=batch_size, batch_format="numpy",
            prefetch_batches=prefetch_batches, drop_last=drop_last,
        )
        return _device_batches(host_iter, device=device, sharding=sharding, dtype=dtype)

    def streaming_split(self, n: int, *, equal: bool = True) -> List["DataIterator"]:
        """Split into n per-consumer iterators fed round-robin from one
        execution (reference: dataset.py:1363 streaming_split used by Train's
        DataConfig for per-worker shards). Each shard is backed by a queue
        ACTOR so the iterator handle is serializable into train workers."""
        # max_concurrency>1: a consumer blocked in get() must not starve puts
        shards = [_ShardQueue.options(max_concurrency=4).remote() for _ in range(n)]
        parent = self

        def feeder() -> None:
            try:
                # terminal OutputSplitOp tags each bundle with its consumer
                executor = parent._build_executor(output_split=n,
                                                  equal_split=equal)
                for bundle in executor.execute():
                    # put the BLOCK (values serialize; refs are per-process
                    # futures only in local mode)
                    idx = bundle.output_split_idx or 0
                    ray_tpu_torch.get(shards[idx].put.remote(ray_tpu_torch.get(bundle.ref)))
            finally:
                for s in shards:
                    s.close.remote()

        threading.Thread(target=feeder, daemon=True, name="streaming-split").start()
        return [DataIterator(s) for s in shards]

    # ---------------------------------------------------------------- output
    def write_parquet(self, path: str) -> None:
        import os

        import pyarrow.parquet as pq

        os.makedirs(path, exist_ok=True)
        for i, ref in enumerate(self._execute()):
            pq.write_table(ray_tpu_torch.get(ref), f"{path}/part-{i:05d}.parquet")

    def write_json(self, path: str) -> None:
        import json
        import os

        os.makedirs(path, exist_ok=True)
        for i, ref in enumerate(self._execute()):
            with open(f"{path}/part-{i:05d}.jsonl", "w") as f:
                for row in BlockAccessor(ray_tpu_torch.get(ref)).iter_rows():
                    f.write(json.dumps(row, default=str) + "\n")

    def write_csv(self, path: str) -> None:
        import os

        import pyarrow.csv as pacsv

        os.makedirs(path, exist_ok=True)
        for i, ref in enumerate(self._execute()):
            pacsv.write_csv(ray_tpu_torch.get(ref), f"{path}/part-{i:05d}.csv")

    def stats(self) -> str:
        """Per-operator blocks/bytes/time/queue metrics of the LAST
        execution (runs the pipeline with row collection if nothing has
        executed yet). Reference: Dataset.stats() backed by
        _internal/stats.py."""
        last = getattr(self, "_last_executor", None)
        # no output anywhere means an execution was CREATED but never
        # consumed — run for real, collecting row counts
        if last is None or not last.any_output_produced():
            for _ in self._execute(collect_rows=True):
                pass
            last = self._last_executor
        return last.summary()

    def stats_rows(self) -> List[Dict[str, Any]]:
        """Structured per-operator stats of the last execution (the rows
        behind ``stats()``; empty if nothing has executed)."""
        last = getattr(self, "_last_executor", None)
        return last.stats_rows() if last is not None else []

    def __repr__(self) -> str:
        return f"Dataset(num_stages={len(self._stages)})"


class GroupedData:
    """Result of Dataset.groupby (reference: data/grouped_data.py)."""

    def __init__(self, ds: Dataset, keys: List[str]):
        self._ds = ds
        self._keys = keys

    def aggregate(self, *aggs) -> Dataset:
        return self._ds._with_stage(AggregateStage(self._keys, list(aggs)))

    def count(self) -> Dataset:
        from ray_tpu_torch.data.aggregate import Count

        return self.aggregate(Count())

    def sum(self, on: str) -> Dataset:
        from ray_tpu_torch.data.aggregate import Sum

        return self.aggregate(Sum(on))

    def min(self, on: str) -> Dataset:
        from ray_tpu_torch.data.aggregate import Min

        return self.aggregate(Min(on))

    def max(self, on: str) -> Dataset:
        from ray_tpu_torch.data.aggregate import Max

        return self.aggregate(Max(on))

    def mean(self, on: str) -> Dataset:
        from ray_tpu_torch.data.aggregate import Mean

        return self.aggregate(Mean(on))

    def std(self, on: str, ddof: int = 1) -> Dataset:
        from ray_tpu_torch.data.aggregate import Std

        return self.aggregate(Std(on, ddof))

    def map_groups(self, fn: Callable[[Dict[str, np.ndarray]], Any]) -> Dataset:
        """Apply fn to each whole group (rows of one key, as a numpy batch);
        fn returns a batch/dict of rows (reference: GroupedData.map_groups).
        Implemented as sort-by-key then per-block group apply — the sort
        exchange guarantees one group never spans two blocks."""
        keys = self._keys
        sorted_ds = self._ds.sort(keys[0])

        def block_fn(block: Block) -> Block:
            import numpy as np

            from ray_tpu_torch.data.block import BlockAccessor, block_from_batch, concat_blocks

            if block.num_rows == 0:
                return block
            acc = BlockAccessor(block)
            batch = acc.to_numpy()
            kcol = batch[keys[0]]
            # group boundaries within the sorted block
            change = np.nonzero(kcol[1:] != kcol[:-1])[0] + 1
            starts = np.concatenate([[0], change])
            ends = np.concatenate([change, [len(kcol)]])
            outs = []
            for s, e in zip(starts, ends):
                sub = {k: v[s:e] for k, v in batch.items()}
                res = fn(sub)
                outs.append(block_from_batch(res))
            return concat_blocks(outs)

        return sorted_ds._with_stage(MapStage("map_groups", block_fn))


@ray_tpu_torch.remote
class _ShardQueue:
    """Bounded block queue between one execution and one consumer; the actor
    handle serializes into train workers (async: puts and gets interleave)."""

    def __init__(self, maxsize: int = 8):
        import asyncio

        self._q = None
        self._maxsize = maxsize

    def _queue(self):
        import asyncio

        if self._q is None:
            self._q = asyncio.Queue(maxsize=self._maxsize)
        return self._q

    async def put(self, block) -> bool:
        await self._queue().put(block)
        return True

    async def close(self) -> bool:
        await self._queue().put(None)
        return True

    async def get(self):
        return await self._queue().get()


class DataIterator:
    """Per-consumer shard handle (reference: data/iterator.py DataIterator).
    Serializable: backed by a _ShardQueue actor."""

    def __init__(self, shard_actor: Any):
        self._shard = shard_actor

    def __reduce__(self):
        return (DataIterator, (self._shard,))

    def _refs(self) -> Iterator[ObjectRef]:
        while True:
            block = ray_tpu_torch.get(self._shard.get.remote())
            if block is None:
                return
            yield ray_tpu_torch.put(block)

    def iter_batches(self, *, batch_size: int = 256, batch_format: str = "numpy",
                     prefetch_batches: int = 2, drop_last: bool = False) -> Iterator[Batch]:
        return _batch_iterator(self._refs(), batch_size, batch_format,
                               prefetch_batches, drop_last)

    def iter_rows(self) -> Iterator[Dict[str, Any]]:
        for ref in self._refs():
            yield from BlockAccessor(ray_tpu_torch.get(ref)).iter_rows()

    def iter_torch_batches(self, *, batch_size: int = 256,
                           prefetch_batches: int = 2, drop_last: bool = True,
                           sharding=None, dtype=None, device=None) -> Iterator[Dict[str, Any]]:
        """Device-side prefetch on a streaming_split shard — the per-train-
        worker half of the data->train path (reference: DataIterator.
        iter_torch_batches used by Train via DataConfig)."""
        host_iter = self.iter_batches(
            batch_size=batch_size, batch_format="numpy",
            prefetch_batches=prefetch_batches, drop_last=drop_last,
        )
        return _device_batches(host_iter, device=device, sharding=sharding, dtype=dtype)


def _device_batches(host_iter: Iterator[Dict[str, np.ndarray]], *, device=None,
                    sharding=None, dtype=None) -> Iterator[Dict[str, Any]]:
    """Host batches to torch tensors on ``device`` (None: the card), kept
    ``config.device_prefetch_depth`` batches ahead of the consumer.

    ``dtype``: a numpy dtype each column is cast to on the host first, as
    ``iter_jax_batches`` casts. ``sharding``: ``(mesh, placements)``, a DeviceMesh
    and its DTensor placements (the counterpart of a ``NamedSharding``);
    every rank holds the same global batch and keeps its shard
    (``parallel.sharding.shard_tensor``), as ``jax.device_put`` does with a
    ``NamedSharding``.

    On the card, each column is copied once into pinned host memory, then to
    the device with ``non_blocking=True`` on a side stream, so the copies of
    the batches ahead overlap the consumer's work; the consumer's stream
    waits on the batch's event before the batch is handed out (no batch is
    read before it lands), and each tensor is recorded on that stream so its
    memory is not reused while the consumer's work is queued."""
    import collections

    import torch

    from ray_tpu_torch._device import resolve_device
    from ray_tpu_torch.core.config import config

    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    side = torch.cuda.Stream(device=dev) if cuda else None

    def column(arr: np.ndarray):
        arr = np.asarray(arr if dtype is None else arr.astype(dtype))
        if cuda:
            pinned = torch.empty(arr.shape, dtype=torch.from_numpy(np.empty(0, arr.dtype)).dtype,
                                 pin_memory=True)
            pinned.numpy()[...] = arr
            t = pinned.to(dev, non_blocking=True)
        else:
            t = torch.from_numpy(np.array(arr))  # a copy: Arrow's buffers are read-only
        if sharding is not None:
            from ray_tpu_torch.parallel.sharding import shard_tensor

            t = shard_tensor(t, *sharding)
        return t

    def to_device(batch: Dict[str, np.ndarray]):
        if not cuda:
            return {k: column(v) for k, v in batch.items()}, None
        with torch.cuda.stream(side):
            out = {k: column(v) for k, v in batch.items()}
            event = torch.cuda.Event()
            event.record(side)
        return out, event

    def hand_out(item):
        out, event = item
        if event is not None:
            consumer = torch.cuda.current_stream(dev)
            consumer.wait_event(event)
            for t in out.values():
                (t.to_local() if hasattr(t, "to_local") else t).record_stream(consumer)
        return out

    depth = max(1, config.device_prefetch_depth)
    buf: "collections.deque" = collections.deque()
    for batch in host_iter:
        buf.append(to_device(batch))
        if len(buf) >= depth:
            yield hand_out(buf.popleft())
    while buf:
        yield hand_out(buf.popleft())


def _batch_iterator(refs: Iterator[ObjectRef], batch_size: int, batch_format: str,
                    prefetch_batches: int, drop_last: bool) -> Iterator[Batch]:
    """Re-chunk a stream of blocks into fixed-size batches with background
    block prefetch (reference: _internal/block_batching)."""
    out_q: "_queue.Queue" = _queue.Queue(maxsize=max(1, prefetch_batches))
    DONE = object()

    def producer() -> None:
        try:
            carry: Optional[Block] = None
            for ref in refs:
                block = ray_tpu_torch.get(ref)
                if carry is not None:
                    block = concat_blocks([carry, block])
                    carry = None
                offset = 0
                n = block.num_rows
                while n - offset >= batch_size:
                    out_q.put(BlockAccessor(block).slice(offset, offset + batch_size))
                    offset += batch_size
                if offset < n:
                    carry = BlockAccessor(block).slice(offset, n)
            if carry is not None and carry.num_rows and not drop_last:
                out_q.put(carry)
        except BaseException as e:  # noqa: BLE001
            out_q.put(e)
            return
        finally:
            out_q.put(DONE)

    threading.Thread(target=producer, daemon=True, name="batch-prefetch").start()
    while True:
        item = out_q.get()
        if item is DONE:
            return
        if isinstance(item, BaseException):
            raise item
        yield BlockAccessor(item).to_batch(batch_format)
