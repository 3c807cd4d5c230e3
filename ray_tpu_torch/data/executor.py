"""Logical stages of the Data plan + the distributed all-to-all exchanges.

Reference capability: python/ray/data/_internal/logical_ops + planner/
exchange/. A ``Stage`` is a LOGICAL description of a transformation;
``ray_tpu_torch.data.execution.planner`` compiles stages into physical operators
and ``execution.streaming_executor.StreamingExecutor`` runs them with
per-operator budgets and backpressure. The old flat per-stage in-flight
window (``_iter_completed``) is gone — pacing decisions live in the
executor's scheduling loop now, not in each stage.

The all-to-all stages (repartition/shuffle/sort/aggregate/zip) keep their
``execute(inputs) -> Iterator[ObjectRef]`` methods: that generator IS the
distributed exchange (split map tasks + reduce tasks; block data never
touches the driver), and the physical ``AllToAllOp`` drives it one output
block per scheduling step."""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, Optional

import ray_tpu_torch
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.utils.logging import get_logger

logger = get_logger("data.executor")


class Stage:
    """A logical transformation of a stream of block refs."""

    name = "stage"

    def shuffle_spec(self):
        """The stage's ``ShuffleSpec`` (shuffle.spec) when it is an
        all-to-all exchange the streaming shuffle subsystem can drive; None
        compiles to the legacy ``AllToAllOp`` barrier (zip, keyless
        aggregate, non-exchange stages)."""
        return None


class MapStage(Stage):
    """Row/batch map (task pool, or actor pool when fn_constructor is set).
    Purely descriptive: execution lives in TaskPoolMapOp/ActorPoolMapOp."""

    def __init__(
        self,
        name: str,
        block_fn: Callable,  # Block -> Block (pickled to workers)
        num_cpus: float = 1.0,
        fn_constructor: Optional[Callable] = None,  # class-based: actor pool
        concurrency: Optional[int] = None,
    ):
        self.name = name
        self.block_fn = block_fn
        self.num_cpus = num_cpus
        self.fn_constructor = fn_constructor
        self.concurrency = concurrency


class LimitStage(Stage):
    """First-n-rows truncation; compiles to a LimitOp that short-circuits
    every upstream operator once satisfied."""

    def __init__(self, limit: int):
        self.name = f"limit({limit})"
        self.limit = limit


def _exchange(inputs: Iterator[ObjectRef], num_outputs: Optional[int],
              split_fn: Callable, reduce_fn: Callable) -> Iterator[ObjectRef]:
    """Two-phase map/reduce exchange (reference: planner/exchange/
    shuffle_task_scheduler): map tasks split every input block into
    num_outputs partitions (refs only — block DATA never touches the
    driver, so datasets larger than any one store spill instead of OOM);
    reduce tasks combine partition j of every map output. Yields reduce
    output refs as they finish."""
    input_refs = list(inputs)
    if not input_refs:
        return
    n_out = num_outputs or len(input_refs)

    split_remote = ray_tpu_torch.remote(num_returns=n_out, name="data::exchange_split")(
        split_fn
    ) if n_out > 1 else None

    # map phase: one split task per input block -> n_out partition refs each
    partitions: List[List[ObjectRef]] = []
    for i, ref in enumerate(input_refs):
        if n_out == 1:
            partitions.append([ref])
        else:
            out = split_remote.remote(ref, n_out, i)
            partitions.append(list(out) if isinstance(out, (list, tuple)) else [out])

    reduce_remote = ray_tpu_torch.remote(name="data::exchange_reduce")(reduce_fn)
    reduce_refs = [
        reduce_remote.remote(j, *[parts[j] for parts in partitions])
        for j in range(n_out)
    ]
    for ref in reduce_refs:
        ray_tpu_torch.wait([ref], num_returns=1, timeout=None)
        yield ref


def _exchange_spec(spec, inputs: Iterator[ObjectRef]) -> Iterator[ObjectRef]:
    """Barrier-mode exchange driven by a ``ShuffleSpec`` — the SAME
    partition functions the streaming ``ShuffleMapOp``/``ShuffleReduceOp``
    run, so ``RTPU_STREAMING_SHUFFLE=0`` changes scheduling, never data.
    Collects every input ref up front (the barrier), runs the optional plan
    phase (boundary samples / row counts), then split + reduce tasks."""
    input_refs = list(inputs)
    if not input_refs:
        return
    n_out = spec.resolve_partitions(len(input_refs))
    plan = None
    if spec.needs_plan:
        sample_remote = ray_tpu_torch.remote(
            name=f"data::{spec.name}::sample")(spec.sample_fn)
        samples = ray_tpu_torch.get(
            [sample_remote.remote(ref, i) for i, ref in enumerate(input_refs)])
        plan = spec.plan_fn(samples, n_out)

    map_fn = spec.map_fn

    def split(block, idx, plan_):
        return map_fn(block, n_out, idx, plan_)

    split_remote = ray_tpu_torch.remote(
        num_returns=n_out, name=f"data::{spec.name}::map")(split)
    partitions: List[List[ObjectRef]] = []
    for i, ref in enumerate(input_refs):
        out = split_remote.remote(ref, i, plan)
        partitions.append(list(out) if isinstance(out, (list, tuple)) else [out])

    reduce_remote = ray_tpu_torch.remote(name=f"data::{spec.name}::reduce")(
        spec.reduce_fn)
    reduce_refs = [
        reduce_remote.remote(j, *[parts[j] for parts in partitions])
        for j in range(n_out)
    ]
    for ref in reduce_refs:
        ray_tpu_torch.wait([ref], num_returns=1, timeout=None)
        yield ref


class RepartitionStage(Stage):
    """Order-preserving repartition (reference: shuffle=False repartition —
    global row order is kept, so zip() after repartition stays aligned)."""

    def __init__(self, num_blocks: int):
        self.name = f"repartition({num_blocks})"
        self.num_blocks = num_blocks

    def shuffle_spec(self):
        from ray_tpu_torch.data.shuffle.spec import repartition_spec

        return repartition_spec(self.num_blocks)

    def execute(self, inputs: Iterator[ObjectRef]) -> Iterator[ObjectRef]:
        yield from _exchange_spec(self.shuffle_spec(), inputs)


class ShuffleStage(Stage):
    """Distributed all-to-all random shuffle: rows scatter to random output
    partitions in map tasks, reduce tasks permute within their partition.
    No driver-side materialization (reference: planner/exchange/). Map RNGs
    are derived from the BLOCK INDEX (shuffle.spec.derive_rng), never
    dispatch order, so a seeded shuffle is deterministic even when maps
    complete out of order."""

    def __init__(self, seed: Optional[int] = None):
        self.name = "random_shuffle"
        self.seed = seed

    def shuffle_spec(self):
        from ray_tpu_torch.data.shuffle.spec import random_shuffle_spec

        return random_shuffle_spec(self.seed)

    def execute(self, inputs: Iterator[ObjectRef]) -> Iterator[ObjectRef]:
        yield from _exchange_spec(self.shuffle_spec(), inputs)


class SortStage(Stage):
    """Distributed range-partition sort (reference: planner/exchange/
    sort_task_spec.py SortTaskSpec — sample boundaries, range-split map
    tasks, sorted-merge reduce tasks)."""

    def __init__(self, key: str, descending: bool = False,
                 num_blocks: Optional[int] = None):
        self.name = f"sort({key})"
        self.key = key
        self.descending = descending
        self.num_blocks = num_blocks

    def shuffle_spec(self):
        from ray_tpu_torch.data.shuffle.spec import sort_spec

        return sort_spec(self.key, self.descending, self.num_blocks)

    def execute(self, inputs: Iterator[ObjectRef]) -> Iterator[ObjectRef]:
        yield from _exchange_spec(self.shuffle_spec(), inputs)


class AggregateStage(Stage):
    """Hash-partition groupby + aggregate (reference: planner/exchange/
    aggregate_task_spec.py): map tasks pre-combine per-group partials
    (vectorized pyarrow group_by), reduce tasks merge partials and finalize.
    With no keys, a single global-aggregate output block."""

    def __init__(self, keys: List[str], aggs: List[Any],
                 num_blocks: Optional[int] = None):
        names = ",".join(a.name for a in aggs)
        self.name = f"aggregate({','.join(keys) or '-'}:{names})"
        self.keys = keys
        self.aggs = aggs
        self.num_blocks = num_blocks

    def shuffle_spec(self):
        from ray_tpu_torch.data.shuffle.spec import aggregate_spec

        # keyless (global) aggregation returns None: a single-output
        # barrier combine is already optimal, no exchange to stream
        return aggregate_spec(self.keys, self.aggs, self.num_blocks)

    def execute(self, inputs: Iterator[ObjectRef]) -> Iterator[ObjectRef]:
        spec = self.shuffle_spec()
        if spec is not None:
            yield from _exchange_spec(spec, inputs)
            return
        keys, aggs = self.keys, self.aggs
        input_refs = list(inputs)
        if not input_refs:
            return

        def split(block, n, _idx=0):
            return block  # n_out == 1: _exchange skips the split phase

        def reduce(_j, *parts):
            from ray_tpu_torch.data.aggregate import make_partial, merge_partials

            # parts are RAW blocks (no split phase ran): combine them here
            expected = {c for a in aggs for c, _ in a.merge_aggs()}
            norm = [p if expected.issubset(set(p.column_names))
                    else make_partial(p, keys, aggs) for p in parts]
            return merge_partials(norm, keys, aggs)

        yield from _exchange(iter(input_refs), 1, split, reduce)


def _stable_hash_partition(table, keys: List[str], n: int):
    """Partition assignment stable ACROSS processes (python's str hash is
    per-process salted; numpy splitmix for ints, crc32 for anything else)."""
    import zlib

    import numpy as np

    h = np.zeros(table.num_rows, dtype=np.uint64)
    for k in keys:
        col = table.column(k)
        try:
            vals = col.to_numpy(zero_copy_only=False)
        except Exception:  # noqa: BLE001
            vals = np.array(col.to_pylist(), dtype=object)
        if np.issubdtype(vals.dtype, np.integer):
            x = vals.astype(np.uint64)
            x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
            x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
            h ^= x ^ (x >> np.uint64(31))
        else:
            h ^= np.array(
                [zlib.crc32(str(v).encode()) for v in vals], dtype=np.uint64
            )
    return (h % np.uint64(n)).astype(np.int64)


class ZipStage(Stage):
    """Column-zip with another dataset's block stream (reference:
    dataset.py Dataset.zip — aligns differing block boundaries, combines
    columns; right-side name collisions get a _1 suffix)."""

    def __init__(self, other_source: Callable[[], Iterator[ObjectRef]]):
        self.name = "zip"
        self.other_source = other_source

    def execute(self, inputs: Iterator[ObjectRef]) -> Iterator[ObjectRef]:
        left = list(inputs)
        right = list(self.other_source())

        @ray_tpu_torch.remote(name="data::zip_rows")
        def count_rows(block):
            return block.num_rows

        l_counts = ray_tpu_torch.get([count_rows.remote(r) for r in left])
        r_counts = ray_tpu_torch.get([count_rows.remote(r) for r in right])
        if sum(l_counts) != sum(r_counts):
            raise ValueError(
                f"zip(): datasets have different row counts "
                f"({sum(l_counts)} vs {sum(r_counts)})"
            )

        # aligned segments: union of both sides' cumulative boundaries
        def cum(counts):
            out, acc = [], 0
            for c in counts:
                acc += c
                out.append(acc)
            return out

        bounds = sorted(set(cum(l_counts)) | set(cum(r_counts)))

        @ray_tpu_torch.remote(name="data::zip_slice")
        def zip_slice(lblock, loff, rblock, roff, length):
            import pyarrow as pa

            lpart = lblock.slice(loff, length)
            rpart = rblock.slice(roff, length)
            cols = {name: lpart.column(name) for name in lpart.column_names}
            for name in rpart.column_names:
                out_name = name if name not in cols else f"{name}_1"
                cols[out_name] = rpart.column(name)
            return pa.table(cols)

        start = 0
        for end in bounds:
            length = end - start
            if length <= 0:
                continue
            li, loff = _locate(l_counts, start)
            ri, roff = _locate(r_counts, start)
            yield zip_slice.remote(left[li], loff, right[ri], roff, length)
            start = end


def _locate(counts: List[int], global_row: int):
    """(block index, offset within block) of a global row index."""
    acc = 0
    for i, c in enumerate(counts):
        if global_row < acc + c:
            return i, global_row - acc
        acc += c
    raise IndexError(global_row)
