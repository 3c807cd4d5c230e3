"""Physical operators of the streaming Data executor.

Reference counterparts (python/ray/data/_internal/execution/operators/):

- ``InputDataOp``      -> input_data_buffer.py InputDataBuffer (+ the read
                          half of plan_read_op.py: paced read-task submission)
- ``TaskPoolMapOp``    -> map_operator.py TaskPoolMapOperator
- ``ActorPoolMapOp``   -> actor_pool_map_operator.py ActorPoolMapOperator
- ``AllToAllOp``       -> all_to_all_operator.py AllToAllOperator (barrier +
                          bulk exchange: repartition/shuffle/sort/agg/zip)
- ``LimitOp``          -> limit_operator.py LimitOperator (+ upstream
                          short-circuit via the executor)
- ``OutputSplitOp``    -> output_splitter.py OutputSplitter (streaming_split)

Map-family operators preserve submission order: completions are harvested
out of order but emitted head-of-line, so ``take()`` and zip alignment see
deterministic row order while stragglers still overlap."""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Callable, Deque, Dict, Iterator, List, Optional

import ray_tpu_torch
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.data.execution.interfaces import (
    ExecutionContext,
    PhysicalOperator,
    ReadTaskSource,
    RefBundle,
)


class _InFlight:
    __slots__ = ("ref", "submitted_at", "done", "size_bytes")

    def __init__(self, ref: ObjectRef, submitted_at: float):
        self.ref = ref
        self.submitted_at = submitted_at
        self.done = False
        self.size_bytes: Optional[int] = None


class _OrderedTaskMixin(PhysicalOperator):
    """Shared harvest machinery: poll in-flight refs, emit in order."""

    def __init__(self, name: str):
        super().__init__(name)
        self._pending: Deque[_InFlight] = deque()
        self._by_ref: Dict[ObjectRef, _InFlight] = {}

    def _track(self, ref: ObjectRef) -> None:
        t = _InFlight(ref, self.stats.on_task_submitted())
        self._pending.append(t)
        self._by_ref[ref] = t

    def active_refs(self) -> List[ObjectRef]:
        return list(self._by_ref)

    def num_active_tasks(self) -> int:
        # tracked-but-not-yet-emitted counts against the concurrency cap:
        # ordered emission means a straggling head-of-line task must pause
        # dispatches, not let completed outputs pile up behind it unbounded
        return len(self._pending)

    def _on_task_done(self, t: _InFlight, ctx: ExecutionContext) -> None:
        """Hook for subclasses (actor pools return the actor here)."""

    def process_completions(self, ctx: ExecutionContext,
                            ready: Optional[List[ObjectRef]] = None) -> bool:
        """``ready``: completed refs the EXECUTOR already discovered with its
        one wait() per tick (in cluster mode every wait is a control RPC, and
        a zero-timeout wait only sees the driver node's store — per-op
        zero-timeout polling would never observe remote completions)."""
        if ready is None:
            ready = []
            if self._by_ref:
                refs = list(self._by_ref)
                ready, _ = ray_tpu_torch.wait(refs, num_returns=len(refs),
                                        timeout=0.05)
        else:
            ready = [r for r in ready if r in self._by_ref]
        if ready:
            sizes = ctx.probe_sizes(ready)
            for ref, size in zip(ready, sizes):
                t = self._by_ref.pop(ref)
                t.done = True
                t.size_bytes = size
                self.stats.on_task_finished(t.submitted_at)
                self._on_task_done(t, ctx)
        produced = False
        # head-of-line ordered emission
        while self._pending and self._pending[0].done:
            t = self._pending.popleft()
            if not self._finished:
                self._emit(RefBundle(t.ref, size_bytes=t.size_bytes), ctx)
                produced = True
        return produced or bool(ready)


class InputDataOp(_OrderedTaskMixin):
    """Source operator. Two shapes:

    - a ``ReadTaskSource``: each thunk becomes one remote read task; the
      scheduling loop paces submission (concurrency cap + memory budget),
      so parallelism of the READ phase is an executor decision, not a
      datasource loop;
    - a driver-side ref iterator (materialized datasets, unions, nested
      executions): each dispatch pulls one ref and emits it directly.
    """

    num_cpus = 1.0

    def __init__(self, source: Any, name: Optional[str] = None):
        self._read_source: Optional[ReadTaskSource] = None
        self._ref_iter: Optional[Iterator[ObjectRef]] = None
        self._source = source
        if isinstance(source, ReadTaskSource):
            self._read_source = source
            label = f"input::read_{source.name}[{len(source)}]"
        else:
            label = name or "input"
        super().__init__(label)
        self._next_idx = 0
        self._iter_exhausted = False
        self._read_remote = None
        from ray_tpu_torch.core.config import config

        self.concurrency_cap = config.data_default_op_concurrency
        self.inputs_complete()  # sources have no upstream

    def start(self, ctx: ExecutionContext) -> None:
        if self._read_source is not None:
            tasks = self._read_source.make_tasks

            @ray_tpu_torch.remote(num_cpus=1,
                            name=f"data::read_{self._read_source.name}")
            def read_one(idx: int):
                return tasks[idx]()

            self._read_remote = read_one
        else:
            self._ref_iter = iter(self._source())
            self.concurrency_cap = None  # driver-side pull, not a task pool

    def can_dispatch(self) -> bool:
        if self._finished:
            return False
        if self._read_source is not None:
            return self._next_idx < len(self._read_source)
        return not self._iter_exhausted

    def dispatch(self, ctx: ExecutionContext) -> None:
        if self._read_source is not None:
            self._track(self._read_remote.remote(self._next_idx))
            self._next_idx += 1
            return
        try:
            ref = next(self._ref_iter)
        except StopIteration:
            self._iter_exhausted = True
            return
        size = ctx.probe_sizes([ref])[0]
        self._emit(RefBundle(ref, size_bytes=size), ctx)

    def completed(self) -> bool:
        if self._finished:
            return True
        if self._read_source is not None:
            return (self._next_idx >= len(self._read_source)
                    and not self._by_ref and not self._pending)
        return self._iter_exhausted


class TaskPoolMapOp(_OrderedTaskMixin):
    """One remote task per input block over the shared task pool."""

    def __init__(self, name: str, block_fn: Callable, num_cpus: float = 1.0,
                 concurrency: Optional[int] = None):
        super().__init__(name)
        self.block_fn = block_fn
        self.num_cpus = num_cpus
        from ray_tpu_torch.core.config import config

        self.concurrency_cap = concurrency or config.data_default_op_concurrency
        self._remote = None

    def start(self, ctx: ExecutionContext) -> None:
        block_fn = self.block_fn

        @ray_tpu_torch.remote(num_cpus=self.num_cpus, name=f"data::{self.name}")
        def apply(block):
            return block_fn(block)

        self._remote = apply

    def dispatch(self, ctx: ExecutionContext) -> None:
        bundle = self.input_queue.popleft()
        self._track(self._remote.remote(bundle.ref))


class ActorPoolMapOp(_OrderedTaskMixin):
    """Stateful transform over a fixed pool of actors (class-based
    map_batches: the callable is constructed once per actor and reused)."""

    def __init__(self, name: str, block_fn: Callable,
                 fn_constructor: Callable, concurrency: Optional[int] = None,
                 num_cpus: float = 1.0):
        super().__init__(name)
        self.block_fn = block_fn
        self.fn_constructor = fn_constructor
        self.num_cpus = num_cpus
        self.pool_size = max(1, concurrency or 2)
        self.concurrency_cap = self.pool_size
        self._actors: List[Any] = []
        self._idle: Deque[Any] = deque()
        self._actor_of: Dict[ObjectRef, Any] = {}

    def start(self, ctx: ExecutionContext) -> None:
        ctor = self.fn_constructor
        block_fn = self.block_fn

        @ray_tpu_torch.remote(num_cpus=self.num_cpus)
        class _MapWorker:
            def __init__(self):
                self.fn = ctor()

            def apply(self, block):
                return block_fn(block, self.fn)

        self._actors = [_MapWorker.remote() for _ in range(self.pool_size)]
        self._idle = deque(self._actors)

    def can_dispatch(self) -> bool:
        return bool(self.input_queue) and bool(self._idle)

    def dispatch(self, ctx: ExecutionContext) -> None:
        bundle = self.input_queue.popleft()
        actor = self._idle.popleft()
        ref = actor.apply.remote(bundle.ref)
        self._actor_of[ref] = actor
        self._track(ref)

    def _on_task_done(self, t: _InFlight, ctx: ExecutionContext) -> None:
        actor = self._actor_of.pop(t.ref, None)
        if actor is not None:
            self._idle.append(actor)

    def shutdown(self) -> None:
        for a in self._actors:
            try:
                ray_tpu_torch.kill(a)
            except Exception:  # noqa: BLE001
                pass
        self._actors = []
        self._idle.clear()


class AllToAllOp(PhysicalOperator):
    """Barrier + bulk exchange. Accumulates every input ref, then drives a
    bulk transform (the distributed map/reduce exchanges in
    ``data/executor.py``) one output block per dispatch — the scheduling
    loop stays in control, so downstream backpressure still throttles how
    fast reduce outputs materialize."""

    num_cpus = 0.0

    def __init__(self, name: str, bulk_fn: Callable[[Iterator[ObjectRef]],
                                                    Iterator[ObjectRef]]):
        super().__init__(name)
        self.bulk_fn = bulk_fn
        # no concurrency cap (the bulk generator owns its own task fan-out),
        # but exchange outputs still count against the memory budget — the
        # barrier exchange must not bypass the accounting that throttles
        # every other operator
        self.budget_participates = True
        self._collected: List[ObjectRef] = []
        self._gen: Optional[Iterator[ObjectRef]] = None
        self._gen_done = False

    def can_dispatch(self) -> bool:
        if self._finished or self._gen_done:
            return False
        # barrier: the exchange needs every input block (sort samples all
        # blocks, shuffle scatters rows everywhere); the blocks themselves
        # wait in our input queue until the first dispatch drains them
        if self._gen is None and not self._inputs_complete:
            return False
        return True

    def dispatch(self, ctx: ExecutionContext) -> None:
        if self._gen is None:
            while self.input_queue:
                self._collected.append(self.input_queue.popleft().ref)
            t0 = self.stats.on_task_submitted()
            self._gen = self.bulk_fn(iter(self._collected))
            self.stats.on_task_finished(t0)
        t0 = time.perf_counter()
        try:
            ref = next(self._gen)
        except StopIteration:
            self._gen_done = True
            return
        finally:
            self.stats.task_time_s += time.perf_counter() - t0
        size = ctx.probe_sizes([ref])[0]
        self._emit(RefBundle(ref, size_bytes=size), ctx)

    def add_input(self, bundle: RefBundle) -> None:
        super().add_input(bundle)

    def completed(self) -> bool:
        return self._finished or self._gen_done


class LimitOp(PhysicalOperator):
    """Driver-side row limit: counts rows per block, slices the boundary
    block, then short-circuits every upstream operator (the executor stops
    their dispatches and drops their queues)."""

    num_cpus = 0.0

    def __init__(self, limit: int):
        super().__init__(f"limit({limit})")
        self.limit = limit
        self.remaining = limit
        self.short_circuit = False

    def can_dispatch(self) -> bool:
        return bool(self.input_queue) and self.remaining > 0

    def dispatch(self, ctx: ExecutionContext) -> None:
        from ray_tpu_torch.data.block import BlockAccessor

        bundle = self.input_queue.popleft()
        rows = bundle.num_rows
        block = None
        if rows is None:
            block = ray_tpu_torch.get(bundle.ref)
            rows = block.num_rows
        if rows <= self.remaining:
            self.remaining -= rows
            bundle.num_rows = rows
            self._emit(bundle, ctx)
        else:
            if block is None:
                block = ray_tpu_torch.get(bundle.ref)
            sliced = BlockAccessor(block).slice(0, self.remaining)
            ref = ray_tpu_torch.put(sliced)
            self._emit(RefBundle(ref, size_bytes=sliced.nbytes,
                                 num_rows=self.remaining), ctx)
            self.remaining = 0
        if self.remaining <= 0:
            self.short_circuit = True
            self.input_queue.clear()
            self.inputs_complete()


class OutputSplitOp(PhysicalOperator):
    """Terminal fan-out for streaming_split: tags bundles with a consumer
    index round-robin (``equal=True`` balances block counts)."""

    num_cpus = 0.0

    def __init__(self, n: int, equal: bool = True):
        super().__init__(f"output_split({n})")
        self.n = n
        self.equal = equal
        self._next = 0

    def dispatch(self, ctx: ExecutionContext) -> None:
        bundle = self.input_queue.popleft()
        bundle.output_split_idx = self._next
        self._next = (self._next + 1) % self.n
        self._emit(bundle, ctx)
