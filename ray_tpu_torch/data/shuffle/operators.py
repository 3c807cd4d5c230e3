"""Physical operators of the streaming shuffle.

``ShuffleMapOp`` launches one partitioner task per upstream block AS IT
LANDS — there is no driver-side collect-every-ref barrier like
``AllToAllOp``. Exchanges that need global knowledge first (sort
boundaries, repartition row counts) run a streaming plan phase: a tiny
sample task per block overlaps with upstream production, and the full
partitioner fan-out starts the moment the last sample returns.

``ShuffleReduceOp`` dispatches reduce tasks once the partition table is
complete, gated by the coordinator's spill-aware admission budget; outputs
emit head-of-line in reducer order, so a sorted dataset streams out
globally ordered. Partition refs are dropped as each reduce finishes —
distributed GC reclaims exchange intermediates while the shuffle runs.

In cluster mode the partition blocks move over the raw-frame transfer
plane: a reduce task's argument pull fans out through the agent's
TransferManager (striped multi-source pulls under the global
in-flight-bytes budget), with the whole partition set resolved through one
batched GCS holder lookup."""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple

import ray_tpu_torch
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.data.execution.interfaces import (
    ExecutionContext,
    PhysicalOperator,
    RefBundle,
)
from ray_tpu_torch.data.shuffle.coordinator import ShuffleCoordinator
from ray_tpu_torch.data.shuffle.spec import ShuffleSpec


class ShuffleMapOp(PhysicalOperator):
    """Map-side partitioner: one ``num_returns=n_out`` split task per input
    block, launched as blocks arrive. Produces no executor-visible bundles —
    partition refs go straight into the coordinator's table; the partition
    blocks themselves are AT REST in the object store (spillable), so they
    are deliberately not charged against the streaming memory budget."""

    num_cpus = 1.0

    def __init__(self, spec: ShuffleSpec, coord: ShuffleCoordinator,
                 concurrency: Optional[int] = None):
        super().__init__(f"shuffle_map({spec.name})")
        from ray_tpu_torch.core.config import config

        self.spec = spec
        self.coord = coord
        self.n_out = coord.n_out
        self.concurrency_cap = concurrency or config.data_default_op_concurrency
        self._next_idx = 0
        # plan phase state (sort boundaries / repartition row counts)
        self._plan_ready = not spec.needs_plan
        self._plan_ref: Optional[ObjectRef] = None
        self._buffered: Deque[Tuple[int, RefBundle]] = deque()
        self._samples: Dict[int, Any] = {}
        self._sample_refs: Dict[ObjectRef, Tuple[int, float]] = {}
        # map-task tracking: last return ref -> (block idx, all refs, t0)
        self._map_refs: Dict[ObjectRef, Tuple[int, List[ObjectRef], float]] = {}
        self._split_remote = None
        self._sample_remote = None

    # ------------------------------------------------------------------ setup
    def start(self, ctx: ExecutionContext) -> None:
        spec_map, n_out = self.spec.map_fn, self.n_out

        @ray_tpu_torch.remote(num_cpus=self.num_cpus, num_returns=n_out,
                        name=f"data::{self.name}")
        def split_task(block, idx, plan):
            return spec_map(block, n_out, idx, plan)

        self._split_remote = split_task
        if self.spec.needs_plan:
            spec_sample = self.spec.sample_fn

            @ray_tpu_torch.remote(num_cpus=1, name=f"data::{self.name}::sample")
            def sample_task(block, idx):
                return spec_sample(block, idx)

            self._sample_remote = sample_task
        self.coord.sample_baseline()

    # ------------------------------------------------------------- scheduling
    def can_dispatch(self) -> bool:
        if self._finished:
            return False
        if self.input_queue:
            return True
        if self._plan_ready:
            return bool(self._buffered)
        # plan pending: computable once every sample returned and no more
        # blocks can arrive
        return (self._inputs_complete and not self._sample_refs
                and not self.input_queue)

    def dispatch(self, ctx: ExecutionContext) -> None:
        if self.input_queue:
            bundle = self.input_queue.popleft()
            idx = self._next_idx
            self._next_idx += 1
            if self.spec.needs_plan:
                ref = self._sample_remote.remote(bundle.ref, idx)
                self._sample_refs[ref] = (idx, self.stats.on_task_submitted())
                self._buffered.append((idx, bundle))
            else:
                self._launch_map(idx, bundle)
            return
        if not self._plan_ready:
            if self._sample_refs or not self._inputs_complete:
                return
            plan = self.spec.plan_fn(
                [self._samples[i] for i in sorted(self._samples)], self.n_out)
            self._plan_ref = ray_tpu_torch.put(plan)
            self._plan_ready = True
        if self._buffered:
            idx, bundle = self._buffered.popleft()
            self._launch_map(idx, bundle)

    def _launch_map(self, idx: int, bundle: RefBundle) -> None:
        out = self._split_remote.remote(bundle.ref, idx, self._plan_ref)
        refs = list(out) if isinstance(out, (list, tuple)) else [out]
        # the LAST return seals last: its completion implies every sibling
        # partition ref of this map task is ready to probe and consume
        self._map_refs[refs[-1]] = (idx, refs, self.stats.on_task_submitted())

    # ------------------------------------------------------------ completions
    def active_refs(self) -> List[ObjectRef]:
        return list(self._sample_refs) + list(self._map_refs)

    def num_active_tasks(self) -> int:
        return len(self._sample_refs) + len(self._map_refs)

    def process_completions(self, ctx: ExecutionContext,
                            ready: Optional[List[ObjectRef]] = None) -> bool:
        if ready is None:
            refs = self.active_refs()
            ready, _ = ray_tpu_torch.wait(refs, num_returns=len(refs), timeout=0.05) \
                if refs else ([], [])
        progressed = False
        for ref in ready:
            if ref in self._sample_refs:
                idx, t0 = self._sample_refs.pop(ref)
                self._samples[idx] = ray_tpu_torch.get(ref)
                self.stats.on_task_finished(t0)
                progressed = True
            elif ref in self._map_refs:
                idx, refs, t0 = self._map_refs.pop(ref)
                sizes = ctx.probe_sizes(refs)
                self.coord.add_map_output(idx, refs, sizes)
                self.stats.on_task_finished(t0)
                self.stats.blocks_out += len(refs)
                self.stats.bytes_out += sum(s or 0 for s in sizes)
                self.stats.last_output_at = time.perf_counter()
                progressed = True
        if (self.all_inputs_done() and not self._buffered
                and self.coord.expected_maps is None
                and (self._plan_ready or self._next_idx == 0)):
            # every map task is launched: the reduce side now knows the
            # final partition-table height
            self.coord.expected_maps = self._next_idx
        return progressed

    def completed(self) -> bool:
        if self._finished:
            return True
        done = (self.all_inputs_done() and not self._buffered
                and not self._sample_refs and not self._map_refs)
        if done and self.coord.expected_maps is None:
            self.coord.expected_maps = self._next_idx
        return done

    def mark_finished(self) -> None:
        super().mark_finished()
        self._buffered.clear()
        if self.coord.expected_maps is None:
            self.coord.expected_maps = 0

    # ------------------------------------------------------ memory accounting
    def queued_output_bytes(self) -> int:
        # partition blocks are at rest in the store and spill under
        # pressure; charging them against the streaming budget would wedge
        # the pipeline (every map must run before ANY reduce can drain)
        return 0


class ShuffleReduceOp(PhysicalOperator):
    """Reduce-side pull scheduler: dispatches reduce task ``j`` over
    partition ``j`` of every map output once the table is complete and the
    spill-aware admission budget allows. Ordered head-of-line emission in
    reducer order keeps global sort order intact."""

    num_cpus = 1.0

    def __init__(self, spec: ShuffleSpec, coord: ShuffleCoordinator,
                 concurrency: Optional[int] = None):
        super().__init__(f"shuffle_reduce({spec.name})")
        from ray_tpu_torch.core.config import config

        self.spec = spec
        self.coord = coord
        self.n_out = coord.n_out
        self.concurrency_cap = concurrency or config.data_default_op_concurrency
        self._next_j = 0
        # (j, ref, t0) in dispatch (= reducer index) order
        self._pending: Deque[Tuple[int, ObjectRef, float]] = deque()
        self._done: Dict[int, Optional[int]] = {}  # j -> size, once finished
        self._by_ref: Dict[ObjectRef, Tuple[int, float]] = {}
        self._reduce_remote = None
        self.stats.extra = self.coord.stats

    def start(self, ctx: ExecutionContext) -> None:
        spec_reduce = self.spec.reduce_fn

        @ray_tpu_torch.remote(num_cpus=self.num_cpus, name=f"data::{self.name}")
        def reduce_task(j, *parts):
            return spec_reduce(j, *parts)

        self._reduce_remote = reduce_task

    # ------------------------------------------------------------- scheduling
    def can_dispatch(self) -> bool:
        if self._finished or self._next_j >= self.n_out:
            return False
        if not self.coord.maps_complete() or self.coord.num_maps == 0:
            return False
        return self.coord.admit(self._next_j)

    def dispatch(self, ctx: ExecutionContext) -> None:
        j = self._next_j
        self._next_j += 1
        refs = self.coord.partition_refs(j)
        ref = self._reduce_remote.remote(j, *refs)
        t0 = self.stats.on_task_submitted()
        self._pending.append((j, ref, t0))
        self._by_ref[ref] = (j, t0)

    # ------------------------------------------------------------ completions
    def active_refs(self) -> List[ObjectRef]:
        return list(self._by_ref)

    def num_active_tasks(self) -> int:
        # tracked-but-not-yet-emitted counts against the concurrency cap
        # (ordered emission: a straggling head-of-line reduce pauses
        # dispatches instead of piling finished outputs behind it)
        return len(self._pending)

    def process_completions(self, ctx: ExecutionContext,
                            ready: Optional[List[ObjectRef]] = None) -> bool:
        if ready is None:
            refs = list(self._by_ref)
            ready, _ = ray_tpu_torch.wait(refs, num_returns=len(refs), timeout=0.05) \
                if refs else ([], [])
        else:
            ready = [r for r in ready if r in self._by_ref]
        if ready:
            sizes = ctx.probe_sizes(ready)
            for ref, size in zip(ready, sizes):
                j, t0 = self._by_ref.pop(ref)
                self._done[j] = size
                self.stats.on_task_finished(t0)
                self.coord.mark_reduced(j)
        produced = False
        while self._pending and self._pending[0][0] in self._done:
            j, ref, _t0 = self._pending.popleft()
            if not self._finished:
                self._emit(RefBundle(ref, size_bytes=self._done[j]), ctx)
                produced = True
        return produced or bool(ready)

    def completed(self) -> bool:
        if self._finished:
            return True
        if not self._inputs_complete or not self.coord.maps_complete():
            return False
        if self.coord.num_maps == 0:
            return True
        return self._next_j >= self.n_out and not self._pending

    def shutdown(self) -> None:
        self.coord.finalize_metrics()

    # ------------------------------------------------------ memory accounting
    def internal_bytes(self) -> int:
        # an in-flight reduce holds its whole partition set plus its output:
        # charge the admitted sets so the ResourceManager sees exchange
        # bytes like any other operator's (satellite: no more budget bypass)
        inflight = [j for j, _r, _t in self._pending if j not in self._done]
        return sum(self.coord.partition_bytes(j) for j in inflight) + \
            len(inflight) * self.estimated_output_bytes_per_block()
