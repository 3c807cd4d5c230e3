"""Execution-plane interfaces for the streaming Data executor.

Reference capability: python/ray/data/_internal/execution/interfaces/
(RefBundle, PhysicalOperator, ExecutionResources). A physical operator is a
node of the compiled DAG: it receives ``RefBundle``s from upstream, launches
(or performs) work, and exposes finished bundles through a bounded output
queue. Only ObjectRefs flow between operators — block data never rides the
driver unless an operator explicitly needs it (Limit slicing, stats rows).
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Callable, Deque, List, Optional

from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.data.execution.stats import OpStats


class RefBundle:
    """One block ref plus the metadata the scheduler needs (size for memory
    accounting, rows when known, output-split tag for streaming_split)."""

    __slots__ = ("ref", "size_bytes", "num_rows", "output_split_idx")

    def __init__(self, ref: ObjectRef, size_bytes: Optional[int] = None,
                 num_rows: Optional[int] = None,
                 output_split_idx: Optional[int] = None):
        self.ref = ref
        self.size_bytes = size_bytes
        self.num_rows = num_rows
        self.output_split_idx = output_split_idx

    def size_or(self, default: int) -> int:
        return self.size_bytes if self.size_bytes is not None else default


class ReadTaskSource:
    """A datasource compiled to independent read tasks (reference:
    planner/plan_read_op.py). Each thunk produces ONE block in a remote
    worker; the InputData operator owns submission pacing, so a 10k-file
    read never floods the cluster ahead of the consumer."""

    def __init__(self, make_tasks: List[Callable[[], Any]], name: str):
        self.make_tasks = make_tasks
        self.name = name

    def __len__(self) -> int:
        return len(self.make_tasks)


class PhysicalOperator:
    """Base physical operator. Subclasses implement dispatch/completion.

    Lifecycle: the executor moves bundles edge-to-edge (``add_input``),
    asks ``can_dispatch``/``dispatch`` to launch one unit of work at a time
    (the select_operator_to_run contract), polls ``process_completions``,
    and drains ``take_output``. ``mark_finished`` short-circuits the op when
    a downstream Limit is satisfied."""

    def __init__(self, name: str):
        self.name = name
        self.stats = OpStats(name)
        self.input_queue: Deque[RefBundle] = deque()
        self.output_queue: Deque[RefBundle] = deque()
        self.downstream: Optional["PhysicalOperator"] = None
        self.concurrency_cap: Optional[int] = None
        # participates in the ResourceManager's memory reservation + the
        # can_submit gate. Default: ops that launch remote tasks. Exchange
        # ops (AllToAll, shuffle reduce) opt in explicitly even when their
        # task accounting differs — their materialized outputs must not
        # bypass the budget every other operator honors.
        self.budget_participates: Optional[bool] = None
        self._inputs_complete = False
        self._finished = False  # short-circuit (Limit) or fully drained
        self._avg_out_bytes: Optional[float] = None

    # ---------------------------------------------------------------- wiring
    def start(self, ctx: "ExecutionContext") -> None:  # noqa: B027
        """One-time setup (remote fn/actor pool construction)."""

    def add_input(self, bundle: RefBundle) -> None:
        self.input_queue.append(bundle)
        self.stats.blocks_in += 1
        self.stats.bytes_in += bundle.size_or(0)
        self.stats.observe_queue(len(self.input_queue))

    def inputs_complete(self) -> None:
        self._inputs_complete = True

    def all_inputs_done(self) -> bool:
        return self._inputs_complete and not self.input_queue

    # ------------------------------------------------------------ scheduling
    def in_memory_budget(self) -> bool:
        """Resolved budget participation (``budget_participates`` wins when
        set; else: launches remote tasks <=> has a concurrency cap)."""
        if self.budget_participates is not None:
            return self.budget_participates
        return self.concurrency_cap is not None

    def can_dispatch(self) -> bool:
        """Work is available to launch right now (ignoring backpressure —
        policies and the ResourceManager gate the actual selection)."""
        return bool(self.input_queue)

    def dispatch(self, ctx: "ExecutionContext") -> None:
        raise NotImplementedError

    def active_refs(self) -> List[ObjectRef]:
        """In-flight task refs (for the executor's blocking wait)."""
        return []

    def num_active_tasks(self) -> int:
        return len(self.active_refs())

    def process_completions(self, ctx: "ExecutionContext",
                            ready: Optional[List["ObjectRef"]] = None) -> bool:
        """Harvest finished work into the output queue (non-blocking).
        ``ready``: refs the executor already observed complete this tick.
        Returns True if anything was produced."""
        return False

    def completed(self) -> bool:
        return self._finished or (
            self.all_inputs_done() and self.num_active_tasks() == 0
        )

    def mark_finished(self) -> None:
        """Downstream no longer needs outputs (Limit satisfied): drop queued
        input and stop dispatching. In-flight tasks finish in the background
        and are discarded."""
        self._finished = True
        self.input_queue.clear()
        self.output_queue.clear()

    def shutdown(self) -> None:  # noqa: B027
        """Release operator-owned resources (actor pools)."""

    # ------------------------------------------------------------- emit path
    def _emit(self, bundle: RefBundle, ctx: "ExecutionContext") -> None:
        if self._finished:
            return
        if bundle.size_bytes is not None:
            n = self.stats.blocks_out
            prev = self._avg_out_bytes if self._avg_out_bytes is not None else 0.0
            self._avg_out_bytes = (prev * n + bundle.size_bytes) / (n + 1)
        if ctx.collect_rows and bundle.num_rows is None:
            try:
                import ray_tpu_torch

                bundle.num_rows = ray_tpu_torch.get(bundle.ref).num_rows
            except Exception:  # noqa: BLE001 - stats must not fail the run
                pass
        self.output_queue.append(bundle)
        self.stats.blocks_out += 1
        self.stats.bytes_out += bundle.size_or(0)
        if bundle.num_rows:
            self.stats.rows_out += bundle.num_rows
        self.stats.last_output_at = time.perf_counter()

    # ------------------------------------------------------ memory accounting
    def estimated_output_bytes_per_block(self) -> int:
        if self._avg_out_bytes:
            return int(self._avg_out_bytes)
        if self.stats.blocks_in:
            return max(1, self.stats.bytes_in // self.stats.blocks_in)
        return 1 << 20  # nothing observed yet: assume 1 MiB blocks

    def internal_bytes(self) -> int:
        """Bytes this op holds outside the queues: in-flight task outputs,
        estimated from observed output sizes."""
        return self.num_active_tasks() * self.estimated_output_bytes_per_block()

    def queued_output_bytes(self) -> int:
        """Bytes this op has produced that nobody consumed yet: its own
        output queue plus what sits in the downstream input queue."""
        total = sum(b.size_or(self.estimated_output_bytes_per_block())
                    for b in self.output_queue)
        if self.downstream is not None:
            total += sum(
                b.size_or(self.estimated_output_bytes_per_block())
                for b in self.downstream.input_queue)
        return total

    def __repr__(self) -> str:
        return (f"{type(self).__name__}({self.name!r}, active="
                f"{self.num_active_tasks()}, in={len(self.input_queue)}, "
                f"out={len(self.output_queue)})")


class ExecutionContext:
    """Shared per-execution state handed to operators."""

    def __init__(self, collect_rows: bool = False):
        self.collect_rows = collect_rows
        self._runtime = None

    @property
    def runtime(self):
        if self._runtime is None:
            from ray_tpu_torch import api as _api

            self._runtime = _api.global_worker().runtime
        return self._runtime

    def probe_sizes(self, refs: List[ObjectRef]) -> List[Optional[int]]:
        """Batched stored-size lookup (one control RPC per completion batch,
        not one per block)."""
        try:
            return self.runtime.object_sizes(refs)
        except Exception:  # noqa: BLE001 - hints only; never fail the run
            return [None] * len(refs)
