"""Pull-based scheduling loop over the physical operator DAG.

Reference capability: python/ray/data/_internal/execution/
streaming_executor.py (:48, loop :272) + streaming_executor_state.py:527
``select_operator_to_run``. Each turn of the loop:

1. harvests finished tasks into operator output queues,
2. moves bundles along the edges (bounded, byte-accounted block queues),
3. repeatedly picks ONE runnable operator — filtered through the
   backpressure policies and the ResourceManager budgets, ranked by least
   un-consumed output (drain toward the sink) — and dispatches one unit of
   work,
4. yields terminal bundles to the consumer.

The executor is a generator: while the consumer is not pulling, nothing new
dispatches, so a stalled consumer freezes the pipeline at its current
(bounded) occupancy instead of buffering the world. A slow operator's full
queues make the policies reject its upstream — backpressure propagates to
the source, which stops submitting read tasks."""

from __future__ import annotations

import time
from typing import Iterator, List, Optional

import ray_tpu_torch
from ray_tpu_torch.data.execution.backpressure import (
    BackpressurePolicy,
    default_policies,
)
from ray_tpu_torch.data.execution.interfaces import (
    ExecutionContext,
    PhysicalOperator,
    RefBundle,
)
from ray_tpu_torch.data.execution.resource_manager import ResourceManager
from ray_tpu_torch.data.execution.stats import format_stats_table
from ray_tpu_torch.utils.logging import get_logger

logger = get_logger("data.streaming_executor")

# per-tick dispatch bound: a safety valve against a buggy operator that
# always claims dispatchability without making progress
_MAX_DISPATCHES_PER_TICK = 256


class StreamingExecutor:
    def __init__(self, operators: List[PhysicalOperator],
                 collect_rows: bool = False,
                 resource_manager: Optional[ResourceManager] = None,
                 policies: Optional[List[BackpressurePolicy]] = None):
        if not operators:
            raise ValueError("streaming executor needs at least one operator")
        self._ops = operators
        self._index = {id(op): i for i, op in enumerate(operators)}
        for up, down in zip(operators, operators[1:]):
            up.downstream = down
        self._ctx = ExecutionContext(collect_rows=collect_rows)
        self._rm = resource_manager or ResourceManager(operators)
        self._policies = policies if policies is not None else default_policies()
        self.collect_rows = collect_rows
        # high-water mark of blocks alive anywhere in the pipeline
        # (in-flight tasks + queued): the number the backpressure tests and
        # the bench artifact watch
        self.peak_total_blocks = 0
        self._consumed = False

    # ------------------------------------------------------------- execution
    def execute(self) -> Iterator[RefBundle]:
        for op in self._ops:
            op.start(self._ctx)
        last = self._ops[-1]
        try:
            discovered = None
            while True:
                progressed = self._tick(discovered)
                discovered = None
                while last.output_queue:
                    self._consumed = True
                    yield last.output_queue.popleft()
                if self._all_done():
                    return
                if not progressed and not last.output_queue:
                    if not self._liveness_valve():
                        discovered = self._wait_for_any()
        finally:
            for op in self._ops:
                try:
                    op.shutdown()
                except Exception:  # noqa: BLE001 - teardown must not mask
                    logger.exception("operator %s shutdown failed", op.name)

    def _tick(self, discovered=None) -> bool:
        progressed = False
        # ONE wait across every operator's in-flight refs per tick.
        # ``discovered`` carries refs the blocking _wait_for_any already saw
        # complete — crucial in cluster mode, where a zero-timeout wait only
        # reports the DRIVER node's store and would never observe tasks that
        # finished on other nodes (their readiness signal is the GCS
        # location directory, consulted only by positive-timeout waits).
        ready_set = set(discovered or ())
        all_refs = [r for op in self._ops for r in op.active_refs()]
        if all_refs and not ready_set:
            ready, _ = ray_tpu_torch.wait(all_refs, num_returns=len(all_refs),
                                    timeout=0)
            ready_set.update(ready)
        for op in self._ops:
            if op.active_refs() and op.process_completions(
                    self._ctx, ready=[r for r in op.active_refs()
                                      if r in ready_set]):
                progressed = True
        progressed |= self._move_edges()
        for _ in range(_MAX_DISPATCHES_PER_TICK):
            op = self._select_operator_to_run()
            if op is None:
                break
            before = (op.num_active_tasks(), len(op.output_queue),
                      len(op.input_queue))
            op.dispatch(self._ctx)
            op.stats.observe_in_flight(op.num_active_tasks())
            after = (op.num_active_tasks(), len(op.output_queue),
                     len(op.input_queue))
            self._move_edges()
            self._observe_occupancy()
            if after == before:
                # a dispatch that did nothing (exhausted iterator source):
                # don't spin on it this tick
                break
            progressed = True
        progressed |= self._short_circuit_limits()
        self._observe_occupancy()
        return progressed

    def _move_edges(self) -> bool:
        moved = False
        for op in self._ops:
            down = op.downstream
            if down is None:
                continue
            while op.output_queue:
                down.add_input(op.output_queue.popleft())
                moved = True
            if (op.completed() and not op.output_queue
                    and not down._inputs_complete):  # noqa: SLF001
                down.inputs_complete()
                moved = True
        return moved

    def _select_operator_to_run(self) -> Optional[PhysicalOperator]:
        candidates = []
        for op in self._ops:
            if op._finished or not op.can_dispatch():  # noqa: SLF001
                continue
            if not all(p.can_add_input(op) for p in self._policies):
                continue
            if op.in_memory_budget() and not self._rm.can_submit(op):
                continue
            candidates.append(op)
        if not candidates:
            return None
        # least un-consumed output first; ties drain toward the sink
        return min(
            candidates,
            key=lambda op: (
                len(op.output_queue)
                + (len(op.downstream.input_queue) if op.downstream else 0),
                -self._index[id(op)],
            ),
        )

    def _short_circuit_limits(self) -> bool:
        changed = False
        for i, op in enumerate(self._ops):
            if getattr(op, "short_circuit", False):
                for up in self._ops[:i]:
                    if not up._finished:  # noqa: SLF001
                        up.mark_finished()
                        changed = True
        return changed

    def _liveness_valve(self) -> bool:
        """Deadlock breaker: when every policy rejects every operator and
        NOTHING is in flight, force one dispatch on the first op with work.
        (E.g. an exchange whose output count equals the queue cap needs one
        more pull to observe exhaustion — a budget must throttle, never
        wedge the pipeline.)"""
        if any(op.active_refs() for op in self._ops):
            return False
        forced = next(
            (op for op in self._ops
             if not op._finished and op.can_dispatch()),  # noqa: SLF001
            None,
        )
        if forced is None:
            return False
        forced.dispatch(self._ctx)
        self._move_edges()
        self._observe_occupancy()
        return True

    def _observe_occupancy(self) -> None:
        total = 0
        for op in self._ops:
            total += (op.num_active_tasks() + len(op.input_queue)
                      + len(op.output_queue))
        if total > self.peak_total_blocks:
            self.peak_total_blocks = total

    def _all_done(self) -> bool:
        last = self._ops[-1]
        return last.completed() and not last.output_queue and not any(
            op.num_active_tasks() for op in self._ops
        )

    def _wait_for_any(self):
        # BLOCKING wait, not a poll: in cluster mode every wait() is a
        # control RPC, and a 100ms poll loop both spams the agents and (on
        # small hosts) starves the very workers it is waiting on. Nothing
        # new becomes dispatchable until a task completes, so parking here
        # is free; the bounded timeout is only a liveness net. Returns the
        # refs observed ready so the next tick can act on them — in cluster
        # mode this is the ONLY reliable completion signal for tasks that
        # ran on other nodes.
        refs = [r for op in self._ops for r in op.active_refs()]
        if refs:
            ready, _ = ray_tpu_torch.wait(refs, num_returns=1, timeout=5.0)
            return ready or None
        time.sleep(0.01)
        return None

    # ------------------------------------------------------------------ stats
    @property
    def stats(self):
        return [op.stats for op in self._ops]

    def stats_rows(self) -> List[dict]:
        return [op.stats.row() for op in self._ops]

    def summary(self) -> str:
        return format_stats_table(self.stats_rows(),
                                  collect_rows=self.collect_rows)

    def any_output_produced(self) -> bool:
        return any(st.blocks_out for st in self.stats)
