"""Per-operator resource budgets (reference: _internal/execution/
resource_manager.py ReservationOpResourceAllocator).

The global Data budget is a fraction of the object-store capacity
(``config.data_memory_fraction``) plus the cluster CPU total. Half the
memory budget is RESERVED, split evenly across budget-participating
operators — so a fast producer can never starve a slow consumer of its
guaranteed headroom; the other half is a SHARED pool claimed first-come.
An operator with nothing in flight may always launch one task (liveness:
a budget must throttle, never deadlock)."""

from __future__ import annotations

from typing import Dict, List, Optional

from ray_tpu_torch.data.execution.interfaces import PhysicalOperator


class ResourceManager:
    def __init__(self, operators: List[PhysicalOperator],
                 memory_budget_bytes: Optional[int] = None,
                 cpu_total: Optional[float] = None):
        from ray_tpu_torch.core.config import config

        self._ops = operators
        self.memory_budget = memory_budget_bytes if memory_budget_bytes \
            is not None else int(config.object_store_memory_bytes
                                 * config.data_memory_fraction)
        self.cpu_total = cpu_total if cpu_total is not None \
            else self._detect_cpu_total()
        # only ops that materialize blocks participate in the reservation;
        # pass-through ops (Limit, OutputSplit) hold no task memory. Exchange
        # ops (AllToAll, shuffle) opt in via budget_participates even though
        # their task model differs — their outputs must not bypass the
        # accounting that backpressures every other operator.
        budgeted = [op for op in operators if op.in_memory_budget()] \
            or list(operators)
        self._reserved: Dict[int, int] = {
            id(op): self.memory_budget // (2 * len(budgeted)) for op in budgeted
        }
        self._shared_total = self.memory_budget - sum(self._reserved.values())

    @staticmethod
    def _detect_cpu_total() -> float:
        try:
            from ray_tpu_torch import api as _api

            return float(_api.cluster_resources().get("CPU", 0)) or 1.0
        except Exception:  # noqa: BLE001 - uninitialized runtime (tests)
            import os

            return float(os.cpu_count() or 1)

    # ------------------------------------------------------------- accounting
    def op_usage_bytes(self, op: PhysicalOperator) -> int:
        """An operator is charged for what it has MATERIALIZED but nobody
        consumed: in-flight task outputs (estimated) + its output queue +
        the downstream input queue it filled."""
        return op.internal_bytes() + op.queued_output_bytes()

    def global_usage_bytes(self) -> int:
        return sum(self.op_usage_bytes(op) for op in self._ops)

    def cpus_in_flight(self) -> float:
        return sum(
            op.num_active_tasks() * getattr(op, "num_cpus", 1.0)
            for op in self._ops
        )

    # -------------------------------------------------------------- decisions
    def can_submit(self, op: PhysicalOperator) -> bool:
        if op.num_active_tasks() == 0 and not op.output_queue:
            return True  # liveness valve: one task per starved op always runs
        # CPU: never queue more tasks than the cluster can run concurrently
        # (oversubscribing buys queueing, not throughput)
        if self.cpus_in_flight() + getattr(op, "num_cpus", 1.0) > self.cpu_total:
            return False
        projected = (self.op_usage_bytes(op)
                     + op.estimated_output_bytes_per_block())
        reserved = self._reserved.get(id(op), 0)
        if projected <= reserved:
            return True
        shared_used = sum(
            max(0, self.op_usage_bytes(o) - self._reserved.get(id(o), 0))
            for o in self._ops
        )
        return projected - reserved <= self._shared_total - shared_used

    def debug(self) -> Dict[str, int]:
        return {
            "memory_budget": self.memory_budget,
            "memory_used": self.global_usage_bytes(),
            "cpu_total": int(self.cpu_total),
            "cpus_in_flight": int(self.cpus_in_flight()),
        }
