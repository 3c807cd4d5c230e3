"""Pluggable backpressure policies (reference: _internal/execution/
backpressure_policy/ — ConcurrencyCapBackpressurePolicy +
DownstreamCapacityBackpressurePolicy). A policy answers one question per
scheduling step: may this operator launch another task right now?

Both built-ins are on by default: the concurrency cap bounds how many tasks
one operator keeps in flight, and the downstream-capacity policy stops a
producer whose consumer is falling behind (queue depth in blocks AND bytes),
so a slow stage throttles its upstream instead of ballooning the block
queues."""

from __future__ import annotations

from typing import List

from ray_tpu_torch.data.execution.interfaces import PhysicalOperator


class BackpressurePolicy:
    def can_add_input(self, op: PhysicalOperator) -> bool:
        raise NotImplementedError


class ConcurrencyCapBackpressurePolicy(BackpressurePolicy):
    """At most ``op.concurrency_cap`` tasks in flight per operator (ops with
    no cap — driver-side pass-throughs — are unthrottled here)."""

    def can_add_input(self, op: PhysicalOperator) -> bool:
        cap = op.concurrency_cap
        return cap is None or op.num_active_tasks() < cap


class DownstreamCapacityBackpressurePolicy(BackpressurePolicy):
    """Stop dispatching when the operator's un-consumed output — its output
    queue plus the downstream input queue — exceeds the configured block
    count or the operator's share of the memory budget."""

    def __init__(self, max_queued_blocks: int = 0,
                 max_queued_bytes: int = 0):
        from ray_tpu_torch.core.config import config

        self.max_queued_blocks = max_queued_blocks \
            or config.data_max_queued_blocks
        self.max_queued_bytes = max_queued_bytes or int(
            config.object_store_memory_bytes * config.data_memory_fraction)

    def can_add_input(self, op: PhysicalOperator) -> bool:
        queued_blocks = len(op.output_queue)
        if op.downstream is not None:
            queued_blocks += len(op.downstream.input_queue)
        if queued_blocks >= self.max_queued_blocks:
            return False
        return op.queued_output_bytes() < self.max_queued_bytes


def default_policies() -> List[BackpressurePolicy]:
    return [ConcurrencyCapBackpressurePolicy(),
            DownstreamCapacityBackpressurePolicy()]
