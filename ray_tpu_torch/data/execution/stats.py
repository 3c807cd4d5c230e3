"""Per-operator execution statistics (reference: _internal/stats.py
DatasetStats / OpRuntimeMetrics). Collected at the operator boundaries the
scheduling loop already owns, so recording costs a few counter bumps per
block, not extra RPCs."""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional


class OpStats:
    """Counters for one physical operator."""

    def __init__(self, name: str):
        self.name = name
        self.blocks_in = 0
        self.blocks_out = 0
        self.bytes_in = 0
        self.bytes_out = 0
        self.rows_out = 0
        self.tasks_submitted = 0
        self.tasks_finished = 0
        # sum of per-task (completion - submission) wall, driver-observed
        self.task_time_s = 0.0
        self.first_dispatch_at: Optional[float] = None
        self.last_output_at: Optional[float] = None
        self.queue_peak = 0      # input-queue occupancy high-water mark
        self.in_flight_peak = 0  # concurrent-task high-water mark
        # operator-specific counters (e.g. a shuffle's exchange bytes,
        # spill bytes, admission stalls) rendered as a supplementary line
        self.extra: Dict[str, Any] = {}

    def observe_queue(self, depth: int) -> None:
        if depth > self.queue_peak:
            self.queue_peak = depth

    def observe_in_flight(self, n: int) -> None:
        if n > self.in_flight_peak:
            self.in_flight_peak = n

    def on_task_submitted(self) -> float:
        self.tasks_submitted += 1
        if self.first_dispatch_at is None:
            self.first_dispatch_at = time.perf_counter()
        return time.perf_counter()

    def on_task_finished(self, submitted_at: float) -> None:
        self.tasks_finished += 1
        self.task_time_s += time.perf_counter() - submitted_at

    @property
    def wall_s(self) -> float:
        """Operator-active wall span: first dispatch to last output."""
        if self.first_dispatch_at is None:
            return 0.0
        end = self.last_output_at or time.perf_counter()
        return max(0.0, end - self.first_dispatch_at)

    def row(self) -> Dict[str, Any]:
        out = {
            "operator": self.name,
            "blocks_in": self.blocks_in,
            "blocks_out": self.blocks_out,
            "bytes_out": self.bytes_out,
            "rows": self.rows_out,
            "tasks": self.tasks_finished,
            "task_s": round(self.task_time_s, 4),
            "wall_s": round(self.wall_s, 4),
            "queue_peak": self.queue_peak,
            "in_flight_peak": self.in_flight_peak,
        }
        if self.extra:
            out["extra"] = dict(self.extra)
        return out


def format_stats_table(rows: List[Dict[str, Any]],
                       collect_rows: bool = True) -> str:
    header = (f"{'operator':<32}{'in':>6}{'out':>6}{'bytes_out':>12}"
              f"{'rows':>8}{'task_s':>9}{'wall_s':>9}{'queue^':>7}{'tasks^':>7}")
    lines = [header]
    for r in rows:
        lines.append(
            f"{r['operator'][:31]:<32}{r['blocks_in']:>6}{r['blocks_out']:>6}"
            f"{r['bytes_out']:>12}"
            f"{(r['rows'] if collect_rows else '-'):>8}"
            f"{r['task_s']:>9}{r['wall_s']:>9}"
            f"{r['queue_peak']:>7}{r['in_flight_peak']:>7}")
        extra = r.get("extra")
        if extra:
            detail = ", ".join(
                f"{k}={round(v, 3) if isinstance(v, float) else v}"
                for k, v in extra.items())
            lines.append(f"  └ {detail}")
    return "\n".join(lines)
