"""Host-memory monitor and OOM worker-killing policy.

Protects a node from a runaway task eating host RAM: the agent polls kernel
memory state and, above a usage threshold, kills the worker whose task is
cheapest to sacrifice — retriable tasks first, newest first — surfacing a
typed ``OutOfMemoryError`` to the caller instead of letting the kernel OOM
killer take down the whole node agent.

Equivalent capability to the reference's MemoryMonitor
(reference: src/ray/common/memory_monitor.h:52 — cgroup/proc polling with a
usage-fraction threshold) and its retriable-FIFO kill policy
(reference: src/ray/raylet/worker_killing_policy_retriable_fifo.h — "retriable
last-started first" victim ordering). Redesigned for the asyncio agent: the
monitor is a coroutine on the agent's loop and the kill is a plain SIGKILL on
the leased worker process; cleanup rides the existing worker-death path.
"""

from __future__ import annotations

import os
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ray_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

_PAGE = os.sysconf("SC_PAGE_SIZE") if hasattr(os, "sysconf") else 4096


def read_host_memory() -> Tuple[int, int]:
    """(total_bytes, available_bytes) from /proc/meminfo.

    MemAvailable is the kernel's estimate of allocatable memory without
    swapping — the same signal the reference reads (memory_monitor.cc
    GetLinuxMemoryBytes)."""
    total = available = 0
    with open("/proc/meminfo", "rb") as f:
        for line in f:
            if line.startswith(b"MemTotal:"):
                total = int(line.split()[1]) * 1024
            elif line.startswith(b"MemAvailable:"):
                available = int(line.split()[1]) * 1024
            if total and available:
                break
    return total, available


def process_rss_bytes(pid: int) -> int:
    """Resident set size of one process (0 if it is gone)."""
    try:
        with open(f"/proc/{pid}/statm", "rb") as f:
            return int(f.read().split()[1]) * _PAGE
    except (OSError, ValueError, IndexError):
        return 0


def choose_victim(candidates: List[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    """Retriable-FIFO policy: prefer killing a task that can be retried, and
    among equals the one started most recently (it has lost the least work).
    Each candidate: {"retriable": bool, "started_at": float, ...}."""
    if not candidates:
        return None
    return sorted(
        candidates,
        key=lambda c: (not c.get("retriable", False), -c.get("started_at", 0.0)),
    )[0]


class MemoryMonitor:
    """Threshold detector with injectable readers (tests fake the kernel).

    ``on_pressure(usage_fraction, total, available)`` fires each poll tick
    while memory is above threshold; the owner decides whom to kill.
    """

    def __init__(
        self,
        threshold_fraction: float,
        min_free_bytes: int = -1,
        read_memory: Callable[[], Tuple[int, int]] = read_host_memory,
    ):
        self.threshold_fraction = threshold_fraction
        self.min_free_bytes = min_free_bytes
        self._read_memory = read_memory

    def check(self) -> Optional[Dict[str, Any]]:
        """Returns a pressure report when above threshold, else None."""
        total, available = self._read_memory()
        if total <= 0:
            return None
        used_fraction = 1.0 - available / total
        over_fraction = used_fraction > self.threshold_fraction
        over_floor = self.min_free_bytes >= 0 and available < self.min_free_bytes
        if not (over_fraction or over_floor):
            return None
        return {
            "total": total,
            "available": available,
            "used_fraction": used_fraction,
            "threshold": self.threshold_fraction,
            "ts": time.time(),
        }


def format_oom_message(report: Dict[str, Any], task_name: str, rss: int) -> str:
    gib = 1024.0**3
    return (
        f"Task {task_name} was killed by the node memory monitor: host memory "
        f"usage {report['used_fraction']:.1%} exceeded the threshold "
        f"{report['threshold']:.1%} "
        f"({(report['total'] - report['available']) / gib:.2f}/"
        f"{report['total'] / gib:.2f} GiB used); this worker's RSS was "
        f"{rss / gib:.2f} GiB. The task was chosen because it is the most "
        f"recently started retriable work on the node (retriable-FIFO "
        f"policy). Reduce per-task memory use, or lower parallelism, or "
        f"raise RAY_TPU_MEMORY_USAGE_THRESHOLD."
    )
