"""User profile events: spans that land on the cluster timeline.

Reference capability: src/ray/core_worker/profile_event.{h,cc} +
python/ray/_private/profiling.py:20-40 — `with ray.profiling.profile("x"):`
inside a task records a span shipped to the observability backend and
rendered by `ray timeline`. Here (own copy of ray_tpu.profiling): spans
buffer in the process; in the in-process runtime they flush into a local
span log when the task finishes (read back with ``local_spans()``), and in
a cluster worker they flush to the node agent (one RPC only when profiling
was used), whose dashboard merges them into the timeline.

    import ray_tpu_torch

    @ray_tpu_torch.remote
    def step():
        with ray_tpu_torch.profile("load"):
            ...
        with ray_tpu_torch.profile("compute", extra={"batch": 8}):
            ...
"""

from __future__ import annotations

import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Deque, Dict, List, Optional

# process-wide buffer: async actor methods record on the event-loop thread
# while the flush runs on an executor thread, so the buffer must NOT be
# thread-local. Bounded: an unflushed producer (local runtime, long-lived
# profiling loop, a serving engine's loop) can't grow memory without limit;
# a full buffer drops its oldest span and counts it (``dropped()``).
_MAX_PENDING = 20000
_spans: Deque[Dict[str, Any]] = deque(maxlen=_MAX_PENDING)
_dropped = 0
_lock = threading.Lock()
# local-runtime sink (no agent to ship to): bounded in-process span log
_local_runtime_spans: Deque[Dict[str, Any]] = deque(maxlen=_MAX_PENDING)


def _append(span: Dict[str, Any]) -> None:
    global _dropped
    with _lock:
        if len(_spans) == _MAX_PENDING:
            _dropped += 1
        _spans.append(span)


@contextmanager
def profile(name: str, extra: Optional[Dict[str, Any]] = None):
    """Record a named span for the cluster timeline."""
    start = time.time()
    try:
        yield
    finally:
        end = time.time()
        span: Dict[str, Any] = {"name": str(name), "start": start, "end": end}
        if extra:
            span["extra"] = {str(k): v for k, v in extra.items()}
        try:
            from ray_tpu_torch.core.worker import global_worker

            w = global_worker()
            task_id = getattr(w, "current_task_id", None)
            if task_id is not None:
                span["task_id"] = task_id.hex() if hasattr(task_id, "hex") \
                    else str(task_id)
        except Exception:  # noqa: BLE001 - outside a runtime
            pass
        _append(span)


def record_external_span(name: str, start: float, end: float,
                         extra: Optional[Dict[str, Any]] = None) -> None:
    """Record an already-timed span (the tracing bridge: util/tracing.py
    spans ride the same flush path to the agent/timeline; serve/llm.py's
    engine loop records its iterations and requests here)."""
    span: Dict[str, Any] = {"name": str(name), "start": start, "end": end}
    if extra:
        span["extra"] = {str(k): v for k, v in extra.items()}
    _append(span)


def drain() -> List[Dict[str, Any]]:
    """Take (and clear) every recorded span (worker/local flush paths)."""
    with _lock:
        out = list(_spans)
        _spans.clear()
    return out


def snapshot() -> List[Dict[str, Any]]:
    """Copy the pending spans, oldest first, without draining them."""
    with _lock:
        return list(_spans)


def dropped() -> int:
    """Spans dropped since the process started because the pending buffer
    was full (the oldest go first)."""
    return _dropped


def flush_local() -> None:
    """Local-runtime sink: move pending spans into the in-process log
    (read back with local_spans(); there is no agent to ship to)."""
    spans = drain()
    if spans:
        with _lock:
            _local_runtime_spans.extend(spans)


def local_spans() -> List[Dict[str, Any]]:
    with _lock:
        return list(_local_runtime_spans)
