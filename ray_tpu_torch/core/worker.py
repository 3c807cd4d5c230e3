"""Per-process worker state: runtime handle, reference counting, task context
(own copy of ray_tpu.core.worker: a process that imports both packages holds
one ``Worker`` of each, each set by its own package's ``init``).

Capability-equivalent of the reference's CoreWorker + ReferenceCounter
(reference: src/ray/core_worker/core_worker.h:271, reference_count.h:64):
every process that touches the API — driver or worker — holds exactly one
``Worker`` with:

- the runtime backend (the in-process LocalRuntime or a cluster client),
- a reference counter tracking local refs, borrowed refs and
  pending-task argument refs; when an object's count reaches zero the
  runtime is told to release it (eviction eligibility / owner bookkeeping),
- a thread-local execution context (current task/actor id, put counter) so
  ``put()`` inside a task derives lineage-correct ObjectIDs.
"""

from __future__ import annotations

import threading
from collections import defaultdict
from typing import Dict, List, Optional, TYPE_CHECKING

from ray_tpu_torch.core.ids import ActorID, JobID, NodeID, ObjectID, TaskID, WorkerID

if TYPE_CHECKING:
    from ray_tpu_torch.core.object_ref import ObjectRef
    from ray_tpu_torch.core.runtime import CoreRuntime


class ReferenceCounter:
    """Tracks why each object id is still alive in this process.

    Counts: local (ObjectRef instances alive in this interpreter), borrowed
    (refs deserialized out of other objects/args), submitted (pending tasks
    that take the object as an argument)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._local: Dict[ObjectID, int] = defaultdict(int)
        self._submitted: Dict[ObjectID, int] = defaultdict(int)
        self._borrowed: Dict[ObjectID, bool] = {}
        self._on_zero = None  # callback(ObjectID)

    def set_on_zero(self, cb) -> None:
        self._on_zero = cb

    def add_local(self, oid: ObjectID, borrowed: bool = False) -> None:
        with self._lock:
            self._local[oid] += 1
            if borrowed:
                self._borrowed[oid] = True

    def remove_local(self, oid: ObjectID) -> None:
        fire = False
        with self._lock:
            self._local[oid] -= 1
            if self._local[oid] <= 0:
                del self._local[oid]
                self._borrowed.pop(oid, None)
                if self._submitted.get(oid, 0) <= 0:
                    self._submitted.pop(oid, None)
                    fire = True
        if fire and self._on_zero is not None:
            self._on_zero(oid)

    def live_ids(self) -> List[str]:
        """Hex ids of every object this process still holds (local refs or
        pending submissions) — what a GCS-restart catch-up re-asserts."""
        with self._lock:
            return [oid.hex() for oid in
                    set(self._local) | set(self._submitted)]

    def add_submitted(self, oid: ObjectID) -> None:
        with self._lock:
            self._submitted[oid] += 1

    def remove_submitted(self, oid: ObjectID) -> None:
        fire = False
        with self._lock:
            self._submitted[oid] -= 1
            if self._submitted[oid] <= 0:
                del self._submitted[oid]
                if self._local.get(oid, 0) <= 0:
                    fire = True
        if fire and self._on_zero is not None:
            self._on_zero(oid)

    def count(self, oid: ObjectID) -> int:
        with self._lock:
            return self._local.get(oid, 0) + self._submitted.get(oid, 0)

    def alive_ids(self):
        with self._lock:
            return set(self._local) | set(self._submitted)


class _TaskCtx:
    __slots__ = ("task_id", "actor_id", "task_name", "put_index", "attempt")

    def __init__(
        self,
        task_id: Optional[TaskID] = None,
        actor_id: Optional[ActorID] = None,
        task_name: str = "",
        attempt: int = 0,
    ) -> None:
        self.task_id = task_id
        self.actor_id = actor_id
        self.task_name = task_name
        self.put_index = 0
        self.attempt = attempt


# contextvars (not threading.local): async actor calls interleave many logical
# tasks on one event-loop thread, and each asyncio task gets its own Context,
# so per-call execution context stays isolated in both thread and coroutine
# execution models.
import contextvars

_task_ctx: "contextvars.ContextVar[Optional[_TaskCtx]]" = contextvars.ContextVar(
    "ray_tpu_task_ctx", default=None
)


class Worker:
    def __init__(
        self,
        runtime: "CoreRuntime",
        job_id: JobID,
        worker_id: Optional[WorkerID] = None,
        node_id: Optional[NodeID] = None,
        is_driver: bool = True,
    ) -> None:
        self.runtime = runtime
        self.job_id = job_id
        self.worker_id = worker_id or WorkerID.from_random()
        self.node_id = node_id or NodeID.nil()
        self.is_driver = is_driver
        self.ref_counter = ReferenceCounter()
        self._driver_task_id = TaskID.for_driver(job_id)
        self._put_lock = threading.Lock()
        self._driver_put_index = 0

    # --- execution context -------------------------------------------------
    def set_task_context(
        self,
        task_id: Optional[TaskID],
        actor_id: Optional[ActorID] = None,
        task_name: str = "",
        attempt: int = 0,
    ) -> None:
        if task_id is None:
            _task_ctx.set(None)
        else:
            _task_ctx.set(_TaskCtx(task_id, actor_id, task_name, attempt))

    @property
    def current_task_id(self) -> TaskID:
        ctx = _task_ctx.get()
        return ctx.task_id if ctx is not None else self._driver_task_id

    @property
    def current_actor_id(self) -> Optional[ActorID]:
        ctx = _task_ctx.get()
        return ctx.actor_id if ctx is not None else None

    @property
    def current_task_name(self) -> str:
        ctx = _task_ctx.get()
        return ctx.task_name if ctx is not None else ""

    def next_put_id(self) -> ObjectID:
        ctx = _task_ctx.get()
        if ctx is not None and ctx.task_id is not None:
            ctx.put_index += 1
            return ObjectID.for_put(ctx.task_id, ctx.put_index)
        with self._put_lock:
            self._driver_put_index += 1
            return ObjectID.for_put(self._driver_task_id, self._driver_put_index)

    # --- reference counting -------------------------------------------------
    def add_local_ref(self, oid: ObjectID, borrowed: bool = False) -> None:
        self.ref_counter.add_local(oid, borrowed=borrowed)

    def remove_local_ref(self, oid: ObjectID) -> None:
        self.ref_counter.remove_local(oid)


_global_worker: Optional[Worker] = None
_global_lock = threading.Lock()

# ---------------------------------------------------------------------------
# Deferred-release drain: ObjectRef.__del__ may fire mid-GC while this very
# thread holds the ref-counter/store lock, so it only appends the id to
# object_ref._PENDING_RELEASES (lock-free). This thread applies the releases
# OUTSIDE any caller's critical section (see object_ref.py module comment —
# this closed the r4 monolithic-suite deadlock).
# ---------------------------------------------------------------------------
_drain_started = False


def drain_deferred_releases(max_items: int = 100_000) -> int:
    """Apply queued __del__ releases now. Called by the background drain
    thread; also useful in tests that assert prompt frees."""
    from ray_tpu_torch.core.object_ref import _PENDING_RELEASES

    w = _global_worker
    n = 0
    while n < max_items:
        try:
            oid = _PENDING_RELEASES.popleft()
        except IndexError:
            break
        n += 1
        if w is None:
            continue  # shutdown raced: nothing to release against
        try:
            w.ref_counter.remove_local(oid)
        except Exception:  # noqa: BLE001 - releases are best-effort
            pass
    return n


def _drain_loop() -> None:
    import time

    while True:
        time.sleep(0.05)
        try:
            drain_deferred_releases()
        except Exception:  # noqa: BLE001 - the drain must never die
            pass


def _ensure_drain_thread() -> None:
    global _drain_started
    with _global_lock:
        if _drain_started:
            return
        _drain_started = True
    threading.Thread(target=_drain_loop, daemon=True,
                     name="ref-release-drain").start()


def global_worker() -> Optional[Worker]:
    return _global_worker


def require_worker() -> Worker:
    w = _global_worker
    if w is None:
        raise RuntimeError("ray_tpu_torch.init() has not been called in this process")
    return w


def set_global_worker(worker: Optional[Worker]) -> None:
    global _global_worker
    if worker is None:
        # shutdown: apply releases against the OUTGOING worker first, so a
        # shutdown-then-init sequence can't leak them onto the next runtime
        try:
            drain_deferred_releases()
        except Exception:  # noqa: BLE001
            pass
    with _global_lock:
        _global_worker = worker
    if worker is not None:
        _ensure_drain_thread()


def maybe_register_borrowed_ref(ref: "ObjectRef") -> None:
    """Called by the deserializer when an ObjectRef is reconstructed out of a
    containing object — the borrowing hook (reference:
    reference_count.h AddBorrowedObject)."""
    # ObjectRef.__init__ already added the local ref with borrowed=True when a
    # worker exists; nothing further for the in-process plane. The cluster
    # runtime additionally notifies the owner (see core/cluster_runtime.py).
    w = _global_worker
    if w is not None and hasattr(w.runtime, "on_borrowed_ref"):
        w.runtime.on_borrowed_ref(ref)
