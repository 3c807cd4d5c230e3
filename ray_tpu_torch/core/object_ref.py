"""ObjectRef: a first-class future/handle to an object in the object plane
(own copy of ray_tpu.core.object_ref).

Capability-equivalent of the reference's ObjectRef (reference:
python/ray/includes/object_ref.pxi + ownership model in
src/ray/core_worker/reference_count.h): every ref knows its owner (the worker
that created it), participates in distributed reference counting via
``__del__`` → runtime release, is awaitable in asyncio, and can be captured
inside other objects (borrowing, see core/serialization.py).
"""

from __future__ import annotations

import asyncio
import collections
import threading
from typing import Any, Optional

from ray_tpu_torch.core.ids import ObjectID

# Deferred-release queue. ``__del__`` runs at ARBITRARY points — including
# inside GC triggered while this very thread holds the ref-counter or
# object-store lock — so it must never take a lock itself: a non-reentrant
# lock re-acquired on the same thread wedges the whole process (observed:
# InProcessStore.entry() -> Future() alloc -> GC -> __del__ -> store.free()
# self-deadlock; every other thread then piles onto the lock — the r4
# monolithic-suite hang). deque.append is a single C call with no Python-level
# locking, which is the entire point; a worker-side drain thread applies the
# releases (reference posture: _raylet.pyx defers ref removal out of
# __dealloc__ onto the io thread for the same reason).
_PENDING_RELEASES: "collections.deque[ObjectID]" = collections.deque()


class ObjectRef:
    __slots__ = ("id", "owner_hint", "_registered", "__weakref__")

    def __init__(
        self,
        object_id: ObjectID,
        owner_hint: Optional[str] = None,
        *,
        _borrowed: bool = False,
        _skip_refcount: bool = False,
    ):
        self.id = object_id
        # owner_hint: serialized owner address "node_hex:worker_hex" used by
        # the cluster runtime to locate metadata without a directory lookup.
        self.owner_hint = owner_hint
        self._registered = False
        if not _skip_refcount:
            from ray_tpu_torch.core.worker import global_worker

            w = global_worker()
            if w is not None:
                w.add_local_ref(self.id, borrowed=_borrowed)
                self._registered = True

    def hex(self) -> str:
        return self.id.hex()

    def binary(self) -> bytes:
        return self.id.binary()

    def task_id(self):
        return self.id.task_id()

    def future(self) -> "asyncio.Future[Any]":
        """An asyncio future resolving to the object's value (or raising)."""
        loop = asyncio.get_event_loop()
        fut: asyncio.Future = loop.create_future()

        def _resolve() -> None:
            from ray_tpu_torch import api

            try:
                value = api.get(self)
            except BaseException as e:  # noqa: BLE001 - propagate to future
                loop.call_soon_threadsafe(lambda: fut.cancelled() or fut.set_exception(e))
            else:
                loop.call_soon_threadsafe(lambda: fut.cancelled() or fut.set_result(value))

        threading.Thread(target=_resolve, daemon=True).start()
        return fut

    def __await__(self):
        return self.future().__await__()

    def __hash__(self) -> int:
        return hash(self.id)

    def __eq__(self, other: object) -> bool:
        return isinstance(other, ObjectRef) and other.id == self.id

    def __repr__(self) -> str:
        return f"ObjectRef({self.id.hex()})"

    def __del__(self) -> None:
        # NO locks, NO imports with side effects here — append only (module
        # comment above). The drain thread in core/worker.py applies it.
        if getattr(self, "_registered", False):
            try:
                _PENDING_RELEASES.append(self.id)
            except Exception:
                pass

    def __reduce__(self):
        # Plain pickling (outside the runtime's serializer) keeps the id but
        # cannot maintain refcounts; the runtime serializer in
        # core/serialization.py handles borrowing.
        return (ObjectRef, (self.id, self.owner_hint))
