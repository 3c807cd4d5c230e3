"""Streaming generators: ``num_returns="streaming"`` and ObjectRefGenerator
(own copy of ray_tpu.core.streaming).

Reference capability: python/ray/_raylet.pyx:281 (ObjectRefGenerator),
:1206,1263 (per-item report paths) — a remote generator task/actor method
yields items that are sealed into the object plane ONE AT A TIME; the caller
iterates ObjectRefs as they are produced, with consumer-driven backpressure
so an unbounded producer cannot flood the store.

Design: the stream directory lives beside the (GCS-centralized)
object directory — each produced item is a normal object (sealed + location-
registered via the existing paths) plus one stream-directory append; the
consumer's ``next`` is a single long-poll that doubles as the consumed
watermark (asking for item *i* acknowledges items < *i*), which is what the
producer's backpressure gate waits on. No extra RPC per consumed item.
"""

from __future__ import annotations

import asyncio
import threading
from typing import Optional, TYPE_CHECKING

from ray_tpu_torch.core.ids import ObjectID, TaskID
from ray_tpu_torch.core.object_ref import ObjectRef

if TYPE_CHECKING:
    from ray_tpu_torch.core.runtime import CoreRuntime

STREAMING = "streaming"

_STOP = object()  # sentinel: end-of-stream across executor boundaries


def stream_item_id(task_hex: str, index: int) -> ObjectID:
    """Object id of stream item ``index`` (0-based): return slot index+1."""
    return ObjectID.for_task_return(TaskID(bytes.fromhex(task_hex)), index + 1)


class ObjectRefGenerator:
    """Iterator over the ObjectRefs produced by a streaming task.

    Sync (``for ref in gen``) and async (``async for ref in gen``) iteration;
    each yielded ObjectRef resolves through the normal ``get`` path. Dropping
    the generator early closes the stream: the producer is unblocked (and told
    to stop) and unconsumed items are released.
    """

    def __init__(self, task_hex: str, runtime: "CoreRuntime"):
        self._task_hex = task_hex
        self._runtime = runtime
        self._index = 0
        self._total: Optional[int] = None
        self._closed = False

    @property
    def task_id_hex(self) -> str:
        return self._task_hex

    def __iter__(self) -> "ObjectRefGenerator":
        return self

    def __next__(self) -> ObjectRef:
        return self._next_internal(timeout=None)

    def _next_internal(self, timeout: Optional[float]) -> ObjectRef:
        if self._total is not None and self._index >= self._total:
            raise StopIteration
        if self._closed:
            raise StopIteration
        kind, value = self._runtime.stream_next(self._task_hex, self._index, timeout)
        if kind == "end":
            self._total = value
            if self._index >= value:
                raise StopIteration
            # items can land before the end marker is observed: retry the index
            return self._next_internal(timeout)
        self._index += 1
        return ObjectRef(ObjectID.from_hex(value))

    def __aiter__(self) -> "ObjectRefGenerator":
        return self

    async def __anext__(self) -> ObjectRef:
        loop = asyncio.get_running_loop()

        def step():  # StopIteration cannot cross a Future boundary
            try:
                return self.__next__()
            except StopIteration:
                return _STOP

        ref = await loop.run_in_executor(None, step)
        if ref is _STOP:
            raise StopAsyncIteration
        return ref

    def completed(self) -> bool:
        return self._total is not None and self._index >= self._total

    def close(self) -> None:
        """Stop consuming: unblocks (and stops) the producer, releases
        unconsumed items."""
        if not self._closed:
            self._closed = True
            try:
                self._runtime.stream_close(self._task_hex)
            except Exception:  # noqa: BLE001 - runtime may already be down
                pass

    def __del__(self) -> None:
        try:
            if self._total is None or self._index < self._total:
                self.close()
        except Exception:  # noqa: BLE001
            pass

    def __repr__(self) -> str:
        return f"ObjectRefGenerator(task={self._task_hex[:16]}, next={self._index})"


def iter_async_gen(agen):
    """Drain an async generator from a sync context on a private event loop
    (used when a streaming task/actor method is an async generator)."""
    loop = asyncio.new_event_loop()
    try:
        while True:
            try:
                yield loop.run_until_complete(agen.__anext__())
            except StopAsyncIteration:
                return
    finally:
        loop.run_until_complete(agen.aclose())
        loop.close()


class LocalStreamState:
    """In-process stream directory entry (LocalRuntime backend)."""

    __slots__ = ("items", "finished", "total", "consumed", "delivered",
                 "closed", "cond")

    def __init__(self) -> None:
        self.items: dict = {}          # index -> oid hex
        self.finished = False
        self.total = 0
        self.consumed = 0              # consumer watermark: next index wanted
        self.delivered = 0             # indices actually handed out via next()
        self.closed = False
        self.cond = threading.Condition()

    # -- producer side ------------------------------------------------------
    def put(self, index: int, oid_hex: str, backpressure: int) -> bool:
        """Record item ``index``; block while too far ahead of the consumer.
        Returns False when the consumer closed the stream (producer should
        stop)."""
        with self.cond:
            self.items[index] = oid_hex
            self.cond.notify_all()
            while (
                backpressure > 0
                and (index + 1) - self.consumed >= backpressure
                and not self.closed
            ):
                self.cond.wait(0.05)
            return not self.closed

    def end(self, total: int) -> None:
        with self.cond:
            self.finished = True
            self.total = total
            self.cond.notify_all()

    # -- consumer side ------------------------------------------------------
    def next(self, index: int, timeout: Optional[float]):
        with self.cond:
            if index > self.consumed:
                self.consumed = index
                self.cond.notify_all()
            deadline = None
            if timeout is not None:
                import time as _time

                deadline = _time.monotonic() + timeout
            while True:
                if index in self.items:
                    self.delivered = max(self.delivered, index + 1)
                    return ("item", self.items[index])
                if self.finished:
                    return ("end", self.total)
                if deadline is not None:
                    import time as _time

                    remaining = deadline - _time.monotonic()
                    if remaining <= 0:
                        raise TimeoutError(
                            f"stream item {index} not produced within {timeout}s"
                        )
                    self.cond.wait(min(remaining, 0.1))
                else:
                    self.cond.wait(0.1)

    def close(self) -> None:
        with self.cond:
            self.closed = True
            self.cond.notify_all()
