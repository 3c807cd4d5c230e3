"""Distributed queue over an actor (own copy of ray_tpu.util.queue).

Reference capability: python/ray/util/queue.py (Queue — an asyncio.Queue
hosted in an actor; Empty/Full mirror the stdlib). Blocking get/put use the
actor's max_concurrency so a blocked consumer doesn't wedge producers.
"""

from __future__ import annotations

import time
from typing import Any, List, Optional

import ray_tpu_torch


class Empty(Exception):
    pass


class Full(Exception):
    pass


@ray_tpu_torch.remote
class _QueueActor:
    def __init__(self, maxsize: int = 0):
        import asyncio

        self._q: "asyncio.Queue" = asyncio.Queue(maxsize=maxsize)

    async def put(self, item: Any, timeout: Optional[float] = None) -> bool:
        import asyncio

        if timeout is None:
            await self._q.put(item)
            return True
        try:
            await asyncio.wait_for(self._q.put(item), timeout)
            return True
        except asyncio.TimeoutError:
            return False

    def put_nowait(self, item: Any) -> bool:
        import asyncio

        try:
            self._q.put_nowait(item)
            return True
        except asyncio.QueueFull:
            return False

    async def get(self, timeout: Optional[float] = None):
        import asyncio

        if timeout is None:
            return (True, await self._q.get())
        try:
            return (True, await asyncio.wait_for(self._q.get(), timeout))
        except asyncio.TimeoutError:
            return (False, None)

    def get_nowait(self):
        import asyncio

        try:
            return (True, self._q.get_nowait())
        except asyncio.QueueEmpty:
            return (False, None)

    def qsize(self) -> int:
        return self._q.qsize()

    def maxsize(self) -> int:
        return self._q.maxsize


class Queue:
    """Process-safe FIFO queue usable from any driver/task/actor.

        q = Queue(maxsize=100)
        q.put(1); q.get()          # blocking with optional timeout
        refs = [worker.remote(q) for _ in range(8)]
    """

    def __init__(self, maxsize: int = 0, *, actor_options: Optional[dict] = None):
        opts = dict(actor_options or {})
        opts.setdefault("max_concurrency", 8)  # blocked gets don't wedge puts
        self.actor = _QueueActor.options(**opts).remote(maxsize)

    # blocking calls wait in bounded chunks: a permanently-blocked call would
    # pin one of the actor's concurrency threads, and max_concurrency blocked
    # consumers would then starve every put (deadlock). Chunked waits free
    # the thread between chunks, so producers always get a turn.
    _WAIT_CHUNK_S = 2.0

    def put(self, item: Any, block: bool = True,
            timeout: Optional[float] = None) -> None:
        if not block:
            if not ray_tpu_torch.get(self.actor.put_nowait.remote(item)):
                raise Full()
            return
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            chunk = self._WAIT_CHUNK_S if deadline is None else max(
                0.001, min(self._WAIT_CHUNK_S, deadline - time.monotonic()))
            if ray_tpu_torch.get(self.actor.put.remote(item, chunk),
                           timeout=chunk + 30):
                return
            if deadline is not None and time.monotonic() >= deadline:
                raise Full()

    def put_nowait(self, item: Any) -> None:
        self.put(item, block=False)

    def get(self, block: bool = True, timeout: Optional[float] = None) -> Any:
        if not block:
            ok, item = ray_tpu_torch.get(self.actor.get_nowait.remote())
            if not ok:
                raise Empty()
            return item
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            chunk = self._WAIT_CHUNK_S if deadline is None else max(
                0.001, min(self._WAIT_CHUNK_S, deadline - time.monotonic()))
            ok, item = ray_tpu_torch.get(self.actor.get.remote(chunk),
                                   timeout=chunk + 30)
            if ok:
                return item
            if deadline is not None and time.monotonic() >= deadline:
                raise Empty()

    def get_nowait(self) -> Any:
        return self.get(block=False)

    def qsize(self) -> int:
        return ray_tpu_torch.get(self.actor.qsize.remote())

    def empty(self) -> bool:
        return self.qsize() == 0

    def full(self) -> bool:
        maxsize = ray_tpu_torch.get(self.actor.maxsize.remote())
        return maxsize > 0 and self.qsize() >= maxsize

    def put_batch(self, items: List[Any]) -> None:
        for i in items:
            self.put(i)

    def shutdown(self) -> None:
        ray_tpu_torch.kill(self.actor)
