"""multiprocessing.Pool API over the task runtime (own copy of
ray_tpu.util.multiprocessing).

Reference capability: python/ray/util/multiprocessing/pool.py — a drop-in
``Pool`` whose workers are cluster actors, so ``pool.map`` scales past one
machine and survives worker crashes (tasks retry). Supported surface:
apply/apply_async/map/map_async/imap/imap_unordered/starmap + context
manager; initializer/initargs run once per worker actor.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Iterable, List, Optional, Sequence

import ray_tpu_torch
from ray_tpu_torch.util.actor_pool import ActorPool


@ray_tpu_torch.remote
class _PoolWorker:
    def __init__(self, initializer: Optional[Callable] = None,
                 initargs: tuple = ()):
        if initializer is not None:
            initializer(*initargs)

    def run(self, fn: Callable, args: tuple, kwargs: dict):
        return fn(*args, **(kwargs or {}))

    def run_chunk(self, fn: Callable, chunk: List[tuple], star: bool):
        if star:
            return [fn(*args) for args in chunk]
        return [fn(args) for args in chunk]


class AsyncResult:
    def __init__(self, refs: List[Any], unchunk: bool):
        self._refs = refs
        self._unchunk = unchunk

    def get(self, timeout: Optional[float] = None):
        out = ray_tpu_torch.get(self._refs, timeout=timeout)
        if self._unchunk:
            return list(itertools.chain.from_iterable(out))
        return out[0] if len(out) == 1 else out

    def wait(self, timeout: Optional[float] = None) -> None:
        ray_tpu_torch.wait(self._refs, num_returns=len(self._refs), timeout=timeout)

    def ready(self) -> bool:
        done, _ = ray_tpu_torch.wait(self._refs, num_returns=len(self._refs),
                               timeout=0)
        return len(done) == len(self._refs)

    def successful(self) -> bool:
        try:
            self.get(timeout=0.001)
            return True
        except Exception:  # noqa: BLE001
            return False


class Pool:
    """Actor-backed process pool (reference: ray.util.multiprocessing.Pool)."""

    def __init__(self, processes: Optional[int] = None,
                 initializer: Optional[Callable] = None,
                 initargs: tuple = ()):
        if processes is None:
            try:
                processes = max(2, int(ray_tpu_torch.cluster_resources().get("CPU", 2)))
            except Exception:  # noqa: BLE001
                processes = 2
        processes = max(1, processes)
        self._workers = [
            _PoolWorker.remote(initializer, initargs) for _ in range(processes)
        ]
        self._pool = ActorPool(self._workers)
        self._closed = False
        self._rr = itertools.count()  # round-robin cursor for apply_async

    # ------------------------------------------------------------- lifecycle
    def close(self) -> None:
        self._closed = True

    def terminate(self) -> None:
        self._closed = True
        for w in self._workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:  # noqa: BLE001
                pass

    def join(self) -> None:
        assert self._closed, "close() the pool before join()"

    def __enter__(self) -> "Pool":
        return self

    def __exit__(self, *exc) -> None:
        self.terminate()

    # ------------------------------------------------------------------ api
    def _check(self) -> None:
        if self._closed:
            raise ValueError("Pool not running")

    def apply(self, fn: Callable, args: tuple = (), kwds: Optional[dict] = None):
        return self.apply_async(fn, args, kwds).get()

    def apply_async(self, fn: Callable, args: tuple = (),
                    kwds: Optional[dict] = None) -> AsyncResult:
        self._check()
        w = self._workers[next(self._rr) % len(self._workers)]
        return AsyncResult([w.run.remote(fn, args, kwds or {})], unchunk=False)

    def _chunks(self, iterable: Iterable, chunksize: Optional[int]) -> List[List]:
        items = list(iterable)
        if chunksize is None:
            chunksize = max(1, len(items) // (len(self._workers) * 4) or 1)
        return [items[i:i + chunksize] for i in range(0, len(items), chunksize)]

    def map(self, fn: Callable, iterable: Iterable,
            chunksize: Optional[int] = None) -> List[Any]:
        return self.map_async(fn, iterable, chunksize).get()

    def map_async(self, fn: Callable, iterable: Iterable,
                  chunksize: Optional[int] = None) -> AsyncResult:
        self._check()
        chunks = self._chunks(iterable, chunksize)
        refs = [
            self._workers[i % len(self._workers)].run_chunk.remote(
                fn, chunk, False)
            for i, chunk in enumerate(chunks)
        ]
        return AsyncResult(refs, unchunk=True)

    def starmap(self, fn: Callable, iterable: Iterable[Sequence],
                chunksize: Optional[int] = None) -> List[Any]:
        self._check()
        chunks = self._chunks(iterable, chunksize)
        refs = [
            self._workers[i % len(self._workers)].run_chunk.remote(
                fn, chunk, True)
            for i, chunk in enumerate(chunks)
        ]
        return AsyncResult(refs, unchunk=True).get()

    def imap(self, fn: Callable, iterable: Iterable,
             chunksize: int = 1):
        """Ordered lazy iterator (reference: pool.imap)."""
        self._check()
        for v in self._pool.map(
                lambda a, item: a.run.remote(fn, (item,), {}), list(iterable)):
            yield v

    def imap_unordered(self, fn: Callable, iterable: Iterable,
                       chunksize: int = 1):
        self._check()
        for v in self._pool.map_unordered(
                lambda a, item: a.run.remote(fn, (item,), {}), list(iterable)):
            yield v
