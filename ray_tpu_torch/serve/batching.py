"""Dynamic request batching (own copy of
ray_tpu.serve.batching).

Reference capability: python/ray/serve/batching.py (@serve.batch — queue
individual calls, flush as a single list-call when max_batch_size is reached
or batch_wait_timeout_s elapses). Thread-based: replica methods execute on
executor threads, so the flusher is a daemon thread and callers block on
per-item futures.
"""

from __future__ import annotations

import functools
import queue
import threading
from concurrent.futures import Future
from typing import Any, Callable, List, Optional


_init_lock = threading.Lock()  # guards lazy _BatchQueue creation everywhere


class _BatchQueue:
    def __init__(self, fn: Callable[[List[Any]], List[Any]],
                 max_batch_size: int, batch_wait_timeout_s: float):
        self._fn = fn
        self._max = max_batch_size
        self._wait = batch_wait_timeout_s
        self._q: "queue.Queue" = queue.Queue()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=f"batch-{getattr(fn, '__name__', 'fn')}")
        self._thread.start()

    def submit(self, item: Any) -> Any:
        fut: Future = Future()
        self._q.put((item, fut))
        return fut.result()

    def _loop(self) -> None:
        while True:
            item, fut = self._q.get()
            batch = [(item, fut)]
            # fill up to max_batch_size, waiting at most batch_wait_timeout_s
            # from the FIRST item (reference semantics)
            import time

            deadline = time.monotonic() + self._wait
            while len(batch) < self._max:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    batch.append(self._q.get(timeout=remaining))
                except queue.Empty:
                    break
            items = [b[0] for b in batch]
            try:
                results = self._fn(items)
                if not isinstance(results, (list, tuple)) or len(results) != len(items):
                    raise TypeError(
                        f"@serve.batch function must return a list of "
                        f"{len(items)} results, got {type(results).__name__}"
                    )
                for (_, f), r in zip(batch, results):
                    f.set_result(r)
            except BaseException as e:  # noqa: BLE001 - propagate to every caller
                for _, f in batch:
                    if not f.done():
                        f.set_exception(e)


def batch(_fn: Optional[Callable] = None, *, max_batch_size: int = 8,
          batch_wait_timeout_s: float = 0.01):
    """Decorator: the wrapped function receives a LIST of requests and must
    return a list of results of the same length. Individual callers invoke it
    with a single request and get their single result."""

    def wrap(fn):
        state_attr = f"__batch_queue_{fn.__name__}__"

        @functools.wraps(fn)
        def method_wrapper(self, request):
            bq = getattr(self, state_attr, None)
            if bq is None:
                # resolve the guard lock via import at CALL time: wrappers are
                # cloudpickled by value with deployments, and any directly
                # referenced lock (closure or global) would be pickled along
                from ray_tpu_torch.serve import batching as _batching

                with _batching._init_lock:
                    bq = getattr(self, state_attr, None)
                    if bq is None:
                        bq = _batching._BatchQueue(
                            functools.partial(fn, self),
                            max_batch_size, batch_wait_timeout_s,
                        )
                        setattr(self, state_attr, bq)
            return bq.submit(request)

        @functools.wraps(fn)
        def func_wrapper(request):
            bq = getattr(func_wrapper, state_attr, None)
            if bq is None:
                from ray_tpu_torch.serve import batching as _batching

                with _batching._init_lock:
                    bq = getattr(func_wrapper, state_attr, None)
                    if bq is None:
                        bq = _batching._BatchQueue(
                            fn, max_batch_size, batch_wait_timeout_s
                        )
                        setattr(func_wrapper, state_attr, bq)
            return bq.submit(request)

        import inspect

        params = list(inspect.signature(fn).parameters)
        if params and params[0] == "self":
            return method_wrapper
        return func_wrapper

    if _fn is not None:
        return wrap(_fn)
    return wrap
