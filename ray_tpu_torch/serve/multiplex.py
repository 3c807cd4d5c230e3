"""Model multiplexing: many models per deployment, LRU-cached per replica (own copy of
ray_tpu.serve.multiplex).

Reference capability: python/ray/serve/multiplex.py (@serve.multiplexed —
a per-replica _ModelMultiplexWrapper with an async LRU of loaded models,
get_multiplexed_model_id() from request context, and multiplex-aware
routing in the replica scheduler). Redesign:

- ``@multiplexed(max_num_models_per_replica=N)`` wraps a model LOADER
  (method or free function taking model_id). Each replica instance keeps
  its own LRU; eviction calls the model's ``__del__``/``unload()`` if
  present.
- ``get_multiplexed_model_id()`` reads the request's model id (propagated
  by the router/replica around each call).
- Routing is STICKY: the router remembers which replica last served each
  model id and prefers it while healthy (locality without extra control
  traffic); overload/death falls back to pow-2 and re-pins. The reference
  propagates exact model->replica maps over long-poll — a roadmap upgrade
  on the same seam.
"""

from __future__ import annotations

import contextvars
import functools
import inspect
from collections import OrderedDict
from typing import Any, Callable, Optional

_model_id_ctx: contextvars.ContextVar = contextvars.ContextVar(
    "rtpu_multiplexed_model_id", default="")


def get_multiplexed_model_id() -> str:
    """The model id of the CURRENT request (empty if the caller didn't set
    one via handle.options(multiplexed_model_id=...))."""
    return _model_id_ctx.get()


def _set_request_model_id(model_id: str):
    return _model_id_ctx.set(model_id or "")


def _reset_request_model_id(token) -> None:
    _model_id_ctx.reset(token)


class _ModelCache:
    """Thread-safe LRU with per-model load deduplication: replicas execute
    requests on concurrent threads, so N simultaneous misses for one model
    id must produce ONE loader call (the reference serializes loads for the
    same reason — a large model loaded N times concurrently blows memory)."""

    def __init__(self, capacity: int):
        import threading

        self.capacity = capacity
        self._models: "OrderedDict[str, Any]" = OrderedDict()
        self._lock = threading.Lock()
        self._loading: dict = {}  # model_id -> threading.Event

    _MISS = object()

    def try_get(self, model_id: str):
        """Cached model, or (_MISS, claim_event): claim_event is None when
        THIS caller claimed the load, else the in-flight loader's event."""
        import threading

        with self._lock:
            if model_id in self._models:
                self._models.move_to_end(model_id)
                return self._models[model_id], None
            ev = self._loading.get(model_id)
            if ev is None:
                self._loading[model_id] = threading.Event()
                return self._MISS, None  # claimed: caller must load+store
            return self._MISS, ev  # someone else is loading: wait on ev

    def finish(self, model_id: str, model=_MISS) -> None:
        """Release the claim; store the model if the load succeeded."""
        evicted = []
        with self._lock:
            ev = self._loading.pop(model_id, None)
            if model is not self._MISS:
                self._models[model_id] = model
                self._models.move_to_end(model_id)
                while len(self._models) > self.capacity:
                    evicted.append(self._models.popitem(last=False)[1])
        if ev is not None:
            ev.set()
        for old in evicted:
            unload = getattr(old, "unload", None)
            if callable(unload):
                try:
                    unload()
                except Exception:  # noqa: BLE001 - best-effort eviction
                    pass

    def get_or_load(self, model_id: str, load: Callable[[], Any]):
        while True:
            model, ev = self.try_get(model_id)
            if model is not self._MISS:
                return model
            if ev is not None:
                ev.wait(timeout=600.0)
                continue  # loader finished (or failed): re-check
            try:
                model = load()
            except BaseException:
                self.finish(model_id)  # release claim; waiters re-try
                raise
            self.finish(model_id, model)
            return model

    def ids(self):
        with self._lock:
            return list(self._models)


def multiplexed(max_num_models_per_replica: int = 3) -> Callable:
    """Decorator for a model loader (reference: serve.multiplexed). The
    wrapped loader is called only on cache misses; hits return the
    replica-resident model instantly.

        @serve.deployment
        class ModelServer:
            @multiplexed(max_num_models_per_replica=4)
            async def get_model(self, model_id: str):
                return load_weights(model_id)

            async def __call__(self, request):
                model = await self.get_model(get_multiplexed_model_id())
                ...
    """
    if max_num_models_per_replica < 1:
        raise ValueError("max_num_models_per_replica must be >= 1")

    def deco(loader: Callable) -> Callable:
        cache_attr = f"__rtpu_mux_cache_{loader.__name__}"
        is_async = inspect.iscoroutinefunction(loader)
        takes_self = "self" in inspect.signature(loader).parameters
        # NOTE: a FREE-FUNCTION loader's cache hangs off the decorator, so
        # in the in-process local runtime multiple replicas of the same
        # deployment SHARE it (capacity is per process, not per replica).
        # Cluster replicas are separate processes, where the distinction
        # vanishes. Method loaders (the documented form) are always
        # per-instance.

        def split(args, kwargs):
            if takes_self:
                owner = args[0]
                rest = args[1:]
            else:
                owner = deco
                rest = args
            if rest:
                model_id = rest[0]
            elif "model_id" in kwargs:
                model_id = kwargs["model_id"]
            else:
                raise TypeError(
                    f"{loader.__name__}() needs a model_id (positional or "
                    "model_id= keyword)")
            return owner, str(model_id)

        def cache_of(owner) -> _ModelCache:
            cache = getattr(owner, cache_attr, None)
            if cache is None:
                cache = _ModelCache(max_num_models_per_replica)
                setattr(owner, cache_attr, cache)
            return cache

        if is_async:
            @functools.wraps(loader)
            async def async_wrapper(*args, **kwargs):
                import asyncio

                owner, model_id = split(args, kwargs)
                cache = cache_of(owner)
                while True:
                    model, ev = cache.try_get(model_id)
                    if model is not _ModelCache._MISS:
                        return model
                    if ev is not None:
                        # another thread/coroutine is loading: wait without
                        # blocking this event loop
                        await asyncio.get_event_loop().run_in_executor(
                            None, ev.wait, 600.0)
                        continue
                    try:
                        model = await loader(*args, **kwargs)
                    except BaseException:
                        cache.finish(model_id)
                        raise
                    cache.finish(model_id, model)
                    return model

            async_wrapper.__rtpu_multiplexed__ = True  # type: ignore[attr-defined]
            return async_wrapper

        @functools.wraps(loader)
        def wrapper(*args, **kwargs):
            owner, model_id = split(args, kwargs)
            return cache_of(owner).get_or_load(
                model_id, lambda: loader(*args, **kwargs))

        wrapper.__rtpu_multiplexed__ = True  # type: ignore[attr-defined]
        return wrapper

    return deco
