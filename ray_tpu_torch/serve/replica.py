"""Replica actor: hosts one copy of a deployment's callable (own copy of
ray_tpu.serve.replica).

Reference capability: serve/_private/replica.py (Replica.__init__:518,
handle_request:533 — user-code execution with ongoing-request accounting,
health checks, graceful shutdown). Runs as a max_concurrency actor; each
request is one actor task. Queue-length accounting backs both the pow-2
router (probe path) and autoscaling (controller scrapes stats).
"""

from __future__ import annotations

import asyncio
import inspect
import threading
import time
from typing import Any, Dict, Optional

from ray_tpu_torch import exceptions as exc


class ReplicaOverloadedError(exc.RayTpuError):
    """Rejected: the replica is at max_ongoing_requests (the router should
    retry on another replica — reference: back-pressure in replica_scheduler)."""


class Replica:
    """Generic replica wrapper. Instantiated as an actor by the controller:
    ``Replica.options(max_concurrency=...).remote(serialized_deployment, ...)``.
    """

    def __init__(self, deployment_def: bytes, init_args: tuple, init_kwargs: dict,
                 replica_id: str = ""):
        import cloudpickle

        dep = cloudpickle.loads(deployment_def)
        self._deployment = dep
        self._replica_id = replica_id
        self._max_ongoing = int(dep.max_ongoing_requests)
        self._ongoing = 0
        self._total = 0
        self._lock = threading.Lock()
        self._started_at = time.time()
        target = dep.func_or_class
        self._is_function = not inspect.isclass(target)
        if self._is_function:
            # function deployment: the function IS __call__
            self._callable = target
        else:
            self._callable = target(*init_args, **init_kwargs)
        if dep.user_config is not None:
            reconfigure = getattr(self._callable, "reconfigure", None)
            if reconfigure is not None:
                reconfigure(dep.user_config)

    # ------------------------------------------------------------- requests
    def handle_request(self, method: str, args: tuple, kwargs: dict,
                       multiplexed_model_id: str = "") -> Any:
        from ray_tpu_torch.serve.multiplex import (
            _reset_request_model_id, _set_request_model_id,
        )

        with self._lock:
            if self._ongoing >= self._max_ongoing:
                raise ReplicaOverloadedError(
                    f"replica {self._replica_id} at max_ongoing_requests="
                    f"{self._max_ongoing}"
                )
            self._ongoing += 1
            self._total += 1
        mux_token = _set_request_model_id(multiplexed_model_id)
        try:
            if self._is_function:
                if method != "__call__":
                    raise AttributeError(
                        f"function deployment '{self._deployment.name}' only "
                        f"supports __call__, not '{method}'"
                    )
                fn = self._callable
            else:
                fn = getattr(self._callable, method, None)
                if fn is None:
                    raise AttributeError(
                        f"deployment '{self._deployment.name}' has no method '{method}'"
                    )
            result = fn(*args, **kwargs)
            if inspect.iscoroutine(result):
                result = _run_coro(result)
            return result
        finally:
            _reset_request_model_id(mux_token)
            with self._lock:
                self._ongoing -= 1

    def handle_request_streaming(self, method: str, args: tuple, kwargs: dict,
                                 multiplexed_model_id: str = ""):
        """Streaming variant: a generator method, invoked by routers with
        ``num_returns="streaming"`` so each yielded item is sealed and
        consumable before the request finishes (reference:
        serve/_private/proxy.py:542 streaming send_request_to_replica +
        replica.py:533 handle_request_streaming). Non-generator results
        stream as a single item."""
        from ray_tpu_torch.serve.multiplex import (
            _reset_request_model_id, _set_request_model_id,
        )

        with self._lock:
            if self._ongoing >= self._max_ongoing:
                raise ReplicaOverloadedError(
                    f"replica {self._replica_id} at max_ongoing_requests="
                    f"{self._max_ongoing}"
                )
            self._ongoing += 1
            self._total += 1
        mux_token = _set_request_model_id(multiplexed_model_id)
        try:
            if self._is_function:
                fn = self._callable
            else:
                fn = getattr(self._callable, method, None)
                if fn is None:
                    raise AttributeError(
                        f"deployment '{self._deployment.name}' has no method '{method}'"
                    )
            result = fn(*args, **kwargs)
            if inspect.iscoroutine(result):
                result = _run_coro(result)
            if inspect.isgenerator(result):
                yield from result
            elif inspect.isasyncgen(result):
                from ray_tpu_torch.core.streaming import iter_async_gen

                yield from iter_async_gen(result)
            else:
                yield result
        finally:
            _reset_request_model_id(mux_token)
            with self._lock:
                self._ongoing -= 1

    # ---------------------------------------------------------------- stats
    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "replica_id": self._replica_id,
                "ongoing": self._ongoing,
                "total": self._total,
                "max_ongoing": self._max_ongoing,
                "uptime_s": time.time() - self._started_at,
            }

    def check_health(self) -> bool:
        user_check = getattr(self._callable, "check_health", None)
        if user_check is not None:
            user_check()
        return True

    def reconfigure(self, user_config: Dict[str, Any]) -> bool:
        fn = getattr(self._callable, "reconfigure", None)
        if fn is not None:
            fn(user_config)
        return True

    def prepare_for_shutdown(self) -> bool:
        """Run user cleanup before the controller kills the worker
        (reference: replica graceful shutdown calls the callable's
        __del__)."""
        fn = getattr(self._callable, "__del__", None)
        if fn is not None:
            try:
                fn()
            except Exception:  # noqa: BLE001 - cleanup must not block kill
                pass
        return True


def _run_coro(coro):
    """Execute a coroutine returned by user code (replica methods run on
    executor threads, so a fresh loop per call is the simple correct thing)."""
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()
