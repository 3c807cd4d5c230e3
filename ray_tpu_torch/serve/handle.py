"""DeploymentHandle: python-level calls into a serve application (own copy of
ray_tpu.serve.handle).

Reference capability: serve/handle.py (DeploymentHandle.remote returning a
DeploymentResponse backed by the replica scheduler). Handles share one Router
per (process, app): pow-2 routing with queue-length estimates.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional

import ray_tpu_torch
from ray_tpu_torch.serve.router import Router

_routers: Dict[str, Router] = {}
_routers_lock = threading.Lock()


def _router_for(controller, app_name: str) -> Router:
    with _routers_lock:
        r = _routers.get(app_name)
        if r is None:
            r = Router(controller, app_name)
            _routers[app_name] = r
        return r


class DeploymentResponse:
    """Future-like result of handle.remote(). ``.result()`` resolves (with
    overload retry via the router); ``.ref`` exposes the underlying ObjectRef
    for composition with ray_tpu_torch.get/wait."""

    def __init__(self, router: Router, ref, replica):
        self._router = router
        self._ref = ref
        self._replica = replica
        self._done = False

    @property
    def ref(self):
        return self._ref

    def result(self, timeout: Optional[float] = None) -> Any:
        from ray_tpu_torch.serve.replica import ReplicaOverloadedError

        try:
            value = ray_tpu_torch.get(self._ref, timeout=timeout)
            return value
        except ReplicaOverloadedError:
            # raced an overloaded replica: fall back to the router's
            # retrying call path
            return self._router.call(
                self._method, self._args, self._kwargs, timeout=timeout,
                multiplexed_model_id=getattr(self, "_multiplexed_model_id", ""))
        finally:
            if not self._done:
                self._done = True
                self._router._note(self._replica, -1)


class DeploymentHandle:
    def __init__(self, controller, app_name: str, method: str = "__call__",
                 stream: bool = False, multiplexed_model_id: str = ""):
        self._controller = controller
        self._app = app_name
        self._method = method
        self._stream = stream
        self._multiplexed_model_id = multiplexed_model_id

    def options(self, method_name: Optional[str] = None,
                stream: Optional[bool] = None,
                multiplexed_model_id: Optional[str] = None) -> "DeploymentHandle":
        return DeploymentHandle(
            self._controller, self._app, method_name or self._method,
            stream=self._stream if stream is None else stream,
            multiplexed_model_id=(self._multiplexed_model_id
                                  if multiplexed_model_id is None
                                  else multiplexed_model_id),
        )

    def __getattr__(self, name: str) -> "DeploymentHandle":
        if name.startswith("_"):
            raise AttributeError(name)
        return DeploymentHandle(self._controller, self._app, name,
                                stream=self._stream,
                                multiplexed_model_id=self._multiplexed_model_id)

    def remote(self, *args, **kwargs):
        router = _router_for(self._controller, self._app)
        if self._stream:
            # generator of VALUES, yielded as the replica produces them
            # (reference: handle.options(stream=True) -> DeploymentResponseGenerator)
            return router.call_streaming(
                self._method, args, kwargs,
                multiplexed_model_id=self._multiplexed_model_id)
        ref, replica = router.route(
            self._method, args, kwargs,
            multiplexed_model_id=self._multiplexed_model_id)
        resp = DeploymentResponse(router, ref, replica)
        resp._method = self._method
        resp._args = args
        resp._kwargs = kwargs
        resp._multiplexed_model_id = self._multiplexed_model_id
        return resp
