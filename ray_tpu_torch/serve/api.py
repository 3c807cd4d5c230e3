"""serve public API: run/shutdown/status/get_handle (own copy of
ray_tpu.serve.api).

Reference capability: serve/api.py (serve.run:565, serve.start,
serve.shutdown, serve.status) — here the controller + proxy are named actors
in the "serve" namespace so every driver/worker in the cluster reaches the
same instance.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

import cloudpickle

import ray_tpu_torch
from ray_tpu_torch.serve.controller import ServeController
from ray_tpu_torch.serve.deployment import Application, Deployment
from ray_tpu_torch.serve.handle import DeploymentHandle
from ray_tpu_torch.serve.proxy import ProxyActor

_CONTROLLER_NAME = "SERVE_CONTROLLER"
_PROXY_NAME = "SERVE_PROXY"
_NAMESPACE = "serve"

_state: Dict[str, Any] = {"controller": None, "proxy": None}


def start(http_host: str = "127.0.0.1", http_port: int = 8000,
          http: bool = True, proxy_location: str = "head"):
    """Idempotently start the serve instance (controller + proxy actors).

    ``proxy_location``: "head" (one proxy on the starting node) or
    "every_node" — one HTTP proxy pinned to each alive node (reference:
    _private/proxy_state.py per-node ProxyStateManager). With every_node,
    pass http_port=0 for ephemeral ports (required on one-box test
    clusters where every "node" shares the same host)."""
    if not ray_tpu_torch.is_initialized():
        ray_tpu_torch.init()
    controller = _state.get("controller")
    if controller is None:
        try:
            controller = ray_tpu_torch.get_actor(_CONTROLLER_NAME, namespace=_NAMESPACE)
        except ValueError:
            controller = (
                ray_tpu_torch.remote(ServeController)
                .options(name=_CONTROLLER_NAME, namespace=_NAMESPACE,
                         # long-poll listeners each hold a call slot for up
                         # to 30 s; size well above expected router count
                         max_concurrency=128)
                .remote()
            )
        _state["controller"] = controller
    if http and not _state.get("proxies"):
        proxies = []
        if proxy_location == "every_node":
            from ray_tpu_torch.core.resources import NodeAffinitySchedulingStrategy
            from ray_tpu_torch.util import state as _st

            for n in _st.list_nodes():
                if not n.get("Alive"):
                    continue
                name = f"{_PROXY_NAME}:{n['NodeID'][:12]}"
                try:
                    p = ray_tpu_torch.get_actor(name, namespace=_NAMESPACE)
                except ValueError:
                    p = (
                        ray_tpu_torch.remote(ProxyActor)
                        .options(
                            name=name, namespace=_NAMESPACE, max_concurrency=8,
                            scheduling_strategy=NodeAffinitySchedulingStrategy(
                                n["NodeID"]),
                        )
                        .remote(controller, http_host, http_port)
                    )
                proxies.append(p)
        else:
            try:
                p = ray_tpu_torch.get_actor(_PROXY_NAME, namespace=_NAMESPACE)
            except ValueError:
                p = (
                    ray_tpu_torch.remote(ProxyActor)
                    .options(name=_PROXY_NAME, namespace=_NAMESPACE,
                             max_concurrency=8)
                    .remote(controller, http_host, http_port)
                )
            proxies.append(p)
        _state["proxy"] = proxies[0] if proxies else None
        _state["proxies"] = proxies
    return controller


def run(app: Application, name: Optional[str] = None, *,
        http: bool = True, http_port: int = 8000,
        proxy_location: str = "head",
        wait_for_ready: bool = True, timeout: float = 120.0) -> DeploymentHandle:
    """Deploy an application; returns its handle (reference: serve.run)."""
    if isinstance(app, Deployment):
        app = app.bind()
    controller = start(http_port=http_port, http=http,
                       proxy_location=proxy_location)
    app_name = name or app.deployment.name
    ray_tpu_torch.get(
        controller.deploy.remote(
            app_name,
            cloudpickle.dumps(app.deployment),
            cloudpickle.dumps((app.init_args, app.init_kwargs)),
        ),
        timeout=60,
    )
    if wait_for_ready:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if ray_tpu_torch.get(controller.wait_ready.remote(app_name), timeout=60):
                break
            time.sleep(0.2)
        else:
            raise TimeoutError(f"app '{app_name}' not ready after {timeout}s")
    return DeploymentHandle(controller, app_name)


def get_app_handle(name: str) -> DeploymentHandle:
    controller = start(http=False)
    return DeploymentHandle(controller, name)


def get_deployment_handle(deployment_name: str, app_name: Optional[str] = None) -> DeploymentHandle:
    return get_app_handle(app_name or deployment_name)


def status() -> Dict[str, Any]:
    controller = _state.get("controller")
    if controller is None:
        return {}
    return ray_tpu_torch.get(controller.status.remote(), timeout=30)


def http_address() -> Optional[str]:
    proxy = _state.get("proxy")
    if proxy is None:
        return None
    return ray_tpu_torch.get(proxy.address.remote(), timeout=30)


def http_addresses() -> list:
    """Every proxy's address (one per node with proxy_location="every_node")."""
    return [ray_tpu_torch.get(p.address.remote(), timeout=30)
            for p in _state.get("proxies") or []]


def delete(name: str) -> None:
    controller = _state.get("controller")
    if controller is not None:
        ray_tpu_torch.get(controller.delete_app.remote(name), timeout=30)


def shutdown() -> None:
    controller = _state.pop("controller", None)
    _state.pop("proxy", None)
    proxies = _state.pop("proxies", None) or []
    if controller is not None:
        try:
            ray_tpu_torch.get(controller.shutdown.remote(), timeout=30)
            ray_tpu_torch.kill(controller)
        except Exception:  # noqa: BLE001
            pass
    for proxy in proxies:
        try:
            ray_tpu_torch.get(proxy.stop.remote(), timeout=10)  # release the port
        except Exception:  # noqa: BLE001
            pass
        try:
            ray_tpu_torch.kill(proxy)
        except Exception:  # noqa: BLE001
            pass
    from ray_tpu_torch.serve import handle as _handle

    for r in _handle._routers.values():
        r.stop()
    _handle._routers.clear()
