"""Declarative serve config: schema validation + apply/rollback (own copy of
ray_tpu.serve.schema).

Reference capability: serve/schema.py (ServeDeploySchema — YAML app configs
validated then reconciled by the controller) + the `serve deploy` CLI/REST
flow. Config shape:

```yaml
applications:
  - name: adder                 # unique app name (required)
    import_path: mymod:app      # "<module>:<attr>" -> Application |
                                #   Deployment | zero-arg builder (required)
    num_replicas: 2             # optional overrides applied via .options()
    max_concurrent_requests: 8
    user_config: {...}          # passed to the deployment ctor IF the
                                #   import path yields a bare Deployment
```

Apply paths:
- CLI `serve deploy app.yaml` -> a driver process calls ``apply_config``
  directly (starts the serve instance when absent);
- REST PUT /api/serve/applications -> dashboard validates and enqueues the
  config in GCS KV; the RUNNING controller's reconcile loop picks it up
  (``ServeController._poll_declarative``) — the long-poll config-bus
  pattern, so the dashboard process needs no actor plumbing.

The previous config is retained under ``PREV_KEY`` for one-step rollback
(`serve rollback` / POST /api/serve/rollback).
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

CONFIG_KEY = "serve:declarative:current"
PREV_KEY = "serve:declarative:prev"
PENDING_KEY = "serve:declarative:pending"
ROLLBACK_KEY = "serve:declarative:rollback"
STATUS_KEY = "serve:declarative:status"

_APP_FIELDS = {
    "name", "import_path", "num_replicas", "max_concurrent_requests",
    "user_config", "autoscaling", "route_prefix",
}


def validate_config(cfg: Any) -> Dict[str, Any]:
    """Normalize + validate; raises ValueError with a field-path message."""
    if not isinstance(cfg, dict):
        raise ValueError("config root must be a mapping")
    unknown = set(cfg) - {"applications"}
    if unknown:
        raise ValueError(f"unknown top-level fields: {sorted(unknown)}")
    apps = cfg.get("applications")
    if not isinstance(apps, list) or not apps:
        raise ValueError("'applications' must be a non-empty list")
    seen = set()
    out: List[Dict[str, Any]] = []
    for i, app in enumerate(apps):
        where = f"applications[{i}]"
        if not isinstance(app, dict):
            raise ValueError(f"{where} must be a mapping")
        unknown = set(app) - _APP_FIELDS
        if unknown:
            raise ValueError(f"{where}: unknown fields {sorted(unknown)}")
        name = app.get("name")
        if not isinstance(name, str) or not name:
            raise ValueError(f"{where}.name: required non-empty string")
        if name in seen:
            raise ValueError(f"{where}.name: duplicate app name '{name}'")
        seen.add(name)
        ip = app.get("import_path")
        if not isinstance(ip, str) or ":" not in ip:
            raise ValueError(
                f"{where}.import_path: required '<module>:<attr>' string")
        for field, typ in (("num_replicas", int),
                           ("max_concurrent_requests", int)):
            if field in app and (not isinstance(app[field], typ)
                                 or app[field] <= 0):
                raise ValueError(f"{where}.{field}: positive {typ.__name__}")
        if "user_config" in app and not isinstance(app["user_config"], dict):
            raise ValueError(f"{where}.user_config: mapping")
        out.append(dict(app))
    return {"applications": out}


def load_yaml(path: str) -> Dict[str, Any]:
    import yaml

    with open(path) as f:
        return validate_config(yaml.safe_load(f))


def _import_app(import_path: str):
    import importlib

    module_name, _, attr = import_path.partition(":")
    obj = importlib.import_module(module_name)
    for part in attr.split("."):
        obj = getattr(obj, part)
    return obj


def _build_application(app_cfg: Dict[str, Any]):
    from ray_tpu_torch.serve.deployment import Application, Deployment

    obj = _import_app(app_cfg["import_path"])
    overrides = {k: app_cfg[k] for k in
                 ("num_replicas", "max_concurrent_requests", "autoscaling")
                 if k in app_cfg}
    if isinstance(obj, Application):
        if overrides:
            dep = obj.deployment.options(**overrides)
            obj = Application(deployment=dep, init_args=obj.init_args,
                              init_kwargs=obj.init_kwargs)
        return obj
    if isinstance(obj, Deployment):
        if overrides:
            obj = obj.options(**overrides)
        user_cfg = app_cfg.get("user_config") or {}
        return obj.bind(**user_cfg)
    if callable(obj):  # zero-arg builder
        return _coerce_built(obj(), overrides, app_cfg)
    raise TypeError(
        f"{app_cfg['import_path']} resolved to {type(obj).__name__}; "
        "expected Application, Deployment, or builder callable")


def _coerce_built(obj, overrides, app_cfg):
    from ray_tpu_torch.serve.deployment import Application, Deployment

    if isinstance(obj, Deployment):
        obj = obj.options(**overrides) if overrides else obj
        return obj.bind(**(app_cfg.get("user_config") or {}))
    if isinstance(obj, Application):
        if overrides:
            dep = obj.deployment.options(**overrides)
            obj = Application(deployment=dep, init_args=obj.init_args,
                              init_kwargs=obj.init_kwargs)
        return obj
    raise TypeError(f"builder returned {type(obj).__name__}")


def apply_config(cfg: Dict[str, Any], *, record: bool = True,
                 wait_for_ready: bool = False) -> Dict[str, Any]:
    """Reconcile the serve instance to ``cfg``: deploy every listed app,
    delete declaratively-owned apps that disappeared. Returns a status dict.
    Runs in any process with an initialized ray_tpu_torch runtime.

    Ingress is NOT reconfigured when a serve instance already exists: a
    declarative app deploy must never spawn an HTTP proxy the operator
    disabled (or fight over a port) — only a COLD start via the CLI brings
    up the default HTTP ingress."""
    import ray_tpu_torch
    from ray_tpu_torch import serve

    cfg = validate_config(cfg)
    try:
        ray_tpu_torch.get_actor("SERVE_CONTROLLER", namespace="serve")
        http = False  # running instance: leave its ingress configuration be
    except ValueError:
        http = True  # cold start (CLI serve deploy): default ingress
    prev_raw = ray_tpu_torch.kv_get(CONFIG_KEY)
    prev = json.loads(prev_raw) if prev_raw else None
    deployed, errors = [], {}
    for app_cfg in cfg["applications"]:
        try:
            application = _build_application(app_cfg)
            serve.run(application, name=app_cfg["name"], http=http,
                      wait_for_ready=wait_for_ready)
            deployed.append(app_cfg["name"])
        except Exception as e:  # noqa: BLE001 - per-app isolation
            errors[app_cfg["name"]] = f"{type(e).__name__}: {e}"
    # remove apps the previous declarative config owned but this one dropped
    wanted = {a["name"] for a in cfg["applications"]}
    if prev:
        for app_cfg in prev.get("applications", []):
            if app_cfg["name"] not in wanted:
                try:
                    serve.delete(app_cfg["name"])
                except Exception:  # noqa: BLE001
                    pass
    if record:
        if prev_raw:
            ray_tpu_torch.kv_put(PREV_KEY, prev_raw)
        ray_tpu_torch.kv_put(CONFIG_KEY, json.dumps(cfg).encode())
    status = {"deployed": deployed, "errors": errors}
    ray_tpu_torch.kv_put(STATUS_KEY, json.dumps(status).encode())
    return status


def rollback() -> Dict[str, Any]:
    """Re-apply the previous declarative config (one-step undo)."""
    import ray_tpu_torch

    prev_raw = ray_tpu_torch.kv_get(PREV_KEY)
    if not prev_raw:
        raise ValueError("no previous declarative config to roll back to")
    cur = ray_tpu_torch.kv_get(CONFIG_KEY)
    cfg = json.loads(prev_raw)
    status = apply_config(cfg, record=False)
    # swap: current <- prev, prev <- what was current
    ray_tpu_torch.kv_put(CONFIG_KEY, prev_raw)
    if cur:
        ray_tpu_torch.kv_put(PREV_KEY, cur)
    return status


def current_config() -> Optional[Dict[str, Any]]:
    import ray_tpu_torch

    raw = ray_tpu_torch.kv_get(CONFIG_KEY)
    return json.loads(raw) if raw else None
