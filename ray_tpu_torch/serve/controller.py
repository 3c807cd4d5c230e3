"""Serve controller: the control plane actor (own copy of
ray_tpu.serve.controller).

Reference capability: serve/_private/controller.py (ServeController:84, the
reconciliation control loop run_control_loop:370) + autoscaling_state.py:262
(queue-depth scaling decisions) + deployment_state.py (target vs running
replica reconciliation). One named actor per serve instance:

- holds the declarative target state {app name -> deployment spec + args}
- reconciles: starts/stops Replica actors to match target counts
- health-checks replicas, replacing dead ones. Unlike the JAX package's
  copy, a replica is checked only once its constructor has returned (a
  model load on a fresh GPU worker outlasts a check's 10 s), and a replica
  that fails a check is killed before it is replaced, so its card is free
  for the replacement (ROADMAP.md, fault C7)
- autoscales deployments with an AutoscalingConfig on mean ongoing requests
  per replica (scrapes replica stats each tick)
"""

from __future__ import annotations

import math
import threading
import time
from typing import Any, Dict, List, Optional

import cloudpickle

import ray_tpu_torch
from ray_tpu_torch.utils.logging import get_logger

logger = get_logger("serve.controller")

CONTROL_LOOP_PERIOD_S = 0.5


class ServeController:
    def __init__(self):
        # app -> record
        self._apps: Dict[str, Dict[str, Any]] = {}
        self._lock = threading.RLock()
        self._shutdown = False
        # versioned config bus (reference: serve/long_poll.py LongPollHost):
        # every replica-set change bumps the version and wakes blocked
        # listen_for_change calls — routers get pushed updates instead of
        # polling + probing every replica
        self._version = 1
        self._version_cv = threading.Condition()
        # replica actor id -> its first check_health call while the replica's
        # constructor runs; None once it has answered
        self._first_checks: Dict[str, Any] = {}
        self._loop_thread = threading.Thread(
            target=self._control_loop, daemon=True, name="serve-control-loop"
        )
        self._loop_thread.start()

    def _bump_version(self) -> None:
        with self._version_cv:
            self._version += 1
            self._version_cv.notify_all()

    def listen_for_change(self, app_name: str, known_version: int,
                          timeout_s: float = 30.0) -> Dict[str, Any]:
        """Long-poll: returns as soon as the config version exceeds
        known_version (or at timeout with the current state). Payload is the
        app's live replica set — everything a router needs."""
        with self._version_cv:
            self._version_cv.wait_for(
                lambda: self._version > known_version or self._shutdown,
                timeout=timeout_s,
            )
        with self._lock:
            rec = self._apps.get(app_name)
            return {
                "version": self._version,
                "exists": rec is not None,
                "replicas": list(rec["replicas"]) if rec else [],
            }

    # ------------------------------------------------------------ target API
    def deploy(self, app_name: str, deployment_def: bytes, init_args: bytes) -> bool:
        """Set/replace an application's target state. Replicas are created by
        the control loop (deploy returns once the target is recorded; callers
        poll wait_ready)."""
        dep = cloudpickle.loads(deployment_def)
        stale: List[Any] = []
        with self._lock:
            old = self._apps.get(app_name)
            # code/ctor-args change = a new VERSION: existing replicas run
            # the old code and must be rolled, not reconfigured (reference:
            # deployment_state.py version-change rolling update). num_replicas
            # and user_config changes keep replicas in place.
            code_changed = old is not None and (
                old["init_args"] != init_args
                or old["deployment_def"] != deployment_def
            )
            self._apps[app_name] = {
                "deployment_def": deployment_def,
                "deployment": dep,
                "init_args": init_args,
                "target": dep.target_replicas,
                "replicas": [] if code_changed else (old["replicas"] if old else []),
                "next_replica_idx": old["next_replica_idx"] if old else 0,
                "last_scale_up": 0.0,
                "last_scale_down": 0.0,
                "ongoing_history": [],
            }
            if code_changed:
                stale = list(old["replicas"])
            elif old is not None:
                for r in old["replicas"]:
                    if dep.user_config is not None:
                        try:
                            r.reconfigure.remote(dep.user_config)
                        except Exception:  # noqa: BLE001
                            pass
        # stale replicas left the routing set with the version bump below;
        # drain off-thread so their in-flight requests finish first
        for r in stale:
            threading.Thread(target=self._drain_then_stop, args=(r,),
                             daemon=True, name="serve-drain").start()
        self._bump_version()
        return True

    def delete_app(self, app_name: str) -> bool:
        with self._lock:
            rec = self._apps.pop(app_name, None)
        self._bump_version()
        if rec:
            for r in rec["replicas"]:
                self._stop_replica(r)
        return True

    def get_replicas(self, app_name: str) -> List[Any]:
        with self._lock:
            rec = self._apps.get(app_name)
            return list(rec["replicas"]) if rec else []

    def list_apps(self) -> List[str]:
        with self._lock:
            return list(self._apps)

    def get_app_meta(self, app_name: str) -> Optional[Dict[str, Any]]:
        """Routing-relevant deployment metadata (proxy reads ``stream`` to
        pick buffered vs chunked responses)."""
        with self._lock:
            rec = self._apps.get(app_name)
            if rec is None:
                return None
            dep = rec["deployment"]
            return {
                "name": dep.name,
                "stream": bool(getattr(dep, "stream", False)),
                "max_ongoing_requests": dep.max_ongoing_requests,
            }

    def status(self) -> Dict[str, Any]:
        out = {}
        with self._lock:
            apps = {name: (rec["target"], list(rec["replicas"]))
                    for name, rec in self._apps.items()}
        for name, (target, replicas) in apps.items():
            stats = []
            for r in replicas:
                try:
                    stats.append(ray_tpu_torch.get(r.stats.remote(), timeout=2))
                except Exception:  # noqa: BLE001
                    stats.append({"ongoing": -1})
            out[name] = {
                "target_replicas": target,
                "running_replicas": len(replicas),
                "replica_stats": stats,
            }
        return out

    def wait_ready(self, app_name: str) -> bool:
        """True once at least one replica is alive and answering."""
        with self._lock:
            rec = self._apps.get(app_name)
            replicas = list(rec["replicas"]) if rec else []
        for r in replicas:
            try:
                ray_tpu_torch.get(r.check_health.remote(), timeout=30)
                return True
            except Exception:  # noqa: BLE001
                continue
        return False

    def shutdown(self) -> bool:
        self._shutdown = True
        with self._lock:
            apps = list(self._apps.values())
            self._apps.clear()
        for rec in apps:
            for r in rec["replicas"]:
                self._stop_replica(r)
        return True

    # ---------------------------------------------------------- control loop
    def _control_loop(self) -> None:
        while not self._shutdown:
            time.sleep(CONTROL_LOOP_PERIOD_S)
            try:
                self._reconcile_once()
            except Exception:  # noqa: BLE001 - the loop must never die
                logger.exception("serve control loop error")

    def _reconcile_once(self) -> None:
        self._poll_declarative()
        with self._lock:
            apps = list(self._apps.items())
        for name, rec in apps:
            self._health_check(name, rec)
            self._autoscale(name, rec)
            self._scale_to_target(name, rec)

    def _poll_declarative(self) -> None:
        """Config-bus half of `serve deploy` REST (serve/schema.py): the
        dashboard validates + enqueues configs/rollback flags in GCS KV; the
        controller (a full worker process) applies them here — so the REST
        plane needs no actor plumbing (reference: serve REST -> controller
        deploy flow, schema.py + application_state.py)."""
        import json as _json

        from ray_tpu_torch.serve import schema as _schema

        try:
            raw = ray_tpu_torch.kv_get(_schema.PENDING_KEY)
            if raw:
                ray_tpu_torch.kv_del(_schema.PENDING_KEY)
                _schema.apply_config(_json.loads(raw))
            if ray_tpu_torch.kv_get(_schema.ROLLBACK_KEY):
                ray_tpu_torch.kv_del(_schema.ROLLBACK_KEY)
                _schema.rollback()
        except Exception:  # noqa: BLE001 - the loop must never die
            logger.exception("declarative config apply failed")

    def _starting(self, replica) -> bool:
        """True while ``replica``'s constructor runs (its first check_health
        has not answered). A constructor may take longer than a check's 10 s
        (a fresh GPU worker loading a model): it is not a failed check. A
        constructor that raised fails its first check."""
        key = replica.actor_id.hex()
        if key not in self._first_checks:
            self._first_checks[key] = replica.check_health.remote()
        ref = self._first_checks[key]
        if ref is None:
            return False
        if not ray_tpu_torch.wait([ref], timeout=0)[0]:
            return True
        self._first_checks[key] = None
        ray_tpu_torch.get(ref)
        return False

    def _health_check(self, name: str, rec: Dict[str, Any]) -> None:
        dead = []
        for r in list(rec["replicas"]):
            try:
                if self._starting(r):
                    continue
                ray_tpu_torch.get(r.check_health.remote(), timeout=10)
            except Exception:  # noqa: BLE001
                dead.append(r)
        if dead:
            with self._lock:
                for r in dead:
                    if r in rec["replicas"]:
                        rec["replicas"].remove(r)
            self._bump_version()
            for r in dead:
                # a replica that failed by timing out may still be alive and
                # holding its resources (a card): its replacement needs them
                try:
                    ray_tpu_torch.kill(r)
                except Exception:  # noqa: BLE001 - already gone
                    pass
            logger.warning("serve app %s: %d replica(s) failed health check",
                           name, len(dead))

    def _autoscale(self, name: str, rec: Dict[str, Any]) -> None:
        cfg = rec["deployment"].autoscaling_config
        if cfg is None or not rec["replicas"]:
            return
        total_ongoing = 0
        live = 0
        for r in rec["replicas"]:
            try:
                s = ray_tpu_torch.get(r.stats.remote(), timeout=2)
                total_ongoing += s["ongoing"]
                live += 1
            except Exception:  # noqa: BLE001
                continue
        if live == 0:
            return
        desired = max(1, math.ceil(total_ongoing / max(cfg.target_ongoing_requests, 1e-9)))
        desired = min(max(desired, cfg.min_replicas), cfg.max_replicas)
        now = time.monotonic()
        with self._lock:
            current = rec["target"]
            if desired > current and now - rec["last_scale_up"] >= cfg.upscale_delay_s:
                rec["target"] = desired
                rec["last_scale_up"] = now
                logger.info("autoscale %s: %d -> %d (ongoing=%d)",
                            name, current, desired, total_ongoing)
            elif desired < current and now - rec["last_scale_down"] >= cfg.downscale_delay_s:
                rec["target"] = max(desired, current - 1)  # scale down gently
                rec["last_scale_down"] = now
                logger.info("autoscale %s: %d -> %d (ongoing=%d)",
                            name, current, rec["target"], total_ongoing)

    def _scale_to_target(self, name: str, rec: Dict[str, Any]) -> None:
        with self._lock:
            target = rec["target"]
            current = len(rec["replicas"])
        changed = False
        for _ in range(current, target):
            replica = self._start_replica(name, rec)
            if replica is None:
                break
            with self._lock:
                rec["replicas"].append(replica)
            changed = True
        if current > target:
            with self._lock:
                victims = rec["replicas"][target:]
                rec["replicas"] = rec["replicas"][:target]
            changed = True
            # victims left the replica set (and the push below tells every
            # router) BEFORE they stop: drain in the background so no
            # in-flight request is lost (reference: proxy_state.py draining)
            for r in victims:
                threading.Thread(
                    target=self._drain_then_stop, args=(r,),
                    daemon=True, name="serve-drain",
                ).start()
        if changed:
            self._bump_version()

    def _drain_then_stop(self, replica, drain_timeout_s: float = 30.0) -> None:
        deadline = time.monotonic() + drain_timeout_s
        while time.monotonic() < deadline:
            try:
                if ray_tpu_torch.get(replica.stats.remote(), timeout=5)["ongoing"] <= 0:
                    break
            except Exception:  # noqa: BLE001 - already dead: nothing to drain
                break
            time.sleep(0.1)
        self._stop_replica(replica)

    def _start_replica(self, name: str, rec: Dict[str, Any]):
        from ray_tpu_torch.serve.replica import Replica

        dep = rec["deployment"]
        with self._lock:
            idx = rec["next_replica_idx"]
            rec["next_replica_idx"] += 1
        replica_id = f"{name}#{idx}"
        init_args, init_kwargs = cloudpickle.loads(rec["init_args"])
        actor_opts = dict(dep.ray_actor_options)
        actor_opts.setdefault("max_concurrency", max(dep.max_ongoing_requests * 2, 8))
        actor_opts.setdefault("max_restarts", 0)
        try:
            cls = ray_tpu_torch.remote(Replica)
            return cls.options(**actor_opts).remote(
                rec["deployment_def"], init_args, init_kwargs, replica_id
            )
        except Exception:  # noqa: BLE001
            logger.exception("failed to start replica %s", replica_id)
            return None

    def _stop_replica(self, replica) -> None:
        try:
            # wait for user cleanup BEFORE killing (a fire-and-forget would
            # race the kill and never run)
            ray_tpu_torch.get(replica.prepare_for_shutdown.remote(), timeout=15)
        except Exception:  # noqa: BLE001
            pass
        try:
            ray_tpu_torch.kill(replica)
        except Exception:  # noqa: BLE001
            pass
