"""GCS — the cluster control service (the "brain"); own copy of
ray_tpu.core.gcs.server, which the port runs for GPU nodes unchanged.

Reference capability: src/ray/gcs/gcs_server/ (GcsServer::Start wiring
gcs_server.cc:138-232 — node manager, KV, actor manager + scheduler,
placement groups, health checks, job manager, pubsub) re-designed for a
TPU-cluster control plane:

- node membership + per-node resource/label view (slice labels included:
  a GPU node's slice is its host, one NVLink domain)
- global placement: hybrid pack/spread, SPREAD, node-affinity, label match,
  placement-group bundles (PACK/SPREAD/STRICT_*), slice-aware strategies,
  and the **external policy hook** — the fork's capability
  (external_scheduler/scheduler.py + external_scheduler.cc) kept OFF the
  per-task hot path: requests are batched per scheduling tick and the
  external service answers with placements asynchronously
- actor directory with restart bookkeeping, named-actor registry
- object directory (location set per object; owner + size metadata)
- KV store (function table, runtime env URIs, cluster config)
- pubsub channels: "nodes", "actors", "actor:<hex>", "objects:<hex>"
- health: agents heartbeat; misses beyond threshold mark the node dead and
  trigger actor failover + location cleanup.

Single asyncio process; storage is in-memory (the Redis-backed persistence
tier of the reference maps to a snapshot/journal TODO, recorded in docs).
"""

from __future__ import annotations

import asyncio
import os
import random
import time
from typing import Any, Dict, List, Optional, Set, Tuple

from ray_tpu_torch.core.config import config, gcs_recovery_enabled
from ray_tpu_torch.core.recovery.window import ReconstructionWindow
from ray_tpu_torch.core.rpc import RpcServer, loop_lag_watchdog, spawn
from ray_tpu_torch.utils.logging import get_logger

logger = get_logger("gcs")


class GcsServer:
    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 persist_dir: Optional[str] = None):
        # persist_dir accepts a plain directory, file://<dir>, or
        # sqlite://<path> (pluggable persistence; reference:
        # gcs/store_client/ in-memory vs Redis backends)
        self.persist_dir = persist_dir
        self._storage = None
        if persist_dir:
            from ray_tpu_torch.core.gcs.storage import storage_backend_from_uri

            self._storage = storage_backend_from_uri(persist_dir)
        self.rpc = RpcServer(host, port)
        self.rpc.register_object(self)
        # node_id(hex) -> info dict
        self.nodes: Dict[str, Dict[str, Any]] = {}
        # available resources per node (updated by heartbeats)
        self.available: Dict[str, Dict[str, float]] = {}
        self.last_heartbeat: Dict[str, float] = {}
        # delta-sync protocol: node -> version of its last FULL view
        self._node_sync_version: Dict[str, int] = {}
        # per-node load gauges from heartbeats (dispatching counts etc.)
        self.node_load: Dict[str, Dict[str, Any]] = {}
        self.kv: Dict[str, bytes] = {}
        # actors: actor_id hex -> record
        self.actors: Dict[str, Dict[str, Any]] = {}
        self.named_actors: Dict[Tuple[str, str], str] = {}
        # (node, worker) -> signature of the last broadcast log batch
        self._log_seq: Dict[Tuple[str, str], Tuple] = {}
        # objects: object_id hex -> {size, locations: set, owner}
        self.objects: Dict[str, Dict[str, Any]] = {}
        # placement groups: pg hex -> {bundles, strategy, name, placement: [node hex]}
        self.pgs: Dict[str, Dict[str, Any]] = {}
        # per-node, per-pg-bundle reservations: node hex -> resources dict
        self._spread_rr = 0
        self._job_counter = 1
        self._health_task: Optional[asyncio.Task] = None
        self._external: Optional["ExternalPolicyClient"] = None
        self._started_at = time.time()
        # ---- distributed reference counting (reference_count.h:64 analogue,
        # GCS-mediated instead of owner-worker-mediated): object hex ->
        # holder ids ("w:<client>" processes, "task:<id>" in-flight pins).
        # Objects WITHOUT a holder entry are untracked (never auto-freed).
        self.object_holders: Dict[str, Set[str]] = {}
        # holders-empty timestamps: freed by _gc_loop after a grace window so
        # in-flight ref handoffs (borrow registered after the sender's drop)
        # don't free the object mid-transfer.
        self._pending_free: Dict[str, float] = {}
        # lineage (task_manager.h:208 analogue): return object hex -> the
        # producing task's spec, for reconstruction after all copies are lost.
        self.lineage: Dict[str, Dict[str, Any]] = {}
        # containment edges: object hex -> ids of ObjectRefs serialized inside
        # it. The container acts as holder ("obj:<hex>") of its children until
        # it is freed (owner-side "contained refs" in reference_count.h).
        self.object_contains: Dict[str, List[str]] = {}
        # w:* process holders renew a lease via heartbeat; silence beyond
        # object_holder_lease_s = crashed process, drop its holders.
        self.holder_last_seen: Dict[str, float] = {}
        # streaming generators: task hex -> stream record (items produced so
        # far, end marker, consumer watermark) — reference capability:
        # _raylet.pyx ObjectRefGenerator report paths (:1206,1263), here a
        # GCS-centralized stream directory beside the object directory
        self.streams: Dict[str, Dict[str, Any]] = {}
        # one-shot stream items: freed with a short grace once holder-less
        self._fast_free: Set[str] = set()
        self._gc_task: Optional[asyncio.Task] = None
        self._persist_task: Optional[asyncio.Task] = None
        self._schedule_calls = 0  # batched RPCs received
        self._schedule_reqs = 0   # placement requests inside them
        # req_id -> (last_seen, shape): resource requests that could not be
        # placed — the autoscaler's demand signal. Keyed so a pending task
        # retrying placement every 50ms counts ONCE, not once per retry
        # (reference: resource_demand_scheduler's pending snapshot).
        self._unmet_demand: Dict[str, Tuple[float, Dict[str, float]]] = {}
        # object hex -> futures resolved on the next location-state change
        # (registered somewhere, or lost via node death). Backs the
        # wait_object_located long-poll handlers that replace agent-side
        # lookup polling (reference: object_directory.h subscription model).
        self._object_waiters: Dict[str, List[asyncio.Future]] = {}
        # recently freed objects: a batched registration that raced the free
        # must not resurrect a directory record (entries expire in _gc_loop)
        self._freed_tombstones: Dict[str, float] = {}
        # ---- crash-restart recovery (core/recovery/) ----
        # Monotonic boot stamp persisted in the snapshot; every heartbeat /
        # register ack carries it, which is how agents and drivers detect a
        # restart and replay their registrations against THIS incarnation.
        self.gcs_epoch = 1
        self.recovery_window: Optional[ReconstructionWindow] = None
        self._recovery_task: Optional[asyncio.Task] = None
        self._resyncs_seen = 0  # full node re-registrations this incarnation

    async def start(self) -> Tuple[str, int]:
        host, port = await self.rpc.start()
        if config.external_scheduler_address:
            from ray_tpu_torch.core.gcs.external_policy import ExternalPolicyClient

            self._external = ExternalPolicyClient(config.external_scheduler_address)
            await self._external.start()
        if self._storage is not None:
            self._restore_snapshot()
            self._persist_task = spawn(self._persist_loop())
        if self.recovery_window is not None and self.recovery_window.open:
            self._recovery_task = spawn(self.recovery_window.run(self))
        self._health_task = spawn(self._health_loop())
        self._gc_task = spawn(self._gc_loop())
        self._watchdog_task = spawn(loop_lag_watchdog("gcs"))
        logger.info("GCS listening on %s:%d", host, port)
        return host, port

    async def stop(self) -> None:
        if self._persist_task:
            self._persist_task.cancel()
            if self._storage is not None:
                try:
                    self._write_snapshot(self._snapshot_state())
                except Exception:  # noqa: BLE001 - shutdown must reach rpc.stop
                    logger.exception("final snapshot failed")
        if self._health_task:
            self._health_task.cancel()
        if self._gc_task:
            self._gc_task.cancel()
        if self._recovery_task:
            self._recovery_task.cancel()
        if getattr(self, "_watchdog_task", None):
            self._watchdog_task.cancel()
        if self._external:
            await self._external.stop()
        if self._storage is not None:
            self._storage.close()
        await self.rpc.stop()

    # ------------------------------------------------------------- node table
    async def rpc_register_node(
        self,
        node_id: str,
        address: str,
        resources: Dict[str, float],
        labels: Dict[str, str],
        is_head: bool = False,
    ) -> Dict[str, Any]:
        self.nodes[node_id] = {
            "NodeID": node_id,
            "NodeManagerAddress": address,
            "Resources": dict(resources),
            "Labels": dict(labels),
            "Alive": True,
            "is_head": is_head,
            "registered_at": time.time(),
        }
        self.available[node_id] = dict(resources)
        self.last_heartbeat[node_id] = time.monotonic()
        # fresh incarnation: its first heartbeat must carry a full view
        self._node_sync_version.pop(node_id, None)
        if self.recovery_window is not None:
            self.recovery_window.node_registered(node_id)
            self._resyncs_seen += 1
        if self._external:
            self._external.add_node(node_id, resources)
        await self.rpc.publish("nodes", {"event": "register", "node": self.nodes[node_id]})
        return {"system_config": dict_config_snapshot(),
                "gcs_epoch": self.gcs_epoch}

    async def rpc_heartbeat(
        self, node_id: str, available: Optional[Dict[str, float]] = None,
        load: Optional[Dict[str, Any]] = None,
        version: Optional[int] = None,
    ) -> Any:
        """Versioned delta sync (reference: common/ray_syncer/ray_syncer.h —
        versioned resource-view gossip replacing full-payload heartbeats).
        An UNCHANGED view sends only (node_id, version): ~40 bytes instead
        of the full resource/load maps, which is what keeps 2,000-node
        heartbeat fan-in off the GCS loop. A version mismatch (GCS restarted
        from an older snapshot) answers {"resync": True} and the agent
        re-sends the full view next tick. Every ack carries ``gcs_epoch``:
        an agent observing a bump runs its full re-registration
        (core/recovery/resync.py) against this incarnation."""
        info = self.nodes.get(node_id)
        if info is None or not info.get("Alive", False):
            # unknown (GCS restarted) OR marked dead (reaped during a
            # transient partition): force re-register — acking a dead
            # node's heartbeats would leave it unschedulable forever
            return False
        self.last_heartbeat[node_id] = time.monotonic()
        ack = {"ok": True, "epoch": self.gcs_epoch}
        if available is None:
            # delta ping: valid only if we hold this version's full view
            if version is not None and \
                    self._node_sync_version.get(node_id) != version:
                return {**ack, "resync": True}
            return ack
        self.available[node_id] = dict(available)
        self.node_load[node_id] = dict(load or {})
        if version is not None:
            self._node_sync_version[node_id] = version
        return ack

    async def rpc_publish_worker_logs(self, node_id: str, worker_id: str,
                                      lines: List[str],
                                      seq: Optional[int] = None) -> bool:
        """Rebroadcast one node's new worker-log lines to subscribed drivers
        (reference: log monitor -> GCS pubsub -> driver stdout).

        ``seq`` is the publisher's file offset BEFORE this batch: the
        monitor's publish-before-advance retry is at-least-once, so an
        IDENTICAL re-published batch is dropped (exactly-once for the
        common lost-reply case). A batch with the same start but MORE lines
        (the file grew during the retry window) is re-broadcast whole —
        drivers may then see the first lines twice, but lines are never
        LOST (at-least-once beats at-most-once for logs)."""
        if seq is not None:
            key = (node_id, worker_id)
            sig = (seq, len(lines), lines[-1] if lines else "")
            if self._log_seq.get(key) == sig:
                return True  # identical re-publish: already broadcast
            self._log_seq[key] = sig
        await self.rpc.publish("worker_logs", {
            "node": node_id, "worker": worker_id, "lines": lines,
        })
        return True

    async def rpc_drain_node(self, node_id: str) -> bool:
        await self._mark_node_dead(node_id, "drained")
        return True

    async def rpc_get_nodes(self) -> List[Dict[str, Any]]:
        return list(self.nodes.values())

    async def rpc_cluster_resources(self) -> Dict[str, float]:
        total: Dict[str, float] = {}
        for info in self.nodes.values():
            if not info["Alive"]:
                continue
            for k, v in info["Resources"].items():
                total[k] = total.get(k, 0.0) + v
        return total

    async def rpc_available_resources(self) -> Dict[str, float]:
        total: Dict[str, float] = {}
        for node_id, avail in self.available.items():
            if not self.nodes.get(node_id, {}).get("Alive"):
                continue
            for k, v in avail.items():
                total[k] = total.get(k, 0.0) + v
        return total

    async def _health_loop(self) -> None:
        period = config.health_check_period_ms / 1000.0
        threshold = config.health_check_failure_threshold
        while True:
            await asyncio.sleep(period)
            now = time.monotonic()
            for node_id, info in list(self.nodes.items()):
                if not info["Alive"]:
                    continue
                if now - self.last_heartbeat.get(node_id, now) > period * threshold:
                    logger.warning("node %s missed heartbeats; marking dead", node_id[:8])
                    await self._mark_node_dead(node_id, "missed heartbeats")

    async def _mark_node_dead(self, node_id: str, reason: str) -> None:
        info = self.nodes.get(node_id)
        if info is None or not info["Alive"]:
            return
        info["Alive"] = False
        self.available.pop(node_id, None)
        if self.recovery_window is not None:
            # its provisional locations are being dropped right below; the
            # sweep has nothing left to decide about this node
            self.recovery_window.node_dead(node_id)
        # a held version must always imply a held full view (and a future
        # incarnation must never match this one's version)
        self._node_sync_version.pop(node_id, None)
        # prune per-worker log dedup state (keys carry the node's 8-hex
        # prefix) — a churny cluster would otherwise leak one entry per
        # worker ever started
        prefix = node_id[:8]
        for key in [k for k in self._log_seq if k[0] == prefix]:
            del self._log_seq[key]
        if self._external:
            self._external.remove_node(node_id)
        # drop object locations on that node; wake long-poll waiters so they
        # observe "lost" promptly and can start lineage reconstruction
        for object_id, rec in self.objects.items():
            if node_id in rec["locations"]:
                rec["locations"].discard(node_id)
                self._wake_object_waiters(object_id)
        # task pins owned by the dead node's agent would never be removed
        self._drop_node_task_pins(node_id)
        # fail over actors
        for actor_id, rec in list(self.actors.items()):
            if rec.get("node_id") == node_id and rec["state"] == "ALIVE":
                await self._on_actor_failure(actor_id, f"node died: {reason}")
        await self.rpc.publish("nodes", {"event": "dead", "node_id": node_id, "reason": reason})

    # -------------------------------------------------------------------- kv
    async def rpc_kv_put(self, key: str, value: bytes) -> bool:
        self.kv[key] = value
        if key.startswith(("fn:", "runtimeenv:")) and self._storage is not None:
            # durable-critical keys (function exports, runtime-env packages)
            # are written ONCE per content hash and silently cached by the
            # writer — losing one to a crash inside the periodic-snapshot
            # window strands every later task on "function not found in GCS
            # KV" with no path to re-export. Flush eagerly; these writes are
            # rare (once per function/package, not per task).
            try:
                state = self._snapshot_state()
                await asyncio.get_running_loop().run_in_executor(
                    None, self._write_snapshot, state)
            except Exception:  # noqa: BLE001 - persistence is best-effort
                logger.exception("eager snapshot after kv_put failed")
        return True

    async def rpc_kv_get(self, key: str) -> Optional[bytes]:
        return self.kv.get(key)

    async def rpc_kv_del(self, key: str) -> bool:
        return self.kv.pop(key, None) is not None

    async def rpc_kv_keys(self, prefix: str = "") -> List[str]:
        return [k for k in self.kv if k.startswith(prefix)]

    async def rpc_next_job_id(self) -> int:
        self._job_counter += 1
        return self._job_counter

    # -------------------------------------------------------------- placement
    def _feasible_nodes(self, resources: Dict[str, float],
                        labels: Optional[Dict[str, str]] = None) -> List[str]:
        out = []
        for node_id, info in self.nodes.items():
            if not info["Alive"]:
                continue
            if labels and any(info["Labels"].get(k) != v for k, v in labels.items()):
                continue
            total = info["Resources"]
            if all(total.get(k, 0.0) + 1e-9 >= v for k, v in resources.items()):
                out.append(node_id)
        return out

    def _fits_now(self, node_id: str, resources: Dict[str, float]) -> bool:
        avail = self.available.get(node_id, {})
        return all(avail.get(k, 0.0) + 1e-9 >= v for k, v in resources.items())

    async def rpc_schedule(
        self,
        requests: List[Dict[str, Any]],
    ) -> List[Optional[str]]:
        """Batched placement. Each request:
        {resources, strategy: {kind, node_id?, soft?, labels?, pg?, bundle?}}
        Returns a node_id hex (or None = infeasible right now) per request.
        """
        self._schedule_calls += 1
        self._schedule_reqs += len(requests)
        if self._external is not None:
            placements = await self._external.schedule_batch(requests, self)
        else:
            placements = [self._schedule_one(r) for r in requests]
        now = time.monotonic()
        for i, (req, target) in enumerate(zip(requests, placements)):
            rid = req.get("req_id") or f"anon:{self._schedule_reqs}:{i}"
            if target is None:
                self._unmet_demand[rid] = (now, dict(req.get("resources") or {}))
            else:
                self._unmet_demand.pop(rid, None)  # demand satisfied
        if len(self._unmet_demand) > 10000:
            for rid in list(self._unmet_demand)[:5000]:
                self._unmet_demand.pop(rid, None)
        return placements

    async def rpc_autoscaler_state(self, window_s: float = 30.0) -> Dict[str, Any]:
        """Demand + utilization snapshot for the autoscaler: recently-unmet
        resource shapes and per-node availability."""
        cutoff = time.monotonic() - window_s
        self._unmet_demand = {
            rid: (t, r) for rid, (t, r) in self._unmet_demand.items() if t >= cutoff
        }
        return {
            "unmet_shapes": [r for _, r in self._unmet_demand.values()],
            "nodes": {
                n: {
                    "alive": info["Alive"],
                    "address": info["NodeManagerAddress"],
                    "is_head": info.get("is_head", False),
                    "total": info["Resources"],
                    "available": self.available.get(n, {}),
                    "load": self.node_load.get(n, {}),
                    "last_heartbeat_age_s": time.monotonic()
                    - self.last_heartbeat.get(n, 0.0),
                }
                for n, info in self.nodes.items()
            },
        }

    def _schedule_one(self, req: Dict[str, Any]) -> Optional[str]:
        resources = req.get("resources") or {}
        strat = req.get("strategy") or {}
        kind = strat.get("kind", "default")
        if kind == "node_affinity":
            node_id = strat.get("node_id", "")
            if node_id in self.nodes and self.nodes[node_id]["Alive"]:
                if self._fits_now(node_id, resources):
                    return node_id
                if not strat.get("soft"):
                    return None
            elif not strat.get("soft"):
                return None
        if kind == "placement_group":
            pg = self.pgs.get(strat.get("pg", ""))
            if pg is None or pg.get("state") == "PENDING":
                return None  # pending gang: tasks wait for the reservation
            bundle = strat.get("bundle", -1)
            indices = range(len(pg["bundles"])) if bundle < 0 else [bundle]
            for i in indices:
                node_id = pg["placement"][i]
                need = pg["bundles"][i]
                if all(need.get(k, 0.0) + 1e-9 >= v for k, v in resources.items()) and \
                        self.nodes.get(node_id, {}).get("Alive"):
                    return node_id
            return None
        labels = strat.get("labels")
        feasible = self._feasible_nodes(resources, labels)
        if not feasible:
            return None
        fitting = [n for n in feasible if self._fits_now(n, resources)]
        candidates = fitting or feasible
        if kind == "spread":
            self._spread_rr += 1
            return candidates[self._spread_rr % len(candidates)]
        # hybrid: pack onto busiest node below threshold utilization, else
        # spread over top-k least-utilized (reference:
        # hybrid_scheduling_policy.h pack-until-threshold + top-k random)
        def utilization(n: str) -> float:
            total = self.nodes[n]["Resources"]
            avail = self.available.get(n, {})
            u = 0.0
            for k, tot in total.items():
                if tot > 0:
                    u = max(u, (tot - avail.get(k, tot)) / tot)
            return u

        below = [n for n in candidates if utilization(n) < config.scheduler_spread_threshold]
        if below:
            # pack: highest utilization first (fill nodes before opening new)
            return max(below, key=utilization)
        k = max(1, int(len(candidates) * config.scheduler_top_k_fraction))
        top = sorted(candidates, key=utilization)[:k]
        return random.choice(top)

    # ------------------------------------------------------- placement groups
    async def rpc_create_placement_group(
        self, pg_id: str, bundles: List[Dict[str, float]], strategy: str, name: str
    ) -> bool:
        """Register a gang; try to place it now, else leave it PENDING.
        Pending groups feed the autoscaler's demand ledger and are retried by
        _pg_retry_loop as capacity arrives (reference: GcsPlacementGroup-
        Manager pending queue + SchedulePendingPlacementGroups)."""
        if pg_id in self.pgs:
            # duplicate create (re-sent after a dropped response): the first
            # attempt won — re-placing could commit bundles on a DIFFERENT
            # node set and leak the first reservation. Makes the method
            # retry-safe.
            return True
        placed = await self._try_place_pg(pg_id, bundles, strategy, name)
        if not placed:
            self.pgs[pg_id] = {
                "bundles": [dict(b) for b in bundles],
                "strategy": strategy,
                "name": name,
                "placement": [],
                "state": "PENDING",
            }
            self._feed_pg_demand(pg_id, bundles)
        return True

    def _feed_pg_demand(self, pg_id: str, bundles: List[Dict[str, float]]) -> None:
        now = time.monotonic()
        for i, b in enumerate(bundles):
            self._unmet_demand[f"pg:{pg_id}:{i}"] = (now, dict(b))

    async def _retry_pending_pgs(self) -> None:
        for pg_id, rec in list(self.pgs.items()):
            if rec.get("state") != "PENDING":
                continue
            placed = await self._try_place_pg(
                pg_id, rec["bundles"], rec["strategy"], rec["name"]
            )
            if placed:
                for i in range(len(rec["bundles"])):
                    self._unmet_demand.pop(f"pg:{pg_id}:{i}", None)
            else:
                self._feed_pg_demand(pg_id, rec["bundles"])
                since = rec.setdefault("pending_since", time.monotonic())
                if (not rec.get("warned")
                        and time.monotonic() - since > config.infeasible_task_grace_s):
                    rec["warned"] = True
                    logger.warning(
                        "placement group %s pending for %.0fs (bundles=%s): "
                        "no capacity arrived — add nodes or an autoscaler, "
                        "or remove the group; pg.ready() blocks until placed",
                        pg_id[:8], time.monotonic() - since, rec["bundles"])

    async def _try_place_pg(
        self, pg_id: str, bundles: List[Dict[str, float]], strategy: str, name: str
    ) -> bool:
        """Two-phase gang reservation (reference: GcsPlacementGroupScheduler
        prepare/commit): compute a placement, then COMMIT each bundle on its
        agent — the agent deducts from its availability so heartbeats report
        the reduced capacity and unrelated work can't consume the gang's
        resources. Retries the whole placement if a commit races."""
        for _ in range(3):
            placement = self._plan_placement(bundles, strategy)
            if placement is None:
                return False
            committed: List[int] = []
            ok = True
            refused_node: Optional[str] = None
            for i, node_id in enumerate(placement):
                client = await self._agent_client(node_id)
                granted = False
                if client is not None:
                    try:
                        granted = await client.call(
                            "reserve_bundle", pg_id=pg_id, bundle_index=i,
                            resources=bundles[i],
                        )
                    except Exception:  # noqa: BLE001 - node may die mid-commit
                        granted = False
                if not granted:
                    ok = False
                    refused_node = node_id
                    # the RPC may have landed on the agent even though the
                    # reply was lost: roll this index back too (return_bundle
                    # is a no-op if the commit never happened)
                    committed.append(i)
                    break
                committed.append(i)
            if ok:
                self.pgs[pg_id] = {
                    "bundles": [dict(b) for b in bundles],
                    "strategy": strategy,
                    "name": name,
                    "placement": placement,
                    "state": "CREATED",
                }
                return True
            # roll back partial commits and retry against fresh availability
            for i in committed:
                client = await self._agent_client(placement[i])
                if client is not None:
                    try:
                        await client.call("return_bundle", pg_id=pg_id, bundle_index=i)
                    except Exception:  # noqa: BLE001
                        pass
            # heartbeats only refresh self.available every ~1s — far slower
            # than this retry loop. Pull the refusing node's live availability
            # directly so the replan doesn't re-pick the identical placement.
            if refused_node is not None:
                client = await self._agent_client(refused_node)
                if client is not None:
                    try:
                        info = await client.call("node_info")
                        self.available[refused_node] = dict(info["available"])
                    except Exception:  # noqa: BLE001
                        pass
            await asyncio.sleep(0.02)
        return False

    def _plan_placement(
        self, bundles: List[Dict[str, float]], strategy: str
    ) -> Optional[List[str]]:
        placement: List[Optional[str]] = [None] * len(bundles)
        # Greedy 2-phase-lite: compute placement against current availability.
        avail_copy = {n: dict(a) for n, a in self.available.items()
                      if self.nodes.get(n, {}).get("Alive")}

        def fits(node: str, need: Dict[str, float]) -> bool:
            a = avail_copy.get(node, {})
            return all(a.get(k, 0.0) + 1e-9 >= v for k, v in need.items())

        def take(node: str, need: Dict[str, float]) -> None:
            a = avail_copy[node]
            for k, v in need.items():
                a[k] = a.get(k, 0.0) - v

        def slice_of(node: str) -> Optional[str]:
            from ray_tpu_torch.core.accelerators import SLICE_LABEL

            return self.nodes.get(node, {}).get("Labels", {}).get(SLICE_LABEL)

        order = sorted(range(len(bundles)), key=lambda i: -sum(bundles[i].values()))
        used_nodes: Set[str] = set()
        for i in order:
            need = bundles[i]
            nodes = [n for n in avail_copy if fits(n, need)]
            if strategy == "STRICT_SPREAD":
                nodes = [n for n in nodes if n not in used_nodes]
            elif strategy == "STRICT_PACK":
                if used_nodes:
                    # topology: STRICT_PACK means "one interconnect domain"
                    # — the same node, or any node of the SAME SLICE when the
                    # gang started on a slice-labelled node (a GPU node's
                    # slice is its host: NVLink within it, the network
                    # across hosts)
                    gang_slices = {slice_of(n) for n in used_nodes}
                    gang_slice = next(iter(gang_slices)) if len(gang_slices) == 1 else None
                    if gang_slice is not None:
                        nodes = [n for n in nodes
                                 if n in used_nodes or slice_of(n) == gang_slice]
                    else:
                        nodes = [n for n in nodes if n in used_nodes]
            elif strategy == "PACK":
                packed = [n for n in nodes if n in used_nodes]
                nodes = packed or nodes
            elif strategy == "SPREAD":
                # prefer untouched nodes; among those, prefer untouched SLICES
                # (one bundle per failure/bandwidth domain first)
                fresh = [n for n in nodes if n not in used_nodes]
                used_slices = {slice_of(n) for n in used_nodes} - {None}
                fresh_slices = [n for n in fresh if slice_of(n) not in used_slices]
                nodes = fresh_slices or fresh or nodes
            if not nodes:
                return None
            choice = nodes[0]
            placement[i] = choice
            used_nodes.add(choice)
            take(choice, need)
        return placement

    async def rpc_remove_placement_group(self, pg_id: str) -> bool:
        pg = self.pgs.pop(pg_id, None)
        if pg is None:
            return False
        for i in range(len(pg.get("bundles", []))):
            self._unmet_demand.pop(f"pg:{pg_id}:{i}", None)
        for node_id in set(pg["placement"]):
            client = await self._agent_client(node_id)
            if client is not None:
                try:
                    await client.call("return_bundle", pg_id=pg_id, bundle_index=-1)
                except Exception:  # noqa: BLE001
                    pass
        return True

    async def rpc_placement_group_info(self, pg_id: str) -> Optional[Dict[str, Any]]:
        return self.pgs.get(pg_id)

    async def rpc_placement_group_table(self) -> Dict[str, Dict[str, Any]]:
        return dict(self.pgs)

    # ----------------------------------------------------------------- actors
    async def rpc_create_actor(
        self,
        spec: Dict[str, Any],
        class_name: str = "",
        name: str = "",
        namespace: str = "default",
        max_restarts: int = 0,
        options: Optional[bytes] = None,
    ) -> bool:
        """Register AND schedule an actor. The GCS owns actor placement and
        restart (reference: GcsActorManager + GcsActorScheduler,
        gcs_actor_scheduler.cc:49 Schedule / restart on worker death)."""
        actor_id = spec["actor_id"]
        if actor_id in self.actors:
            # idempotent by actor_id: a parked driver retry after a GCS
            # restart (or a transparently re-sent frame) must not double-
            # schedule or trip its own name reservation
            return True
        if name:
            key = (namespace, name)
            if key in self.named_actors and self.named_actors[key] != actor_id:
                raise ValueError(f"Actor name '{name}' already taken in namespace '{namespace}'")
            self.named_actors[key] = actor_id
        self.actors[actor_id] = {
            "actor_id": actor_id,
            "class_name": class_name,
            "state": "PENDING",
            "address": "",
            "node_id": "",
            "name": name,
            "namespace": namespace,
            "max_restarts": max_restarts,
            "restarts": 0,
            "spec": options,
            "creation_spec": spec,
            "death_reason": "",
        }
        spawn(self._schedule_actor(actor_id))
        return True

    async def _schedule_actor(self, actor_id: str) -> None:
        rec = self.actors.get(actor_id)
        if rec is None:
            return
        spec = rec["creation_spec"]
        request = {"resources": spec.get("resources") or {},
                   "strategy": spec.get("strategy") or {}}
        backoff = 0.02
        last_error = "unknown"
        attempts = 0
        # a pending actor is demand the autoscaler scales up from, as a
        # pending task is (the JAX package's feeds none: fault C9)
        demand = f"actor:{actor_id}"
        while True:
            rec = self.actors.get(actor_id)
            if rec is None or rec["state"] == "DEAD":
                self._unmet_demand.pop(demand, None)
                return
            target = self._schedule_one(request)
            if target is None:
                self._unmet_demand[demand] = (time.monotonic(), dict(request["resources"]))
                if not self._feasible_nodes(request["resources"]):
                    # no alive node can EVER satisfy it right now; keep
                    # waiting a bounded time for nodes to join, then fail
                    attempts += 1
                    if attempts > 200:
                        self._unmet_demand.pop(demand, None)
                        await self._actor_creation_failed(
                            actor_id, f"infeasible resources {request['resources']}"
                        )
                        return
                await asyncio.sleep(backoff)
                backoff = min(backoff * 1.5, 1.0)
                continue
            # rtpulint: disable=race -- the key is this actor's own
            self._unmet_demand.pop(demand, None)
            client = await self._agent_client(target)
            if client is None:
                await asyncio.sleep(backoff)
                continue
            try:
                result = await client.call("start_actor", spec=spec, timeout=None)
            except Exception as e:  # noqa: BLE001 - node may die mid-start
                last_error = str(e)
                await asyncio.sleep(backoff)
                backoff = min(backoff * 1.5, 1.0)
                continue
            if result.get("ok"):
                return  # agent reported actor_started
            if not result.get("retryable", True):
                await self._actor_creation_failed(
                    actor_id, result.get("error", "constructor failed"), store=False
                )
                return
            last_error = result.get("error", "start failed")
            await asyncio.sleep(backoff)
            backoff = min(backoff * 1.5, 1.0)

    async def _actor_creation_failed(self, actor_id: str, reason: str, store: bool = True) -> None:
        rec = self.actors.get(actor_id)
        if rec is None:
            return
        rec.update(state="DEAD", death_reason=reason)
        self._drop_actor_name(actor_id)
        if store:
            await self._store_error_objects(
                rec["creation_spec"].get("returns", []),
                rec["creation_spec"].get("name", "?"),
                f"actor creation failed: {reason}",
                "ActorDiedError",
            )
        await self.rpc.publish(f"actor:{actor_id}", _actor_public(rec))
        await self.rpc.publish("actors", {"event": "dead", "actor": _actor_public(rec)})

    async def _store_error_objects(self, returns: List[str], name: str,
                                   message: str, error_type: str) -> None:
        """Materialize error objects via any alive agent's store."""
        for node_id, info in self.nodes.items():
            if not info["Alive"]:
                continue
            client = await self._agent_client(node_id)
            if client is None:
                continue
            try:
                await client.call(
                    "store_error", returns=returns, name=name,
                    message=message, error_type=error_type,
                )
                return
            except Exception:  # noqa: BLE001
                continue
        logger.error("no agent available to store error objects for %s", name)

    async def _agent_client(self, node_id: str):
        from ray_tpu_torch.core.rpc import RpcClient

        info = self.nodes.get(node_id)
        if info is None or not info["Alive"]:
            return None
        client = getattr(self, "_agent_clients", None)
        if client is None:
            self._agent_clients = {}
        cached = self._agent_clients.get(node_id)
        if cached is not None and not cached._closed:
            return cached
        try:
            c = await RpcClient(info["NodeManagerAddress"]).connect(timeout=2.0)
        except Exception:  # noqa: BLE001
            return None
        self._agent_clients[node_id] = c
        return c

    async def rpc_actor_started(self, actor_id: str, node_id: str, address: str) -> bool:
        rec = self.actors.get(actor_id)
        if rec is None:
            return False
        rec.update(state="ALIVE", node_id=node_id, address=address)
        await self.rpc.publish("actors", {"event": "alive", "actor": _actor_public(rec)})
        await self.rpc.publish(f"actor:{actor_id}", _actor_public(rec))
        return True

    async def rpc_report_actor_death(self, actor_id: str, reason: str) -> bool:
        await self._on_actor_failure(actor_id, reason)
        return True

    async def rpc_kill_actor(self, actor_id: str, no_restart: bool = True) -> bool:
        rec = self.actors.get(actor_id)
        if rec is None:
            return False
        if no_restart:
            rec["max_restarts"] = 0
        rec.update(state="DEAD", death_reason="killed")
        self._drop_actor_name(actor_id)
        await self.rpc.publish(f"actor:{actor_id}", _actor_public(rec))
        await self.rpc.publish("actors", {"event": "dead", "actor": _actor_public(rec)})
        return True

    async def _on_actor_failure(self, actor_id: str, reason: str) -> None:
        rec = self.actors.get(actor_id)
        if rec is None or rec["state"] == "DEAD":
            return
        if rec["restarts"] < rec["max_restarts"]:
            rec["restarts"] += 1
            rec.update(state="RESTARTING", address="", node_id="")
            await self.rpc.publish(f"actor:{actor_id}", _actor_public(rec))
            await self.rpc.publish(
                "actors", {"event": "restarting", "actor": _actor_public(rec)}
            )
            spawn(self._schedule_actor(actor_id))
        else:
            rec.update(state="DEAD", death_reason=reason)
            self._drop_actor_name(actor_id)
            await self.rpc.publish(f"actor:{actor_id}", _actor_public(rec))
            await self.rpc.publish("actors", {"event": "dead", "actor": _actor_public(rec)})

    def _drop_actor_name(self, actor_id: str) -> None:
        for key, aid in list(self.named_actors.items()):
            if aid == actor_id:
                del self.named_actors[key]

    async def rpc_get_actor(self, actor_id: str) -> Optional[Dict[str, Any]]:
        rec = self.actors.get(actor_id)
        return _actor_public(rec) if rec else None

    async def rpc_get_actor_spec(self, actor_id: str) -> Optional[bytes]:
        rec = self.actors.get(actor_id)
        return rec.get("spec") if rec else None

    async def rpc_get_named_actor(self, name: str, namespace: str = "default") -> Optional[str]:
        return self.named_actors.get((namespace, name))

    async def rpc_list_named_actors(self, all_namespaces: bool = False,
                                    namespace: str = "default") -> List[str]:
        if all_namespaces:
            return [n for (_ns, n) in self.named_actors]
        return [n for (ns, n) in self.named_actors if ns == namespace]

    async def rpc_list_actors(self) -> List[Dict[str, Any]]:
        return [_actor_public(r) for r in self.actors.values()]

    # ---------------------------------------------------------------- objects
    async def rpc_register_object(
        self, object_id: str, size: int, node_id: str, owner: str = "",
        contained: Optional[List[str]] = None,
        payload: Optional[bytes] = None,
    ) -> bool:
        targets = await self._register_object_inner(
            object_id, size, node_id, owner, contained, payload)
        for holder, event in targets:
            await self.rpc.publish(f"sealed:{holder}", {"events": [event]})
        return True

    async def _register_object_inner(
        self, object_id: str, size: int, node_id: str, owner: str = "",
        contained: Optional[List[str]] = None,
        payload: Optional[bytes] = None,
    ) -> List[Tuple[str, Dict[str, Any]]]:
        """Register one location; returns the (holder, sealed-event) pairs to
        push (the batch path coalesces them into one frame per holder)."""
        if object_id in self._freed_tombstones:
            # freed while this registration was in flight (direct path is
            # RETRY_SAFE, so a transparent retry can land after a
            # free_object_everywhere): stay dead, never resurrect
            return []
        rec = self.objects.setdefault(
            object_id, {"size": size, "locations": set(), "owner": owner}
        )
        rec["size"] = size
        rec["locations"].add(node_id)
        rec["had_locations"] = True
        if self.recovery_window is not None:
            # an agent re-reporting a copy confirms the snapshot-restored
            # provisional (object, node) pair as authoritative
            self.recovery_window.confirm(object_id, node_id)
        self._wake_object_waiters(object_id)
        if contained:
            # ObjectRefs serialized INSIDE this object: the container holds
            # them until it is freed, so `return ray.put(x)` style nesting
            # survives the inner creator's process dropping its own refs
            self.object_contains[object_id] = list(contained)
            await self.rpc_add_object_refs(contained, f"obj:{object_id}")
        await self.rpc.publish(f"objects:{object_id}", {"size": size, "node_id": node_id})
        # push completions: every client-process holder (the submitter was
        # registered on task returns at pin time) learns of the seal without
        # polling; payloads at most the inline threshold ride in-band so the
        # holder's get() needs neither an ensure RPC nor an arena read
        # (reference: pushed object-location updates + inline small returns)
        holders = [h for h in self.object_holders.get(object_id, ())
                   if h.startswith("w:")]
        if not holders:
            return []
        if payload is not None and self.rpc.chaos_drop_inline():
            logger.warning("rpc chaos: stripping inline payload of %s",
                           object_id[:16])
            payload = None  # completion still arrives; receiver falls
            # back to the ensure+read path
        event = {"object_id": object_id, "size": size, "node_id": node_id,
                 "is_error": owner.endswith(":error")}
        if payload is not None:
            event["payload"] = payload
        return [(h, event) for h in holders]

    async def rpc_dump_stacks(self) -> str:
        """All thread stacks of THIS process (`ray_tpu_torch stack` backend;
        reference capability: `ray stack` py-spy dump)."""
        from ray_tpu_torch.utils.debug import format_all_stacks

        return format_all_stacks()

    async def rpc_list_objects(self, limit: int = 1000) -> List[Dict[str, Any]]:
        out = []
        for object_id, rec in self.objects.items():
            out.append({
                "object_id": object_id,
                "size": rec["size"],
                "locations": sorted(rec["locations"]),
                "holders": len(self.object_holders.get(object_id, ())),
                "has_lineage": object_id in self.lineage,
            })
            if len(out) >= limit:
                break
        return out

    async def rpc_lookup_object(self, object_id: str) -> Optional[Dict[str, Any]]:
        rec = self.objects.get(object_id)
        if rec is None:
            return None
        locations = sorted(rec["locations"])
        if len(locations) > 1:
            # rotate per lookup: concurrent pullers (and single-source
            # pulls with striping off) spread across holders instead of
            # all draining the lexicographically-first replica
            k = rec["_rr"] = (rec.get("_rr", 0) + 1) % len(locations)
            locations = locations[k:] + locations[:k]
        return {
            "size": rec["size"],
            "locations": locations,
            "owner": rec["owner"],
            # lost = every copy was on since-dead nodes: the value is gone and
            # only lineage reconstruction (owner resubmits the producing task)
            # can bring it back — waiting won't (object_recovery_manager.h:41).
            # Suppressed inside the reconstruction window: a provisional
            # object with zero confirmed copies may be re-reported any tick,
            # and a premature loss signal fires spurious re-executions.
            "lost": (not rec["locations"] and rec.get("had_locations", False)
                     and not self._reconstruction_open()),
        }

    def _reconstruction_open(self) -> bool:
        return self.recovery_window is not None and self.recovery_window.open

    async def rpc_lookup_objects(
        self, object_ids: List[str]
    ) -> List[Optional[Dict[str, Any]]]:
        """Batched holder lookup: one RPC resolves a whole partition set
        (a shuffle reduce task's N map-partition deps) instead of N
        round trips. Each record gets the same per-lookup holder rotation
        as ``lookup_object``."""
        return [await self.rpc_lookup_object(o) for o in object_ids]

    async def rpc_register_objects(self, regs: List[Dict[str, Any]]) -> bool:
        """Batched object registration: one RPC covers every object an agent
        sealed in the last coalescing tick (cuts a GCS round trip off every
        task-return seal; reference: flushed location updates in the
        ownership protocol). Sealed-event pushes coalesce into ONE frame per
        holder per batch — one receiver wakeup instead of one per object."""
        per_holder: Dict[str, List[Dict[str, Any]]] = {}
        for i, r in enumerate(regs):
            for holder, event in await self._register_object_inner(**r):
                per_holder.setdefault(holder, []).append(event)
            if i % 100 == 99:
                await asyncio.sleep(0)  # big batch: let heartbeats interleave
        for holder, events in per_holder.items():
            await self.rpc.publish(f"sealed:{holder}", {"events": events})
        return True

    async def rpc_pin_tasks(self, pins: List[Dict[str, Any]]) -> bool:
        """Batched pin_task (one RPC per agent coalescing tick)."""
        for p in pins:
            await self.rpc_pin_task(**p)
        return True

    def _wake_object_waiters(self, object_id: str) -> None:
        for fut in self._object_waiters.pop(object_id, ()):  # one-shot wake
            if not fut.done():
                fut.set_result(True)

    async def rpc_wait_object_located(
        self, object_id: str, timeout_s: float = 10.0
    ) -> Optional[Dict[str, Any]]:
        """Long-poll lookup: returns as soon as the object has a location (or
        is known lost), else after timeout_s with the current record.
        Replaces agent-side lookup_object polling (event-driven wait;
        reference: ownership-based object directory subscriptions,
        object_directory.h:57)."""
        deadline = time.monotonic() + timeout_s
        while True:
            rec = await self.rpc_lookup_object(object_id)
            if rec is not None and (rec["locations"] or rec["lost"]):
                return rec
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return rec
            fut: asyncio.Future = asyncio.get_event_loop().create_future()
            self._object_waiters.setdefault(object_id, []).append(fut)
            try:
                await asyncio.wait_for(fut, timeout=remaining)
            except asyncio.TimeoutError:
                waiters = self._object_waiters.get(object_id)
                if waiters and fut in waiters:
                    waiters.remove(fut)
                    if not waiters:
                        del self._object_waiters[object_id]
                return await self.rpc_lookup_object(object_id)

    async def rpc_wait_objects_located(
        self, object_ids: List[str], num_returns: int, timeout_s: float = 10.0,
        include_lost: bool = False,
    ) -> List[str]:
        """Long-poll `ray.wait` backend: block until >= num_returns of the
        ids have a registered location, then return the located subset.
        ``include_lost`` also reports ids whose every copy died (the batched
        get() path needs the loss signal promptly to start reconstruction)."""
        deadline = time.monotonic() + timeout_s

        def located() -> List[str]:
            out = []
            for object_id in object_ids:
                rec = self.objects.get(object_id)
                if rec is not None and (rec["locations"] or (
                    include_lost and not rec["locations"]
                    and rec.get("had_locations", False)
                    and not self._reconstruction_open()
                )):
                    out.append(object_id)
            return out

        while True:
            ready = located()
            if len(ready) >= min(num_returns, len(object_ids)):
                return ready
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return ready
            pending = [o for o in object_ids if o not in set(ready)]
            fut: asyncio.Future = asyncio.get_event_loop().create_future()
            for object_id in pending:
                self._object_waiters.setdefault(object_id, []).append(fut)
            try:
                await asyncio.wait_for(fut, timeout=remaining)
            except asyncio.TimeoutError:
                pass
            finally:
                for object_id in pending:
                    waiters = self._object_waiters.get(object_id)
                    if waiters and fut in waiters:
                        waiters.remove(fut)
                        if not waiters:
                            del self._object_waiters[object_id]

    async def rpc_free_object_everywhere(self, object_id: str) -> bool:
        """Explicit free: drop all bookkeeping and delete every copy.
        Idempotent (safe for transparent RPC retries — the old destructive
        pop-and-return-locations contract lost the fan-out on retry)."""
        await self._free_everywhere(object_id)
        return True

    # ------------------------------------------- distributed reference counts
    async def rpc_add_object_refs(self, object_ids: List[str], holder: str) -> bool:
        if holder.startswith("w:"):
            self.holder_last_seen[holder] = time.monotonic()
        for object_id in object_ids:
            self.object_holders.setdefault(object_id, set()).add(holder)
            self._pending_free.pop(object_id, None)
        return True

    async def rpc_pin_task(
        self,
        task_holder: str,
        deps: List[str],
        returns: List[str],
        submitter: str = "",
        spec: Optional[Dict[str, Any]] = None,
    ) -> bool:
        """One-shot task-submission bookkeeping (single RPC on the submit hot
        path): pin deps+returns under the task holder, register the
        submitter's holder on the returns, retain the spec as lineage."""
        await self.rpc_add_object_refs(deps + returns, task_holder)
        if submitter:
            await self.rpc_add_object_refs(returns, submitter)
        if spec is not None:
            for object_id in returns:
                self.lineage[object_id] = spec
        return True

    async def rpc_unpin_tasks(self, unpins: List[Dict[str, Any]]) -> bool:
        """Batched task-pin release (one RPC per client coalescing tick —
        the pipelined actor path's counterpart to rpc_pin_tasks)."""
        for u in unpins:
            await self.rpc_remove_object_refs(u["object_ids"], u["holder"])
        return True

    async def rpc_holder_heartbeat(self, holder: str) -> Dict[str, Any]:
        self.holder_last_seen[holder] = time.monotonic()
        # the ack carries the GCS incarnation: a driver has no node heartbeat,
        # so its ref flusher's lease renewal doubles as epoch observation
        return {"ok": True, "epoch": self.gcs_epoch}

    async def rpc_remove_object_refs(self, object_ids: List[str], holder: str) -> bool:
        now = time.monotonic()
        for object_id in object_ids:
            holders = self.object_holders.get(object_id)
            if holders is None:
                continue  # untracked object: explicit free()/LRU only
            holders.discard(holder)
            if not holders:
                self._pending_free[object_id] = now
        return True

    async def rpc_drop_holder(self, holder: str) -> int:
        """Remove a holder from every object (dead worker / departing driver).
        Returns how many objects it was dropped from."""
        n = 0
        now = time.monotonic()
        for object_id, holders in self.object_holders.items():
            if holder in holders:
                holders.discard(holder)
                n += 1
                if not holders:
                    self._pending_free[object_id] = now
        return n

    # ------------------------------------------------- streaming generators
    def _stream(self, task_id: str) -> Dict[str, Any]:
        rec = self.streams.get(task_id)
        if rec is None:
            rec = {
                "items": {},        # index -> object id hex
                "finished": False,
                "total": 0,
                "consumed": 0,      # consumer watermark: next index wanted
                "closed": False,
                "waiters": [],      # futures woken on any state change
                "updated": time.monotonic(),
            }
            self.streams[task_id] = rec
        return rec

    @staticmethod
    def _stream_wake(rec: Dict[str, Any]) -> None:
        waiters, rec["waiters"] = rec["waiters"], []
        for fut in waiters:
            if not fut.done():
                fut.set_result(None)
        rec["updated"] = time.monotonic()

    async def _stream_changed(self, rec: Dict[str, Any], chunk_s: float) -> None:
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        rec["waiters"].append(fut)
        try:
            await asyncio.wait_for(fut, chunk_s)
        except (asyncio.TimeoutError, TimeoutError):
            pass

    @staticmethod
    def _stream_holder(task_id: str) -> str:
        return f"stream:{task_id}"

    async def rpc_stream_put(self, task_id: str, index: int, object_id: str) -> Dict[str, Any]:
        """Producer reports item ``index``. The item is pinned under the
        stream's own holder (dynamic return ids can't be pinned at submit
        time); that pin is dropped as the consumer watermark passes the item,
        leaving only the consumer's ref — so consumed-and-dropped items free
        promptly while kept refs stay valid. Returns the consumer watermark
        for backpressure."""
        rec = self._stream(task_id)
        rec["items"][index] = object_id
        await self.rpc_add_object_refs([object_id], self._stream_holder(task_id))
        # one-shot stream items use a short free grace once their holders
        # empty: a 1,000-item stream must not accumulate a full ref-grace
        # window of consumed items in the store
        self._fast_free.add(object_id)
        self._stream_wake(rec)
        return {"consumed": rec["consumed"], "closed": rec["closed"]}

    async def rpc_stream_end(self, task_id: str, total: int) -> bool:
        rec = self._stream(task_id)
        rec["finished"] = True
        rec["total"] = total
        self._stream_wake(rec)
        return True

    async def rpc_stream_state(self, task_id: str) -> Dict[str, Any]:
        """Producer-side introspection (used by agents to report a failure at
        the correct index of a partially-produced stream)."""
        rec = self.streams.get(task_id)
        if rec is None:
            return {"produced": 0, "finished": False, "consumed": 0}
        return {"produced": len(rec["items"]), "finished": rec["finished"],
                "consumed": rec["consumed"]}

    async def rpc_stream_next(self, task_id: str, index: int,
                              timeout_s: Optional[float] = None) -> Dict[str, Any]:
        """Consumer long-poll for item ``index``; asking for index i doubles
        as the consumed-watermark update (items < i acknowledged), which is
        what producer backpressure waits on."""
        rec = self._stream(task_id)
        if index > rec["consumed"]:
            old = rec["consumed"]
            rec["consumed"] = index
            # the consumer has items < index in hand (its own ref holders
            # flush within the ref-sync interval, well inside the free
            # grace): drop the stream pin so consumed items can free
            passed = [rec["items"][j] for j in range(old, index) if j in rec["items"]]
            if passed:
                await self.rpc_remove_object_refs(passed, self._stream_holder(task_id))
            self._stream_wake(rec)  # unblock a producer waiting on capacity
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        while True:
            if index in rec["items"]:
                return {"object_id": rec["items"][index]}
            if rec["finished"]:
                return {"end": rec["total"]}
            remaining = None if deadline is None else deadline - time.monotonic()
            if remaining is not None and remaining <= 0:
                return {"timeout": True}
            chunk = 5.0 if remaining is None else min(remaining, 5.0)
            await self._stream_changed(rec, chunk)

    async def rpc_stream_wait(self, task_id: str, index: int, max_ahead: int,
                              timeout_s: Optional[float] = None) -> Dict[str, Any]:
        """Producer backpressure gate: block until producing item ``index``
        would be < max_ahead items past the consumer, or the stream closed."""
        rec = self._stream(task_id)
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        while (index - rec["consumed"]) >= max_ahead and not rec["closed"]:
            remaining = None if deadline is None else deadline - time.monotonic()
            if remaining is not None and remaining <= 0:
                return {"timeout": True, "closed": rec["closed"]}
            await self._stream_changed(rec, 5.0 if remaining is None else min(remaining, 5.0))
        return {"closed": rec["closed"], "consumed": rec["consumed"]}

    async def rpc_stream_close(self, task_id: str) -> bool:
        """Consumer abandoned the stream: stop the producer and release the
        submitter's holders on items it never consumed."""
        rec = self.streams.get(task_id)
        if rec is None:
            # record the closure so a producer's later put/wait sees it
            rec = self._stream(task_id)
        rec["closed"] = True
        unconsumed = [oid for idx, oid in rec["items"].items()
                      if idx >= rec["consumed"]]
        if unconsumed:
            await self.rpc_remove_object_refs(unconsumed, self._stream_holder(task_id))
        self._stream_wake(rec)
        return True

    async def _reap_streams(self) -> None:
        """Drop stream records that can no longer matter: fully consumed,
        or closed/abandoned and idle past the holder lease."""
        now = time.monotonic()
        stale = now - config.object_holder_lease_s
        doomed = [
            t for t, rec in self.streams.items()
            if not rec["waiters"] and (
                # fully consumed: linger briefly so a retried final
                # stream_next still sees the end marker instead of a
                # recreated empty record
                (rec["finished"] and rec["consumed"] >= rec["total"]
                 and rec["updated"] < now - 5.0)
                or (rec["closed"] and rec["updated"] < stale)
                or rec["updated"] < now - 10 * config.object_holder_lease_s
            )
        ]
        for t in doomed:
            rec = self.streams.pop(t)
            # abandoned/finished streams must not pin items forever
            if rec["items"]:
                await self.rpc_remove_object_refs(
                    list(rec["items"].values()), self._stream_holder(t)
                )

    async def _gc_loop(self) -> None:
        """Free objects whose cluster-wide holder set has been empty for a
        full grace window (the window absorbs in-flight ref handoffs: a
        receiver registering its borrow after the sender already dropped).
        Also reaps holders of crashed processes: w:* holders past their
        heartbeat lease, and task:*@node pins whose node is dead."""
        while True:
            await asyncio.sleep(min(0.25, config.object_ref_grace_s / 4))
            self._reap_stale_holders()
            await self._reap_streams()
            try:
                await self._retry_pending_pgs()
            except Exception:  # noqa: BLE001 - retries must not kill the loop
                logger.exception("pending placement-group retry failed")
            if self._freed_tombstones:
                tomb_cutoff = time.monotonic() - 30.0
                for o in [o for o, t in self._freed_tombstones.items()
                          if t <= tomb_cutoff]:
                    del self._freed_tombstones[o]
            if not self._pending_free:
                continue
            now = time.monotonic()
            cutoff = now - config.object_ref_grace_s
            # stream items get a short grace: the only handoff to absorb is
            # the consumer's ref-sync flush (~ref_sync_interval_s)
            fast_cutoff = now - max(0.25, 5 * config.ref_sync_interval_s)
            expired = [
                o for o, t in self._pending_free.items()
                if t <= (fast_cutoff if o in self._fast_free else cutoff)
            ]
            for object_id in expired:
                if self.object_holders.get(object_id):
                    self._pending_free.pop(object_id, None)
                    continue  # a holder came back during the grace window
                self._fast_free.discard(object_id)
                await self._free_everywhere(object_id)

    def _reap_stale_holders(self) -> None:
        now = time.monotonic()
        lease = config.object_holder_lease_s
        stale = {
            h for h, seen in self.holder_last_seen.items() if now - seen > lease
        }
        if not stale:
            return
        for holder in stale:
            self.holder_last_seen.pop(holder, None)
            logger.info("reaping stale holder %s (missed lease)", holder[:24])
        # a dead process's in-flight task pins (task:<id>@w:<client>) die too
        dead_suffixes = tuple(f"@{h}" for h in stale)
        for object_id, holders in self.object_holders.items():
            doomed = holders & stale
            doomed |= {h for h in holders
                       if h.startswith("task:") and h.endswith(dead_suffixes)}
            if doomed:
                holders -= doomed
                if not holders:
                    self._pending_free[object_id] = now

    def _drop_node_task_pins(self, node_id: str) -> None:
        """Task pins are namespaced task:<id>@<node>; the owning agent removes
        them on completion — unless the whole node died first."""
        suffix = f"@{node_id}"
        now = time.monotonic()
        for object_id, holders in self.object_holders.items():
            dead = {h for h in holders if h.startswith("task:") and h.endswith(suffix)}
            if dead:
                holders -= dead
                if not holders:
                    self._pending_free[object_id] = now

    async def _free_everywhere(self, object_id: str) -> None:
        rec = self.objects.pop(object_id, None)
        self.object_holders.pop(object_id, None)
        self._pending_free.pop(object_id, None)
        self.lineage.pop(object_id, None)
        self._freed_tombstones[object_id] = time.monotonic()
        # the container's grip on its children dies with it (cascade)
        contained = self.object_contains.pop(object_id, [])
        if contained:
            await self.rpc_remove_object_refs(contained, f"obj:{object_id}")
        for node_id in sorted(rec["locations"]) if rec else []:
            client = await self._agent_client(node_id)
            if client is not None:
                try:
                    await client.call("delete_local_object", object_id=object_id)
                except Exception:  # noqa: BLE001
                    pass

    # ------------------------------------------------------------------ lineage
    async def rpc_get_lineage(self, object_id: str) -> Optional[Dict[str, Any]]:
        return self.lineage.get(object_id)

    # ------------------------------------------------------------ persistence
    # Reference capability: src/ray/gcs/store_client/redis_store_client —
    # control-plane state survives GCS process death. Redesign: periodic
    # atomic msgpack snapshots to local disk (no external store to operate);
    # agents re-register on heartbeat rejection and drivers reconnect, so a
    # restarted GCS resumes from the last snapshot.
    def _snapshot_state(self) -> Dict[str, Any]:
        # Shallow-copies every mutable container so the dict can be serialized
        # off the event loop while RPC handlers keep mutating live state.
        return {
            "nodes": {n: dict(v) for n, v in self.nodes.items()},
            "available": {n: dict(v) for n, v in self.available.items()},
            "node_load": dict(self.node_load),
            "kv": dict(self.kv),
            "actors": {a: dict(v) for a, v in self.actors.items()},
            "named_actors": {f"{ns}\x00{name}": aid for (ns, name), aid
                             in self.named_actors.items()},
            "objects": {
                o: {"size": r["size"], "locations": sorted(r["locations"]),
                    "owner": r.get("owner", ""),
                    "had_locations": r.get("had_locations", False)}
                for o, r in self.objects.items()
            },
            "object_holders": {o: sorted(h) for o, h in self.object_holders.items()},
            "object_contains": {o: list(c) for o, c in self.object_contains.items()},
            "lineage": {o: dict(v) for o, v in self.lineage.items()},
            "pgs": {p: dict(v) for p, v in self.pgs.items()},
            "job_counter": self._job_counter,
            "gcs_epoch": self.gcs_epoch,
        }

    def _write_snapshot(self, state: Dict[str, Any]) -> None:
        self._storage.save(state)

    def _restore_snapshot(self) -> None:
        try:
            s = self._storage.load()
        except Exception:  # noqa: BLE001 - a corrupt snapshot must not brick startup
            logger.exception("snapshot restore failed; starting fresh")
            return
        if s is None:
            return
        self.nodes = s.get("nodes", {})
        self.available = s.get("available", {})
        self.node_load = s.get("node_load", {})
        self.kv = s.get("kv", {})
        self.actors = s.get("actors", {})
        self.named_actors = {
            tuple(k.split("\x00", 1)): v
            for k, v in s.get("named_actors", {}).items()
        }
        self.objects = {
            o: {"size": r["size"], "locations": set(r["locations"]),
                "owner": r.get("owner", ""),
                "had_locations": r.get("had_locations", False)}
            for o, r in s.get("objects", {}).items()
        }
        self.object_holders = {o: set(h) for o, h in
                               s.get("object_holders", {}).items()}
        self.object_contains = s.get("object_contains", {})
        self.lineage = s.get("lineage", {})
        self.pgs = s.get("pgs", {})
        self._job_counter = s.get("job_counter", 1)
        # new incarnation: every epoch observer (agent heartbeats, driver
        # holder_heartbeat acks) sees the bump and triggers its resync
        self.gcs_epoch = s.get("gcs_epoch", 0) + 1
        if gcs_recovery_enabled():
            # restored directory/node state is authoritative-but-stale until
            # agents re-report it; the window bounds how long we wait
            self.recovery_window = ReconstructionWindow(self.objects, self.nodes)
        # nodes must prove liveness again: stamp now so the health loop gives
        # them a full window to heartbeat before declaring them dead
        now = time.monotonic()
        for node_id in self.nodes:
            self.last_heartbeat[node_id] = now
        # holders likewise: restored w:* holders whose processes died while the
        # GCS was down must age out via the normal lease, so give each a fresh
        # last-seen stamp (otherwise _reap_stale_holders never sees them and
        # their objects stay pinned forever). Only w:* process holders — obj:*
        # containers never heartbeat (they'd be falsely reaped one lease later)
        # and task:*@w:* pins already die with their process's holder.
        for holders in self.object_holders.values():
            for holder in holders:
                if holder.startswith("w:"):
                    self.holder_last_seen.setdefault(holder, now)
        # a PENDING actor restored from the snapshot has no scheduling loop
        # (its driver's create_actor retry dedupes by actor_id and returns
        # without re-scheduling): restart placement for it here
        for actor_id, rec in self.actors.items():
            if rec.get("state") == "PENDING":
                spawn(self._schedule_actor(actor_id))
        logger.info(
            "restored GCS snapshot: %d nodes, %d actors, %d objects, %d kv "
            "(epoch %d)",
            len(self.nodes), len(self.actors), len(self.objects), len(self.kv),
            self.gcs_epoch,
        )

    async def _persist_loop(self) -> None:
        while True:
            await asyncio.sleep(config.gcs_snapshot_interval_s)
            try:
                # Copy state on the event loop (no concurrent mutation), then
                # serialize + write off-loop.
                state = self._snapshot_state()
                await asyncio.get_running_loop().run_in_executor(
                    None, self._write_snapshot, state
                )
            except Exception:  # noqa: BLE001
                logger.exception("snapshot write failed")

    # ------------------------------------------------------------------ debug
    async def rpc_debug_state(self) -> Dict[str, Any]:
        return {
            "nodes": len([n for n in self.nodes.values() if n["Alive"]]),
            "actors": len(self.actors),
            "objects": len(self.objects),
            "tracked_refs": len(self.object_holders),
            "pending_free": len(self._pending_free),
            "lineage_entries": len(self.lineage),
            "pgs": len(self.pgs),
            "kv_keys": len(self.kv),
            "schedule_calls": self._schedule_calls,
            "schedule_requests": self._schedule_reqs,
            "uptime_s": time.time() - self._started_at,
            "gcs_epoch": self.gcs_epoch,
            "recovery": {
                "window_open": self._reconstruction_open(),
                "provisional": (self.recovery_window.remaining()
                                if self.recovery_window is not None else 0),
                "converged_in_s": (self.recovery_window.converged_in_s
                                   if self.recovery_window is not None else 0.0),
                "resyncs": self._resyncs_seen,
            },
        }


def _actor_public(rec: Dict[str, Any]) -> Dict[str, Any]:
    return {k: v for k, v in rec.items() if k != "spec"}


def dict_config_snapshot() -> Dict[str, Any]:
    return config.snapshot()


async def serve_forever(host: str = "127.0.0.1", port: int = 0,
                        ready_file: Optional[str] = None,
                        persist_dir: Optional[str] = None) -> None:
    server = GcsServer(host, port, persist_dir=persist_dir)
    h, p = await server.start()
    if ready_file:
        with open(ready_file, "w") as f:
            f.write(f"{h}:{p}")
    await asyncio.Event().wait()


def main() -> None:
    import argparse

    parser = argparse.ArgumentParser(description="ray_tpu_torch GCS server")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--ready-file", default=None)
    parser.add_argument("--persist-dir", default=None)
    args = parser.parse_args()
    asyncio.run(serve_forever(args.host, args.port, args.ready_file,
                              args.persist_dir))


if __name__ == "__main__":
    main()
