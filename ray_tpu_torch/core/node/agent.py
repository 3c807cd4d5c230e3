"""Node agent — the raylet equivalent (own copy of ray_tpu.core.node.agent,
with GPU cards where the JAX package leases TPU chips).

Reference capability: src/ray/raylet/ (NodeManager node_manager.cc worker
leasing + dependency pulling + object pinning, WorkerPool worker_pool.h:174,
LocalObjectManager spilling, ObjectManager push/pull object_manager.h:117).
One asyncio process per node:

- registers the node (+GPU and host labels) with the GCS, heartbeats available
  resources;
- supervises a pool of worker processes (spawned on demand up to the CPU
  count, reused across leases, keyed by runtime env hash);
- dispatches tasks: placement via batched GCS scheduling, dependency
  ensure-local (chunked pulls from peer agents), worker lease, direct push
  to the worker; retries on worker death; failure results become error
  objects so ``get()`` raises exactly like the local runtime;
- hosts the node's shared-memory object store lifecycle (create/seal/pull/
  restore/delete) and serves chunked reads to peer agents;
- starts actors on leased-for-life workers and reports their direct RPC
  address to the GCS actor directory.
"""

from __future__ import annotations

import asyncio
import os
import subprocess
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional, Set, Tuple

from ray_tpu_torch.core.config import config, gcs_recovery_enabled, raw_transfer_enabled
from ray_tpu_torch.core.ids import NodeID, ObjectID
from ray_tpu_torch.core.node.transfer import TransferManager
from ray_tpu_torch.core.rpc import (RawResult, RpcClient, RpcConnectionError,
                              RpcError, RpcServer, loop_lag_watchdog, spawn)
from ray_tpu_torch.core.shm_store import SHM_PREFIX, ShmObjectStore, ShmReader, ShmWriter
from ray_tpu_torch.utils.logging import get_logger

logger = get_logger("node_agent")


def _gauge(name: str, desc: str):
    """Get-or-create a gauge with tag support (idempotent registration)."""
    from ray_tpu_torch.utils import metrics

    g = metrics.registry.get(name)
    if g is None:
        g = metrics.Gauge(name, desc, tag_keys=("resource",))
    return g


class _WorkerHandle:
    def __init__(self, proc: subprocess.Popen, worker_id: str):
        self.proc = proc
        self.worker_id = worker_id
        self.address: Optional[str] = None
        self.client: Optional[RpcClient] = None
        self.state = "STARTING"  # STARTING | IDLE | LEASED | ACTOR | DEAD
        self.actor_id: Optional[str] = None
        self.client_holder: Optional[str] = None  # GCS ref-holder id of the process
        self.ready = asyncio.Event()
        self.lease_token: Optional[Tuple[str, Any, Dict[str, float]]] = None
        self._actor_token: Optional[Tuple[str, Any, Dict[str, float]]] = None
        self.blocked = False
        self.gpu_chips: Optional[Tuple[int, ...]] = None  # dedicated chip subset
        self.env_hash: str = ""          # runtime-env pool key
        self.staged_cwd: Optional[str] = None
        # task currently executing on this worker (OOM kill-policy input)
        self.running_task: Optional[Dict[str, Any]] = None
        self.task_started_at: float = 0.0


class NodeAgent:
    def __init__(
        self,
        gcs_address: str,
        host: str = "127.0.0.1",
        port: int = 0,
        num_cpus: Optional[int] = None,
        num_gpus: int = 0,
        resources: Optional[Dict[str, float]] = None,
        labels: Optional[Dict[str, str]] = None,
        is_head: bool = False,
        session_dir: Optional[str] = None,
        object_store_memory: Optional[int] = None,
    ):
        self.node_id = NodeID.from_random()
        self.hex = self.node_id.hex()
        self.gcs_address = gcs_address
        self.rpc = RpcServer(host, port)
        self.rpc.register_object(self)
        self.is_head = is_head
        from ray_tpu_torch.core import accelerators

        ncpus = num_cpus if num_cpus is not None else (os.cpu_count() or 1)
        self.total_resources: Dict[str, float] = {"CPU": float(ncpus), **(resources or {})}
        # GPU model: explicit num_gpus wins; otherwise count the cards
        # (device files, never a CUDA context) + host label (accelerators.py)
        if num_gpus:
            self.total_resources["GPU"] = float(num_gpus)
        else:
            self.total_resources.update(accelerators.node_gpu_resources())
        self._total_chips = int(self.total_resources.get("GPU", 0))
        self._free_chips: List[int] = list(range(self._total_chips))
        # card-set tuple -> idle dedicated GPU workers (their CUDA context
        # and loaded kernels stay warm)
        self._gpu_idle: Dict[Tuple[int, ...], List[_WorkerHandle]] = {}
        self.total_resources[f"node:{self.hex}"] = 1.0
        self.available: Dict[str, float] = dict(self.total_resources)
        self.labels = {**accelerators.node_gpu_labels(), **(labels or {})}
        self.session_dir = session_dir or os.path.join(
            tempfile.gettempdir(), "ray_tpu_torch", str(os.getpid()))
        os.makedirs(self.session_dir, exist_ok=True)
        self.store = ShmObjectStore(
            self.hex,
            capacity_bytes=object_store_memory,
            spill_dir=os.path.join(self.session_dir, "spill", self.hex[:8]),
        )
        # shm-locality nonce (rpc_node_info "shm_probe"): proves a client is
        # on THIS machine regardless of hostname collisions across clones
        import uuid as _uuid

        self._shm_probe_nonce = _uuid.uuid4().hex
        self._shm_probe_path = f"/dev/shm/{SHM_PREFIX}probe-{self.hex[:16]}"
        try:
            with open(self._shm_probe_path, "w") as f:
                f.write(self._shm_probe_nonce)
        except OSError:  # no usable /dev/shm: direct plane impossible anyway
            self._shm_probe_path = ""
        # object_id hex -> error flag (mirror of GCS metadata for local objs)
        self.error_objects: Set[str] = set()
        # object_id hex -> (owner, contained): sealed-object metadata kept so
        # a peer's pull gets it piggybacked on the first chunk reply instead
        # of paying a post-transfer object_info/GCS round trip (bounded FIFO)
        from collections import OrderedDict as _OD

        self._object_meta: "_OD[str, Tuple[str, Optional[List[str]]]]" = _OD()
        # raw-frame transfer plane: pull manager + chunked-ingest writer
        # cache + per-transfer stats (reference: ObjectManager pull/push)
        self.transfer = TransferManager(self)
        self.rpc.register_raw("receive_chunk_raw", self.transfer.open_ingest)
        self.gcs: Optional[RpcClient] = None
        self._workers: Dict[str, _WorkerHandle] = {}
        # idle task-pool workers, keyed by runtime-env hash ("" = plain):
        # envs never share worker processes (reference: pool env isolation)
        self._idle_workers: Dict[str, List[_WorkerHandle]] = {}
        # env-hash -> event set whenever a worker of that env becomes IDLE;
        # _lease_worker blocks on this instead of a fixed-interval poll
        self._worker_free_events: Dict[str, asyncio.Event] = {}
        # FIFO of local-queue waiters; each resource release wakes exactly ONE
        # (a broadcast event here stampedes the loop: hundreds of queued
        # dispatches all waking per task completion)
        from collections import deque as _deque

        self._local_wait_q: "_deque[asyncio.Future]" = _deque()
        self._local_waiters = 0  # LIVE waiters (deque may hold stale futures)
        self._memory_task: Optional[asyncio.Task] = None
        self._log_monitor_task: Optional[asyncio.Task] = None
        # task_id -> OOM kill message: lets the dispatch path distinguish an
        # intentional memory-monitor kill from a plain worker crash
        self._oom_kills: Dict[str, str] = {}
        # worker_id -> last-seen absolute Arrow decode counters from run_task
        # replies (columnar exchange); node_info sums them so the shuffle
        # coordinator can diff zero-copy vs copied bytes per exchange
        self._worker_decode: Dict[str, Dict[str, int]] = {}
        # GCS write batching: submit-time pins and seal-time registrations
        # coalesce into one RPC per tick each, taking two GCS round trips off
        # every task's critical path (reference: batched location/ref flushes
        # in the ownership protocol)
        self._pin_queue: List[Tuple[Dict[str, Any], asyncio.Future]] = []
        self._pin_event = asyncio.Event()
        self._pin_flusher: Optional[asyncio.Task] = None
        self._reg_queue: List[Dict[str, Any]] = []
        self._reg_event = asyncio.Event()
        self._reg_flusher: Optional[asyncio.Task] = None
        # task-pin releases coalesce the same way (one unpin_tasks RPC per
        # tick instead of one remove_object_refs round trip per finished
        # task — the last per-task GCS RPC on the agent's hot path)
        self._unpin_queue: List[Dict[str, Any]] = []
        self._unpin_event = asyncio.Event()
        self._unpin_flusher: Optional[asyncio.Task] = None
        self._peer_clients: Dict[str, RpcClient] = {}
        # dedicated bulk-transfer connections per peer: multi-MB chunk
        # payloads must not head-of-line-block control RPCs sharing a socket
        self._transfer_clients: Dict[str, RpcClient] = {}
        self._peer_addr_cache: Dict[str, str] = {}
        self._hb_task: Optional[asyncio.Task] = None
        self._hb_client: Optional[RpcClient] = None  # dedicated heartbeat conn
        # delta-sync state: version of the current view, whether the full
        # payload must ride the next tick, and the last view sent
        self._hb_version = 0
        self._hb_full_pending = True
        self._hb_last_view: Optional[tuple] = None
        self._supervise_task: Optional[asyncio.Task] = None
        # GCS crash-restart recovery (core/recovery/resync.py): last epoch
        # observed on a heartbeat ack; a bump means a new GCS incarnation and
        # triggers a full re-registration of node/objects/actors/pins
        self._last_gcs_epoch: Optional[int] = None
        self._resync_task: Optional[asyncio.Task] = None
        self._resync_rerun = False
        self._resyncs = 0
        # task_holder -> pin kwargs of tasks still in flight on this node;
        # the resync re-asserts these leases so a restarted GCS can't reap
        # in-progress returns that were pinned after its last snapshot
        self._active_pins: Dict[str, Dict[str, Any]] = {}
        self._pull_locks: Dict[str, asyncio.Lock] = {}
        self._recon_locks: Dict[str, asyncio.Lock] = {}
        self._recon_attempts: Dict[str, int] = {}
        from collections import OrderedDict

        # task_id -> accept time: dedupes retried submit_task RPCs
        self._accepted_tasks: "OrderedDict[str, float]" = OrderedDict()
        # coalescing queue for GCS placement requests (one RPC per tick)
        self._sched_queue: List[Tuple[Dict[str, Any], asyncio.Future]] = []
        self._sched_drainer: Optional[asyncio.Task] = None
        # task_id -> lifecycle state (observability; state API reads this)
        self._task_states: Dict[str, str] = {}
        self._profile_events: List[Dict[str, Any]] = []
        # task_id -> [(wall_ts, state), ...] transition log (timeline source;
        # reference capability: core_worker/profile_event.h -> GcsTaskManager
        # -> `ray timeline` chrome trace)
        self._task_events: Dict[str, List[Tuple[float, str]]] = {}
        # job_id -> {proc, log, entrypoint, started} (job supervisor)
        self._jobs: Dict[str, Dict[str, Any]] = {}
        # task_id -> when it first became cluster-infeasible (grace window
        # lets the autoscaler add capacity before the task errors)
        self._infeasible_since: Dict[str, float] = {}
        # in-flight local dispatches (queued-or-running): heartbeated to the
        # GCS so the autoscaler never scales away a node with assigned work
        self._active_dispatches = 0
        # task_id -> first time its dispatch target was unreachable
        self._unreachable_since: Dict[str, float] = {}
        self._max_workers = max(1, int(ncpus))
        self.dashboard = None  # DashboardHead on the head node
        self._shutting_down = False
        # committed placement-group bundle reservations living on THIS node:
        # (pg_id, bundle_index) -> {"total": resources, "avail": remaining}.
        # Reserved out of self.available at prepare time so heartbeats report
        # the reduced capacity and unrelated tasks can't consume a gang's
        # resources (reference: raylet prepared/committed bundle state).
        self._pg_bundles: Dict[Tuple[str, int], Dict[str, Dict[str, float]]] = {}

    # ------------------------------------------------------------- lifecycle
    async def start(self) -> Tuple[str, int]:
        host, port = await self.rpc.start()
        self.gcs = await RpcClient(self.gcs_address).connect()
        resp = await self.gcs.call(
            "register_node",
            node_id=self.hex,
            address=self.rpc.address,
            resources=self.total_resources,
            labels=self.labels,
            is_head=self.is_head,
        )
        if isinstance(resp, dict):
            self._last_gcs_epoch = resp.get("gcs_epoch")
        await self.gcs.subscribe("nodes", self._on_node_event)
        self._hb_task = spawn(self._heartbeat_loop())
        self._supervise_task = spawn(self._supervise_loop())
        if config.log_to_driver:
            self._log_monitor_task = spawn(self._log_monitor_loop())
        if config.memory_monitor_refresh_ms > 0:
            self._memory_task = spawn(self._memory_monitor_loop())
        self._pin_flusher = spawn(self._pin_flush_loop())
        self._reg_flusher = spawn(self._reg_flush_loop())
        self._unpin_flusher = spawn(self._unpin_flush_loop())
        self._watchdog_task = spawn(loop_lag_watchdog("agent"))
        if self.is_head and config.dashboard_port >= 0:
            from ray_tpu_torch.dashboard.head import DashboardHead

            self.dashboard = DashboardHead(
                self, host=config.dashboard_host, port=config.dashboard_port
            )
            try:
                addr = await self.dashboard.start()
                await self.gcs.call("kv_put", key="dashboard:address",
                                    value=addr.encode())
            except Exception:  # noqa: BLE001 - observability must not block boot
                logger.exception("dashboard failed to start")
                if self.dashboard is not None:
                    try:  # kv_put may have failed AFTER the server came up
                        await self.dashboard.stop()
                    except Exception:  # noqa: BLE001
                        pass
                    self.dashboard = None
        logger.info("node agent %s listening on %s", self.hex[:8], self.rpc.address)
        return host, port

    async def stop(self) -> None:
        self._shutting_down = True
        if self.dashboard is not None:
            await self.dashboard.stop()
        for t in (self._hb_task, self._supervise_task, self._memory_task,
                  self._pin_flusher, self._reg_flusher, self._unpin_flusher,
                  self._log_monitor_task, self._resync_task,
                  getattr(self, "_watchdog_task", None)):
            if t:
                t.cancel()
        if self._hb_client is not None:
            try:
                await self._hb_client.close()
            except Exception:  # noqa: BLE001
                pass
        for w in self._workers.values():
            try:
                w.proc.terminate()
            except Exception:
                pass
        self.store.cleanup()
        await self.rpc.stop()

    def _on_node_event(self, event: Dict[str, Any]) -> None:
        if event.get("event") == "dead":
            node_id = event.get("node_id", "")
            self._peer_addr_cache.pop(node_id, None)
            for pool in (self._peer_clients, self._transfer_clients):
                client = pool.pop(node_id, None)
                if client is not None:
                    spawn(client.close())

    async def _log_monitor_loop(self) -> None:
        """Tail this node's worker logs and push NEW lines to the GCS
        "worker_logs" pubsub channel, where connected drivers print them
        (reference: _private/log_monitor.py:103 — per-node log monitor
        publishing to the driver's stdout). Only growth after tail start
        ships; batches are capped so one chatty worker can't flood a tick.
        NOTE: fan-out is cluster-wide — every connected driver mirrors
        every worker's output; per-job filtering (the reference scopes
        lines by owning job) needs a worker->job registry and is a
        roadmap item. Opt out per driver with init(log_to_driver=False)
        or cluster-wide with config log_to_driver=false."""
        import glob as _glob

        window = 64 * 1024
        max_lines = 200
        # content existing at monitor START predates the tail: skip it.
        # Priming here (not lazily inside the tick) keeps the semantics
        # stable even if the first ticks fail on a GCS hiccup — files
        # appearing later always tail from 0.
        offsets: Dict[str, int] = {}
        for path in _glob.glob(os.path.join(self.session_dir, "worker-*.log")):
            try:
                offsets[path] = os.path.getsize(path)
            except OSError:
                pass
        while True:
            try:
                paths = set(_glob.glob(os.path.join(self.session_dir,
                                                    "worker-*.log")))
                for gone in set(offsets) - paths:
                    del offsets[gone]  # dead worker's file removed
                for path in sorted(paths):
                    try:
                        size = os.path.getsize(path)
                    except OSError:
                        continue
                    prev = offsets.get(path)
                    if prev is None:
                        prev = offsets[path] = 0  # new file: tail from start
                    if size <= prev:
                        continue
                    with open(path, "rb") as f:
                        f.seek(prev)
                        chunk = f.read(min(size - prev, window))
                    cut = chunk.rfind(b"\n")
                    if cut < 0:
                        if len(chunk) < window:
                            continue  # incomplete tail: wait for the newline
                        # one line bigger than the window: ship truncated and
                        # move on — never wedge this file's tail forever
                        raw = [chunk]
                        suffix = " ...[line truncated]"
                        new_off = prev + len(chunk)
                    else:
                        # split on the SAME delimiter the offset math uses
                        # (splitlines() also breaks on \r/\x85 and would
                        # desynchronize count vs byte position)
                        raw = chunk[:cut].split(b"\n")
                        suffix = ""
                        if len(raw) > max_lines:
                            raw = raw[:max_lines]
                            new_off = prev + sum(len(l) + 1 for l in raw)
                        else:
                            new_off = prev + cut + 1
                    lines = [l.decode("utf-8", "replace") + suffix for l in raw]
                    worker = os.path.basename(path)[len("worker-"):-len(".log")]
                    # publish BEFORE advancing: a failed publish re-sends the
                    # batch next tick instead of dropping it; seq (= the
                    # pre-batch offset) lets the GCS drop the duplicate when
                    # only the REPLY was lost, so drivers see each line once
                    await self.gcs.call(
                        "publish_worker_logs", node_id=self.hex[:8],
                        worker_id=worker, lines=lines, seq=prev, timeout=5.0,
                    )
                    offsets[path] = new_off
            except (RpcConnectionError, RpcError, TimeoutError, OSError):
                pass  # GCS hiccup: batch re-sends next tick
            except Exception:  # noqa: BLE001 - the tailer must survive
                logger.exception("log monitor tick failed")
            await asyncio.sleep(config.log_monitor_interval_s)

    async def _heartbeat_loop(self) -> None:
        period = config.health_check_period_ms / 1000.0
        # Dedicated connection: heartbeats must not queue behind bursty
        # control traffic (batched pins/registers/long-polls share the main
        # client's socket and send lock) — a busy node is not a dead node.
        while True:
            await asyncio.sleep(period)
            # the heartbeat tick doubles as the MAIN client's repairman: no
            # other path reconnects it after a breakage (long-poll handlers
            # would otherwise error-loop forever on a closed client)
            if self.gcs is not None and self.gcs._closed:  # noqa: SLF001
                try:
                    await self._reconnect_gcs()
                except Exception:  # noqa: BLE001
                    logger.warning("GCS main-client reconnect failed")
            try:
                if self._hb_client is None or self._hb_client._closed:  # noqa: SLF001
                    self._hb_client = await RpcClient(self.gcs_address).connect(timeout=2.0)
                # versioned delta sync (reference: ray_syncer.h): the full
                # resource/load view rides only when it CHANGED since the
                # last ack'd send; steady-state ticks are ~40-byte pings
                view = (dict(self.available),
                        {"dispatching": self._active_dispatches})
                if view != self._hb_last_view:
                    self._hb_version += 1
                    self._hb_last_view = view
                    self._hb_full_pending = True
                kwargs: Dict[str, Any] = {"node_id": self.hex,
                                          "version": self._hb_version}
                if self._hb_full_pending:
                    kwargs["available"] = view[0]
                    kwargs["load"] = view[1]
                ok = await self._hb_client.call(
                    "heartbeat",
                    timeout=period * config.health_check_failure_threshold,
                    **kwargs,
                )
                if ok is False:
                    # restarted GCS with no (or a pre-us) snapshot: it lost
                    # this node entirely — full re-registration, not just
                    # register_node (our objects/actors/pins are gone too)
                    if gcs_recovery_enabled():
                        from ray_tpu_torch.core.recovery import trigger_resync

                        trigger_resync(self, "heartbeat rejected: GCS lost "
                                             "this node")
                    else:
                        await self.gcs.call(
                            "register_node",
                            node_id=self.hex,
                            address=self.rpc.address,
                            resources=self.total_resources,
                            labels=self.labels,
                            is_head=self.is_head,
                        )
                    self._hb_full_pending = True  # fresh GCS: resend view
                elif isinstance(ok, dict) and ok.get("resync"):
                    self._hb_full_pending = True  # GCS lost our version
                else:
                    self._hb_full_pending = False
                if isinstance(ok, dict):
                    epoch = ok.get("epoch")
                    if (epoch is not None and gcs_recovery_enabled()
                            and self._last_gcs_epoch is not None
                            and epoch != self._last_gcs_epoch):
                        from ray_tpu_torch.core.recovery import trigger_resync

                        self._last_gcs_epoch = epoch
                        trigger_resync(
                            self, f"GCS epoch bumped to {epoch}")
                    elif epoch is not None:
                        self._last_gcs_epoch = epoch
            except (RpcConnectionError, TimeoutError):
                logger.warning("heartbeat to GCS failed")
                self._hb_full_pending = True
                await self._reconnect_gcs()

    async def _reconnect_gcs(self) -> None:
        """GCS restarted (or the connection broke): rebuild the client and
        re-subscribe — with persistence the new GCS resumes from its snapshot
        and this agent re-appears via the next heartbeat/register
        (reference: raylet GCS reconnect, node_manager.cc:1181)."""
        if self.gcs is not None and not self.gcs._closed:  # noqa: SLF001
            return
        try:
            fresh = await RpcClient(self.gcs_address).connect(timeout=2.0)
            await fresh.subscribe("nodes", self._on_node_event)
            old, self.gcs = self.gcs, fresh
            if old is not None:
                await old.close()
            logger.info("reconnected to GCS at %s", self.gcs_address)
        except (RpcConnectionError, OSError):
            pass  # still down; next heartbeat retries

    async def _supervise_loop(self) -> None:
        while True:
            await asyncio.sleep(0.2)
            for w in list(self._workers.values()):
                if w.state != "DEAD" and w.proc.poll() is not None:
                    await self._on_worker_death(w)

    async def _memory_monitor_loop(self) -> None:
        """OOM protection (reference: memory_monitor.h:52 + retriable-FIFO
        kill policy). Above the usage threshold, kill the newest retriable
        running task's worker; its caller sees a typed OutOfMemoryError (or a
        retry, if attempts remain). One victim per tick — killing frees
        memory asynchronously, so re-check before killing again."""
        from ray_tpu_torch.core.node.memory_monitor import (
            MemoryMonitor, choose_victim, format_oom_message, process_rss_bytes,
        )

        monitor = MemoryMonitor(
            threshold_fraction=config.memory_usage_threshold,
            min_free_bytes=config.min_memory_free_bytes,
        )
        period = config.memory_monitor_refresh_ms / 1000.0
        while True:
            await asyncio.sleep(period)
            try:
                report = monitor.check()
            except OSError:
                continue  # /proc hiccup: skip the tick
            if report is None:
                continue
            candidates = []
            for w in self._workers.values():
                spec = w.running_task
                if spec is None or w.state == "DEAD" or w.proc.poll() is not None:
                    continue
                candidates.append({
                    "worker": w,
                    "spec": spec,
                    # same default as the dispatch retry loop (a spec without
                    # the key gets 0 retries there, so it is NOT retriable)
                    "retriable": int(spec.get("max_retries", 0)) > 0,
                    "started_at": w.task_started_at,
                })
            victim = choose_victim(candidates)
            if victim is None:
                logger.warning(
                    "memory pressure (%.1f%% used) but no running task to kill",
                    report["used_fraction"] * 100)
                continue
            w = victim["worker"]
            spec = victim["spec"]
            rss = process_rss_bytes(w.proc.pid)
            msg = format_oom_message(report, spec.get("name", "<task>"), rss)
            logger.warning("OOM kill: worker %s running %s (rss=%d)",
                           w.worker_id[:8], spec.get("name"), rss)
            tid = spec.get("task_id", "")
            if tid:
                self._oom_kills[tid] = msg
                while len(self._oom_kills) > 1000:
                    self._oom_kills.pop(next(iter(self._oom_kills)))
            try:
                w.proc.kill()  # cleanup rides _supervise_loop's death path
            except Exception:  # noqa: BLE001
                pass

    async def _on_worker_death(self, w: _WorkerHandle) -> None:
        prev_state = w.state
        w.state = "DEAD"
        self._workers.pop(w.worker_id, None)
        pool = self._idle_workers.get(w.env_hash)
        if pool and w in pool:
            pool.remove(w)
        logger.warning("worker %s died (state=%s)", w.worker_id[:8], prev_state)
        if w.gpu_chips is not None:
            self._return_chips(w.gpu_chips)
            pool = self._gpu_idle.get(w.gpu_chips)
            if pool and w in pool:
                pool.remove(w)
            w.gpu_chips = None
        if w.client_holder:
            try:
                await self.gcs.call("drop_holder", holder=w.client_holder)
            except Exception:  # noqa: BLE001
                pass
        token = w._actor_token
        if token is not None:
            self._release_token(token)
            w._actor_token = None
        if w.actor_id is not None:
            try:
                await self.gcs.call(
                    "report_actor_death", actor_id=w.actor_id,
                    reason=f"worker process exited with {w.proc.returncode}",
                )
            except Exception:  # noqa: BLE001
                pass

    # ----------------------------------------------------------- worker pool
    async def _spawn_worker(self, gpu_chips: Optional[Tuple[int, ...]] = None,
                            renv: Optional[Dict[str, Any]] = None,
                            env_hash: str = "",
                            staged: Optional[tuple] = None) -> _WorkerHandle:
        import uuid

        staged_cwd, py_paths = staged if staged else (None, [])

        worker_id = uuid.uuid4().hex
        env = dict(os.environ)
        env["RAY_TPU_WORKER_ID"] = worker_id
        env["RAY_TPU_AGENT_ADDR"] = self.rpc.address
        env["RAY_TPU_GCS_ADDR"] = self.gcs_address
        env["RAY_TPU_NODE_ID"] = self.hex
        if renv and renv.get("env_vars"):
            env.update(renv["env_vars"])
        path_prefix = ([staged_cwd] if staged_cwd else []) + list(py_paths)
        if path_prefix:
            # staged working_dir: cwd + importable; py_modules: importable
            # only (reference working_dir / py_modules plugin semantics)
            env["PYTHONPATH"] = os.pathsep.join(
                path_prefix + [env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
        from ray_tpu_torch.core import accelerators

        if gpu_chips is not None:
            # dedicated GPU worker: sees exactly its cards
            # (accelerators.py visible_chip_env)
            env.update(accelerators.visible_chip_env(list(gpu_chips), self._total_chips))
        elif renv is None or accelerators.CUDA_VISIBLE_DEVICES_ENV not in (
                renv.get("env_vars") or {}):
            # CPU workers must NOT take a card: they see none
            env[accelerators.CUDA_VISIBLE_DEVICES_ENV] = ""
        logfile = open(os.path.join(self.session_dir, f"worker-{worker_id[:8]}.log"), "ab")
        proc = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch.core.node.worker_main"],
            env=env, stdout=logfile, stderr=subprocess.STDOUT,
            cwd=staged_cwd or os.getcwd(),
        )
        handle = _WorkerHandle(proc, worker_id)
        handle.gpu_chips = gpu_chips
        handle.env_hash = env_hash
        handle.staged_cwd = staged_cwd
        self._workers[worker_id] = handle
        return handle

    def _runtime_env_of(self, spec: Dict[str, Any]):
        """(renv, env_hash) for a task/actor spec. The driver already
        normalized/validated and replaced working_dir with its content
        hash."""
        from ray_tpu_torch.core.runtime_env import env_hash as _h

        renv = {k: v for k, v in (spec.get("runtime_env") or {}).items()
                if not k.startswith("__")}
        return (renv or None), _h(renv)

    # ------------------------------------------------------- GPU card leasing
    # Invariant: every chip id is in EXACTLY ONE place — self._free_chips, or
    # the .gpu_chips of one live worker handle. Workers own their chips from
    # spawn to death (_on_worker_death returns them); nothing else does.
    def _take_chips(self, n: int) -> Optional[Tuple[int, ...]]:
        """Assign n concrete chip ids from the free pool, reclaiming (killing)
        idle dedicated workers when the pool runs short — availability
        accounting already guarantees n <= total unleased."""
        if len(self._free_chips) < n:
            for key, idles in list(self._gpu_idle.items()):
                while idles and len(self._free_chips) < n:
                    w = idles.pop()
                    if w.state != "IDLE":
                        continue  # leased/racing: not reclaimable, just unlist
                    self._kill_worker(w)
                    if w.gpu_chips is not None:
                        self._return_chips(w.gpu_chips)
                        w.gpu_chips = None
                if not idles:
                    self._gpu_idle.pop(key, None)
                if len(self._free_chips) >= n:
                    break
        if len(self._free_chips) < n:
            return None
        chips = tuple(sorted(self._free_chips[:n]))
        self._free_chips = self._free_chips[n:]
        return chips

    def _return_chips(self, chips: Tuple[int, ...]) -> None:
        self._free_chips.extend(chips)

    def _kill_worker(self, w: _WorkerHandle) -> None:
        """Kill + deregister so _supervise_loop/_on_worker_death never sees it
        (the caller handles chip return exactly once)."""
        w.state = "DEAD"
        self._workers.pop(w.worker_id, None)
        try:
            w.proc.kill()
        except Exception:  # noqa: BLE001
            pass

    async def _lease_gpu_worker(self, n: int, env_hash: str = "",
                                renv: Optional[Dict[str, Any]] = None) -> _WorkerHandle:
        """Lease a dedicated worker for n chips: exact-size warm reuse first
        (a CUDA context and loaded kernels take seconds; runtime env must match too),
        else spawn on freshly assigned chip ids. Owns the whole chip
        lifecycle on failure."""
        for key, idles in self._gpu_idle.items():
            if len(key) != n:
                continue
            for w in list(idles):
                if (w.proc.poll() is None and w.state == "IDLE"
                        and w.env_hash == env_hash):
                    idles.remove(w)
                    w.state = "LEASED"
                    return w
        chips = self._take_chips(n)
        if chips is None:
            raise TimeoutError("GPUs unavailable")
        staged = await self._stage_runtime_env(renv) if renv else None
        w = await self._spawn_worker(gpu_chips=chips, renv=renv,
                                     env_hash=env_hash, staged=staged)
        deadline = time.monotonic() + config.worker_start_timeout_s
        try:
            while not w.ready.is_set():
                if w.proc.poll() is not None:
                    raise TimeoutError(f"GPU worker exited with {w.proc.returncode}")
                if time.monotonic() > deadline:
                    raise TimeoutError("timed out waiting for GPU worker")
                try:  # woken by rpc_worker_ready; chunked only to re-check liveness
                    await asyncio.wait_for(w.ready.wait(), timeout=0.2)
                except asyncio.TimeoutError:
                    pass
        except TimeoutError:
            self._kill_worker(w)
            self._return_chips(chips)
            w.gpu_chips = None
            raise
        w.state = "LEASED"
        pool = self._gpu_idle.get(w.gpu_chips)
        if pool and w in pool:  # worker_ready parked it; we own it now
            pool.remove(w)
        return w

    def _release_gpu_worker(self, w: _WorkerHandle) -> None:
        if w.proc.poll() is None and w.gpu_chips is not None:
            w.state = "IDLE"
            pool = self._gpu_idle.setdefault(w.gpu_chips, [])
            if w not in pool:
                pool.append(w)

    async def rpc_worker_ready(self, worker_id: str, address: str,
                               client_holder: str = "") -> bool:
        w = self._workers.get(worker_id)
        if w is None:
            return False
        if w.ready.is_set() and w.address == address:
            # idempotent re-announce (retried RPC): the worker may already be
            # LEASED — resetting state/re-listing it would double-lease it
            return True
        w.client_holder = client_holder or None
        w.address = address
        w.client = await RpcClient(address).connect()
        w.state = "IDLE"
        w.ready.set()
        if w.gpu_chips is None:
            self._idle_workers.setdefault(w.env_hash, []).append(w)
            self._notify_worker_free(w.env_hash)
        else:
            # dedicated GPU worker: park in the chip-keyed pool so a worker
            # whose original lease timed out is reusable/reclaimable instead
            # of orphaned with its chips. A waiting _lease_gpu_worker grabs
            # it right after (state -> LEASED) and reuse skips non-IDLE.
            pool = self._gpu_idle.setdefault(w.gpu_chips, [])
            if w not in pool:
                pool.append(w)
        return True

    async def _lease_worker(self, timeout: Optional[float] = None,
                            env_hash: str = "",
                            renv: Optional[Dict[str, Any]] = None) -> _WorkerHandle:
        deadline = time.monotonic() + (timeout or config.worker_start_timeout_s)
        staged = await self._stage_runtime_env(renv) if renv else None
        free_ev = self._worker_free_events.setdefault(env_hash, asyncio.Event())
        while True:
            # clear-before-check: a worker freed after the check sets the
            # event and the wait below returns immediately (no missed wakeup)
            free_ev.clear()
            idles = self._idle_workers.get(env_hash, [])
            while idles:
                w = idles.pop()
                if w.state == "IDLE" and w.proc.poll() is None:
                    w.state = "LEASED"
                    return w
            # Cap counts only task-pool workers: actors hold their workers for
            # life and are bounded by node RESOURCES, not the pool (matching
            # the reference, where dedicated actor workers don't consume the
            # task worker pool). At the cap, idle workers of OTHER runtime
            # envs are evicted — they can never serve this env, and without
            # eviction the Nth distinct env would starve forever.
            pool = [w for w in self._workers.values() if w.state != "ACTOR"]
            starting = [w for w in pool if w.state == "STARTING"]
            if len(pool) < self._max_workers or not starting:
                if len(pool) >= self._max_workers * 2:
                    self._evict_idle_other_env(env_hash)
                    pool = [w for w in self._workers.values() if w.state != "ACTOR"]
                if len(pool) < self._max_workers * 2:
                    await self._spawn_worker(renv=renv, env_hash=env_hash,
                                             staged=staged)
            # event-driven wait for the next freed worker; the 0.25 s cap is
            # only a safety net for spawn failures (a release wakes us at once)
            try:
                await asyncio.wait_for(free_ev.wait(), timeout=0.25)
            except asyncio.TimeoutError:
                pass
            if time.monotonic() > deadline:
                raise TimeoutError("timed out waiting for a worker")

    def _evict_idle_other_env(self, env_hash: str) -> bool:
        for h, idles in list(self._idle_workers.items()):
            if h == env_hash:
                continue
            while idles:
                w = idles.pop()
                if w.state == "IDLE" and w.proc.poll() is None:
                    self._kill_worker(w)
                    if w.client_holder:
                        spawn(
                            self.gcs.call("drop_holder", holder=w.client_holder)
                        )
                    return True
            self._idle_workers.pop(h, None)
        return False

    async def _stage_runtime_env(self, renv: Dict[str, Any]) -> tuple:
        """Stage working_dir + py_modules packages from GCS KV. Returns
        (cwd_or_None, extra_pythonpath_dirs)."""
        from ray_tpu_torch.core.runtime_env import kv_key, stage_package

        async def fetch(h: str) -> str:
            # staged-already fast path: _lease_worker stages on EVERY lease,
            # so skipping the KV download for warm hashes keeps multi-MB
            # packages off the per-task hot path
            dest = os.path.join(self.session_dir, "runtime_envs", h)
            if os.path.isdir(dest):
                return dest
            payload = await self.gcs.call("kv_get", key=kv_key(h))
            if payload is None:
                raise KeyError(f"runtime_env package {h} not found in GCS KV")
            return stage_package(payload, h, self.session_dir)

        h = renv.get("working_dir_hash")
        mods = renv.get("py_modules_hashes") or []
        # one gather: cold staging latency is max(fetches), not
        # workdir + max(modules)
        staged = list(await asyncio.gather(
            *(fetch(x) for x in ([h] if h else []) + list(mods))))
        cwd = staged.pop(0) if h else None
        return cwd, staged

    def _notify_worker_free(self, env_hash: str) -> None:
        ev = self._worker_free_events.get(env_hash)
        if ev is not None:
            ev.set()

    def _release_worker(self, w: _WorkerHandle) -> None:
        if w.state == "LEASED" and w.proc.poll() is None:
            w.state = "IDLE"
            self._idle_workers.setdefault(w.env_hash, []).append(w)
            self._notify_worker_free(w.env_hash)

    # ------------------------------------------------------------ object api
    async def rpc_create_object(self, object_id: str, size: int) -> Dict[str, Any]:
        """Idempotent reserve. ``existing``: None (fresh), "reserved" (a
        retried create whose first response was dropped — caller should
        attach and write), or "sealed" (object complete — caller must NOT
        rewrite live-readable memory)."""
        oid = ObjectID.from_hex(object_id)
        try:
            offset = self.store.reserve(oid, size)
            return {"ok": True, "existing": None, "offset": offset}
        except FileExistsError:
            info = self.store.info(oid)
            sealed = bool(info and info[1])
            return {
                "ok": True,
                "existing": "sealed" if sealed else "reserved",
                "size": info[0] if info else 0,
                "offset": self.store.offset(oid),
            }

    async def rpc_seal_object(self, object_id: str, size: int, owner: str = "",
                              is_error: bool = False,
                              contained: Optional[List[str]] = None,
                              payload: Optional[bytes] = None) -> bool:
        oid = ObjectID.from_hex(object_id)
        self.store.seal(oid)
        if is_error:
            self.error_objects.add(object_id)
        self._remember_meta(object_id, owner, contained)
        # registration is BATCHED (one GCS RPC covers every seal that arrives
        # while the previous flush is in flight) but the ack WAITS for the
        # flush: "sealed" always implies "GCS-registered" (state API and
        # remote waiters observe the object the moment the seal ack lands)
        reg = {
            "object_id": object_id, "size": size, "node_id": self.hex,
            "owner": owner, "contained": contained or None,
        }
        from ray_tpu_torch.core.config import inline_max_bytes
        if payload is not None and len(payload) <= inline_max_bytes():
            # small result: the payload rides the registration so the GCS can
            # push it in-band to the submitter's sealed-event channel
            reg["payload"] = payload
        fut: asyncio.Future = asyncio.get_event_loop().create_future()
        self._reg_queue.append((reg, fut))
        self._reg_event.set()
        await fut
        return True

    async def _reg_flush_loop(self) -> None:
        # no coalescing sleep: batching happens naturally — seals arriving
        # during the in-flight GCS RPC pile into the next batch
        while True:
            await self._reg_event.wait()
            self._reg_event.clear()
            batch, self._reg_queue = self._reg_queue, []
            if not batch:
                continue
            parked_until: Optional[float] = None
            while True:
                try:
                    await self.gcs.call("register_objects",
                                        regs=[r for r, _ in batch])
                    for _, fut in batch:
                        if not fut.done():
                            fut.set_result(True)
                    break
                except (RpcConnectionError, TimeoutError) as e:
                    # GCS outage: PARK the batch and re-send once the
                    # restarted GCS answers — "sealed implies registered"
                    # must hold across a crash-restart, so pending seal acks
                    # wait instead of failing their tasks. register_objects
                    # is idempotent on the GCS side, so a duplicate re-send
                    # after an ambiguous timeout is harmless.
                    if not gcs_recovery_enabled():
                        self._fail_reg_batch(batch, e)
                        await asyncio.sleep(0.2)
                        break
                    now = time.monotonic()
                    if parked_until is None:
                        parked_until = now + config.recovery_park_timeout_s
                        logger.warning("register_objects parked across GCS "
                                       "outage (%d seals pending)", len(batch))
                    if now >= parked_until:
                        self._fail_reg_batch(batch, e)
                        break
                    await asyncio.sleep(0.2)
                except Exception as e:  # noqa: BLE001 - remote error: fail seals
                    logger.exception("register_objects flush failed")
                    self._fail_reg_batch(batch, e)
                    await asyncio.sleep(0.2)
                    break

    @staticmethod
    def _fail_reg_batch(batch: List[Tuple[Dict[str, Any], asyncio.Future]],
                        e: Exception) -> None:
        for _, fut in batch:
            if not fut.done():
                fut.set_exception(e)
                fut.exception()  # sealer may have gone: mark seen

    async def _unpin_flush_loop(self) -> None:
        while True:
            await self._unpin_event.wait()
            self._unpin_event.clear()
            batch, self._unpin_queue = self._unpin_queue, []
            if not batch:
                continue
            try:
                await self.gcs.call("unpin_tasks", unpins=batch)
            except Exception:  # noqa: BLE001 - advisory; node-scoped pins are
                # reaped with this node if they leak
                logger.exception("unpin flush failed")
                await asyncio.sleep(0.2)

    async def _pin_flush_loop(self) -> None:
        while True:
            await self._pin_event.wait()
            self._pin_event.clear()
            batch, self._pin_queue = self._pin_queue, []
            if not batch:
                continue
            try:
                await self.gcs.call("pin_tasks", pins=[p for p, _ in batch])
                for _, fut in batch:
                    if not fut.done():
                        fut.set_result(True)
            except Exception as e:  # noqa: BLE001
                for _, fut in batch:
                    if not fut.done():
                        fut.set_exception(e)
                        fut.exception()  # submitter may have gone: mark seen

    async def rpc_put_object(self, object_id: str, payload: bytes,
                             owner: str = "", is_error: bool = False,
                             contained: Optional[List[str]] = None) -> Dict[str, Any]:
        """Single-round-trip put for small objects: reserve + write + seal +
        GCS-register in ONE RPC. The payload rides the local socket instead
        of a client-side shm write, collapsing the create/seal handshake
        (reference: inlined small returns, max_direct_call_object_size)."""
        return await self._put_local(object_id, payload, owner=owner,
                                     is_error=is_error, contained=contained)

    async def _put_local(self, object_id: str, payload: bytes,
                         owner: str = "", is_error: bool = False,
                         contained: Optional[List[str]] = None) -> Dict[str, Any]:
        oid = ObjectID.from_hex(object_id)
        if self._reserve_idempotent(oid, len(payload)) == "sealed":
            return {"ok": True, "existing": "sealed"}  # idempotent retry
        offset = self.store.offset(oid)

        def _write_segment() -> None:
            # shm create/ftruncate/mmap/copy are synchronous syscalls: run off
            # the event loop so a put flood can't starve heartbeats/RPCs
            try:
                writer = ShmWriter(oid, len(payload), self.hex, offset=offset)
            except FileExistsError:
                # stale segment from a crashed writer: attach and overwrite
                from ray_tpu_torch.core.shm_store import ShmSegment, segment_name

                shm = ShmSegment(segment_name(oid, self.hex), create=False)
                shm.buf[: len(payload)] = payload
                shm.close()
            else:
                writer.buffer[:] = payload
                writer.seal()

        if len(payload) > 256 * 1024:
            # big copy: off the loop (a put flood of large objects would
            # starve heartbeats); tiny writes are cheaper inline than the
            # executor handoff
            await asyncio.get_event_loop().run_in_executor(None, _write_segment)
        else:
            _write_segment()
        from ray_tpu_torch.core.config import inline_max_bytes
        small = bytes(payload) if len(payload) <= inline_max_bytes() else None
        await self.rpc_seal_object(object_id, len(payload), owner=owner,
                                   is_error=is_error, contained=contained,
                                   payload=small)
        return {"ok": True, "existing": None}

    async def rpc_abort_object(self, object_id: str) -> bool:
        self.store.abort(ObjectID.from_hex(object_id))
        return True

    # ops endpoint: invoked ad hoc via `ray_tpu_torch` tooling, not by in-tree code
    async def rpc_store_debug(self, limit: int = 200) -> List[Dict[str, Any]]:  # rtpulint: disable=rpc-drift
        return self.store.debug_entries(limit)

    async def rpc_object_sizes(self, object_ids: List[str]) -> List[Optional[int]]:
        """Stored sizes (local index first, GCS directory for remote refs);
        None = unknown. Backpressure hint for the Data executor."""
        out: List[Optional[int]] = []
        remote_idx: List[int] = []
        for object_id in object_ids:
            info = self.store.info(ObjectID.from_hex(object_id))
            if info is not None:
                out.append(info[0])
            else:
                out.append(None)
                remote_idx.append(len(out) - 1)
        for i in remote_idx:
            rec = await self.gcs.call("lookup_object", object_id=object_ids[i])
            if rec is not None:
                out[i] = rec["size"]
        return out

    async def rpc_object_info(self, object_id: str) -> Optional[Dict[str, Any]]:
        oid = ObjectID.from_hex(object_id)
        info = self.store.info(oid)
        if info is None:
            return None
        size, sealed = info
        return {"size": size, "sealed": sealed,
                "is_error": object_id in self.error_objects,
                "offset": self.store.offset(oid)}

    async def rpc_read_chunk(self, object_id: str, offset: int, length: int) -> bytes:
        oid = ObjectID.from_hex(object_id)
        size = self.store.ensure_local(oid)
        if size is None:
            raise KeyError(f"object {object_id[:16]} not on node {self.hex[:8]}")
        reader = ShmReader(oid, size, self.hex, offset=self.store.offset(oid))
        try:
            data = bytes(reader.buffer[offset : offset + length])
            if not reader.revalidate():
                raise KeyError(f"object {object_id[:16]} evicted mid-read")
            return data
        finally:
            reader.close()

    def _remember_meta(self, object_id: str, owner: str = "",
                       contained: Optional[List[str]] = None) -> None:
        """Keep sealed-object metadata so peer pulls get is_error/owner/
        contained piggybacked on their first chunk reply (bounded FIFO —
        an evicted entry costs the puller nothing: owner/contained already
        live at the GCS from the primary seal)."""
        if not owner and not contained:
            return
        self._object_meta[object_id] = (owner,
                                        list(contained) if contained else None)
        while len(self._object_meta) > 20000:
            self._object_meta.popitem(last=False)

    async def rpc_read_chunk_raw(self, object_id: str, offset: int,
                                 length: int, want_meta: bool = False) -> RawResult:
        """Serve one chunk on the raw transfer plane: the reply payload is
        the arena mapping itself (no bytes() copy, no msgpack encode). The
        object is PINNED until the frame is written so LRU eviction cannot
        recycle the slot mid-send; ``want_meta`` piggybacks is_error/owner/
        contained on the reply so a pull costs exactly its data frames."""
        oid = ObjectID.from_hex(object_id)
        size = self.store.ensure_local(oid)
        if size is None:
            raise KeyError(f"object {object_id[:16]} not on node {self.hex[:8]}")
        reader = ShmReader(oid, size, self.hex, offset=self.store.offset(oid))
        self.store.pin(oid)
        released = [False]

        def release() -> None:
            if not released[0]:
                released[0] = True
                self.store.unpin(oid)
                reader.close()

        try:
            ln = max(0, min(length, size - offset))
            view = reader.buffer[offset : offset + ln]
            if not reader.revalidate():
                raise KeyError(f"object {object_id[:16]} evicted mid-read")
        except BaseException:
            release()
            raise
        meta: Dict[str, Any] = {"size": size}
        if want_meta:
            owner, contained = self._object_meta.get(object_id, ("", None))
            meta.update(has_meta=True,
                        is_error=object_id in self.error_objects,
                        owner=owner, contained=contained)
        ts = self.transfer.stats
        ts["chunks_out"] += 1
        ts["bytes_out"] += ln
        usage = self.store.usage()
        if usage["used"] >= config.object_spilling_threshold * usage["capacity"]:
            # store under pressure: a pin held across the socket write would
            # block spill/eviction of exactly the objects that need to move
            # (observed jamming a 10x-over-budget Data pipeline). Serve a
            # copied chunk and release immediately — zero-copy stays the
            # healthy-store fast path.
            try:
                data = bytes(view)
                if not reader.revalidate():
                    raise KeyError(
                        f"object {object_id[:16]} evicted mid-read")
            finally:
                release()
            return RawResult(meta, data)
        return RawResult(meta, view, release)

    async def rpc_transfer_stats(self) -> Dict[str, Any]:
        """Per-transfer data-plane stats (pull/push bytes, bytes/s, stripe
        sources, stalls, retries, failovers) for the dashboard + ray_perf."""
        return self.transfer.snapshot()

    async def rpc_ensure_local(self, object_id: str,
                               timeout_s: Optional[float] = None,
                               rec_hint: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """Make the object readable on this node, pulling if remote.
        Returns {size, is_error}. (named timeout_s: `timeout` is the RPC
        client's own deadline kwarg). ``rec_hint``: a directory record a
        BATCHED lookup already resolved — the first iteration skips the
        per-object GCS long-poll (partition-set pulls cost one lookup RPC
        for the whole set, not one per block); a stale hint falls through
        to the long-poll on the next iteration."""
        oid = ObjectID.from_hex(object_id)
        deadline = time.monotonic() + (timeout_s if timeout_s is not None else 1e18)
        lock = self._pull_locks.setdefault(object_id, asyncio.Lock())
        async with lock:
            size = self.store.ensure_local(oid)
            if size is not None and self.store.contains(oid):
                return {"size": size, "is_error": object_id in self.error_objects,
                        "offset": self.store.offset(oid)}
            # remote: resolve location via GCS long-poll (event-driven — the
            # GCS wakes us on register/lost instead of us re-polling lookup)
            rec = rec_hint
            while True:
                if rec is None:
                    chunk = min(2.0, max(0.05, deadline - time.monotonic()))
                    try:
                        # per-object pull lock: serializing concurrent pulls
                        # of ONE object behind this RPC is the point
                        # rtpulint: disable=race
                        rec = await self.gcs.call(
                            "wait_object_located", object_id=object_id,
                            timeout_s=chunk, timeout=chunk + 5.0,
                        )
                    except (TimeoutError, RpcError):  # chaos-dropped frame: re-poll
                        rec = None
                    except (RpcConnectionError, OSError):
                        # GCS down/restarting: the heartbeat loop reconnects the
                        # shared client; back off instead of failing the wait
                        await asyncio.sleep(0.2)
                        rec = None
                if rec and rec["locations"]:
                    if self.hex in rec["locations"] and self.store.contains(oid):
                        return {"size": rec["size"],
                                "is_error": object_id in self.error_objects,
                                "offset": self.store.offset(oid)}
                    remotes = [n for n in rec["locations"] if n != self.hex]
                    if remotes:
                        meta = await self._pull(oid, rec["size"], remotes,
                                                owner_hint=rec.get("owner", ""))
                        if meta is not None:
                            if meta.get("is_error") or \
                                    rec.get("owner", "").endswith(":error"):
                                self.error_objects.add(object_id)
                            return {
                                "size": rec["size"],
                                "is_error": object_id in self.error_objects,
                                "offset": self.store.offset(oid),
                            }
                        # pull failed (e.g. the only location just crashed and
                        # the GCS hasn't reaped it yet): the long-poll returns
                        # instantly while locations look live, so a failed
                        # pull must back off or this loop spins at full speed
                        await asyncio.sleep(0.05)
                elif rec and rec.get("lost"):
                    # every copy died with its node: waiting is pointless —
                    # re-execute the producing task from lineage (reference:
                    # object_recovery_manager.h:41 + task resubmission,
                    # task_manager.h:468). Raises if no lineage or the
                    # reconstruction budget is exhausted.
                    await self._reconstruct(object_id)
                    rec = None
                    continue  # lookup again: the re-run registered locations
                if time.monotonic() > deadline:
                    raise TimeoutError(f"object {object_id[:16]} not available")
                rec = None  # hint consumed/stale: long-poll next iteration

    async def rpc_ensure_local_batch(
        self, object_ids: List[str], timeout_s: Optional[float] = None
    ) -> List[Dict[str, Any]]:
        """Batched ensure_local (reference: plasma batched Get + parallel
        PullManager pulls). Ids not yet anywhere wait on ONE shared GCS
        long-poll for the whole batch — a 1,000-ref get() costs one control
        RPC per tick, not 1,000 concurrent pollers. Per-object failures come
        back in-band as {"error", "error_type"} so one missing object doesn't
        poison the whole batch."""
        deadline = time.monotonic() + (timeout_s if timeout_s is not None else 1e18)
        out: Dict[str, Dict[str, Any]] = {}

        async def _finish(object_id: str, rec_hint=None) -> None:
            try:
                out[object_id] = await self.rpc_ensure_local(
                    object_id, timeout_s=max(0.05, deadline - time.monotonic()),
                    rec_hint=rec_hint,
                )
            except BaseException as res:  # noqa: BLE001
                out[object_id] = {
                    "error": str(res) or type(res).__name__,
                    "error_type": type(res).__name__,
                    "object_id": object_id,
                }

        # fast path: whatever is already local or already located resolves
        # through rpc_ensure_local immediately (pulls run concurrently)
        pending: List[str] = []
        for object_id in object_ids:
            if self.store.contains(ObjectID.from_hex(object_id)):
                await _finish(object_id)
            else:
                pending.append(object_id)
        while pending:
            chunk = min(2.0, max(0.05, deadline - time.monotonic()))
            try:
                located = await self.gcs.call(
                    "wait_objects_located", object_ids=pending,
                    num_returns=len(pending), timeout_s=chunk,
                    include_lost=True,  # loss must trigger reconstruction NOW
                    timeout=chunk + 5.0,
                )
            except (TimeoutError, RpcError):
                located = []
            except (RpcConnectionError, OSError):
                await asyncio.sleep(0.2)
                located = []
            if located:
                # ONE batched holder lookup for the whole located set (a
                # shuffle reduce's partition set resolves in a single RPC);
                # each record rides into rpc_ensure_local as its first-
                # iteration hint, skipping the per-object long-poll
                try:
                    recs = await self.gcs.call("lookup_objects",
                                               object_ids=located,
                                               timeout=10.0)
                except (TimeoutError, RpcError, RpcConnectionError, OSError):
                    recs = [None] * len(located)
                await asyncio.gather(*[
                    _finish(o, rec_hint=r) for o, r in zip(located, recs)
                ])
                located_set = set(located)
                pending = [o for o in pending if o not in located_set]
            if pending and time.monotonic() >= deadline:
                for object_id in pending:
                    # the per-object path reports lost/reconstruction errors;
                    # anything still unlocated at the deadline times out there
                    await _finish(object_id)
                pending = []
        return [out[o] for o in object_ids]

    async def _reconstruct(self, object_id: str) -> None:
        """Re-execute the task that produced a lost object, from GCS lineage.
        Serialized per producing task (sibling return ids share one re-run);
        raises ObjectLostError (no lineage — e.g. put() data or actor-task
        returns) or ObjectReconstructionFailedError (budget exhausted)."""
        from ray_tpu_torch import exceptions as exc

        spec = await self.gcs.call("get_lineage", object_id=object_id)
        if spec is None:
            raise exc.ObjectLostError(
                object_id,
                "all copies were lost with their nodes and the object has no "
                "lineage (ray.put data and actor-task returns are not "
                "reconstructable)",
            )
        task_key = spec.get("task_id", object_id)
        attempts = self._recon_attempts.get(task_key, 0)
        if attempts >= config.max_object_reconstructions:
            raise exc.ObjectReconstructionFailedError(
                f"object {object_id[:16]} lost again after "
                f"{attempts} reconstruction attempts"
            )
        lock = self._recon_locks.setdefault(task_key, asyncio.Lock())
        async with lock:
            # another waiter may have reconstructed while we queued; the
            # per-task recon lock exists to serialize exactly these RPCs
            # rtpulint: disable=race
            rec = await self.gcs.call("lookup_object", object_id=object_id)
            if rec and rec["locations"]:
                return
            self._recon_attempts[task_key] = self._recon_attempts.get(task_key, 0) + 1
            logger.info(
                "reconstructing %s (attempt %d): re-running task %s",
                object_id[:16], self._recon_attempts[task_key], spec.get("name"),
            )
            if (spec.get("strategy") or {}).get("kind") == "node_affinity":
                # the pinned node is typically the one that died; the original
                # placement preference is moot for a re-run
                spec = {**spec, "strategy": {"kind": "default"}}
            # pin deps+returns for the re-run (removed by _submit_with_retries);
            # dep objects that are themselves lost reconstruct recursively via
            # the dispatch path's ensure_local.
            pinned = (spec.get("deps") or []) + (spec.get("returns") or [])
            try:
                # rtpulint: disable=race -- same per-task recon lock as above
                await self.gcs.call(
                    "add_object_refs", object_ids=pinned,
                    holder=self._task_holder(spec),
                )
            except Exception:  # noqa: BLE001
                pass
            await self._submit_with_retries(spec)

    # ------------------------------------------------------- object broadcast
    async def _upload_object_to(self, client: "RpcClient", oid: ObjectID,
                                object_id: str, size: int) -> bool:
        """Stream the object to one peer. Returns True if the peer NEWLY
        materialized it, False if it already held a sealed copy (detected on
        the first chunk — no wasted re-upload). A size-0 object still sends
        one empty chunk so the receiver can reserve+seal.

        Raw plane: chunk payloads are arena memoryviews written straight to
        the socket (object pinned for the duration — no bytes() copy, no
        msgpack encode) with ``transfer_window_chunks`` sends in flight;
        RTPU_RAW_TRANSFER=0 restores the serial in-band path."""
        if not raw_transfer_enabled():
            return await self._upload_object_to_legacy(client, oid,
                                                       object_id, size)
        reader = ShmReader(oid, size, self.hex, offset=self.store.offset(oid))
        self.store.pin(oid)
        try:
            if not reader.revalidate():
                raise KeyError(f"object {object_id[:16]} evicted mid-push")
            owner, contained = self._object_meta.get(object_id, ("", None))
            is_err = object_id in self.error_objects
            chunk = config.fetch_chunk_bytes

            async def send(off: int, n: int) -> Dict[str, Any]:
                from ray_tpu_torch.core.node.transfer import attempt_timeout

                last_err: Optional[Exception] = None
                for attempt in range(4):
                    try:
                        # re-sends are idempotent: the receiver's ingest
                        # table dedupes by offset (chaos may drop frames);
                        # short first deadline, doubling per retry
                        return await client.call_raw_send(
                            "receive_chunk_raw",
                            reader.buffer[off : off + n],
                            timeout=attempt_timeout(attempt),
                            object_id=object_id, total_size=size, offset=off,
                            is_error=is_err, owner=owner, contained=contained,
                        )
                    except TimeoutError as e:
                        last_err = e
                raise last_err  # type: ignore[misc]

            resp = await send(0, min(chunk, size))
            if isinstance(resp, dict) and resp.get("existing") == "sealed":
                return False
            sem = asyncio.Semaphore(max(1, int(config.transfer_window_chunks)))

            async def one(off: int) -> None:
                async with sem:
                    await send(off, min(chunk, size - off))

            await asyncio.gather(*(one(off)
                                   for off in range(chunk, size, chunk)))
            self.transfer.stats["bytes_out"] += size
            return True
        finally:
            self.store.unpin(oid)
            reader.close()

    async def _upload_object_to_legacy(self, client: "RpcClient",
                                       oid: ObjectID, object_id: str,
                                       size: int) -> bool:
        """Serial in-band msgpack chunk upload (pre-raw-plane baseline)."""
        reader = ShmReader(oid, size, self.hex, offset=self.store.offset(oid))
        try:
            sent = 0
            chunk = config.fetch_chunk_bytes
            while True:
                n = min(chunk, size - sent)
                data = bytes(reader.buffer[sent : sent + n])
                if not reader.revalidate():
                    raise KeyError(f"object {object_id[:16]} evicted mid-push")
                resp = await client.call(
                    "receive_chunk", object_id=object_id, total_size=size,
                    offset=sent, data=data,
                    is_error=object_id in self.error_objects,
                    timeout=60.0,
                )
                if isinstance(resp, dict) and resp.get("existing") == "sealed":
                    return sent > 0  # already had it iff detected up front
                sent += n
                if sent >= size:
                    return True
        finally:
            reader.close()

    async def rpc_push_object(self, object_id: str,
                              targets: List[str]) -> Dict[str, Any]:
        """Binomial-tree broadcast (reference: object_manager/push_manager.h
        — proactive pushes; here the N-node broadcast costs each node at
        most 2 uploads and completes in ~log2(N) rounds instead of N serial
        pulls from one source). This node uploads the object to the head of
        each half of `targets`; each head recurses on the rest of its half.
        Unreachable/failed heads are skipped (the next node in the half
        takes over) and reported in ``failed`` — one dead node never sinks
        its whole subtree. ``pushed`` counts nodes that NEWLY got a copy."""
        oid = ObjectID.from_hex(object_id)
        size = self.store.ensure_local(oid)
        if size is None or not self.store.contains(oid):
            raise KeyError(f"object {object_id[:16]} not local to {self.hex[:8]}")
        targets = [t for t in targets if t != self.hex]
        if not targets:
            return {"ok": True, "pushed": 0, "failed": {}}
        mid = (len(targets) + 1) // 2
        halves = [h for h in (targets[:mid], targets[mid:]) if h]

        async def push_half(half: List[str]):
            failed: Dict[str, str] = {}
            for i, head in enumerate(half):
                client = await self._peer(head)
                if client is None:
                    failed[head] = "no route"
                    continue
                try:
                    # bulk bytes ride the dedicated transfer connection so
                    # they don't head-of-line-block control RPCs to the peer
                    xfer = await self._transfer_peer(head) or client
                    newly = await self._upload_object_to(xfer, oid,
                                                         object_id, size)
                except (RpcError, RpcConnectionError, TimeoutError,
                        KeyError, OSError) as e:
                    failed[head] = str(e) or type(e).__name__
                    continue
                rest = half[i + 1:]
                try:
                    sub = await client.call("push_object",
                                            object_id=object_id,
                                            targets=rest, timeout=600.0)
                except (RpcError, RpcConnectionError, TimeoutError) as e:
                    # the head has its copy but couldn't fan out: count it,
                    # report the rest as failed
                    failed.update({t: f"via {head[:8]}: {e}" for t in rest})
                    return int(newly), failed
                failed.update(sub.get("failed", {}))
                return int(newly) + int(sub.get("pushed", 0)), failed
            return 0, failed

        results = await asyncio.gather(*(push_half(h) for h in halves))
        failed: Dict[str, str] = {}
        for _, f in results:
            failed.update(f)
        return {"ok": True, "pushed": sum(p for p, _ in results),
                "failed": failed}

    def _reserve_idempotent(self, oid: ObjectID, size: int) -> str:
        """Reserve-or-recover shared by every ingest path. Returns "fresh",
        "reserved" (same-size reservation exists), or "sealed"."""
        try:
            self.store.reserve(oid, size)
            return "fresh"
        except FileExistsError:
            info = self.store.info(oid)
            if info and info[1]:
                return "sealed"
            if info is None or info[0] != size:
                # stale half-written reservation of a DIFFERENT size (or an
                # entry aborted between reserve and info): recreate
                self.store.abort(oid)
                self.store.reserve(oid, size)
                return "fresh"
            return "reserved"

    async def rpc_receive_chunk(self, object_id: str, total_size: int,
                                offset: int, data: bytes,
                                is_error: bool = False, owner: str = "",
                                contained: Optional[List[str]] = None) -> Dict[str, Any]:
        """In-band (msgpack) chunk ingest — compat path and the
        RTPU_RAW_TRANSFER=0 A/B baseline. Shares the per-object cached
        ShmWriter ingest table with the raw plane instead of constructing a
        fresh writer (attach + validate) for every chunk; seals + registers
        with the GCS once every byte has landed."""
        sink, finish = await self.transfer.open_ingest(
            payload_len=len(data), object_id=object_id,
            total_size=total_size, offset=offset, is_error=is_error,
            owner=owner, contained=contained)
        if sink is not None and data:
            sink[: len(data)] = data
        return await finish(len(data))

    async def _pull(self, oid: ObjectID, size: int, locations: List[str],
                    owner_hint: str = "") -> Optional[Dict[str, Any]]:
        """Materialize a remote object locally. Raw plane: striped windowed
        pull with mid-object failover/resume (TransferManager); returns the
        piggybacked metadata dict on success, None on failure.
        RTPU_RAW_TRANSFER=0 restores the serial single-source msgpack path."""
        if raw_transfer_enabled():
            return await self.transfer.pull(oid, size, locations,
                                            owner_hint=owner_hint)
        ok = await self._pull_legacy(oid, size, locations)
        return {} if ok else None

    async def _pull_legacy(self, oid: ObjectID, size: int,
                           locations: List[str]) -> bool:
        """Serial chunked pull from one peer agent (pre-raw-plane baseline;
        reference: PullManager/PushManager 64MB chunks)."""
        object_id = oid.hex()
        for node_id in locations:
            try:
                client = await self._peer(node_id)
                if client is None:
                    continue
                arena_off = self.store.reserve(oid, size)
                writer = ShmWriter(oid, size, self.hex, offset=arena_off)
                seal_failed = False
                try:
                    offset = 0
                    chunk = config.fetch_chunk_bytes
                    while offset < size:
                        data = await client.call(
                            "read_chunk", object_id=object_id, offset=offset,
                            length=min(chunk, size - offset),
                        )
                        writer.buffer[offset : offset + len(data)] = data
                        offset += len(data)
                finally:
                    try:
                        writer.seal()
                    except FileNotFoundError:
                        # reservation aborted while pulling: don't let the
                        # seal error mask the chunk error / skip cleanup
                        seal_failed = True
                if seal_failed:
                    raise KeyError(
                        f"reservation for {object_id[:16]} aborted mid-pull")
                self.store.seal(oid)
                # peer knows error-ness
                info = await client.call("object_info", object_id=object_id)
                if info and info.get("is_error"):
                    self.error_objects.add(object_id)
                await self.gcs.call(
                    "register_object", object_id=object_id, size=size, node_id=self.hex
                )
                return True
            except (RpcConnectionError, RpcError, TimeoutError, KeyError) as e:
                logger.warning("pull of %s from %s failed: %s", object_id[:16], node_id[:8], e)
                try:
                    self.store.abort(oid)
                except Exception:  # noqa: BLE001
                    pass
                continue
        return False

    async def _peer(self, node_id: str) -> Optional[RpcClient]:
        client = self._peer_clients.get(node_id)
        if client is not None and not client._closed:
            return client
        addr = self._peer_addr_cache.get(node_id)
        if addr is None:
            for info in await self.gcs.call("get_nodes"):
                self._peer_addr_cache[info["NodeID"]] = info["NodeManagerAddress"]
            addr = self._peer_addr_cache.get(node_id)
        if addr is None:
            return None
        try:
            client = await RpcClient(addr).connect(timeout=2.0)
        except RpcConnectionError:
            return None
        self._peer_clients[node_id] = client
        return client

    async def _transfer_peer(self, node_id: str) -> Optional[RpcClient]:
        """Dedicated bulk-transfer connection to a peer (chunk payloads must
        not queue control RPCs behind multi-MB reads on a shared socket)."""
        client = self._transfer_clients.get(node_id)
        if client is not None and not client._closed:  # noqa: SLF001
            return client
        if await self._peer(node_id) is None:  # resolves + caches the address
            return None
        addr = self._peer_addr_cache.get(node_id)
        if addr is None:
            return None
        try:
            client = await RpcClient(addr).connect(timeout=2.0)
        except RpcConnectionError:
            return None
        self._transfer_clients[node_id] = client
        return client

    async def rpc_wait_objects(
        self, object_ids: List[str], num_returns: int, timeout_s: Optional[float]
    ) -> List[str]:
        """Wait until >= num_returns of the ids are available SOMEWHERE in the
        cluster (GCS-registered) or locally; returns the ready subset."""
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        ready: Set[str] = set(
            o for o in object_ids if self.store.contains(ObjectID.from_hex(o))
        )
        while True:
            if len(ready) >= num_returns or len(ready) == len(object_ids):
                break
            remaining = None if deadline is None else deadline - time.monotonic()
            if remaining is not None and remaining <= 0:
                break
            # event-driven: one GCS long-poll covers every still-pending id
            # (sealed objects always register at the GCS, so GCS-located is
            # the cluster-wide readiness signal)
            pending = [o for o in object_ids if o not in ready]
            chunk = 2.0 if remaining is None else min(2.0, max(0.05, remaining))
            try:
                located = await self.gcs.call(
                    "wait_objects_located", object_ids=pending,
                    num_returns=num_returns - len(ready),
                    timeout_s=chunk, timeout=chunk + 5.0,
                )
            except (TimeoutError, RpcError):  # chaos-dropped frame: re-poll
                located = []
            except (RpcConnectionError, OSError):  # GCS down: back off, retry
                await asyncio.sleep(0.2)
                located = []
            ready.update(located)
            if not located and remaining is not None and remaining <= chunk:
                break
        return [o for o in object_ids if o in ready]

    async def rpc_free_objects(self, object_ids: List[str]) -> bool:
        for object_id in object_ids:
            # prompt local delete, then the GCS fans out to every other
            # location (idempotent — a retried RPC re-frees nothing)
            self.store.delete(ObjectID.from_hex(object_id))
            self.error_objects.discard(object_id)
            self._object_meta.pop(object_id, None)
            await self.gcs.call("free_object_everywhere", object_id=object_id)
        return True

    async def rpc_delete_local_object(self, object_id: str) -> bool:
        self.store.delete(ObjectID.from_hex(object_id))
        self.error_objects.discard(object_id)
        self._object_meta.pop(object_id, None)
        return True

    # ------------------------------------------------------------ scheduling
    async def rpc_submit_task(self, spec: Dict[str, Any]) -> Dict[str, Any]:
        """Entry from drivers/workers on this node. Returns {accepted: bool}.
        Completion is observed through the object plane.

        Before accepting, the task's deps + returns are PINNED at the GCS
        under a task holder (so distributed GC can't free an argument while
        the task is queued/running — the pin outlives the submitter's own
        refs), the submitter's holder is registered on the returns, and the
        spec is retained as lineage for reconstruction. Pinning completes
        before this RPC returns, which closes the submit-then-drop race:
        the caller's arg refs are still live during this call."""
        fut = self._accept_task(spec)
        if fut is None:
            return {"accepted": True}  # duplicate submit (retried RPC): dedupe
        try:
            # the ack still waits for the pin (it closes the submit-then-drop
            # race) but the pin rides a BATCHED GCS RPC shared with every
            # other submit in the same tick
            await fut
        except Exception:  # noqa: BLE001 - pinning is best-effort bookkeeping
            logger.exception("ref pinning failed")
        spawn(self._submit_with_retries(spec))
        return {"accepted": True}

    def _accept_task(self, spec: Dict[str, Any]) -> Optional[asyncio.Future]:
        """Dedupe + queue the GCS ref pin for one submitted spec. Returns the
        pin future, or None for a duplicate (already accepted) task."""
        tid = spec.get("task_id", "")
        if tid in self._accepted_tasks:
            return None
        self._accepted_tasks[tid] = time.monotonic()
        while len(self._accepted_tasks) > 20000:
            self._accepted_tasks.popitem(last=False)
        returns: List[str] = spec.get("returns") or []
        deps: List[str] = spec.get("deps") or []
        pin = {
            "task_holder": self._task_holder(spec),
            "deps": deps,
            "returns": returns,
            "submitter": spec.get("holder") or "",
            "spec": spec if (
                returns and self._lineage_size(spec) <= config.max_lineage_bytes
            ) else None,
        }
        fut: asyncio.Future = asyncio.get_event_loop().create_future()
        self._pin_queue.append((pin, fut))
        self._pin_event.set()
        # tracked while the task is in flight so a GCS-restart resync can
        # re-assert the lease (pins taken after the last snapshot are gone
        # from the restored state)
        self._active_pins[pin["task_holder"]] = pin
        return fut

    async def rpc_submit_task_batch(self, specs: List[Dict[str, Any]]) -> Dict[str, Any]:
        """Coalesced driver-side submission: one RPC accepts a whole batch of
        task specs (the driver flushes its buffer by size or a ~1 ms window).
        Per-task dedupe makes the batch idempotent, so the method is
        retry-safe; the ack waits for every batch member's ref pin exactly
        like the single-spec path."""
        entries = [(spec, self._accept_task(spec)) for spec in specs]
        pins = [f for _, f in entries if f is not None]
        if pins:
            results = await asyncio.gather(*pins, return_exceptions=True)
            for r in results:
                if isinstance(r, Exception):
                    logger.error("ref pinning failed in batch: %s", r)
        for spec, fut in entries:
            if fut is not None:
                spawn(self._submit_with_retries(spec))
        return {"accepted": sum(1 for _, f in entries if f is not None)}

    def _task_holder(self, spec: Dict[str, Any]) -> str:
        # node-scoped so the GCS can drop this pin if the whole node dies
        # before _submit_with_retries gets to remove it
        return f"task:{spec.get('task_id', '')}@{self.hex}"

    @staticmethod
    def _lineage_size(spec: Dict[str, Any]) -> int:
        return len(spec.get("args_payload") or b"")

    async def _submit_with_retries(self, spec: Dict[str, Any]) -> None:
        try:
            await self._submit_with_retries_inner(spec)
        except Exception as e:  # noqa: BLE001 - fire-and-forget: NEVER lose returns
            logger.exception("task submission crashed")
            try:
                await self._store_error(spec, f"internal scheduling error: {e}")
            except Exception:  # noqa: BLE001
                logger.exception("failed to store error objects")
        finally:
            self._unreachable_since.pop(spec.get("task_id", ""), None)
            self._infeasible_since.pop(spec.get("task_id", ""), None)
            # release the task pin: returns stay alive through the
            # submitter's holder; deps fall back to their own holders.
            # Rides the batched unpin flush (one GCS RPC per tick).
            pinned = (spec.get("deps") or []) + (spec.get("returns") or [])
            self._active_pins.pop(self._task_holder(spec), None)
            if pinned:
                self._unpin_queue.append({
                    "holder": self._task_holder(spec), "object_ids": pinned,
                })
                self._unpin_event.set()

    def _can_grant_locally(self, spec: Dict[str, Any]) -> bool:
        """Local-first fast path (reference two-level design:
        cluster_resource_scheduler.cc:150 + local_task_manager.h:58): grant
        on THIS node without a control-plane round trip when the strategy has
        no global placement intent and resources fit right now. Everything
        else — SPREAD, labels, affinity to other nodes, unfit — goes through
        the (batched) GCS path with spillback."""
        if config.external_scheduler_address:
            # an external placement policy has authority over EVERY placement
            # (the fork's contract); the local fast path would bypass it
            return False
        strat = spec.get("strategy") or {}
        kind = strat.get("kind", "default")
        if kind == "node_affinity":
            if strat.get("node_id") != self.hex:
                return False
        elif kind != "placement_group" and (kind != "default" or strat.get("labels")):
            return False
        # the SAME code path the real acquire uses, in dry-run mode, so the
        # fast-path check can never drift from acquire semantics
        return self._acquire_for_spec(spec, dry_run=True) is not None

    async def _schedule_via_gcs(self, spec: Dict[str, Any]) -> Optional[str]:
        """Batched placement: requests arriving within one tick coalesce into
        a single GCS `schedule` RPC (the fork's measured failure mode was a
        control-plane round trip per lease; SURVEY §6)."""
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        self._sched_queue.append((
            {"resources": spec.get("resources") or {},
             "strategy": spec.get("strategy") or {},
             "req_id": spec.get("task_id", "")},
            fut,
        ))
        if self._sched_drainer is None or self._sched_drainer.done():
            self._sched_drainer = spawn(self._drain_sched_queue())
        return await fut

    async def _drain_sched_queue(self) -> None:
        try:
            while self._sched_queue:
                await asyncio.sleep(config.scheduler_batch_ms / 1000.0)
                batch, self._sched_queue = self._sched_queue, []
                if not batch:
                    continue
                try:
                    placements = await self.gcs.call(
                        "schedule", requests=[r for r, _ in batch]
                    )
                except RpcError:
                    # a handler-level error (e.g. one request's invalid PG
                    # bundle index) must not fail the whole batch: isolate it
                    # by re-scheduling each request individually
                    await self._schedule_batch_individually(batch)
                    continue
                except Exception as e:  # noqa: BLE001
                    for _, fut in batch:
                        if not fut.done():
                            fut.set_exception(e)
                    continue
                if not isinstance(placements, list) or len(placements) != len(batch):
                    # malformed scheduler reply (e.g. buggy external policy):
                    # fail loudly instead of stranding the tail futures forever
                    err = RpcError(
                        "SchedulerProtocolError",
                        f"scheduler returned {len(placements) if isinstance(placements, list) else type(placements).__name__} "
                        f"placements for {len(batch)} requests",
                    )
                    for _, fut in batch:
                        if not fut.done():
                            fut.set_exception(err)
                    continue
                for (_, fut), target in zip(batch, placements):
                    if not fut.done():
                        fut.set_result(target)
        finally:
            # no await between the while-exit and this check, so an enqueue
            # cannot slip in unseen (single-threaded loop): if one raced in
            # during the last batch's processing, hand off to a fresh drainer
            # rather than strand its future (lost-wakeup)
            if self._sched_queue:
                self._sched_drainer = spawn(self._drain_sched_queue())

    async def _schedule_batch_individually(
        self, batch: List[Tuple[Dict[str, Any], asyncio.Future]]
    ) -> None:
        for req, fut in batch:
            if fut.done():
                continue
            try:
                placements = await self.gcs.call("schedule", requests=[req])
                fut.set_result(placements[0] if placements else None)
            except Exception as e:  # noqa: BLE001
                fut.set_exception(e)

    async def _submit_with_retries_inner(self, spec: Dict[str, Any]) -> None:
        max_retries = int(spec.get("max_retries", 0))
        tid = spec.get("task_id", "")
        attempt = 0
        last_error = "unknown"
        last_error_type = "WorkerCrashedError"
        skip_local = False  # set after a local busy-grant: spill back via GCS
        busy_rounds = 0     # consecutive busy spillbacks (adaptive backoff)
        while attempt <= max_retries:
            target = None
            self._set_task_state(tid, "scheduling")
            if not skip_local and self._can_grant_locally(spec):
                target = self.hex
            else:
                try:
                    target = await self._schedule_via_gcs(spec)
                except RpcError as e:
                    # handler-level failure (e.g. invalid placement-group
                    # index) is fatal: materialize the error for get()
                    self._set_task_state(tid, "failed")
                    await self._store_error(spec, f"scheduling failed: {e}")
                    return
                except (RpcConnectionError, TimeoutError) as e:
                    last_error = f"scheduler unavailable: {e}"
            skip_local = False
            self._set_task_state(tid, f"placed:{(target or 'none')[:8]}")
            if target is None:
                # unplaceable now: backoff-retry without consuming an attempt.
                # Even CLUSTER-infeasible shapes wait out a grace window —
                # the unmet-demand ledger this retry keeps feeding is exactly
                # what the autoscaler scales up from (reference: infeasible
                # tasks pend while the autoscaler reacts; they don't error)
                feasible = await self._check_feasible(spec)
                if not feasible:
                    start = self._infeasible_since.setdefault(tid, time.monotonic())
                    if time.monotonic() - start > config.infeasible_task_grace_s:
                        self._infeasible_since.pop(tid, None)
                        await self._store_error(
                            spec,
                            f"Task {spec.get('name')} is infeasible: requires "
                            f"{spec.get('resources')}, no alive node can satisfy "
                            f"it, and none appeared within "
                            f"{config.infeasible_task_grace_s}s",
                        )
                        return
                    self._set_task_state(tid, "pending:infeasible")
                    await asyncio.sleep(0.5)
                    continue
                self._infeasible_since.pop(tid, None)
                await asyncio.sleep(0.05)
                continue
            self._infeasible_since.pop(tid, None)
            dispatch_started = False
            try:
                if target == self.hex:
                    dispatch_started = True
                    result = await self._dispatch_local(spec)
                else:
                    peer = await self._peer(target)
                    if peer is None:
                        raise RpcConnectionError(f"no route to node {target[:8]}")
                    dispatch_started = True
                    result = await peer.call("dispatch_task", spec=spec, timeout=None)
                if result.get("ok"):
                    self._set_task_state(tid, "finished")
                    return
                if not result.get("retryable", True):
                    self._set_task_state(tid, "failed")
                    return  # error object already stored by executor
                last_error = result.get("error", "dispatch failed")
                last_error_type = ("OutOfMemoryError" if result.get("oom")
                                   else "WorkerCrashedError")
                if spec.get("streaming") and result.get("reason") != "busy":
                    # the generator may have begun producing: a re-run would
                    # duplicate side effects and splice items from a second
                    # execution into a partially-consumed stream — fail it
                    # (consumer sees an error item at the next index)
                    attempt = max_retries + 1
                    continue
                if result.get("reason") == "busy":
                    # spillback: the task is merely QUEUED (resources/worker
                    # busy on the chosen node) — not a failure; re-place
                    # without consuming a retry attempt (reference: lease
                    # spillback never burns task retries). If the busy grant
                    # was the local fast path, consult the GCS next round.
                    # Backoff grows with consecutive busy rounds so a deep
                    # backlog doesn't hammer the scheduler at 50 Hz per task.
                    skip_local = target == self.hex
                    busy_rounds += 1
                    await asyncio.sleep(min(0.02 * busy_rounds, 0.25))
                    continue
                busy_rounds = 0
            except (RpcConnectionError, RpcError, TimeoutError) as e:
                last_error = str(e)
                if spec.get("streaming") and dispatch_started:
                    # connection lost mid-execution of a generator: never
                    # re-run a possibly-partially-consumed stream
                    attempt = max_retries + 1
                    continue
                if isinstance(e, RpcConnectionError) and not dispatch_started:
                    # target unreachable BEFORE the task could start: a pure
                    # PLACEMENT problem (node died or was scaled down; health
                    # checks lag by seconds) — re-place without consuming task
                    # retries, within a grace window. Connection loss MID-call
                    # must consume an attempt (at-most-once for retries=0).
                    start = self._unreachable_since.setdefault(tid, time.monotonic())
                    if time.monotonic() - start < config.dispatch_unreachable_grace_s:
                        self._set_task_state(tid, "replacing:unreachable-node")
                        await asyncio.sleep(0.2)
                        continue
            self._unreachable_since.pop(tid, None)
            self._set_task_state(tid, f"retrying:{last_error[:40]}")
            attempt += 1
            await asyncio.sleep(min(0.05 * (2 ** attempt), 1.0))
        self._set_task_state(tid, "failed")
        await self._store_error(
            spec, f"Task {spec.get('name')} failed after {max_retries} retries: {last_error}",
            error_type=last_error_type,
        )

    async def _check_feasible(self, spec: Dict[str, Any]) -> bool:
        resources = spec.get("resources") or {}
        for info in await self.gcs.call("get_nodes"):
            if info["Alive"] and all(
                info["Resources"].get(k, 0.0) + 1e-9 >= v for k, v in resources.items()
            ):
                return True
        return False

    async def rpc_dispatch_task(self, spec: Dict[str, Any]) -> Dict[str, Any]:
        return await self._dispatch_local(spec)

    async def _dispatch_local(self, spec: Dict[str, Any]) -> Dict[str, Any]:
        self._active_dispatches += 1
        try:
            return await self._dispatch_local_inner(spec)
        finally:
            self._active_dispatches -= 1

    async def _dispatch_local_inner(self, spec: Dict[str, Any]) -> Dict[str, Any]:
        tid = spec.get("task_id", "")
        # 1. dependencies local — ONE batched ensure (concurrent pulls, one
        # shared GCS long-poll + one batched holder lookup for the whole
        # dep set). A shuffle reduce task's N map-partition args land
        # through the transfer plane in parallel instead of N serial
        # lookup->pull round trips.
        deps: List[str] = spec.get("deps") or []
        from ray_tpu_torch.exceptions import ObjectStoreFullError

        if deps:
            results = await self.rpc_ensure_local_batch(
                deps, timeout_s=config.worker_lease_timeout_s * 10)
            failed = [r for r in results if "error" in r]
            try:
                # failures re-resolve through the per-object path so hard
                # errors (lost without lineage, reconstruction budget spent)
                # surface with their original exception type
                for r in failed:
                    await self.rpc_ensure_local(r["object_id"], timeout_s=5.0)
            except (TimeoutError, ObjectStoreFullError) as e:
                # store-full/timeout while pulling deps = transient local
                # pressure, not a task failure: requeue and let GC/spill
                # free space
                return {"ok": False, "retryable": True, "reason": "busy",
                        "error": f"deps unavailable: {e}"}
        self._set_task_state(tid, "deps-ready")
        # Pin deps in the LOCAL store for the rest of dispatch: the worker
        # reads its args straight out of the shm arena — and under the
        # columnar exchange keeps column views over the slot for the whole
        # task body — so LRU spill/eviction must not recycle a dep's slot
        # while the task can still touch it. (The GCS holder pins taken at
        # rpc_submit_task guard distributed GC; they say nothing about
        # local LRU.) pin() on a not-yet-resident entry is a no-op, so
        # re-ensure and re-pin until the pin actually holds: once an entry
        # is resident AND pinned it can neither be evicted nor spilled.
        pinned_deps: List[ObjectID] = []
        try:
            for d in dict.fromkeys(deps):
                oid = ObjectID.from_hex(d)
                self.store.pin(oid)
                pinned_deps.append(oid)
                while not self.store.contains(oid):
                    # entry vanished before the pin took (evicted while a
                    # later batch member was still pulling)
                    self.store.unpin(oid)
                    pinned_deps.remove(oid)
                    try:
                        await self.rpc_ensure_local(d, timeout_s=5.0)
                    except (TimeoutError, ObjectStoreFullError) as e:
                        return {"ok": False, "retryable": True,
                                "reason": "busy",
                                "error": f"deps unavailable: {e}"}
                    self.store.pin(oid)
                    pinned_deps.append(oid)
            return await self._dispatch_execute(spec, tid)
        finally:
            for oid in pinned_deps:
                self.store.unpin(oid)

    async def _dispatch_execute(self, spec: Dict[str, Any],
                                tid: str) -> Dict[str, Any]:
        """Steps 2+3 of local dispatch (resources, worker lease, run, seal);
        runs with the task's deps pinned in the local store by the caller."""
        from ray_tpu_torch.exceptions import ObjectStoreFullError

        # 2. resources (PG tasks draw from their committed bundle). Busy is
        # first absorbed by a short LOCAL wait — tasks queue at the node like
        # the reference raylet's local task queue — and only then reported
        # back for (GCS) spillback, which avoids a control-plane round trip
        # per 10ms of contention.
        # NO-STEAL fast path: a fresh dispatch may only grab resources when
        # nobody is parked in the FIFO — otherwise a sustained arrival stream
        # starves parked tasks indefinitely (each release stolen by a
        # newcomer; observed losing a task for 20+ min in the 50k stress)
        token = self._acquire_for_spec(spec) if self._local_waiters == 0 else None
        if token is None:
            deadline = time.monotonic() + config.local_queue_wait_s
            while token is None and time.monotonic() < deadline:
                # event-driven FIFO: _release_token wakes exactly one waiter;
                # the timeout is a safety net for resource-shape mismatches
                # (e.g. head waiter needs a GPU, a CPU was released)
                fut: asyncio.Future = asyncio.get_event_loop().create_future()
                self._local_wait_q.append(fut)
                self._local_waiters += 1
                try:
                    # wakeups come from the FIFO (releases chain through
                    # mismatched waiters); the 0.5 s cap bounds head-of-line
                    # stalls for resource-SHAPE mismatches — e.g. a CPU task
                    # parked behind a GPU waiter while CPUs sit free and no
                    # release ever fires to chain the wakeup
                    await asyncio.wait_for(
                        fut,
                        timeout=max(0.01, min(0.5, deadline - time.monotonic())),
                    )
                except asyncio.TimeoutError:
                    fut.cancel()  # abandoned: a release must skip, not consume
                finally:
                    self._local_waiters -= 1
                token = self._acquire_for_spec(spec)
                if token is None and fut.done() and not fut.cancelled():
                    # consumed a wakeup without acquiring (wrong resource
                    # shape): pass it on so the release isn't wasted
                    while self._local_wait_q:
                        # the wait queue exists to straddle the await: append
                        # before parking, hand off after waking is the protocol
                        # rtpulint: disable=race
                        nxt = self._local_wait_q.popleft()
                        if not nxt.done():
                            nxt.set_result(True)
                            break
        if token is None:
            return {"ok": False, "retryable": True, "reason": "busy", "error": "resources busy"}
        self._set_task_state(tid, "resources-acquired")
        # 3. worker lease + push. Tasks holding GPU resources run on a
        # DEDICATED worker that sees exactly its assigned cards
        # (CUDA_VISIBLE_DEVICES); CPU tasks use the shared pool.
        gpu_need = int((spec.get("resources") or {}).get("GPU", 0))
        renv, env_hash = self._runtime_env_of(spec)
        try:
            if gpu_need > 0:
                w = await self._lease_gpu_worker(gpu_need, env_hash=env_hash, renv=renv)
            else:
                w = await self._lease_worker(env_hash=env_hash, renv=renv)
        except TimeoutError as e:
            self._release_token(token)
            return {"ok": False, "retryable": True, "reason": "busy", "error": str(e)}
        except Exception as e:  # noqa: BLE001 - staging/env errors are fatal
            self._release_token(token)
            await self._store_error(spec, f"runtime_env setup failed: {e}")
            return {"ok": False, "retryable": False, "error": str(e)}
        w.lease_token = token
        w.running_task = spec
        w.task_started_at = time.monotonic()
        self._set_task_state(tid, "running")
        try:
            result = await w.client.call("run_task", spec=spec, timeout=None)
            snap = (result or {}).pop("decode_stats", None)
            if snap:
                self._worker_decode[w.worker_id] = snap
            self._set_task_state(tid, "executed")
        except (RpcConnectionError, RpcError) as e:
            if isinstance(e, RpcError):
                # handler-level failure: error object was stored by the worker
                return {"ok": False, "retryable": False, "error": str(e)}
            oom_msg = self._oom_kills.pop(spec.get("task_id", ""), None)
            if oom_msg is not None:
                # the memory monitor killed this worker deliberately: typed
                # failure (or retry) instead of a generic crash
                return {"ok": False, "retryable": True, "error": oom_msg,
                        "oom": True}
            return {"ok": False, "retryable": True, "error": f"worker connection lost: {e}"}
        finally:
            # release the worker + resource slot the moment execution ends:
            # sealing the returns below is AGENT-side work and must not
            # extend slot occupancy (it awaits a batched GCS registration —
            # ~tens of ms that used to serialize into every slot's turnover)
            w.running_task = None
            if not w.blocked:
                self._release_token(token)
            else:
                w.blocked = False  # resources already released at block time
            w.lease_token = None
            if w.gpu_chips is not None:
                self._release_gpu_worker(w)
            else:
                self._release_worker(w)
        # small returns ride inline in the reply: write+seal them here
        # (one fewer worker->agent round trip per task)
        inline = (result or {}).pop("inline_returns", None) or []
        try:
            for item in inline:
                await self._put_local(**item)
        except ObjectStoreFullError as e:
            # the task ran but its returns don't fit RIGHT NOW: requeue
            # (at-least-once; already-sealed returns dedupe on re-store)
            # instead of surfacing an internal error
            return {"ok": False, "retryable": True, "reason": "busy",
                    "error": f"store full for returns: {e}"}
        if (result or {}).get("state") == "retry_store_full":
            # worker-side big-return store failed the same way: requeue
            return {"ok": False, "retryable": True, "reason": "busy",
                    "error": "store full for returns (worker)"}
        return {"ok": True, **(result or {})}

    def _try_acquire(self, resources: Dict[str, float], dry_run: bool = False) -> bool:
        for k, v in resources.items():
            if self.available.get(k, 0.0) + 1e-9 < v:
                return False
        if not dry_run:
            for k, v in resources.items():
                self.available[k] = self.available.get(k, 0.0) - v
        return True

    def _release_resources(self, resources: Dict[str, float]) -> None:
        for k, v in resources.items():
            self.available[k] = self.available.get(k, 0.0) + v

    # -------------------------------------------------- placement-group bundles
    async def rpc_reserve_bundle(
        self, pg_id: str, bundle_index: int, resources: Dict[str, float]
    ) -> bool:
        key = (pg_id, bundle_index)
        if key in self._pg_bundles:
            return True  # idempotent re-commit
        if not self._try_acquire(resources):
            return False
        self._pg_bundles[key] = {"total": dict(resources), "avail": dict(resources)}
        return True

    async def rpc_return_bundle(self, pg_id: str, bundle_index: int = -1) -> bool:
        """Release bundle reservation(s) back to node availability.
        bundle_index < 0 releases every bundle of the pg on this node.
        In-flight tasks still drawing from a returned bundle release into a
        no-op (the full bundle already went back) — PG removal while tasks
        run is destructive, matching the reference."""
        for key in list(self._pg_bundles):
            if key[0] == pg_id and (bundle_index < 0 or key[1] == bundle_index):
                rec = self._pg_bundles.pop(key)
                self._release_resources(rec["total"])
        return True

    def _acquire_for_spec(self, spec: Dict[str, Any], dry_run: bool = False
                          ) -> Optional[Tuple[str, Any, Dict[str, float]]]:
        """Acquire execution resources for a task/actor spec. PG-scheduled
        work draws from its committed bundle; everything else from the node
        pool. Returns an opaque token for _release_token, or None if busy.
        ``dry_run`` answers "would this acquire succeed" without mutating —
        the local-first fast path uses it so grant checks can't drift from
        acquire semantics."""
        resources = spec.get("resources") or {}
        strat = spec.get("strategy") or {}
        if strat.get("kind") == "placement_group":
            pg_id = strat.get("pg", "")
            want = strat.get("bundle", -1)
            keys = [k for k in self._pg_bundles
                    if k[0] == pg_id and (want < 0 or k[1] == want)]
            for key in sorted(keys, key=lambda k: k[1]):
                avail = self._pg_bundles[key]["avail"]
                if all(avail.get(r, 0.0) + 1e-9 >= v for r, v in resources.items()):
                    if not dry_run:
                        for r, v in resources.items():
                            avail[r] = avail.get(r, 0.0) - v
                    return ("bundle", key, resources)
            return None
        if self._try_acquire(resources, dry_run=dry_run):
            return ("node", None, resources)
        return None

    def _release_token(self, token: Tuple[str, Any, Dict[str, float]]) -> None:
        kind, key, resources = token
        if kind == "bundle":
            rec = self._pg_bundles.get(key)
            if rec is not None:
                for r, v in resources.items():
                    rec["avail"][r] = rec["avail"].get(r, 0.0) + v
        else:
            self._release_resources(resources)
        while self._local_wait_q:  # wake ONE live waiter
            fut = self._local_wait_q.popleft()
            if not fut.done():
                fut.set_result(True)
                break

    def _reacquire_token(self, token: Tuple[str, Any, Dict[str, float]]) -> None:
        """Forcible re-acquire after a blocked worker resumes: brief
        oversubscription beats deadlock."""
        kind, key, resources = token
        if kind == "bundle":
            rec = self._pg_bundles.get(key)
            if rec is not None:
                for r, v in resources.items():
                    rec["avail"][r] = rec["avail"].get(r, 0.0) - v
        else:
            for k, v in resources.items():
                self.available[k] = self.available.get(k, 0.0) - v

    async def _store_error(self, spec: Dict[str, Any], message: str,
                           error_type: str = "TaskError") -> None:
        """Materialize a failure as error objects for every return id."""
        from ray_tpu_torch import exceptions as exc
        from ray_tpu_torch.core import serialization

        cls = getattr(exc, error_type, exc.TaskError)
        if cls is exc.TaskError:
            err = exc.TaskError(spec.get("name", "?"), message)
        else:
            err = cls(message)
        payload, _ = serialization.pack(err)
        if spec.get("streaming") and spec.get("task_id"):
            # a streaming consumer blocks on the stream directory, not the
            # fixed returns: surface the failure as an error ITEM at the
            # first unproduced index + end-of-stream. Never at index 0
            # blindly — a worker crash after items 0..k were produced (and
            # possibly consumed) must not truncate the stream into a
            # successful-looking end (the error would be invisible).
            tid = spec["task_id"]
            try:
                st = await self.gcs.call("stream_state", task_id=tid)
                if st.get("finished"):
                    return  # stream already ended (e.g. producer reported)
                nxt = int(st.get("produced", 0))
                from ray_tpu_torch.core.streaming import stream_item_id

                err_hex = stream_item_id(tid, nxt).hex()
                await self._write_error_object(err_hex, payload)
                await self.gcs.call(
                    "register_object", object_id=err_hex, size=len(payload),
                    node_id=self.hex, owner=":error",
                )
                await self.gcs.call("stream_put", task_id=tid, index=nxt,
                                    object_id=err_hex)
                await self.gcs.call("stream_end", task_id=tid, total=nxt + 1)
            except Exception:  # noqa: BLE001
                logger.exception("failed to report stream error")
            return
        from ray_tpu_torch.core.config import inline_max_bytes
        small = bytes(payload) if len(payload) <= inline_max_bytes() else None
        for object_id in spec.get("returns", []):
            try:
                await self._write_error_object(object_id, payload)
                await self.gcs.call(
                    "register_object", object_id=object_id, size=len(payload),
                    node_id=self.hex, owner=":error", payload=small,
                )
            except FileExistsError:
                pass  # a retry already stored a result

    async def _write_error_object(self, object_id: str, payload: bytes) -> None:
        from ray_tpu_torch.exceptions import ObjectStoreFullError

        oid = ObjectID.from_hex(object_id)
        deadline = time.monotonic() + 30.0
        while True:
            try:
                offset = self.store.reserve(oid, len(payload))
                break
            except ObjectStoreFullError:
                # error objects are what UNBLOCK waiters — losing one turns a
                # failure into an infinite hang. Wait out transient pressure
                # (GC/spill frees space within the ref-grace window).
                if time.monotonic() > deadline:
                    raise
                await asyncio.sleep(0.1)
        writer = ShmWriter(oid, len(payload), self.hex, offset=offset)
        writer.buffer[:] = payload
        writer.seal()
        self.store.seal(oid)
        self.error_objects.add(object_id)

    # ---------------------------------------------------------------- actors
    async def rpc_start_actor(self, spec: Dict[str, Any]) -> Dict[str, Any]:
        token = self._acquire_for_spec(spec)
        if token is None:
            return {"ok": False, "retryable": True, "reason": "busy", "error": "resources busy"}
        gpu_need = int((spec.get("resources") or {}).get("GPU", 0))
        renv, env_hash = self._runtime_env_of(spec)
        try:
            if gpu_need > 0:
                w = await self._lease_gpu_worker(gpu_need, env_hash=env_hash, renv=renv)
            else:
                w = await self._lease_worker(env_hash=env_hash, renv=renv)
        except TimeoutError as e:
            self._release_token(token)
            return {"ok": False, "retryable": True, "error": str(e)}
        except Exception as e:  # noqa: BLE001 - staging/env errors are fatal
            self._release_token(token)
            await self._store_error(spec, f"runtime_env setup failed: {e}")
            return {"ok": False, "retryable": False, "error": str(e)}
        w.state = "ACTOR"
        w.actor_id = spec["actor_id"]
        w._actor_token = token
        try:
            result = await w.client.call("start_actor", spec=spec, timeout=None)
        except (RpcConnectionError, RpcError) as e:
            self._release_token(token)
            w._actor_token = None
            await self._on_worker_death(w)
            return {"ok": False, "retryable": True, "error": str(e)}
        if not result.get("ok"):
            # constructor raised: creation error object stored by worker
            self._release_token(token)
            w._actor_token = None
            w.actor_id = None
            if w.gpu_chips is not None:
                # dedicated worker returns to the chip-keyed pool (NEVER the
                # CPU pool: it would run CPU tasks with a GPU env and strand
                # its chips forever)
                self._release_gpu_worker(w)
            else:
                w.state = "IDLE"
                self._idle_workers.setdefault(w.env_hash, []).append(w)
                self._notify_worker_free(w.env_hash)
            return {"ok": False, "retryable": False, "error": result.get("error", "")}
        await self.gcs.call(
            "actor_started", actor_id=spec["actor_id"], node_id=self.hex, address=w.address
        )
        return {"ok": True, "address": w.address}

    async def rpc_store_error(self, returns: List[str], name: str, message: str,
                              error_type: str = "TaskError") -> bool:
        await self._store_error({"returns": returns, "name": name}, message, error_type)
        return True

    async def rpc_kill_actor_worker(self, actor_id: str) -> bool:
        for w in list(self._workers.values()):
            if w.actor_id == actor_id:
                w.actor_id = None  # supervisor must not report this as a crash
                try:
                    w.proc.kill()
                except Exception:  # noqa: BLE001
                    pass
                token = w._actor_token
                if token is not None:
                    self._release_token(token)
                    w._actor_token = None
                return True
        return False

    # ------------------------------------------------------------------ info
    def _set_task_state(self, tid: str, state: str) -> None:
        self._task_states[tid] = state
        self._task_events.setdefault(tid, []).append((time.time(), state))
        while len(self._task_states) > 20000:  # bounded, like _accepted_tasks
            self._task_states.pop(next(iter(self._task_states)))
        while len(self._task_events) > 20000:
            self._task_events.pop(next(iter(self._task_events)))

    async def rpc_task_states(self) -> Dict[str, str]:
        return dict(self._task_states)

    async def rpc_report_profile_events(self, worker_id: str,
                                        events: List[Dict[str, Any]]) -> bool:
        """User profile spans from a worker (reference: profile_event.h ->
        GcsTaskManager); bounded ring, served to the dashboard timeline."""
        if len(events) > 1000:
            logger.warning("profile report from %s truncated: %d of %d spans "
                           "kept", worker_id[:8], 1000, len(events))
        for e in events[:1000]:
            e["worker_id"] = worker_id
            self._profile_events.append(e)
        del self._profile_events[:-20000]
        return True

    async def rpc_profile_events(self) -> List[Dict[str, Any]]:
        return list(self._profile_events)

    async def rpc_task_events(self) -> Dict[str, List[Tuple[float, str]]]:
        """Per-task (wall_ts, state) transition logs for the timeline."""
        return {t: list(ev) for t, ev in self._task_events.items()}

    async def rpc_metrics_text(self) -> str:
        """This node's metrics in Prometheus exposition format, labeled with
        the node id (reference: _private/metrics_agent.py:483 per-node
        collector -> Prometheus scrape)."""
        from ray_tpu_torch.utils import metrics

        self._scrape_gauges()
        return metrics.registry.prometheus_text(
            extra_labels={"node": self.hex[:16]}
        )

    def _scrape_gauges(self) -> None:
        from ray_tpu_torch.utils import metrics

        usage = self.store.usage()
        _gauge("ray_tpu_object_store_used_bytes",
               "Shared-memory object store bytes in use").set(usage.get("used", 0))
        _gauge("ray_tpu_object_store_capacity_bytes",
               "Shared-memory object store capacity").set(usage.get("capacity", 0))
        _gauge("ray_tpu_object_store_spilled_bytes",
               "Bytes spilled to disk").set(usage.get("spilled", 0))
        _gauge("ray_tpu_node_workers", "Worker processes on this node").set(
            len(self._workers))
        _gauge("ray_tpu_node_active_dispatches",
               "Tasks queued or running on this node").set(self._active_dispatches)
        ts = self.transfer.stats
        _gauge("ray_tpu_transfer_pull_bytes_total",
               "Object bytes pulled from peers").set(ts["pull_bytes"])
        _gauge("ray_tpu_transfer_ingest_bytes_total",
               "Object bytes received via chunked ingest").set(ts["ingest_bytes"])
        _gauge("ray_tpu_transfer_bytes_out_total",
               "Object bytes served/pushed to peers").set(ts["bytes_out"])
        _gauge("ray_tpu_transfer_pull_failovers_total",
               "Pulls that failed over to another source mid-object").set(
            ts["pull_failovers"])
        _gauge("ray_tpu_transfer_stalls_total",
               "Chunk requests delayed by the in-flight-bytes budget").set(
            ts["stalls"])
        _gauge("ray_tpu_transfer_last_pull_mbps",
               "Throughput of the most recent completed pull").set(
            ts["last_pull"].get("mbps", 0.0))
        for res in ("CPU", "GPU"):
            if res in self.total_resources:
                _gauge("ray_tpu_resource_available", "Available resource units",
                       ).set(self.available.get(res, 0.0), tags={"resource": res})
                _gauge("ray_tpu_resource_total", "Total resource units",
                       ).set(self.total_resources.get(res, 0.0), tags={"resource": res})

    # ------------------------------------------------------------------- jobs
    # Driver-script job submission (reference capability:
    # dashboard/modules/job/sdk.py:35 submit_job:125 — here the head agent
    # doubles as the job supervisor; job metadata mirrors into GCS KV so any
    # client can query status/logs cluster-wide).
    async def rpc_submit_job(
        self,
        entrypoint: str,
        env: Optional[Dict[str, str]] = None,
        working_dir: Optional[str] = None,
        job_id: Optional[str] = None,
    ) -> str:
        import shlex
        import uuid as _uuid

        if not entrypoint.strip():
            raise ValueError("empty job entrypoint")
        job_id = job_id or f"job-{_uuid.uuid4().hex[:10]}"
        log_path = os.path.join(self.session_dir, f"{job_id}.log")
        jenv = dict(os.environ)
        jenv.update(env or {})
        jenv["RAY_TPU_ADDRESS"] = self.gcs_address
        with open(log_path, "ab") as logfile:  # child keeps its own dup
            proc = subprocess.Popen(
                shlex.split(entrypoint), env=jenv, stdout=logfile,
                stderr=subprocess.STDOUT, cwd=working_dir or os.getcwd(),
                start_new_session=True,
            )
        self._jobs[job_id] = {"proc": proc, "log": log_path,
                              "entrypoint": entrypoint, "started": time.time()}
        await self._publish_job(job_id, "RUNNING")
        spawn(self._watch_job(job_id))
        return job_id

    async def _watch_job(self, job_id: str) -> None:
        rec = self._jobs[job_id]
        proc: subprocess.Popen = rec["proc"]
        while proc.poll() is None:
            await asyncio.sleep(0.2)
        rec["returncode"] = proc.returncode
        if rec.get("stop_requested"):
            status = "STOPPED"
        else:
            status = "SUCCEEDED" if proc.returncode == 0 else "FAILED"
        await self._publish_job(job_id, status, retries=30)

    async def _publish_job(self, job_id: str, status: str, retries: int = 3) -> None:
        import json

        rec = self._jobs.get(job_id, {})
        meta = {
            "job_id": job_id,
            "status": status,
            "node_id": self.hex,
            "entrypoint": rec.get("entrypoint", ""),
            "returncode": rec.get("returncode"),
            "started": rec.get("started"),
        }
        for attempt in range(max(retries, 1)):
            try:
                await self.gcs.call("kv_put", key=f"job:{job_id}",
                                    value=json.dumps(meta).encode())
                return
            except Exception:  # noqa: BLE001
                if attempt == max(retries, 1) - 1:
                    logger.exception("failed to publish job status")
                else:
                    await asyncio.sleep(1.0)

    async def rpc_job_logs(self, job_id: str, tail_bytes: int = 65536,
                           offset: Optional[int] = None) -> Any:
        """tail mode (offset=None): last tail_bytes as raw bytes.
        stream mode (offset=N): {"data": bytes-from-N, "offset": new-end} so
        followers track an absolute position instead of a sliding tail."""
        rec = self._jobs.get(job_id)
        if rec is None:
            raise KeyError(f"unknown job {job_id}")
        if offset is None:
            return self._read_log_tail(rec["log"], tail_bytes)
        try:
            with open(rec["log"], "rb") as f:
                f.seek(offset)
                data = f.read(tail_bytes)
                return {"data": data, "offset": offset + len(data)}
        except OSError:
            return {"data": b"", "offset": offset}

    async def rpc_stop_job(self, job_id: str) -> bool:
        rec = self._jobs.get(job_id)
        if rec is None:
            return False
        rec["stop_requested"] = True
        proc: subprocess.Popen = rec["proc"]
        if proc.poll() is None:
            try:
                os.killpg(os.getpgid(proc.pid), 15)
            except Exception:  # noqa: BLE001
                proc.terminate()
        return True

    @staticmethod
    def _read_log_tail(path: str, tail_bytes: int) -> bytes:
        try:
            with open(path, "rb") as f:
                f.seek(0, os.SEEK_END)
                size = f.tell()
                f.seek(max(0, size - tail_bytes))
                return f.read()
        except OSError:
            return b""

    async def rpc_get_log(self, name: str, tail_bytes: int = 65536) -> bytes:
        """Read a log file from this node's session dir by BASENAME only
        (no path traversal)."""
        base = os.path.basename(name)
        return self._read_log_tail(os.path.join(self.session_dir, base), tail_bytes)

    async def rpc_list_logs(self) -> List[str]:
        try:
            return sorted(f for f in os.listdir(self.session_dir) if f.endswith(".log"))
        except OSError:
            return []

    async def rpc_dump_stacks(self) -> str:
        """All thread stacks of THIS process (`ray_tpu_torch stack` backend;
        reference capability: `ray stack` py-spy dump)."""
        from ray_tpu_torch.utils.debug import format_all_stacks

        return format_all_stacks()

    async def rpc_dump_worker_stacks(self) -> Dict[str, str]:
        """Relay dump_stacks to every live worker on this node — where hung
        USER code actually lives (the `ray stack` use-case)."""
        out: Dict[str, str] = {}

        async def one(worker_id: str, w) -> None:
            if w.client is None or w.proc.poll() is not None:
                return
            try:
                out[worker_id] = await w.client.call("dump_stacks", timeout=10.0)
            except Exception as e:  # noqa: BLE001 - a stuck worker still times out
                out[worker_id] = f"<dump failed: {type(e).__name__}: {e}>"

        await asyncio.gather(*[one(wid, w) for wid, w in self._workers.items()])
        return out

    async def rpc_node_info(self) -> Dict[str, Any]:
        import socket

        return {
            "node_id": self.hex,
            "hostname": socket.gethostname(),
            "address": self.rpc.address,
            "resources": self.total_resources,
            "available": self.available,
            "labels": self.labels,
            "workers": len(self._workers),
            "idle_workers": sum(len(v) for v in self._idle_workers.values()),
            "store": self.store.usage(),
            # summed last-seen worker decode counters (dead workers keep
            # their final value so the node total stays monotonic)
            "decode": {
                k: sum(v.get(k, 0) for v in self._worker_decode.values())
                for k in ("zero_copy_bytes", "copied_bytes")
            },
            # shm-locality probe: a nonce file in THIS machine's /dev/shm.
            # A driver that can read the nonce shares the agent's shm and may
            # use the direct data plane; hostname comparison alone misses
            # cloned VMs with identical hostnames (ADVICE r4)
            "shm_probe": {"path": self._shm_probe_path,
                          "nonce": self._shm_probe_nonce},
        }

    async def rpc_worker_blocked(self, worker_id: str) -> bool:
        """A leased worker is blocking in get(): release its CPU lease so
        dependent tasks can run (reference: raylet releases CPUs for workers
        blocked in ray.get — prevents nested-task deadlock)."""
        w = self._workers.get(worker_id)
        if w is not None and w.state == "LEASED" and w.lease_token and not w.blocked:
            w.blocked = True
            self._release_token(w.lease_token)
        return True

    async def rpc_worker_unblocked(self, worker_id: str) -> bool:
        w = self._workers.get(worker_id)
        if w is not None and w.blocked and w.lease_token:
            w.blocked = False
            # reacquire without waiting: brief oversubscription beats deadlock
            self._reacquire_token(w.lease_token)
        return True

    async def rpc_ping(self) -> str:
        return "pong"


async def serve_forever(args) -> None:
    agent = NodeAgent(
        gcs_address=args.gcs,
        host=args.host,
        port=args.port,
        num_cpus=args.num_cpus,
        num_gpus=args.num_gpus,
        resources={k: float(v) for k, v in
                   (kv.split("=", 1) for kv in (args.resource or []))},
        labels=dict(kv.split("=", 1) for kv in (args.label or [])),
        is_head=args.head,
        session_dir=args.session_dir,
        object_store_memory=args.object_store_memory or None,
    )
    h, p = await agent.start()
    if args.ready_file:
        with open(args.ready_file, "w") as f:
            f.write(f"{h}:{p}")
    await asyncio.Event().wait()


def main() -> None:
    import argparse

    parser = argparse.ArgumentParser(description="ray_tpu_torch node agent")
    parser.add_argument("--gcs", required=True)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--num-cpus", type=int, default=None)
    # --num-tpus: the JAX package's name, kept as an alias
    parser.add_argument("--num-gpus", "--num-tpus", dest="num_gpus", type=int, default=0)
    parser.add_argument("--label", action="append", default=[])
    parser.add_argument("--resource", action="append", default=[])
    parser.add_argument("--head", action="store_true")
    parser.add_argument("--session-dir", default=None)
    parser.add_argument("--object-store-memory", type=int, default=0)
    parser.add_argument("--ready-file", default=None)
    args = parser.parse_args()
    asyncio.run(serve_forever(args))


if __name__ == "__main__":
    main()
