"""Typed, env-overridable configuration registry (own copy of
ray_tpu.core.config).

Equivalent capability to the reference's RAY_CONFIG system
(reference: src/ray/common/ray_config_def.h — env override via
``RAY_<name>``, per-run override via ``init(_system_config=...)``). Here:

- defaults declared once in ``_DEFINITIONS``
- env override: ``RAY_TPU_<NAME>`` (bools: 0/1/true/false), the JAX
  package's names, so one environment configures both
- programmatic override: ``config.apply_overrides({...})`` (called by
  ``ray_tpu_torch.init(system_config=...)``); on a cluster the head node
  publishes the merged dict through the control service so every node
  agent and worker sees one view.

The JAX package's TPU cost-model entries (chips per host, ICI and DCN
bandwidth) have no reader in the port and are left out.
"""

from __future__ import annotations

import json
import os
import threading
from dataclasses import dataclass
from typing import Any, Dict, Optional

_ENV_PREFIX = "RAY_TPU_"


@dataclass
class _ConfigEntry:
    name: str
    default: Any
    type: type
    doc: str = ""


def _parse(raw: str, typ: type) -> Any:
    if typ is bool:
        return raw.strip().lower() in ("1", "true", "yes", "on")
    if typ is dict or typ is list:
        return json.loads(raw)
    return typ(raw)


class Config:
    """Process-wide config. Thread-safe; values resolve as
    override > environment > default."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._entries: Dict[str, _ConfigEntry] = {}
        self._overrides: Dict[str, Any] = {}
        for name, default, typ, doc in _DEFINITIONS:
            self._entries[name] = _ConfigEntry(name, default, typ, doc)

    def get(self, name: str) -> Any:
        entry = self._entries[name]
        with self._lock:
            if name in self._overrides:
                return self._overrides[name]
        raw = os.environ.get(_ENV_PREFIX + name.upper())
        if raw is not None:
            try:
                return _parse(raw, entry.type)
            except (ValueError, json.JSONDecodeError):
                pass
        return entry.default

    def __getattr__(self, name: str) -> Any:
        if name.startswith("_"):
            raise AttributeError(name)
        try:
            return self.get(name)
        except KeyError:
            raise AttributeError(name) from None

    def apply_overrides(self, overrides: Optional[Dict[str, Any]]) -> None:
        if not overrides:
            return
        unknown = [k for k in overrides if k not in self._entries]
        if unknown:
            raise ValueError(f"Unknown config keys: {unknown}. Known: {sorted(self._entries)}")
        with self._lock:
            self._overrides.update(overrides)

    def snapshot(self) -> Dict[str, Any]:
        """Resolved view of every entry (for distribution to other nodes)."""
        return {name: self.get(name) for name in self._entries}

    def reset(self) -> None:
        with self._lock:
            self._overrides.clear()


# (name, default, type, doc)
_DEFINITIONS = [
    # --- object store / object plane ---
    ("object_store_memory_bytes", 2 * 1024**3, int,
     "Shared-memory object store arena size per node."),
    ("object_store_full_retries", 10, int,
     "Retries (with eviction attempts) before a put fails with ObjectStoreFullError."),
    ("store_full_put_wait_s", 30.0, float,
     "How long a put blocks retrying while the local store is transiently "
     "full of pinned/unsealed bytes (running tasks' pinned args) before "
     "raising ObjectStoreFullError."),
    ("arena_abort_quarantine_s", 5.0, float,
     "Grace period before an aborted arena reservation's block is reused "
     "(a zombie writer's late bytes must land in dead memory)."),
    ("object_store_backend", "auto", str,
     "Object store backend: 'arena' (native C++ allocator over one shm arena), "
     "'segments' (one shm file per object), or 'auto' (arena when the native "
     "library builds, else segments)."),
    ("max_direct_call_object_size", 100 * 1024, int,
     "Task returns under this size are sent inline to the owner instead of the shared store."),
    ("object_spilling_enabled", True, bool,
     "Spill primary copies to local disk under memory pressure."),
    ("object_spilling_dir", "", str,
     "Directory for spilled objects; defaults to <session_dir>/spill."),
    ("object_spilling_threshold", 0.8, float,
     "Arena utilization fraction that triggers spilling."),
    ("fetch_chunk_bytes", 8 * 1024 * 1024, int,
     "Chunk size for node-to-node object transfer."),
    ("object_transfer_retries", 5, int,
     "Pull retries (exponential backoff) before an object fetch errors."),
    # --- zero-copy pipelined transfer plane ---
    ("raw_transfer_enabled", True, bool,
     "Data plane for object bytes: raw binary frames (small msgpack header "
     "+ payload written/received as memoryviews, socket<->arena with no "
     "msgpack encode of the payload) with windowed pipelined chunk "
     "requests, striped multi-source pulls and mid-object failover. "
     "Escape hatch: env RTPU_RAW_TRANSFER=0 restores the serial in-band "
     "msgpack chunk path."),
    ("pull_stripe_enabled", True, bool,
     "Striped pulls: spread chunk ranges of one object across every "
     "GCS-known holder instead of draining a single source."),
    ("transfer_window_chunks", 8, int,
     "In-flight chunk requests per transfer source (the pull/push "
     "pipelining window; 1 = lockstep await-per-chunk)."),
    ("transfer_max_sources", 4, int,
     "Max holders one striped pull spreads its chunk ranges across."),
    ("transfer_inflight_max_bytes", 256 * 1024 * 1024, int,
     "Global budget of in-flight transfer bytes per agent (backpressure: "
     "chunk requests wait instead of over-committing arena/network)."),
    ("transfer_chunk_timeout_s", 60.0, float,
     "Per-chunk deadline on the raw transfer plane before the chunk is "
     "re-requested (possibly from another source)."),
    ("transfer_ingest_idle_s", 60.0, float,
     "In-flight chunked ingests (cached writer keyed by object id) idle "
     "longer than this are aborted and swept."),
    ("object_ref_grace_s", 2.0, float,
     "Grace window after an object's cluster-wide holder set empties before "
     "the GCS frees it everywhere (absorbs in-flight ref handoffs)."),
    ("ref_sync_interval_s", 0.05, float,
     "Flush interval for the client-side batched object-ref add/remove sync."),
    ("object_holder_lease_s", 30.0, float,
     "Process holders (w:*) that miss heartbeats for this long are dropped "
     "(crashed driver/worker cleanup); task pins are dropped with their node."),
    ("max_object_reconstructions", 3, int,
     "Per-object cap on lineage-reconstruction attempts after all copies are lost."),
    ("max_lineage_bytes", 8 * 1024 * 1024, int,
     "Task specs above this size are not retained for lineage reconstruction."),
    # --- scheduling ---
    ("gcs_snapshot_interval_s", 1.0, float,
     "Interval between GCS state snapshots when --persist-dir is set."),
    ("dispatch_unreachable_grace_s", 15.0, float,
     "Re-place (without consuming task retries) when the dispatch target is "
     "unreachable, for this long — covers the health-check lag after a node "
     "dies or is scaled down."),
    ("infeasible_task_grace_s", 120.0, float,
     "How long a cluster-infeasible task stays pending (feeding the "
     "autoscaler's demand signal) before erroring."),
    ("local_queue_wait_s", 10.0, float,
     "How long a task queues at a busy node before spilling back to global "
     "placement (the raylet local-queue analogue). Parked tasks cost one "
     "FIFO entry each; short values make a deep backlog churn through "
     "re-placement cycles that starve the agent loop."),
    ("scheduler_batch_ms", 5, int,
     "Agent-side coalescing window for GCS placement requests (one batched "
     "schedule RPC per tick instead of a round trip per task)."),
    ("scheduler_spread_threshold", 0.5, float,
     "Hybrid policy: pack onto nodes below this utilization, then spread."),
    ("scheduler_top_k_fraction", 0.2, float,
     "Hybrid policy samples among the top-k fraction of feasible nodes."),
    ("external_scheduler_address", "", str,
     "host:port of an external placement-policy service (batched, off the per-task hot path)."),
    ("external_scheduler_batch_ms", 10, int,
     "Batching window for external scheduler placement requests."),
    ("worker_lease_timeout_s", 30.0, float,
     "Timeout for a worker-lease request before retrying elsewhere."),
    ("max_pending_lease_requests_per_key", 10, int,
     "Pipelined lease requests per scheduling key."),
    ("generator_backpressure_items", 16, int,
     "Streaming generators: max items produced ahead of the consumer before "
     "the producer blocks (0 = unlimited). Per-task override via "
     "_generator_backpressure option."),
    # --- workers ---
    ("num_workers_per_node", 0, int,
     "Worker processes per node (0 = num_cpus)."),
    ("worker_idle_timeout_s", 60.0, float,
     "Idle leased workers are returned to the pool after this."),
    ("worker_start_timeout_s", 60.0, float,
     "Time to wait for a worker process to register before declaring it failed."),
    ("prestart_workers", True, bool,
     "Start workers ahead of demand based on queue backlog."),
    # --- fault tolerance ---
    ("gcs_recovery_enabled", True, bool,
     "GCS crash-restart recovery subsystem (core/recovery/): a restarted "
     "GCS stamps a new gcs_epoch, restores snapshot state, and rebuilds "
     "the object directory from agent re-registration inside a bounded "
     "reconstruction window; agents and drivers park-and-retry across the "
     "outage instead of failing. Escape hatch: env RTPU_GCS_RECOVERY=0 "
     "restores fail-fast behavior for A/B."),
    ("gcs_reconstruction_window_s", 5.0, float,
     "Upper bound on the post-restart reconstruction window: snapshot-"
     "restored object locations stay provisional until the holder node "
     "re-reports them; at the deadline unconfirmed locations are dropped "
     "(so lost objects surface and lineage reconstruction can run). The "
     "window also closes early once every provisional location is "
     "confirmed or its node is dead."),
    ("recovery_resync_batch", 200, int,
     "Objects per batched register_objects RPC during an agent's full "
     "re-registration (directory reconstruction after a GCS restart)."),
    ("recovery_park_timeout_s", 60.0, float,
     "How long recovery-aware paths (seal registration flush, transfer-"
     "plane registration batcher) park-and-retry across a GCS outage "
     "before failing their waiters."),
    ("task_max_retries_default", 3, int,
     "Default retries for tasks that die due to worker/node failure."),
    ("actor_max_restarts_default", 0, int,
     "Default actor restarts."),
    ("max_lineage_bytes", 512 * 1024 * 1024, int,
     "Budget of task-spec lineage kept for object reconstruction."),
    ("log_monitor_interval_s", 0.5, float,
     "How often each agent checks worker logs for growth."),
    ("health_check_period_ms", 1000, int,
     "Control-service health ping period."),
    ("health_check_failure_threshold", 10, int,
     "Missed health checks before a node is declared dead (the reference "
     "defaults to 30 s of missed heartbeats; a busy-but-alive node must not "
     "be reaped)."),
    # --- memory monitor / OOM protection ---
    ("memory_monitor_refresh_ms", 250, int,
     "Host-memory monitor poll interval (0 = disabled). Reference: "
     "memory_monitor.h:52 kernel polling."),
    ("memory_usage_threshold", 0.95, float,
     "Fraction of host memory in use above which the agent kills workers "
     "to protect the node (reference: worker_killing_policy.h:34)."),
    ("min_memory_free_bytes", -1, int,
     "Absolute free-memory floor that also triggers the OOM killer when "
     "crossed (-1 = derive from memory_usage_threshold only)."),
    # --- pipelined control plane ---
    ("pipeline_enabled", True, bool,
     "Pipelined control plane: batched task submission, windowed actor-call "
     "dispatch, pushed completions and inline small results. Escape hatch: "
     "env RTPU_PIPELINE=0 restores the lockstep request/response paths."),
    ("inline_max_bytes", 8192, int,
     "Task/actor-call results whose serialized payload is at most this many "
     "bytes ride inline in the completion message (actor replies and pushed "
     "seal events), skipping the arena write and/or the separate read RPC. "
     "Env override: RTPU_INLINE_MAX_BYTES."),
    ("submit_batch_max", 64, int,
     "Driver-side task submissions coalesce into one submit_task_batch RPC; "
     "a batch flushes when it reaches this many specs."),
    ("submit_batch_window_ms", 1.0, float,
     "Coalescing window before a partial submission batch flushes."),
    ("submit_batch_max_bytes", 4 * 1024 * 1024, int,
     "A submission batch also flushes once its argument payloads exceed "
     "this many bytes (bounds per-frame memory)."),
    ("actor_call_window", 32, int,
     "Max in-flight pushed actor calls per actor per caller (the pipelining "
     "window); the dispatcher blocks when the window is full."),
    ("actor_call_deadline_s", 120.0, float,
     "Per-attempt deadline for a pushed actor call. On expiry the caller "
     "probes worker liveness: an alive worker means the call is merely "
     "long-running and the caller re-attaches (the worker dedupes by "
     "task_id), so long calls survive; a dead/unreachable worker routes "
     "through the actor retry path instead of wedging the dispatcher."),
    ("actor_reorder_wait_s", 2.0, float,
     "Worker-side wait for a missing predecessor seq before executing a "
     "later actor call anyway (keeps per-actor in-order execution across "
     "retry-induced reordering without wedging on a lost call)."),
    # --- rpc ---
    ("rpc_connect_timeout_s", 10.0, float, "Socket connect timeout."),
    ("rpc_call_timeout_s", 60.0, float, "Default RPC deadline."),
    ("rpc_retry_attempt_timeout_s", 2.0, float,
     "Per-attempt timeout for retry-safe RPC methods; the overall deadline "
     "is still the call's timeout."),
    ("rpc_max_message_bytes", 512 * 1024 * 1024, int, "Max framed message size."),
    ("rpc_chaos_failure_prob", 0.0, float,
     "Fault injection: probability an RPC is dropped (request or response)."),
    ("rpc_chaos_seed", 0, int, "Seed for RPC chaos injection."),
    # --- observability ---
    ("metrics_export_port", 0, int, "Prometheus text exposition port (0=disabled)."),
    ("dashboard_port", 0, int,
     "HTTP observability plane on the head node (0 = ephemeral port, "
     "-1 = disabled). Address published under GCS KV 'dashboard:address'."),
    ("dashboard_host", "127.0.0.1", str, "Dashboard bind host."),
    ("event_log_enabled", True, bool, "Write task/actor state events to the session dir."),
    ("log_to_driver", True, bool, "Forward worker stdout/stderr to the driver."),
    # --- device ---
    ("device_prefetch_depth", 2, int, "Host->device double-buffering depth for data loading."),
    # --- data ---
    ("data_memory_fraction", 0.25, float,
     "Fraction of the object-store budget the streaming Data executor may "
     "hold in flight across all operators (the ResourceManager's global "
     "memory budget; reference: execution/resource_manager.py)."),
    ("data_default_op_concurrency", 4, int,
     "Default in-flight task cap per physical Data operator "
     "(ConcurrencyCapBackpressurePolicy; override per-op via "
     "map_batches(concurrency=...))."),
    ("data_max_queued_blocks", 4, int,
     "Max un-consumed output blocks per physical Data operator (its output "
     "queue + the downstream input queue) before the downstream-capacity "
     "backpressure policy stops its dispatches."),
    # --- data: streaming distributed shuffle ---
    ("streaming_shuffle_enabled", True, bool,
     "Streaming shuffle subsystem for sort/groupby/repartition/"
     "random_shuffle: map-side partitioner tasks run as each upstream block "
     "lands (no driver barrier), reduce tasks are admitted under a "
     "spill-aware memory budget. Escape hatch: env RTPU_STREAMING_SHUFFLE=0 "
     "restores the AllToAllOp barrier exchange for A/B."),
    ("shuffle_default_partitions", 8, int,
     "Reducer count for a shuffle whose stage doesn't pin one when the "
     "upstream block count is unknown (iterator sources, unions)."),
    ("shuffle_admission_memory_fraction", 0.5, float,
     "Fraction of the Data memory budget the in-flight reduce partition "
     "sets of one shuffle may occupy. Beyond it, reduce admission DEFERS "
     "(map partition blocks stay at rest in the store, spilling under "
     "pressure) instead of pulling the whole exchange into memory — how a "
     "shuffle larger than aggregate arena memory completes."),
    ("transfer_register_batch_ms", 1.0, float,
     "Coalescing window for GCS object registrations on the transfer plane "
     "(pulled partition blocks register in one batched RPC per tick, not "
     "one round trip per block)."),
    # --- data: columnar zero-copy exchange ---
    ("columnar_exchange_enabled", True, bool,
     "Columnar exchange path for shuffle blocks: pyarrow Tables serialize "
     "as Arrow IPC stream bytes carried out-of-band (pickle-5 buffers), so "
     "readers reconstruct columns as views over the payload — in a worker "
     "resolving pinned task args, views over the shm arena itself — and "
     "the shuffle kernels partition/merge via vectorized column ops "
     "(single argsort scatter, map-side pre-sort + reduce-side k-way "
     "merge) instead of n-scan takes and full re-sorts. Escape hatch: env "
     "RTPU_COLUMNAR_EXCHANGE=0 restores the cloudpickle block path and "
     "the row-object kernels wholesale for A/B."),
]


config = Config()


def pipeline_enabled() -> bool:
    """Pipelined control plane on/off. The RTPU_PIPELINE env var is the
    operator escape hatch (tools/ray_perf.py --no-pipeline sets it) and wins
    over the config entry so one process tree can be flipped wholesale."""
    raw = os.environ.get("RTPU_PIPELINE")
    if raw is not None:
        return raw.strip().lower() not in ("0", "false", "no", "off")
    return config.pipeline_enabled


def raw_transfer_enabled() -> bool:
    """Raw-frame data plane on/off. The RTPU_RAW_TRANSFER env var is the
    operator escape hatch (tools/ray_perf.py --no-raw-transfer sets it) and
    wins over the config entry so one process tree can be flipped wholesale
    for A/B measurement against the msgpack in-band path."""
    raw = os.environ.get("RTPU_RAW_TRANSFER")
    if raw is not None:
        return raw.strip().lower() not in ("0", "false", "no", "off")
    return config.raw_transfer_enabled


def streaming_shuffle_enabled() -> bool:
    """Streaming shuffle subsystem on/off. The RTPU_STREAMING_SHUFFLE env
    var is the operator escape hatch (tools/bench_shuffle.py --no-streaming
    sets it) and wins over the config entry so one process tree can be
    flipped wholesale for A/B against the AllToAllOp barrier exchange."""
    raw = os.environ.get("RTPU_STREAMING_SHUFFLE")
    if raw is not None:
        return raw.strip().lower() not in ("0", "false", "no", "off")
    return config.streaming_shuffle_enabled


def columnar_exchange_enabled() -> bool:
    """Columnar zero-copy exchange on/off. The RTPU_COLUMNAR_EXCHANGE env
    var is the operator escape hatch (tools/bench_shuffle.py --columnar=off
    sets it) and wins over the config entry so one process tree can be
    flipped wholesale for A/B against the cloudpickle block path. Shuffle
    specs capture this at DRIVER construction time (the decision bakes into
    the spec closures shipped to workers), so a mid-run env flip in the
    driver never splits one exchange across kernel variants."""
    raw = os.environ.get("RTPU_COLUMNAR_EXCHANGE")
    if raw is not None:
        return raw.strip().lower() not in ("0", "false", "no", "off")
    return config.columnar_exchange_enabled


def gcs_recovery_enabled() -> bool:
    """GCS crash-restart recovery on/off. The RTPU_GCS_RECOVERY env var is
    the operator escape hatch (tests and tools/bench_chaos.py set it) and
    wins over the config entry so one process tree can be flipped wholesale:
    with it off, a dead GCS fails agents and drivers fast (the pre-recovery
    behavior) instead of parking-and-retrying through the outage."""
    raw = os.environ.get("RTPU_GCS_RECOVERY")
    if raw is not None:
        return raw.strip().lower() not in ("0", "false", "no", "off")
    return config.gcs_recovery_enabled


def inline_max_bytes() -> int:
    """Inline-result threshold; RTPU_INLINE_MAX_BYTES env override wins."""
    raw = os.environ.get("RTPU_INLINE_MAX_BYTES")
    if raw:
        try:
            return int(raw)
        except ValueError:
            pass
    return config.inline_max_bytes
