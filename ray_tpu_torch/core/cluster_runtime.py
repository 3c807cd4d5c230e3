"""ClusterRuntime: CoreRuntime backend over a real multi-process cluster.

Driver and worker processes both use this class; it speaks to:
- the GCS (membership, actors, objects directory, KV, placement groups)
- the LOCAL node agent (object plane, task submission)
- actor workers DIRECTLY (per-call push, the agent is off the data path —
  reference: transport/actor_task_submitter.h direct PushTask design).
"""

from __future__ import annotations

import concurrent.futures
import os
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import cloudpickle

from ray_tpu_torch import exceptions as exc
from ray_tpu_torch.core import serialization
from ray_tpu_torch.core.config import (columnar_exchange_enabled, config,
                                 gcs_recovery_enabled)
from ray_tpu_torch.core.ids import ActorID, JobID, NodeID, ObjectID, PlacementGroupID
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.core.resources import (
    DefaultSchedulingStrategy,
    NodeAffinitySchedulingStrategy,
    NodeLabelSchedulingStrategy,
    PlacementGroupSchedulingStrategy,
    SpreadSchedulingStrategy,
)
from ray_tpu_torch.core.rpc import RpcConnectionError, RpcError, SyncRpcClient
from ray_tpu_torch.core.runtime import CoreRuntime
from ray_tpu_torch.core.shm_store import ShmReader, ShmWriter, segment_name
from ray_tpu_torch.core.task_spec import TaskSpec
from ray_tpu_torch.core.worker import Worker, global_worker
from ray_tpu_torch.utils.logging import get_logger

logger = get_logger("cluster_runtime")


def strategy_to_dict(strategy) -> Dict[str, Any]:
    if isinstance(strategy, SpreadSchedulingStrategy):
        return {"kind": "spread"}
    if isinstance(strategy, NodeAffinitySchedulingStrategy):
        return {"kind": "node_affinity", "node_id": strategy.node_id, "soft": strategy.soft}
    if isinstance(strategy, NodeLabelSchedulingStrategy):
        return {"kind": "default", "labels": dict(strategy.hard)}
    if isinstance(strategy, PlacementGroupSchedulingStrategy) and strategy.placement_group is not None:
        return {
            "kind": "placement_group",
            "pg": strategy.placement_group.id.hex(),
            "bundle": strategy.placement_group_bundle_index,
        }
    return {"kind": "default"}


class ClusterRuntime(CoreRuntime):
    is_local = False

    def __init__(
        self,
        gcs_address: str,
        agent_address: str,
        node_id: NodeID,
        is_driver: bool = True,
        namespace: str = "default",
    ):
        self.gcs_address = gcs_address
        self.agent_address = agent_address
        self.node_id = node_id
        self.node_hex = node_id.hex()
        self.namespace = namespace
        # CLIENT MODE (reference: util/client ray:// tier): when the driver
        # runs on a machine that does not share the agent's /dev/shm, the
        # object data plane rides chunked RPCs instead of shm mappings.
        # Set by connect_driver's hostname probe (or force with
        # address="client://host:port").
        self.remote_data_plane = False
        self.gcs = SyncRpcClient(gcs_address)
        self.agent = SyncRpcClient(agent_address)
        # distributed-GC identity of THIS process + batched ref sync (adds and
        # removes flushed in submission order so an add never overtakes the
        # del of the same id)
        import uuid as _uuid

        self.client_id = f"w:{_uuid.uuid4().hex[:16]}"
        self._ref_ops: List[Tuple[str, str]] = []  # ("add"|"del", oid hex)
        self._ref_lock = threading.Lock()       # guards the op queue
        self._flush_lock = threading.Lock()     # serializes drain+send ordering
        self._ref_flusher: Optional[threading.Thread] = None
        self._ref_stop = threading.Event()
        self._last_holder_hb = 0.0
        # the flusher doubles as the holder-lease heartbeat, so it must run
        # from the first moment this process can hold refs (a driver that
        # only submits tasks — no put() — still holds its task returns;
        # without heartbeats the GCS would reap them after the lease)
        self._start_ref_flusher()
        self._exported_fns: set = set()
        self._workdir_hashes: Dict[str, str] = {}
        self._actor_clients: Dict[str, SyncRpcClient] = {}
        self._actor_cache: Dict[str, Dict[str, Any]] = {}
        self._dispatchers: Dict[str, Any] = {}
        self._agent_clients: Dict[str, SyncRpcClient] = {agent_address: self.agent}
        self._lock = threading.Lock()
        self._bg = concurrent.futures.ThreadPoolExecutor(max_workers=16,
                                                         thread_name_prefix="actor-call")
        # pipelined task submission: outstanding submit-ack futures. remote()
        # only blocks when the window is full; get()/wait() barrier on all
        # acks (the agent pins deps before acking, so the ack is the moment
        # arg refs may be safely dropped — the barrier preserves that
        # guarantee at the first point the caller can observe results).
        from collections import deque

        self._submit_acks: "deque" = deque()
        self._submit_window = 64
        self._submit_lock = threading.Lock()  # user threads may race get()/remote()
        self._shutting_down = False
        # ---- pipelined control plane (ISSUE r06) ----
        from ray_tpu_torch.core.config import inline_max_bytes, pipeline_enabled

        self.pipelined = pipeline_enabled()
        self._inline_max = inline_max_bytes()
        # submission coalescing: specs buffer here and flush as ONE
        # submit_task_batch RPC by size or a ~1 ms window
        self._submit_buf: List[Dict[str, Any]] = []
        self._submit_buf_bytes = 0
        self._submit_event = threading.Event()
        self._submit_flusher: Optional[threading.Thread] = None
        self.submit_batches_sent = 0   # observability + tests
        self.tasks_submitted = 0
        # inline completion cache: results that NEVER touched the arena
        # (actor-call replies under the inline threshold). Entries live until
        # the local ref is released; passing such a ref onward promotes the
        # payload to the agent first (_promote_inline).
        # _seal_cond guards BOTH dicts and wakes get()/wait() on any push.
        self._seal_cond = threading.Condition()
        self._inline_cache: Dict[str, Dict[str, Any]] = {}
        self._inline_promoted: set = set()
        # pushed seal events from the GCS (sealed:{client_id} channel):
        # object located cluster-wide, possibly with an in-band small payload
        self._sealed_events: Dict[str, Dict[str, Any]] = {}
        # return ids of in-flight pipelined actor calls: their completions
        # arrive through the reply/push channel (possibly inline-only, never
        # registered at the GCS), so get() must keep waiting on the channel
        # instead of falling back to the ensure path for them
        self._pending_actor_returns: set = set()
        # return ids of submitted-not-yet-sealed tasks: get() expects pushed
        # completions for these and stays RPC-free while they stream in;
        # ids NOT here (puts, borrowed refs) go straight to the ensure path
        self._pending_task_returns: Dict[str, bool] = {}
        self._actor_pipelines: Dict[str, "_ActorPipeline"] = {}
        # batched actor-call ref pins/unpins: one FIFO thread preserves
        # pin-before-unpin order per task while coalescing into pin_tasks/
        # unpin_tasks RPCs (the lockstep path pays one GCS round trip per
        # call for each)
        self._refop_buf: List[Tuple[str, Dict[str, Any]]] = []
        self._refop_event = threading.Event()
        self._refop_thread: Optional[threading.Thread] = None
        # GCS crash-restart recovery (core/recovery/envelope.py): epoch
        # observation rides the holder-heartbeat ack; the reconnect hook
        # fires the catch-up (sealed-channel poll + ref re-assertion) the
        # moment the client transparently re-dials a restarted GCS
        from ray_tpu_torch.core.recovery import RetryEnvelope

        self._envelope = RetryEnvelope()
        self._recovery_lock = threading.Lock()
        if gcs_recovery_enabled():
            self.gcs.add_reconnect_hook(
                lambda: self._spawn_gcs_recovery("gcs client reconnected"))
        if self.pipelined:
            self._submit_flusher = threading.Thread(
                target=self._submit_flush_loop, daemon=True,
                name=f"submit-flush-{self.client_id[2:10]}")
            self._submit_flusher.start()
            self._refop_thread = threading.Thread(
                target=self._refop_flush_loop, daemon=True,
                name=f"refop-flush-{self.client_id[2:10]}")
            self._refop_thread.start()
            try:
                self.gcs.subscribe(f"sealed:{self.client_id}",
                                   self._on_sealed_event)
            except Exception:  # noqa: BLE001 - pushes are an optimization;
                # get()/wait() fall back to the polling paths without them
                logger.warning("sealed-event subscription failed", exc_info=True)

    # ------------------------------------------------------------- objects
    def _store_admission_call(self, method: str, **params):
        """A store-write RPC against the local agent, retried while the
        store is TRANSIENTLY full. Dep pinning (agent dispatch) makes a
        running task's args unevictable and unspillable for the task's
        whole dispatch, so under pressure every byte of the store can be
        pinned-or-unsealed for a few seconds at a time; a put landing in
        that window must wait the pins out (task completion and the
        busy-requeue path both unpin) instead of failing hard."""
        deadline = time.monotonic() + config.store_full_put_wait_s
        delay = 0.05
        while True:
            try:
                return self.agent.call(method, **params)
            except RpcError as e:
                if e.remote_type != "ObjectStoreFullError":
                    raise
                if time.monotonic() >= deadline:
                    raise exc.ObjectStoreFullError(str(e)) from None
            time.sleep(delay)
            delay = min(delay * 2, 0.5)

    def put(self, value: Any) -> ObjectRef:
        w = global_worker()
        oid = w.next_put_id()
        payload, refs = serialization.pack(value)
        if self.pipelined and refs:
            # refs nested inside the stored value escape this process with
            # the container: materialize any inline-only values first
            self._promote_inline([r.id.hex() for r in refs])
        self._queue_ref_op("add", oid.hex())  # this process holds the new ref
        if len(payload) <= config.max_direct_call_object_size:
            # small object: one round trip (agent writes the shm segment)
            self._store_admission_call(
                "put_object", object_id=oid.hex(), payload=bytes(payload),
                contained=[r.id.hex() for r in refs] or None,
            )
            if self.pipelined and len(payload) <= self._inline_max:
                # the putter already HAS the bytes: cache them so a local
                # get() is a dict lookup, no RPC and no arena read. Marked
                # promoted — the value is sealed in the arena already.
                with self._seal_cond:
                    self._inline_cache[oid.hex()] = {
                        "object_id": oid.hex(), "payload": bytes(payload),
                        "is_error": False,
                        "contained": [r.id.hex() for r in refs] or None,
                    }
                    self._inline_promoted.add(oid.hex())
                    self._seal_cond.notify_all()
                self._evict_inline_overflow()
            return ObjectRef(oid)
        if self.remote_data_plane:
            # CLIENT MODE (reference: ray:// Ray Client proxied data plane):
            # the driver is off-cluster, so large puts stream through the
            # agent's chunked ingest instead of writing shm directly.
            # payload stays a buffer view — per-chunk bytes() bounds the
            # extra copy to one chunk, not the whole object
            self._put_via_rpc(oid, payload,
                              [r.id.hex() for r in refs] or None)
            return ObjectRef(oid)
        resp = self._store_admission_call("create_object",
                                          object_id=oid.hex(),
                                          size=len(payload))
        offset = resp.get("offset") if isinstance(resp, dict) else None
        writer = ShmWriter(oid, len(payload), self.node_hex, offset=offset)
        writer.buffer[:] = payload
        writer.seal()
        self.agent.call(
            "seal_object", object_id=oid.hex(), size=len(payload),
            contained=[r.id.hex() for r in refs] or None,
        )
        return ObjectRef(oid)

    def _put_via_rpc(self, oid: ObjectID, payload,
                     contained: Optional[List[str]]) -> None:
        """Stream a large put into the agent store. Raw plane: chunk
        payloads ride raw frames (memoryview straight to the socket, no
        per-chunk bytes() copy or msgpack encode) with a window of sends in
        flight instead of one serial round trip per chunk; the agent's
        cached-writer ingest seals + registers once every byte lands.
        RTPU_RAW_TRANSFER=0 restores the serial in-band path."""
        from ray_tpu_torch.core.config import raw_transfer_enabled

        size = len(payload)
        view = memoryview(payload)
        chunk = config.fetch_chunk_bytes
        if not raw_transfer_enabled():
            sent = 0
            while True:
                n = min(chunk, size - sent)
                last = sent + n >= size
                self.agent.call(
                    "receive_chunk", object_id=oid.hex(), total_size=size,
                    offset=sent, data=bytes(view[sent:sent + n]),
                    contained=contained if last else None,
                    timeout=120.0,
                )
                sent += n
                if last:
                    return
        from collections import deque

        window = max(1, int(config.transfer_window_chunks))
        inflight: "deque" = deque()

        from ray_tpu_torch.core.node.transfer import attempt_timeout

        def send_async(off: int, attempt: int = 0):
            n = min(chunk, size - off)
            return self.agent.call_raw_send_async(
                "receive_chunk_raw", view[off:off + n],
                timeout=attempt_timeout(attempt),
                object_id=oid.hex(), total_size=size, offset=off,
                contained=contained,
            )

        offsets = list(range(0, size, chunk)) or [0]
        retried: Dict[int, int] = {}
        while offsets or inflight:
            while offsets and len(inflight) < window:
                off = offsets.pop(0)
                inflight.append((off, send_async(off, retried.get(off, 0))))
            off, fut = inflight.popleft()
            try:
                fut.result()
            except TimeoutError:
                # idempotent ingest (deduped by offset): re-send the chunk
                # instead of failing the put on one dropped frame
                retried[off] = retried.get(off, 0) + 1
                if retried[off] > 5:
                    raise
                offsets.insert(0, off)

    def start_log_stream(self) -> None:
        """Subscribe to the cluster's worker-log pubsub channel and mirror
        lines to this driver's stderr (reference: log_to_driver /
        _private/log_monitor.py — workers' prints surface at the driver)."""
        import sys

        def on_logs(msg) -> None:
            try:
                prefix = f"({msg['worker'][:8]} {msg['node']})"
                for line in msg.get("lines") or []:
                    print(f"{prefix} {line}", file=sys.stderr)
            except Exception:  # noqa: BLE001 - a bad frame must not kill pubsub
                pass

        try:
            self.gcs.subscribe("worker_logs", on_logs)
        except Exception:  # noqa: BLE001 - log mirroring is best-effort
            logger.warning("worker-log stream unavailable", exc_info=True)

    def _read_via_rpc(self, oid: ObjectID, size: int) -> bytes:
        from ray_tpu_torch.core.config import raw_transfer_enabled

        if raw_transfer_enabled():
            return self._read_via_raw(oid, size)
        data = bytearray()
        chunk = config.fetch_chunk_bytes
        while len(data) < size:
            try:
                data += self.agent.call(
                    "read_chunk", object_id=oid.hex(), offset=len(data),
                    length=min(chunk, size - len(data)), timeout=120.0,
                )
            except RpcError as e:
                if e.remote_type == "KeyError":
                    # evicted between the metadata reply and this chunk:
                    # surface as the same transient condition the shm path
                    # raises so get()'s re-ensure retry loop handles it
                    raise FileNotFoundError(str(e)) from e
                raise
        return bytes(data)

    def _read_via_raw(self, oid: ObjectID, size: int) -> bytes:
        """Client-mode chunked read over raw frames: payload bytes land
        straight in the destination buffer (no msgpack decode, no per-chunk
        bytes accumulation), with a window of requests in flight. Short
        chunks (chaos truncation) re-request exactly the missing tail."""
        from collections import deque

        buf = bytearray(size)
        mv = memoryview(buf)
        chunk = config.fetch_chunk_bytes
        window = max(1, int(config.transfer_window_chunks))
        work = deque((off, min(chunk, size - off))
                     for off in range(0, size, chunk))
        requeues = 0
        max_requeues = 8 * (len(work) + 1)
        while work:
            batch = []
            while work and len(batch) < window:
                off, n = work.popleft()
                dest = mv[off:off + n]

                def make_sink(d):
                    return lambda meta, nbytes: d[:nbytes] if nbytes else None

                batch.append((off, n, self.agent.call_raw_async(
                    "read_chunk_raw", make_sink(dest), timeout=120.0,
                    object_id=oid.hex(), offset=off, length=n)))
            for off, n, fut in batch:
                try:
                    res = fut.result()
                except RpcError as e:
                    if e.remote_type == "KeyError":
                        raise FileNotFoundError(str(e)) from e
                    raise
                except TimeoutError:
                    res = {"nbytes": 0}
                got = int(res.get("nbytes", 0))
                if got < n:
                    requeues += 1
                    if requeues > max_requeues:
                        raise TimeoutError(
                            f"chunked read of {oid.hex()[:16]} kept losing "
                            f"frames after {requeues} re-requests")
                    work.append((off + got, n - got))
        return bytes(buf)

    def _read_local(self, oid: ObjectID, size: int, is_error: bool,
                    offset: Optional[int] = None) -> Any:
        if self.remote_data_plane:
            value = serialization.unpack(self._read_via_rpc(oid, size),
                                         zero_copy=True)
        else:
            reader = ShmReader(oid, size, self.node_hex, offset=offset)
            try:
                if (offset is not None and not is_error
                        and serialization.pinned_reads_active()
                        and columnar_exchange_enabled()):
                    # Pinned-args fast path (columnar exchange): the caller
                    # is a worker resolving task deps the agent holds
                    # pinned until the task completes, and the object lives
                    # in the arena (whose mapping is process-wide and never
                    # unmapped) — decode over the LIVE mapping so arrow
                    # columns / numpy arrays alias the arena instead of a
                    # heap copy. Post-decode revalidation catches the
                    # evicted-and-recycled race exactly like read_bytes().
                    value = serialization.unpack(
                        reader.buffer.toreadonly(), zero_copy=True)
                    if not reader.revalidate():
                        raise FileNotFoundError(
                            f"arena slot for {oid.hex()[:16]} recycled "
                            f"mid-read")
                else:
                    value = serialization.unpack(reader.read_bytes(),
                                                 zero_copy=True)
            finally:
                reader.close()
        if is_error:
            self._raise_error_value(value)
        return value

    @staticmethod
    def _raise_error_value(err: Any) -> None:
        if isinstance(err, dict) and "__rtpu_error__" in err:
            # cross-language (xlang) error envelope from a non-Python
            # submitter's task (see worker_main._store_error_returns)
            raise exc.TaskError(err.get("__rtpu_error__", "?"),
                                err.get("message", ""))
        if isinstance(err, exc.TaskError):
            raise err.as_instanceof_cause()
        raise err

    def _unpack_payload(self, payload: bytes, is_error: bool) -> Any:
        """Materialize a result from an INLINE payload (actor-call reply or
        pushed seal event) — same semantics as _read_local, no arena."""
        value = serialization.unpack(memoryview(payload), zero_copy=False)
        if is_error:
            self._raise_error_value(value)
        return value

    # ------------------------------------------------- pipelined completions
    def _on_sealed_event(self, msg: Any) -> None:
        """Pushed seals from the GCS (this process holds the objects): one
        frame carries every seal of a registration batch. Record them and
        wake parked get()/wait() ONCE. Runs on the GCS client's loop
        thread — must never block."""
        try:
            events = msg.get("events") or []
            with self._seal_cond:
                for ev in events:
                    h = ev.get("object_id")
                    if not h:
                        continue
                    self._pending_task_returns.pop(h, None)
                    self._sealed_events[h] = ev
                while len(self._sealed_events) > 20000:
                    # events are an optimization: evicting one costs a
                    # fallback RPC, never correctness (the object itself
                    # lives in the arena)
                    self._sealed_events.pop(next(iter(self._sealed_events)))
                self._seal_cond.notify_all()
        except Exception:  # noqa: BLE001 - a bad frame must not kill pubsub
            logger.exception("sealed-event handler failed")

    def _absorb_inline(self, reply: Any) -> None:
        """Cache inline results from an actor-call completion. These values
        exist NOWHERE else (the worker skipped the arena write); they are
        promoted to the agent's store the moment the ref could escape this
        process, or when the cache overflows."""
        inline = (reply or {}).get("inline_returns") or []
        if not inline:
            return
        with self._seal_cond:
            for item in inline:
                self._inline_cache[item["object_id"]] = item
            self._seal_cond.notify_all()
        self._evict_inline_overflow()

    def _evict_inline_overflow(self, cap: int = 8192) -> None:
        """Bound the inline cache: already-promoted entries (puts, passed-on
        results) just drop; inline-only entries are promoted to the agent's
        store first so the value survives eviction."""
        with self._seal_cond:
            extra = len(self._inline_cache) - cap
            if extra <= 0:
                return
            overflow = list(self._inline_cache)[:extra]
            droppable = [h for h in overflow if h in self._inline_promoted]
            to_promote = [h for h in overflow if h not in self._inline_promoted]
            for h in droppable:
                self._inline_cache.pop(h, None)
                self._inline_promoted.discard(h)
        if to_promote:
            try:
                self._promote_inline(to_promote)
            except Exception:  # noqa: BLE001 - entries stay cached; retry later
                logger.exception("inline-cache overflow promotion failed")
            else:
                with self._seal_cond:
                    for h in to_promote:
                        self._inline_cache.pop(h, None)
                        self._inline_promoted.discard(h)

    def _promote_inline(self, ids: Sequence[str]) -> None:
        """Write inline-cached results into the agent's store (idempotent).
        Called before a ref escapes this process (task/actor-call argument,
        nested inside a put) so the cluster can serve the value to anyone
        else who may hold the ref."""
        for h in ids:
            with self._seal_cond:
                ent = self._inline_cache.get(h)
                if ent is None or h in self._inline_promoted:
                    continue
                self._inline_promoted.add(h)
            try:
                self.agent.call(
                    "put_object", object_id=h, payload=ent["payload"],
                    owner=ent.get("owner") or "",
                    is_error=bool(ent.get("is_error")),
                    contained=ent.get("contained"),
                )
            except Exception:
                with self._seal_cond:
                    self._inline_promoted.discard(h)
                raise

    def _drop_cached_result(self, oid_hex: str) -> None:
        with self._seal_cond:
            self._inline_cache.pop(oid_hex, None)
            self._inline_promoted.discard(oid_hex)
            self._sealed_events.pop(oid_hex, None)
            self._pending_task_returns.pop(oid_hex, None)

    # ------------------------------------------------ batched pins/unpins
    def _queue_refop(self, kind: str, payload: Dict[str, Any]) -> None:
        with self._ref_lock:
            self._refop_buf.append((kind, payload))
        self._refop_event.set()

    def _refop_flush_loop(self) -> None:
        while not self._ref_stop.is_set():
            if not self._refop_event.wait(timeout=0.5):
                continue
            self._refop_event.clear()
            time.sleep(config.submit_batch_window_ms / 1000.0)
            try:
                self._flush_refops()
            except Exception:  # noqa: BLE001 - advisory bookkeeping
                logger.exception("actor pin/unpin flush failed")

    def _flush_refops(self) -> None:
        """Drain queued actor-call pins/unpins into batched GCS RPCs,
        preserving order (a task's unpin is enqueued strictly after its pin,
        and consecutive same-kind runs coalesce — same scheme as
        flush_refs)."""
        with self._ref_lock:
            ops, self._refop_buf = self._refop_buf, []
        if not ops:
            return
        i = 0
        while i < len(ops):
            kind = ops[i][0]
            j = i
            while j < len(ops) and ops[j][0] == kind:
                j += 1
            batch = [p for _, p in ops[i:j]]
            self.gcs.call("pin_tasks" if kind == "pin" else "unpin_tasks",
                          **({"pins": batch} if kind == "pin"
                             else {"unpins": batch}))
            i = j

    def _actor_returns_done(self, sd: Dict[str, Any]) -> None:
        """An actor call fully completed (inline absorbed / arena stored /
        error objects materialized): its returns may now resolve through the
        normal fallback paths."""
        returns = sd.get("returns") or []
        if not returns:
            return
        with self._seal_cond:
            self._pending_actor_returns.difference_update(returns)
            self._seal_cond.notify_all()

    def _resolve_cached(self, oid_hex: str, resolved: Dict[str, Any]) -> bool:
        """Serve one id from the inline cache or a pushed payload; raises for
        error results (same contract as the arena read)."""
        with self._seal_cond:
            ent = self._inline_cache.get(oid_hex)
            if ent is None:
                ev = self._sealed_events.get(oid_hex)
                if ev is None or "payload" not in ev:
                    return False
                ent = ev
        resolved[oid_hex] = self._unpack_payload(ent["payload"],
                                                 bool(ent.get("is_error")))
        return True

    def get(self, refs: Sequence[ObjectRef], timeout: Optional[float]) -> List[Any]:
        if not refs:
            return []
        self._barrier_submit_acks()
        blocked = self._notify_blocked(True)
        try:
            deadline = None if timeout is None else time.monotonic() + timeout
            ids = [r.id.hex() for r in refs]
            resolved: Dict[str, Any] = {}
            todo: List[str] = []
            seen: set = set()
            for h in ids:
                if h in seen:
                    continue
                seen.add(h)
                if not (self.pipelined and self._resolve_cached(h, resolved)):
                    todo.append(h)
            if todo and self.pipelined:
                # push phase: completions stream in over the sealed-event
                # channel (and actor-call replies); zero RPCs while they flow
                todo = self._await_pushed(todo, deadline, resolved)
            if todo:
                self._get_via_ensure(todo, deadline, resolved)
            return [resolved[h] for h in ids]
        finally:
            if blocked:
                self._notify_blocked(False)

    def _await_pushed(self, todo: List[str], deadline: Optional[float],
                      resolved: Dict[str, Any]) -> List[str]:
        """Block on pushed completions for ids we EXPECT pushes for — our
        own submitted task returns and in-flight actor calls. Everything
        else (puts, borrowed refs, objects sealed before this process held
        them) never pushes, so it goes straight to the ensure+read path.
        A stall with zero progress also falls back (lost pushes cost
        latency, never correctness — the ensure loop re-checks the inline
        cache, so even inline-only completions landing late are served).
        Returns the ids still needing the ensure+read path."""
        pending = set(todo)
        with self._seal_cond:
            if not any(h in self._pending_task_returns
                       or h in self._pending_actor_returns
                       for h in pending):
                return list(todo)
        last_progress = time.monotonic()
        while pending:
            # one lock acquisition per wake: scan, else wait — a per-id lock
            # dance here measurably starves the (co-located) control plane
            found: List[Tuple[str, bytes, bool]] = []
            give_up = False
            with self._seal_cond:
                while True:
                    for h in list(pending):
                        ent = self._inline_cache.get(h)
                        if ent is None:
                            ev = self._sealed_events.get(h)
                            if ev is None or "payload" not in ev:
                                continue
                            ent = ev
                        found.append((h, ent["payload"],
                                      bool(ent.get("is_error"))))
                        pending.discard(h)
                    if found or not pending:
                        break
                    if all(h in self._sealed_events for h in pending):
                        give_up = True  # all located — read via the agent
                        break
                    if not any(h in self._pending_task_returns
                               or h in self._pending_actor_returns
                               for h in pending):
                        # every remaining completion already landed (or was
                        # never expected): the store has whatever exists
                        give_up = True
                        break
                    now = time.monotonic()
                    if now - last_progress > 3.0 and not any(
                            h in self._pending_actor_returns for h in pending):
                        # stalled: polling path takes over. An in-flight
                        # actor call is not a stall: its result comes in
                        # the call's reply (or its failure stores error
                        # objects), never through the store a poll reads,
                        # so polling would only wait out ensure_local's
                        # 10 s chunk for an inline result (a call of over
                        # 3 s, such as a first import of torch, cost 10 s
                        # more in the JAX package's runtime)
                        give_up = True
                        break
                    remaining = None if deadline is None else deadline - now
                    if remaining is not None and remaining <= 0:
                        give_up = True  # ensure path raises GetTimeoutError
                        break
                    chunk = 0.25 if remaining is None else min(0.25, remaining)
                    self._seal_cond.wait(chunk)
            for h, payload, is_error in found:
                resolved[h] = self._unpack_payload(payload, is_error)
            if found:
                last_progress = time.monotonic()
            if give_up:
                break
        return [h for h in todo if h in pending]

    def _get_via_ensure(self, ids: List[str], deadline: Optional[float],
                        resolved: Dict[str, Any]) -> None:
        # One batched RPC: the agent pulls every object concurrently
        # (reference: plasma batched Get, src/ray/core_worker/
        # store_provider/plasma_store_provider.cc). Issued in bounded
        # chunks and re-sent on RPC timeout (ensure_local is idempotent),
        # so one dropped frame doesn't consume the whole user deadline —
        # and a timeout=None get still survives connection hiccups.
        store_full_retries = 0
        while True:
            if self.pipelined:
                # a pushed completion may land while we poll — and an
                # inline-only actor result NEVER appears in the store, so
                # this re-check is what ultimately serves it here
                ids = [h for h in ids if not self._resolve_cached(h, resolved)]
                if not ids:
                    return
            remaining = None if deadline is None else deadline - time.monotonic()
            if remaining is not None and remaining <= 0:
                raise exc.GetTimeoutError(
                    f"get() timed out waiting for {len(ids)} objects"
                )
            # short chunks: ensure_local can't distinguish "frame
            # dropped" from "object not ready yet", so a small window
            # bounds what one lost frame costs; re-issue is idempotent
            attempt_s = 5.0 if remaining is None else min(remaining, 5.0)
            try:
                infos = self.agent.call(
                    "ensure_local_batch", object_ids=ids,
                    timeout=attempt_s + 5.0, timeout_s=attempt_s,
                )
            except TimeoutError:
                continue
            if any(i.get("error_type") == "TimeoutError" for i in infos) and (
                remaining is None or remaining > attempt_s
            ):
                continue  # per-object timeout but user deadline remains
            if any(i.get("error_type") == "ObjectStoreFullError"
                   for i in infos) and store_full_retries < 40:
                # transient local pressure (a fragmented/pinned-out arena
                # while other pulls are in flight — e.g. a shuffle's reduce
                # outputs landing): pins drop and spill frees space as
                # tasks finish, so back off and re-ensure instead of
                # failing the get
                store_full_retries += 1
                time.sleep(min(1.0, 0.05 * store_full_retries))
                continue
            break
        for h, info in zip(ids, infos):
            if "error" in info:
                if info.get("error_type") == "TimeoutError":
                    raise exc.GetTimeoutError(
                        f"get() timed out waiting for {h[:16]}"
                    )
                if info.get("error_type") == "ObjectStoreFullError":
                    raise exc.ObjectStoreFullError(info["error"])
                raise exc.ObjectLostError(h, info["error"])
            oid = ObjectID.from_hex(h)
            for attempt in range(4):
                try:
                    resolved[h] = self._read_local(oid, info["size"],
                                                   info["is_error"],
                                                   offset=info.get("offset"))
                    break
                except FileNotFoundError:
                    # arena slot evicted between the metadata reply and
                    # the copy (or mid-copy): the object may still live
                    # in spill — re-ensure and retry with fresh metadata
                    if attempt == 3:
                        raise exc.ObjectLostError(
                            h, "evicted repeatedly during read")
                    info = self.agent.call(
                        "ensure_local", object_id=h,
                        timeout_s=10.0, timeout=15.0,
                    )

    def _notify_blocked(self, blocked: bool) -> bool:
        """Within a worker: tell the agent this worker is blocked in get()
        (its CPU lease is released while waiting). Driver: no-op."""
        import os

        worker_id = os.environ.get("RAY_TPU_WORKER_ID")
        if worker_id is None:
            return False
        try:
            self.agent.call(
                "worker_blocked" if blocked else "worker_unblocked", worker_id=worker_id
            )
            return True
        except Exception:  # noqa: BLE001
            return False

    def wait(self, refs, num_returns, timeout, fetch_local):
        self._barrier_submit_acks()
        ids = [r.id.hex() for r in refs]
        deadline = None if timeout is None else time.monotonic() + timeout
        if self.pipelined:
            ready_set = self._wait_pushed(ids, num_returns, deadline)
        else:
            ready_set = self._wait_via_rpc(ids, num_returns, deadline)
        ready, not_ready = [], []
        for r in refs:
            if r.id.hex() in ready_set and len(ready) < num_returns:
                ready.append(r)
            else:
                not_ready.append(r)
        return ready, not_ready

    def _wait_pushed(self, ids: List[str], num_returns: int,
                     deadline: Optional[float]) -> set:
        """Push-driven wait: a remote seal wakes us through the sealed-event
        channel with NO polling; a stall (lost push, or the object sealed
        before this process became a holder) falls back to one bounded
        wait_objects RPC per chunk — latency cost only, never correctness."""
        needed = min(num_returns, len(ids))
        ready: set = set()

        def _scan() -> None:
            for h in ids:
                if h in self._inline_cache or h in self._sealed_events:
                    ready.add(h)

        while True:
            with self._seal_cond:
                _scan()
                if len(ready) >= needed:
                    return ready
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return ready
                chunk = 0.5 if remaining is None else min(0.5, remaining)
                self._seal_cond.wait(chunk)
                progressed = len(ready) < needed and any(
                    h in self._inline_cache or h in self._sealed_events
                    for h in ids if h not in ready
                )
            if progressed:
                continue  # pushes are resolving OUR ids: stay RPC-free
            with self._seal_cond:
                replies_due = all(h in self._pending_actor_returns
                                  for h in ids if h not in ready)
            if replies_due:
                # in-flight actor calls: their results come in the calls'
                # replies, which the RPC below (reading the store) would
                # only wait out for its full chunk
                continue
            # no progress this chunk (lost push, or the object sealed before
            # this process became a holder): one bounded wait_objects RPC —
            # itself event-driven at the GCS, so this is a safety net, not a
            # hot poll
            pending = [h for h in ids if h not in ready]
            remaining = None if deadline is None else deadline - time.monotonic()
            attempt_s = 2.0 if remaining is None else max(0.0, min(remaining, 2.0))
            try:
                ready.update(self.agent.call(
                    "wait_objects", object_ids=pending,
                    num_returns=needed - len(ready),
                    timeout=attempt_s + 10.0, timeout_s=attempt_s,
                ))
            except TimeoutError:
                pass
            if len(ready) >= needed:
                return ready
            if remaining is not None and remaining <= attempt_s:
                return ready

    def _wait_via_rpc(self, ids: List[str], num_returns: int,
                      deadline: Optional[float]) -> set:
        # bounded chunks, like get(): one infinite RPC would hang forever if
        # its response frame is lost (agent restart, connection blip) — a
        # re-sent wait is idempotent
        while True:
            remaining = None if deadline is None else deadline - time.monotonic()
            attempt_s = 10.0 if remaining is None else max(0.0, min(remaining, 10.0))
            try:
                ready_ids = self.agent.call(
                    "wait_objects", object_ids=ids, num_returns=num_returns,
                    timeout=attempt_s + 10.0, timeout_s=attempt_s,
                )
            except TimeoutError:
                if remaining is not None and remaining <= attempt_s:
                    ready_ids = []
                    break
                continue
            if len(ready_ids) >= min(num_returns, len(ids)):
                break
            if remaining is not None and remaining <= attempt_s:
                break
        return (set(ready_ids[:num_returns]) if len(ready_ids) > num_returns
                else set(ready_ids))

    def free(self, refs: Sequence[ObjectRef]) -> None:
        for r in refs:
            self._drop_cached_result(r.id.hex())
        self.agent.call("free_objects", object_ids=[r.id.hex() for r in refs])

    def object_sizes(self, refs: Sequence[ObjectRef]) -> List[Optional[int]]:
        try:
            return self.agent.call(
                "object_sizes", object_ids=[r.id.hex() for r in refs]
            )
        except Exception:  # noqa: BLE001 - best-effort (backpressure hint)
            return [None] * len(refs)

    # ------------------------------------------------- streaming generators
    def stream_next(self, task_hex: str, index: int, timeout: Optional[float]):
        """Long-poll the GCS stream directory in bounded chunks (same pattern
        as get(): a dropped frame costs one chunk, not the whole deadline)."""
        self._barrier_submit_acks()  # a dropped submit must raise, not hang
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            remaining = None if deadline is None else deadline - time.monotonic()
            if remaining is not None and remaining <= 0:
                raise exc.GetTimeoutError(
                    f"stream item {index} of {task_hex[:16]} not ready in {timeout}s"
                )
            attempt_s = 5.0 if remaining is None else min(remaining, 5.0)
            try:
                resp = self.gcs.call(
                    "stream_next", task_id=task_hex, index=index,
                    timeout=attempt_s + 5.0, timeout_s=attempt_s,
                )
            except TimeoutError:
                continue
            if resp.get("timeout"):
                continue
            if "end" in resp:
                return ("end", resp["end"])
            return ("item", resp["object_id"])

    def stream_close(self, task_hex: str) -> None:
        try:
            self.gcs.call("stream_close", task_id=task_hex)
        except Exception:  # noqa: BLE001 - teardown path
            pass

    # ------------------------------------------------- distributed ref counts
    def _start_ref_flusher(self) -> None:
        with self._ref_lock:
            if self._ref_flusher is None:
                self._ref_flusher = threading.Thread(
                    target=self._ref_flush_loop, daemon=True,
                    name=f"ref-sync-{self.client_id[2:10]}",
                )
                self._ref_flusher.start()

    def _queue_ref_op(self, op: str, oid_hex: str) -> None:
        with self._ref_lock:
            self._ref_ops.append((op, oid_hex))

    def _ref_flush_loop(self) -> None:
        while not self._ref_stop.wait(config.ref_sync_interval_s):
            try:
                self.flush_refs()
                # renew the holder lease so a crashed process (no shutdown,
                # no heartbeats) gets its holders reaped by the GCS
                now = time.monotonic()
                if now - self._last_holder_hb > min(2.5, config.object_holder_lease_s / 4):
                    self._last_holder_hb = now
                    ack = self.gcs.call("holder_heartbeat",
                                        holder=self.client_id)
                    epoch = ack.get("epoch") if isinstance(ack, dict) else None
                    if self._envelope.observe_epoch(epoch) \
                            and gcs_recovery_enabled():
                        self._spawn_gcs_recovery(
                            f"gcs epoch bumped to {epoch}")
            except Exception:  # noqa: BLE001 - sync is advisory; retry next tick
                pass

    def flush_refs(self) -> None:
        """Drain queued add/del holder updates to the GCS, preserving order.
        Workers call this before completing a task so borrows registered
        during execution land while the task pin still protects them.
        The flush lock spans drain+send: two threads draining and sending
        unserialized could land an add before the del it followed."""
        with self._flush_lock:
            with self._ref_lock:
                ops, self._ref_ops = self._ref_ops, []
            if not ops:
                return
            # coalesce consecutive same-op runs into batched RPCs, keeping order
            i = 0
            while i < len(ops):
                op = ops[i][0]
                j = i
                while j < len(ops) and ops[j][0] == op:
                    j += 1
                ids = [o for _, o in ops[i:j]]
                self.gcs.call(
                    "add_object_refs" if op == "add" else "remove_object_refs",
                    object_ids=ids, holder=self.client_id,
                )
                i = j

    # ----------------------------------------- GCS crash-restart catch-up
    def _spawn_gcs_recovery(self, reason: str) -> None:
        """Run the post-restart catch-up off-thread (the trigger sites — the
        rpc client's reconnect hook and the ref flusher — must not block)."""
        if self._shutting_down:
            return
        threading.Thread(target=self._gcs_restart_catchup, args=(reason,),
                         daemon=True,
                         name=f"gcs-catchup-{self.client_id[2:10]}").start()

    def _gcs_restart_catchup(self, reason: str) -> None:
        """Close the two gaps a GCS restart opens for THIS process:

        - pushed ``sealed:`` events that fired while we were disconnected
          are gone (the channel is re-subscribed, but pushes are not
          replayed) — one catch-up ``wait_objects_located`` poll synthesizes
          payload-less seal events for every pending return that already has
          a location, unparking ``get()``/``wait()`` onto the ensure path;
        - holder refs added after the last snapshot are missing from the
          restored state — re-assert every id this process still holds so
          the new incarnation's GC can't reap live objects.
        """
        if not self._recovery_lock.acquire(blocking=False):
            return  # one catch-up at a time; the next epoch bump re-triggers
        try:
            logger.info("GCS restart catch-up (%s)", reason)
            w = global_worker()
            if w is not None:
                held = w.ref_counter.live_ids()
                for i in range(0, len(held), 500):
                    self.gcs.call("add_object_refs",
                                  object_ids=held[i:i + 500],
                                  holder=self.client_id)
            with self._seal_cond:
                pending = [h for h in list(self._pending_task_returns)
                           if h not in self._sealed_events]
            if pending:
                located = self.gcs.call(
                    "wait_objects_located", object_ids=pending,
                    num_returns=len(pending), timeout_s=0.0)
                with self._seal_cond:
                    for h in located or []:
                        # payload-less synthetic event: get() stops waiting
                        # for a push that already happened and reads the
                        # object through the ensure path instead
                        self._pending_task_returns.pop(h, None)
                        self._sealed_events.setdefault(h, {"object_id": h})
                    self._seal_cond.notify_all()
        except Exception:  # noqa: BLE001 - catch-up is best-effort; the
            # polling fallbacks (ensure path, holder lease renewal) converge
            logger.exception("GCS restart catch-up failed")
        finally:
            self._recovery_lock.release()

    def on_borrowed_ref(self, ref: ObjectRef) -> None:
        """Deserializer hook: an ObjectRef materialized out of another object
        — register this process as a holder (reference_count.h borrow)."""
        self._queue_ref_op("add", ref.id.hex())

    def release(self, oid: ObjectID) -> None:
        """Local refcount hit zero: withdraw this process's cluster holder.
        The GCS frees the object everywhere once ALL holders (other
        processes, in-flight task pins) are gone plus a grace window."""
        self._drop_cached_result(oid.hex())
        self._queue_ref_op("del", oid.hex())

    # --------------------------------------------------------------- tasks
    def _export_function(self, function_id: str, fn: Any) -> None:
        if function_id in self._exported_fns:
            return
        if self.gcs.call("kv_get", key=f"fn:{function_id}") is None:
            self.gcs.call("kv_put", key=f"fn:{function_id}", value=cloudpickle.dumps(fn))
        self._exported_fns.add(function_id)

    def _prepare_runtime_env(self, runtime_env: Optional[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
        """Validate + canonicalize; package and upload working_dir to GCS KV
        once per content hash (agents stage it on demand)."""
        from ray_tpu_torch.core import runtime_env as re_mod

        env = re_mod.normalize(runtime_env)
        internal = {k: v for k, v in (runtime_env or {}).items()
                    if k.startswith("__")}
        if not env:
            return internal or None
        def upload_once(cache_key, packager, path: str) -> str:
            # package once per path per driver (contents are snapshotted at
            # first use, like the reference's URI cache) — re-zipping a
            # large tree on EVERY submit would dominate submit latency
            content_hash = self._workdir_hashes.get(cache_key)
            if content_hash is None:
                content_hash, payload = packager(path)
                key = re_mod.kv_key(content_hash)
                if self.gcs.call("kv_get", key=key) is None:
                    self.gcs.call("kv_put", key=key, value=payload)
                self._workdir_hashes[cache_key] = content_hash
            return content_hash

        if "working_dir" in env:
            path = os.path.abspath(env.pop("working_dir"))
            env["working_dir_hash"] = upload_once(
                path, re_mod.package_working_dir, path)
        if "py_modules" in env:
            env["py_modules_hashes"] = [
                upload_once(("pymod", os.path.abspath(p)),
                            re_mod.package_py_module, os.path.abspath(p))
                for p in env.pop("py_modules")
            ]
        return {**env, **internal}

    def _spec_dict(self, spec: TaskSpec, args: tuple, kwargs: dict) -> Dict[str, Any]:
        payload, _refs = serialization.pack((args, kwargs))
        if self.pipelined:
            # any argument ref whose value lives only in this process's
            # inline cache must be materialized in the cluster before anyone
            # else tries to resolve it (top-level deps AND nested refs)
            self._promote_inline(
                [d.hex() for d in spec.dependencies()]
                + [r.id.hex() for r in _refs])
        sd = {
            "runtime_env": self._prepare_runtime_env(spec.runtime_env),
            "task_id": spec.task_id.binary().hex(),
            "name": spec.name,
            "function_id": spec.function.function_id,
            "args_payload": payload,
            "deps": [d.hex() for d in spec.dependencies()],
            "returns": [r.hex() for r in spec.return_ids()],
            "resources": dict(spec.resources),
            "strategy": strategy_to_dict(spec.strategy),
            "max_retries": spec.max_retries,
            "retry_exceptions": spec.retry_exceptions,
        }
        if spec.generator:
            sd["streaming"] = True
            sd["backpressure"] = spec.generator_backpressure
        return sd

    def submit_task(self, spec: TaskSpec, func: Any, args: tuple, kwargs: dict) -> List[ObjectRef]:
        self._export_function(spec.function.function_id, func)
        sd = self._spec_dict(spec, args, kwargs)
        # the agent registers this holder on the returns (and pins deps under
        # a task holder) BEFORE accepting — see agent.rpc_submit_task
        sd["holder"] = self.client_id
        self.tasks_submitted += 1
        if self.pipelined:
            if not spec.generator:
                # expected pushed completions: get() stays on the channel
                # for these instead of polling the agent
                with self._seal_cond:
                    for r in sd["returns"]:
                        self._pending_task_returns[r] = True
                    while len(self._pending_task_returns) > 200000:
                        self._pending_task_returns.pop(
                            next(iter(self._pending_task_returns)))
            # coalescing buffer: specs flush as ONE submit_task_batch RPC by
            # size or the ~1 ms window (the flusher thread)
            self._enqueue_submit(sd)
        else:
            with self._submit_lock:
                self._submit_acks.append(self.agent.call_async("submit_task", spec=sd))
        self._reap_submit_acks()
        if spec.generator:
            # dynamic returns: item holders are registered at stream_put time;
            # materializing refs here would add-then-del the submitter holder
            # on item 0 and free it before the consumer ever sees it
            return []
        return [ObjectRef(oid) for oid in spec.return_ids()]

    def _enqueue_submit(self, sd: Dict[str, Any]) -> None:
        with self._submit_lock:
            self._submit_buf.append(sd)
            self._submit_buf_bytes += len(sd.get("args_payload") or b"")
            full = (len(self._submit_buf) >= config.submit_batch_max
                    or self._submit_buf_bytes >= config.submit_batch_max_bytes)
        if full:
            self._flush_submits()
        else:
            self._submit_event.set()  # arm the window timer

    def _flush_submits(self) -> None:
        with self._submit_lock:
            batch, self._submit_buf = self._submit_buf, []
            self._submit_buf_bytes = 0
            if not batch:
                return
            self._submit_acks.append(
                self.agent.call_async("submit_task_batch", specs=batch))
            self.submit_batches_sent += 1

    def _submit_flush_loop(self) -> None:
        """Window timer: a partial batch flushes ~submit_batch_window_ms
        after the first spec buffered (size-triggered flushes happen inline
        on the submitting thread)."""
        while not self._ref_stop.is_set():
            if not self._submit_event.wait(timeout=0.5):
                continue
            self._submit_event.clear()
            time.sleep(config.submit_batch_window_ms / 1000.0)
            try:
                self._flush_submits()
            except Exception:  # noqa: BLE001 - flusher must survive; the
                # barrier path re-flushes and surfaces errors to the caller
                logger.exception("submit batch flush failed")

    def _pop_ack(self, only_done: bool) -> Optional[Any]:
        with self._submit_lock:
            acks = self._submit_acks
            if not acks:
                return None
            if only_done and not (acks[0].done() or len(acks) > self._submit_window):
                return None
            return acks.popleft()

    def _reap_submit_acks(self) -> None:
        """Harvest completed submit acks; block only when the pipeline
        window is full (keeps many submits in flight instead of one round
        trip per .remote() call)."""
        while True:
            fut = self._pop_ack(only_done=True)
            if fut is None:
                return
            fut.result()  # surfaces submit failures

    def _barrier_submit_acks(self) -> None:
        """Wait for every in-flight submit to be accepted (and its deps
        pinned). Called before get()/wait() so a dropped submit surfaces as
        an exception instead of a hang."""
        if self.pipelined:
            self._flush_submits()  # buffered specs must join the barrier
        while True:
            fut = self._pop_ack(only_done=False)
            if fut is None:
                return
            fut.result()

    def cancel(self, ref: ObjectRef, force: bool, recursive: bool) -> None:
        logger.warning("cancel() is not yet supported on the cluster backend")

    # -------------------------------------------------------------- actors
    def create_actor(self, spec: TaskSpec, cls: Any, args: tuple, kwargs: dict) -> ActorID:
        self._export_function(spec.function.function_id, cls)
        name = (spec.runtime_env or {}).get("__actor_name__", "")
        ns = (spec.runtime_env or {}).get("__actor_namespace__", self.namespace)
        sd = self._spec_dict(spec, args, kwargs)
        sd.update(
            actor_id=spec.actor_id.hex(),
            max_concurrency=spec.max_concurrency,
            max_restarts=spec.max_restarts,
        )
        self._actor_cache[spec.actor_id.hex()] = {
            "max_task_retries": spec.max_task_retries,
            "max_concurrency": spec.max_concurrency,
        }
        # The GCS owns actor scheduling AND restart (GcsActorScheduler
        # equivalent); one call registers + schedules. The envelope parks
        # the call across a GCS outage (create_actor dedupes by actor_id at
        # the GCS, so the re-send after a restart is harmless).
        self._envelope.send(
            self.gcs,
            "create_actor",
            spec=sd,
            class_name=spec.name.split(".")[0],
            name=name,
            namespace=ns,
            max_restarts=spec.max_restarts,
            options=cloudpickle.dumps({
                "options": {
                    "max_task_retries": spec.max_task_retries,
                    "max_concurrency": spec.max_concurrency,
                },
            }),
        )
        return spec.actor_id

    def _resolve_actor(self, actor_hex: str, timeout: float = 60.0) -> Dict[str, Any]:
        deadline = time.monotonic() + timeout
        while True:
            rec = self.gcs.call("get_actor", actor_id=actor_hex)
            if rec is None:
                raise exc.ActorDiedError(actor_hex, "unknown actor")
            if rec["state"] == "ALIVE":
                return rec
            if rec["state"] == "DEAD":
                raise exc.ActorDiedError(actor_hex, rec.get("death_reason") or "actor is dead")
            if time.monotonic() > deadline:
                raise exc.ActorUnavailableError(
                    f"actor {actor_hex[:8]} still {rec['state']} after {timeout}s"
                )
            time.sleep(0.02)

    def _actor_client(self, address: str) -> SyncRpcClient:
        with self._lock:
            if self._shutting_down:
                # a racing push must not mint a client that shutdown()'s
                # close sweep has already passed by (it would wait on a
                # dead cluster with no one left to fail its futures)
                raise RpcConnectionError("runtime is shut down")
            client = self._actor_clients.get(address)
            if client is None:
                client = SyncRpcClient(address)
                self._actor_clients[address] = client
            return client

    def submit_actor_task(self, actor_id: ActorID, spec: TaskSpec, args, kwargs) -> List[ObjectRef]:
        refs = [] if spec.generator else [ObjectRef(oid) for oid in spec.return_ids()]
        sd = self._spec_dict(spec, args, kwargs)
        if spec.generator:
            sd["holder"] = self.client_id
        # pin deps+returns for the in-flight call (released when the call
        # completes) and register this process's holder on the returns.
        # Client-scoped pin id: reaped with this process's holder lease if we
        # crash before removal.
        sd["task_holder"] = f"task:{sd['task_id']}@{self.client_id}"
        pin_kwargs = dict(task_holder=sd["task_holder"], deps=sd["deps"],
                          returns=sd["returns"], submitter=self.client_id,
                          spec=None)
        sd.update(actor_id=actor_id.hex(), method=spec.actor_method_name)
        rec = self._actor_cache.get(actor_id.hex())
        if rec is None:
            rec = {}
            raw = self.gcs.call("get_actor_spec", actor_id=actor_id.hex())
            if raw:
                try:
                    rec = cloudpickle.loads(raw).get("options", {})
                except Exception:  # noqa: BLE001
                    rec = {}
            self._actor_cache[actor_id.hex()] = rec
        if self.pipelined:
            # windowed pipelining: the pin rides the batched refop channel
            # (FIFO — the completion's unpin is enqueued after it and can
            # never overtake it), results at most the inline threshold ride
            # back IN the completion reply, and many calls stay in flight
            # per actor (seq-ordered on the worker side).
            if not spec.generator:
                sd["inline_max"] = self._inline_max
                with self._seal_cond:
                    self._pending_actor_returns.update(sd["returns"])
            self._queue_refop("pin", pin_kwargs)
            self._actor_pipeline(actor_id.hex()).submit(
                sd, spec.max_task_retries,
                ordered=rec.get("max_concurrency", 1) <= 1)
            return refs
        try:
            self.gcs.call("pin_task", **pin_kwargs)
        except Exception:  # noqa: BLE001 - advisory bookkeeping
            logger.exception("actor-task ref pinning failed")
        if rec.get("max_concurrency", 1) > 1:
            # threaded/async actors: unordered concurrent pushes (reference
            # semantics: ordering is only guaranteed for max_concurrency=1)
            self._bg.submit(self._push_actor_task, actor_id.hex(), sd, spec.max_task_retries)
        else:
            # ordered: one dispatcher thread per actor preserves submission
            # order end-to-end (ActorSchedulingQueue equivalent)
            self._actor_dispatcher(actor_id.hex()).put((sd, spec.max_task_retries))
        return refs

    def _actor_pipeline(self, actor_hex: str) -> "_ActorPipeline":
        with self._lock:
            if self._shutting_down:
                raise RpcConnectionError("runtime is shut down")
            p = self._actor_pipelines.get(actor_hex)
            if p is None:
                p = _ActorPipeline(self, actor_hex)
                self._actor_pipelines[actor_hex] = p
            return p

    def _actor_dispatcher(self, actor_hex: str):
        import queue as _q

        with self._lock:
            disp = self._dispatchers.get(actor_hex)
            if disp is None:
                disp = _q.Queue()
                self._dispatchers[actor_hex] = disp

                def loop() -> None:
                    while True:
                        item = disp.get()
                        if item is None:
                            return
                        sd, retries = item
                        try:
                            self._push_actor_task(actor_hex, sd, retries)
                        except Exception:  # noqa: BLE001
                            logger.exception("actor dispatch failed")

                threading.Thread(
                    target=loop, daemon=True, name=f"actor-dispatch-{actor_hex[:8]}"
                ).start()
            return disp

    def _push_actor_task(self, actor_hex: str, sd: Dict[str, Any], max_task_retries: int) -> None:
        try:
            self._push_actor_task_inner(actor_hex, sd, max_task_retries)
        finally:
            holder = sd.get("task_holder")
            if holder:
                try:
                    self.gcs.call(
                        "remove_object_refs",
                        object_ids=(sd.get("deps") or []) + (sd.get("returns") or []),
                        holder=holder,
                    )
                except Exception:  # noqa: BLE001
                    pass

    def _push_actor_task_inner(self, actor_hex: str, sd: Dict[str, Any], max_task_retries: int) -> None:
        attempts = 0
        while True:
            try:
                rec = self._resolve_actor(actor_hex)
                client = self._actor_client(rec["address"])
                while True:
                    try:
                        client.call("run_actor_task", spec=sd,
                                    caller=self.client_id,
                                    timeout=config.actor_call_deadline_s)
                        return
                    except TimeoutError:
                        # Deadline expired: never wedge this dispatcher on a
                        # hung worker (the old timeout=None did exactly that).
                        # Probe liveness — an alive worker means the call is
                        # merely long-running: re-attach (the worker dedupes
                        # by task_id and piggybacks the running execution). A
                        # dead worker fails the ping, which lands in the
                        # retry handler below.
                        client.call("ping", timeout=5.0)
                        logger.warning(
                            "actor call %s exceeded %.0fs; worker alive, "
                            "re-attaching", sd.get("name"),
                            config.actor_call_deadline_s)
            except (exc.ActorDiedError, exc.ActorUnavailableError) as e:
                self._store_error_objects(sd, str(e), "ActorDiedError")
                return
            except (ConnectionError, RpcError, TimeoutError) as e:
                # worker died mid-call or address stale
                attempts += 1
                if isinstance(e, RpcError) and e.remote_type not in (
                    "ConnectionError", "RpcConnectionError", "ActorDiedError",
                ):
                    # handler-level error: results already stored as errors
                    return
                if attempts > max(max_task_retries, 0):
                    self._store_error_objects(
                        sd, f"actor call failed after {attempts} attempts: {e}",
                        "ActorDiedError" if isinstance(e, RpcError) else "ActorUnavailableError",
                    )
                    return
                time.sleep(0.1 * attempts)

    def _store_error_objects(self, sd: Dict[str, Any], message: str, error_type: str) -> None:
        try:
            self.agent.call(
                "store_error", returns=sd["returns"], name=sd.get("name", "?"),
                message=message, error_type=error_type,
            )
        except Exception:  # noqa: BLE001
            logger.exception("failed to store error objects")

    def kill_actor(self, actor_id: ActorID, no_restart: bool) -> None:
        actor_hex = actor_id.hex()
        rec = self.gcs.call("get_actor", actor_id=actor_hex)
        self.gcs.call("kill_actor", actor_id=actor_hex, no_restart=no_restart)
        if rec and rec.get("node_id"):
            agent_addr = self._agent_addr_for(rec["node_id"])
            if agent_addr:
                try:
                    self._agent_client(agent_addr).call("kill_actor_worker", actor_id=actor_hex)
                except Exception:  # noqa: BLE001
                    pass
        self._actor_cache.pop(actor_hex, None)

    def _agent_addr_for(self, node_hex: str) -> Optional[str]:
        for info in self.gcs.call("get_nodes"):
            if info["NodeID"] == node_hex:
                return info["NodeManagerAddress"]
        return None

    def _agent_client(self, address: str) -> SyncRpcClient:
        with self._lock:
            client = self._agent_clients.get(address)
            if client is None:
                client = SyncRpcClient(address)
                self._agent_clients[address] = client
            return client

    def get_named_actor(self, name: str, namespace: Optional[str]) -> ActorID:
        actor_hex = self.gcs.call(
            "get_named_actor", name=name, namespace=namespace or self.namespace
        )
        if actor_hex is None:
            raise ValueError(f"Failed to look up actor '{name}'")
        return ActorID.from_hex(actor_hex)

    def list_named_actors(self, all_namespaces: bool = False, namespace: str = "default") -> List[str]:
        return self.gcs.call(
            "list_named_actors", all_namespaces=all_namespaces, namespace=namespace
        )

    # ------------------------------------------------------ placement groups
    def create_placement_group(self, bundles, strategy: str, name: str) -> PlacementGroupID:
        w = global_worker()
        pg_id = PlacementGroupID.of(w.job_id)
        # creation always succeeds; an unplaceable group stays PENDING at the
        # GCS, feeding the autoscaler's demand ledger until capacity arrives
        # (reference: GcsPlacementGroupManager pending queue)
        self.gcs.call(
            "create_placement_group",
            pg_id=pg_id.hex(), bundles=bundles, strategy=strategy, name=name,
        )
        return pg_id

    def remove_placement_group(self, pg_id: PlacementGroupID) -> None:
        self.gcs.call("remove_placement_group", pg_id=pg_id.hex())

    def placement_group_ready(self, pg_id: PlacementGroupID, timeout) -> bool:
        info = self.gcs.call("placement_group_info", pg_id=pg_id.hex())
        return info is not None and info.get("state") == "CREATED"

    def placement_group_table(self) -> Dict[str, Dict]:
        return self.gcs.call("placement_group_table")

    # --------------------------------------------------------------- cluster
    def nodes(self) -> List[Dict[str, Any]]:
        return self.gcs.call("get_nodes")

    def cluster_resources(self) -> Dict[str, float]:
        return self.gcs.call("cluster_resources")

    def available_resources(self) -> Dict[str, float]:
        return self.gcs.call("available_resources")

    def shutdown(self) -> None:
        self._ref_stop.set()
        self._submit_event.set()  # wake the flusher so it observes the stop
        with self._lock:
            self._shutting_down = True
            pipelines = list(self._actor_pipelines.values())
        for p in pipelines:
            p.stop()
        try:
            self._barrier_submit_acks()
        except Exception:  # noqa: BLE001
            pass
        try:
            self._flush_refops()
            self.flush_refs()
            self.gcs.call("drop_holder", holder=self.client_id)
        except Exception:  # noqa: BLE001
            pass
        for client in list(self._actor_clients.values()) + list(self._agent_clients.values()):
            if client is not self.agent:
                client.close()
        self._bg.shutdown(wait=False)
        self.agent.close()
        self.gcs.close()

    # -------------------------------------------------------------------- kv
    def kv_put(self, key: str, value: bytes) -> None:
        self.gcs.call("kv_put", key=key, value=value)

    def kv_get(self, key: str) -> Optional[bytes]:
        return self.gcs.call("kv_get", key=key)

    def kv_del(self, key: str) -> None:
        self.gcs.call("kv_del", key=key)

    def kv_keys(self, prefix: str = "") -> List[str]:
        return self.gcs.call("kv_keys", prefix=prefix)


class _ActorPipeline:
    """Windowed, seq-numbered pushes to ONE actor over the worker's
    persistent connection (reference: transport/actor_task_submitter.h —
    many calls in flight, out-of-order completion, per-actor order preserved
    by the worker's seq gate; the old design held ONE blocking call per
    dispatcher thread with an infinite deadline).

    Flow: user threads enqueue; the dispatcher thread resolves the actor,
    stamps a seq (ordered actors), and fires call_async bounded by the
    window semaphore. Completions land on the RPC client's loop thread and
    are immediately handed to the runtime's background pool (absorb inline
    results, release pins, or route failures back through this queue).
    Deadline expiries probe worker liveness: alive workers mean a merely
    long-running call (re-attach; the worker dedupes by task_id), dead ones
    route through the retry path — a hung worker can no longer wedge the
    dispatcher forever."""

    def __init__(self, runtime: "ClusterRuntime", actor_hex: str):
        import queue as _q

        self.rt = runtime
        self.actor_hex = actor_hex
        self.q: "_q.Queue" = _q.Queue()
        self.window = threading.Semaphore(max(1, int(config.actor_call_window)))
        self._seq = 0
        self._seq_lock = threading.Lock()
        self._client: Optional[SyncRpcClient] = None  # cached route
        self.calls_pushed = 0  # observability
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name=f"actor-pipe-{actor_hex[:8]}")
        self._thread.start()

    def submit(self, sd: Dict[str, Any], retries: int,
               ordered: bool = True) -> None:
        if ordered:
            with self._seq_lock:
                sd["seq"] = self._seq
                self._seq += 1
        self.q.put(("dispatch", sd, retries, 0))

    def stop(self) -> None:
        self.q.put(None)

    def _loop(self) -> None:
        while True:
            item = self.q.get()
            if item is None:
                return
            kind, sd, retries, attempts = item
            try:
                if kind == "probe":
                    self._probe(sd, retries, attempts)
                else:
                    self._dispatch(sd, retries, attempts)
            except Exception:  # noqa: BLE001 - the pipeline must survive
                logger.exception("actor pipeline dispatch failed")
                self._finish(sd)

    def _get_client(self) -> SyncRpcClient:
        """Resolve-once routing: the worker address is cached so steady-state
        dispatch costs ZERO control RPCs (one get_actor per call serialized
        the old dispatcher); any failure invalidates the cache and the retry
        re-resolves (actor restarts land on the new address)."""
        if self._client is None:
            rec = self.rt._resolve_actor(self.actor_hex)
            self._client = self.rt._actor_client(rec["address"])
        return self._client

    # ------------------------------------------------------------- dispatch
    def _dispatch(self, sd: Dict[str, Any], retries: int, attempts: int) -> None:
        rt = self.rt
        try:
            client = self._get_client()
        except (exc.ActorDiedError, exc.ActorUnavailableError) as e:
            self._fail(sd, str(e), "ActorDiedError")
            return
        except (ConnectionError, RpcError, TimeoutError) as e:
            self._retry_or_fail(sd, retries, attempts + 1, e)
            return
        self.window.acquire()  # backpressure: at most `window` in flight
        try:
            fut = client.call_async(
                "run_actor_task", spec=sd, seq=sd.get("seq"),
                caller=rt.client_id, timeout=config.actor_call_deadline_s)
        except Exception as e:  # noqa: BLE001 - client closed under us
            self.window.release()
            self._client = None
            self._retry_or_fail(sd, retries, attempts + 1, e)
            return
        self.calls_pushed += 1
        fut.add_done_callback(
            lambda f: self._on_done(f, sd, retries, attempts))

    def _on_done(self, fut: Any, sd: Dict[str, Any], retries: int,
                 attempts: int) -> None:
        # runs on the RPC client's event-loop thread: release the window
        # first; the success path is non-blocking (cache writes + queued
        # unpin), failures go to the background pool (they may sleep/RPC)
        self.window.release()
        try:
            reply = fut.result()
        except BaseException as e:  # noqa: BLE001
            self._submit_bg(self._handle_failure, sd, retries, attempts, e)
            return
        try:
            self.rt._absorb_inline(reply)
        except Exception:  # noqa: BLE001
            logger.exception("inline absorb failed")
        self._finish(sd)

    def _submit_bg(self, fn, *args) -> None:
        try:
            self.rt._bg.submit(fn, *args)
        except RuntimeError:  # pool shut down mid-flight
            pass

    # ------------------------------------------------------------ failures
    def _handle_failure(self, sd: Dict[str, Any], retries: int, attempts: int,
                        e: BaseException) -> None:
        if isinstance(e, TimeoutError):
            # deadline expired with the connection healthy: probe liveness
            # on the dispatcher before deciding (long-running user methods
            # are legitimate and must survive)
            self.q.put(("probe", sd, retries, attempts))
            return
        if isinstance(e, RpcError) and e.remote_type not in (
            "ConnectionError", "RpcConnectionError", "ActorDiedError",
        ):
            # handler-level error: results already stored as error objects
            self._finish(sd)
            return
        self._client = None  # route may be stale (worker died/restarted)
        self._retry_or_fail(sd, retries, attempts + 1, e)

    def _probe(self, sd: Dict[str, Any], retries: int, attempts: int) -> None:
        try:
            self._get_client().call("ping", timeout=5.0)
        except Exception as e:  # noqa: BLE001 - dead/unreachable worker
            self._client = None
            self._retry_or_fail(sd, retries, attempts + 1, e)
            return
        logger.warning(
            "actor call %s exceeded %.0fs; worker alive, re-attaching",
            sd.get("name"), config.actor_call_deadline_s)
        # no attempt consumed: the call is running, we merely re-attach
        # (the worker piggybacks the duplicate push on the live execution)
        self.q.put(("dispatch", sd, retries, attempts))

    def _retry_or_fail(self, sd: Dict[str, Any], retries: int, attempts: int,
                       e: BaseException) -> None:
        if attempts > max(retries, 0):
            self._fail(
                sd,
                f"actor call failed after {attempts} attempts: {e}",
                "ActorDiedError" if isinstance(e, RpcError)
                else "ActorUnavailableError")
            return
        time.sleep(min(0.1 * attempts, 0.5))
        self.q.put(("dispatch", sd, retries, attempts))

    def _fail(self, sd: Dict[str, Any], message: str, error_type: str) -> None:
        self.rt._store_error_objects(sd, message, error_type)
        self._finish(sd)

    def _finish(self, sd: Dict[str, Any]) -> None:
        """Release the in-flight pin exactly once — the unpin rides the SAME
        FIFO refop channel as the pin, so it can never overtake it — then
        unblock get()'s channel wait for these returns."""
        rt = self.rt
        holder = sd.get("task_holder")
        if holder:
            rt._queue_refop("unpin", {
                "holder": holder,
                "object_ids": (sd.get("deps") or []) + (sd.get("returns") or []),
            })
        rt._actor_returns_done(sd)


def connect_driver(address: str, namespace: Optional[str] = None,
                   log_to_driver: bool = True) -> Tuple[ClusterRuntime, Worker]:
    """address = GCS host:port (optionally with a client:// scheme to force
    the proxied data plane). The driver attaches to the head node's agent
    (or the first alive node) as its object/task plane; when the driver is
    on a DIFFERENT machine (no shared /dev/shm) the data plane is proxied
    through the agent via chunked RPCs (the Ray Client tier analogue)."""
    force_client = False
    if address.startswith("client://"):
        force_client = True
        address = address[len("client://"):]
    gcs = SyncRpcClient(address)
    try:
        nodes = [n for n in gcs.call("get_nodes") if n["Alive"]]
        if not nodes:
            raise RuntimeError(f"no alive nodes registered at GCS {address}")
        head = next((n for n in nodes if n.get("is_head")), nodes[0])
        job_n = gcs.call("next_job_id")
    finally:
        gcs.close()
    runtime = ClusterRuntime(
        gcs_address=address,
        agent_address=head["NodeManagerAddress"],
        node_id=NodeID.from_hex(head["NodeID"]),
        is_driver=True,
        namespace=namespace or "default",
    )
    if force_client:
        runtime.remote_data_plane = True
    else:
        # a driver on another machine cannot mmap the agent's shm — flip to
        # the proxied data plane automatically. The probe is FUNCTIONAL for
        # BOTH backends: the agent writes a nonce file into its /dev/shm at
        # startup (agent.rpc_node_info "shm_probe"); only a same-machine
        # driver can read the matching nonce. Hostname comparison is gone —
        # cloned VMs share hostnames without sharing /dev/shm (ADVICE r4).
        try:
            info = runtime.agent.call("node_info", timeout=10.0)
            probe = info.get("shm_probe") or {}
            local = False
            path, nonce = probe.get("path"), probe.get("nonce")
            if path and nonce:
                try:
                    with open(path) as f:
                        local = f.read() == nonce
                except OSError:
                    local = False
            elif "shm_probe" not in info:
                # pre-probe agent (rolling upgrade): fall back to the arena
                # file check, else assume local (the historical default)
                store = info.get("store") or {}
                if store.get("backend") == "arena":
                    from ray_tpu_torch.core.shm_store import arena_path

                    local = os.path.exists(arena_path(runtime.node_hex))
                else:
                    local = True
            runtime.remote_data_plane = not local
        except Exception:  # noqa: BLE001 - probe is best-effort
            pass
    worker = Worker(runtime, JobID.from_int(job_n), node_id=NodeID.from_hex(head["NodeID"]),
                    is_driver=True)
    if log_to_driver:
        runtime.start_log_stream()
    return runtime, worker
