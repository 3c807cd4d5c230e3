"""Worker process: executes tasks and hosts actors (own copy of
ray_tpu.core.node.worker_main; the agent sets its ``CUDA_VISIBLE_DEVICES``).

Reference capability: python/ray/_private/workers/default_worker.py +
the CoreWorker execution path (task_receiver.h, _raylet.pyx
task_execution_handler) — a process that registers with its node agent,
serves direct task/actor-call RPCs (callers push work straight to the
worker, the agent is off the per-call data path exactly like the
reference's lease-then-PushTask design), executes user code on threads,
and writes results into the node's shared-memory object plane.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import functools
import hashlib
import os
import queue
import threading
import traceback
from typing import Any, Dict, List, Optional

import cloudpickle

from ray_tpu_torch import exceptions as exc
from ray_tpu_torch.core import serialization
from ray_tpu_torch.core.config import config
from ray_tpu_torch.core.ids import ActorID, JobID, NodeID, ObjectID, TaskID, WorkerID
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.core.rpc import RpcClient, RpcServer, SyncRpcClient, spawn
from ray_tpu_torch.core.shm_store import ShmWriter
from ray_tpu_torch.utils.logging import get_logger, setup_component_logging

logger = get_logger("worker")


class WorkerProcess:
    def __init__(self) -> None:
        self.worker_id = os.environ["RAY_TPU_WORKER_ID"]
        self.agent_addr = os.environ["RAY_TPU_AGENT_ADDR"]
        self.gcs_addr = os.environ["RAY_TPU_GCS_ADDR"]
        self.node_hex = os.environ["RAY_TPU_NODE_ID"]
        # chaos-exempt: task/actor-call execution is not idempotent (the
        # chaos tier targets the control plane — GCS + agents)
        self.rpc = RpcServer("127.0.0.1", 0, chaos=False)
        self.rpc.register_object(self)
        self.agent: Optional[RpcClient] = None
        self._fn_cache: Dict[str, Any] = {}
        self._exec_pool = concurrent.futures.ThreadPoolExecutor(max_workers=8)
        # actor state
        self.actor_id: Optional[str] = None
        self.actor_instance: Any = None
        self.actor_dead_error: Optional[BaseException] = None
        self._actor_mailbox: "queue.Queue" = queue.Queue()
        self._actor_thread: Optional[threading.Thread] = None
        self._actor_max_concurrency = 1
        self._actor_pool: Optional[concurrent.futures.ThreadPoolExecutor] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        # pipelined actor-call state (reference: ActorSchedulingQueue seq_no
        # ordering + completed-task dedup):
        # caller id -> {"next": expected seq, "ev": event set on each advance}
        self._actor_seq: Dict[str, Dict[str, Any]] = {}
        # task_id -> reply: completed-call cache so a re-pushed call (caller
        # deadline expiry / connection retry) replays instead of re-executing
        from collections import OrderedDict

        self._actor_done: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
        # task_id -> future: a duplicate push of a STILL-RUNNING call
        # piggybacks on the original execution instead of starting a second
        self._actor_inflight: Dict[str, asyncio.Future] = {}

    async def start(self) -> None:
        self._loop = asyncio.get_running_loop()
        await self.rpc.start()
        self.agent = await RpcClient(self.agent_addr).connect()
        # worker-side runtime so user code can call the public API in-task
        from ray_tpu_torch.core.cluster_runtime import ClusterRuntime
        from ray_tpu_torch.core.worker import Worker, set_global_worker

        runtime = ClusterRuntime(
            gcs_address=self.gcs_addr, agent_address=self.agent_addr,
            node_id=NodeID.from_hex(self.node_hex), is_driver=False,
        )
        worker = Worker(
            runtime, JobID.from_int(1),
            worker_id=WorkerID.from_hex(self.worker_id.ljust(32, "0")[:32]),
            node_id=NodeID.from_hex(self.node_hex), is_driver=False,
        )
        # zero-refcount in a worker withdraws its cluster holder (borrowed
        # refs); the GCS frees an object once every process's holder is gone
        worker.ref_counter.set_on_zero(runtime.release)
        set_global_worker(worker)
        self._worker_ctx = worker
        self._runtime = runtime
        await self.agent.call(
            "worker_ready", worker_id=self.worker_id, address=self.rpc.address,
            client_holder=runtime.client_id,
        )
        # tracing bridge: trace spans (created only for specs that carry a
        # __trace_ctx__ from a tracing-enabled driver) fold into the
        # profiling pipeline and land on the cluster timeline
        from ray_tpu_torch import profiling
        from ray_tpu_torch.util import tracing

        def _bridge(spans) -> None:
            for s in spans:
                profiling.record_external_span(
                    s["name"], s["start_s"], s.get("end_s", s["start_s"]),
                    extra={"trace_id": s["trace_id"], "span_id": s["span_id"],
                           "parent_id": s.get("parent_id")},
                )

        tracing.set_exporter(_bridge)  # record ONLY driver-traced tasks
        spawn(self._agent_watchdog())
        logger.info("worker %s ready at %s", self.worker_id[:8], self.rpc.address)

    async def _agent_watchdog(self) -> None:
        """Die with the node agent (reference: workers exit when their raylet
        goes away) — otherwise SIGKILLed agents orphan worker processes that
        accumulate and saturate the host."""
        while True:
            await asyncio.sleep(2.0)
            if self.agent is not None and self.agent._closed:  # noqa: SLF001
                logger.warning("agent connection lost; worker exiting")
                os._exit(0)

    # ----------------------------------------------------------- helpers
    def _load_function(self, function_id: str) -> Any:
        fn = self._fn_cache.get(function_id)
        if fn is None:
            if function_id.startswith("xlang:"):
                # cross-language descriptor "xlang:<module>:<qualname>"
                # (reference capability: java/xlang function descriptors —
                # non-Python frontends submit by importable name instead of
                # a pickled closure)
                import importlib

                _, module_name, qualname = function_id.split(":", 2)
                obj = importlib.import_module(module_name)
                for part in qualname.split("."):
                    obj = getattr(obj, part)
                fn = obj
            else:
                from ray_tpu_torch.core.worker import global_worker

                payload = global_worker().runtime.kv_get(f"fn:{function_id}")
                if payload is None:
                    raise KeyError(f"function {function_id} not found in GCS KV")
                fn = cloudpickle.loads(payload)
            self._fn_cache[function_id] = fn
        return fn

    def _resolve_args(self, payload: bytes) -> tuple:
        """Unpack (args, kwargs); resolve TOP-LEVEL ObjectRefs to values
        (nested refs stay refs — reference semantics). Dep objects are
        pinned by the agent for the whole task execution, so these gets run
        inside a ``pinned_reads`` window: arena-backed payloads decode over
        the live shm mapping (columnar-exchange blocks alias the arena)
        instead of paying a per-arg heap copy."""
        args, kwargs = serialization.unpack(memoryview(payload), zero_copy=False)
        from ray_tpu_torch import api

        def resolve(v):
            return api.get(v) if isinstance(v, ObjectRef) else v

        with serialization.pinned_reads():
            return (tuple(resolve(a) for a in args),
                    {k: resolve(v) for k, v in kwargs.items()})

    def _store_value(self, object_id: str, value: Any, is_error: bool = False,
                     collector: Optional[List[Dict[str, Any]]] = None,
                     xlang: bool = False,
                     inline_limit: Optional[int] = None) -> None:
        if xlang:
            payload, refs = serialization.xlang_pack(value), []
        else:
            payload, refs = serialization.pack(value)
        oid = ObjectID.from_hex(object_id)
        # inline_limit set = actor-call completion path: the payload rides the
        # reply to the CALLER and never touches this node's arena, so nested
        # ObjectRefs must fall through to the agent path (their contained-ref
        # pins only exist for GCS-registered containers)
        collect_ok = (len(payload) <= config.max_direct_call_object_size
                      if inline_limit is None
                      else (len(payload) <= inline_limit and not refs))
        if collector is not None and collect_ok:
            # small return rides INLINE in the run_task reply: the agent
            # writes+seals it locally, removing a full worker->agent round
            # trip per task (reference: max_direct_call_object_size inlining)
            collector.append({
                "object_id": object_id, "payload": bytes(payload),
                "owner": ":error" if is_error else "", "is_error": is_error,
                "contained": [r.id.hex() for r in refs] or None,
            })
            return
        if len(payload) <= config.max_direct_call_object_size:
            # small return: one agent round trip (reserve+write+seal+register)
            resp = asyncio.run_coroutine_threadsafe(
                self.agent.call(
                    "put_object", object_id=object_id, payload=bytes(payload),
                    owner=":error" if is_error else "", is_error=is_error,
                    contained=[r.id.hex() for r in refs] or None,
                ),
                self._loop,
            ).result()
            if isinstance(resp, dict) and resp.get("existing") == "sealed":
                # a previous execution already stored this result; never
                # rewrite memory that readers may be consuming
                raise FileExistsError(object_id)
            return
        fut = asyncio.run_coroutine_threadsafe(
            self.agent.call("create_object", object_id=object_id, size=len(payload)),
            self._loop,
        )
        resp = fut.result()
        if isinstance(resp, dict) and resp.get("existing") == "sealed":
            # a previous execution of this task already stored the result;
            # never rewrite memory that readers may be consuming
            raise FileExistsError(object_id)
        if (isinstance(resp, dict) and resp.get("existing") == "reserved"
                and resp.get("size") != len(payload)):
            # stale half-written reservation from a crashed execution with a
            # DIFFERENT payload size: recreate at the right size
            asyncio.run_coroutine_threadsafe(
                self.agent.call("abort_object", object_id=object_id), self._loop
            ).result()
            resp = asyncio.run_coroutine_threadsafe(
                self.agent.call("create_object", object_id=object_id, size=len(payload)),
                self._loop,
            ).result()
        offset = resp.get("offset") if isinstance(resp, dict) else None
        writer = ShmWriter(oid, len(payload), self.node_hex, offset=offset)
        writer.buffer[:] = payload
        writer.seal()
        asyncio.run_coroutine_threadsafe(
            self.agent.call(
                "seal_object", object_id=object_id, size=len(payload),
                owner=":error" if is_error else "", is_error=is_error,
                contained=[r.id.hex() for r in refs] or None,
            ),
            self._loop,
        ).result()

    def _store_returns(self, spec: Dict[str, Any], result: Any,
                       collector: Optional[List[Dict[str, Any]]] = None,
                       inline_limit: Optional[int] = None) -> None:
        returns: List[str] = spec["returns"]
        xlang = bool(spec.get("xlang"))
        if len(returns) == 1:
            try:
                self._store_value(returns[0], result, collector=collector,
                                  xlang=xlang, inline_limit=inline_limit)
            except FileExistsError:
                pass  # duplicate execution (at-least-once): result already stored
            return
        if not isinstance(result, (tuple, list)) or len(result) != len(returns):
            err = exc.TaskError(
                spec.get("name", "?"),
                f"declared num_returns={len(returns)} but returned "
                f"{type(result).__name__}",
            )
            for r in returns:
                try:
                    self._store_value(r, err, is_error=True, collector=collector,
                                      inline_limit=inline_limit)
                except FileExistsError:
                    pass
            return
        for r, v in zip(returns, result):
            try:
                self._store_value(r, v, collector=collector, xlang=xlang,
                                  inline_limit=inline_limit)
            except FileExistsError:
                pass  # duplicate execution (at-least-once): already stored

    def _store_error_returns(self, spec: Dict[str, Any], e: BaseException,
                             collector: Optional[List[Dict[str, Any]]] = None,
                             inline_limit: Optional[int] = None) -> None:
        err: Any = exc.TaskError.from_exception(
            e, spec.get("name", "?"), pid=os.getpid(), node_id=self.node_hex
        )
        xlang = bool(spec.get("xlang"))
        if xlang:
            # cross-language error envelope: msgpack-able, recognized by
            # cluster_runtime._read_local AND the C++ client's is_error path
            err = {"__rtpu_error__": type(e).__name__, "message": str(err)}
        for r in spec["returns"]:
            try:
                self._store_value(r, err, is_error=True, collector=collector,
                                  xlang=xlang, inline_limit=inline_limit)
            except FileExistsError:
                pass
        if spec.get("streaming") and spec.get("returns"):
            # surface the pre-iteration failure to the streaming consumer as
            # item 0 (the fixed first return slot) followed by end-of-stream
            try:
                self._stream_report(spec, 0, spec["returns"][0])
                self._runtime.gcs.call("stream_end", task_id=spec["task_id"], total=1)
            except Exception:  # noqa: BLE001
                logger.exception("failed to report stream error")

    # ------------------------------------------------- streaming generators
    def _stream_report(self, spec: Dict[str, Any], index: int, oid_hex: str) -> Dict[str, Any]:
        return self._runtime.gcs.call(
            "stream_put", task_id=spec["task_id"], index=index, object_id=oid_hex,
        )

    def _sync_iter_async_gen(self, agen):
        """Iterate an async generator from an executor thread by driving each
        __anext__ on the worker's event loop."""
        while True:
            try:
                yield asyncio.run_coroutine_threadsafe(
                    agen.__anext__(), self._loop
                ).result()
            except StopAsyncIteration:
                return

    def _drive_streaming(self, spec: Dict[str, Any], gen: Any) -> Dict[str, Any]:
        """Producer side of num_returns='streaming' on a cluster worker: seal
        each yielded item via the normal object path, report it to the GCS
        stream directory, honor consumer backpressure via stream_wait.
        Mid-stream exceptions become an error item + end-of-stream.
        (reference: _raylet.pyx:1206,1263 per-item report paths)"""
        import inspect

        from ray_tpu_torch.core.streaming import stream_item_id

        task_hex = spec["task_id"]
        backpressure = int(spec.get("backpressure") or 0)
        if inspect.isasyncgen(gen):
            gen = self._sync_iter_async_gen(gen)
        elif not inspect.isgenerator(gen):
            self._store_error_returns(spec, TypeError(
                f"num_returns='streaming' requires a generator function; "
                f"{spec.get('name', '?')} returned {type(gen).__name__}"
            ))
            return {"state": "error"}
        idx = 0
        try:
            for item in gen:
                oid_hex = stream_item_id(task_hex, idx).hex()
                try:
                    self._store_value(oid_hex, item)
                except FileExistsError:
                    pass  # duplicate execution: item already stored
                resp = self._stream_report(spec, idx, oid_hex)
                idx += 1
                if resp.get("closed"):
                    gen.close()
                    break
                if backpressure > 0 and idx - resp.get("consumed", 0) >= backpressure:
                    while True:
                        try:
                            r = self._runtime.gcs.call(
                                "stream_wait", task_id=task_hex, index=idx,
                                max_ahead=backpressure, timeout=10.0, timeout_s=5.0,
                            )
                        except TimeoutError:
                            continue
                        if r.get("timeout"):
                            continue
                        break
                    if r.get("closed"):
                        gen.close()
                        break
        except BaseException as e:  # noqa: BLE001 - delivered as an error item
            err = exc.TaskError.from_exception(
                e, spec.get("name", "?"), pid=os.getpid(), node_id=self.node_hex
            )
            oid_hex = stream_item_id(task_hex, idx).hex()
            try:
                self._store_value(oid_hex, err, is_error=True)
            except FileExistsError:
                pass
            self._stream_report(spec, idx, oid_hex)
            self._runtime.gcs.call("stream_end", task_id=task_hex, total=idx + 1)
            return {"state": "error"}
        self._runtime.gcs.call("stream_end", task_id=task_hex, total=idx)
        return {"state": "ok"}

    # ------------------------------------------------------------- task rpc
    async def rpc_run_task(self, spec: Dict[str, Any]) -> Dict[str, Any]:
        out = await self._loop.run_in_executor(self._exec_pool, self._execute_task, spec)
        # absolute process-wide Arrow decode counters ride back on every
        # reply; the agent keeps the last-seen value per worker (absolute,
        # not deltas: concurrent tasks in this pool share the counter, so
        # per-task windows would double-count overlapping decodes)
        out["decode_stats"] = serialization.arrow_decode_snapshot()
        return out


    def _flush_profile_spans(self) -> None:
        """Ship this thread's recorded profile spans to the agent (one RPC,
        only when ray_tpu_torch.profile() was used in the task)."""
        from ray_tpu_torch import profiling
        from ray_tpu_torch.util import tracing

        tracing.flush()  # bridge exporter folds trace spans into profiling
        spans = profiling.drain()
        if not spans:
            return
        try:
            # fire-and-forget: the reply is unused and exceptions are
            # swallowed, so never stall the task-completion path on it
            asyncio.run_coroutine_threadsafe(
                self.agent.call("report_profile_events",
                                worker_id=self.worker_id, events=spans),
                self._loop,
            )
        except Exception:  # noqa: BLE001 - observability is best-effort
            pass

    def _execute_task(self, spec: Dict[str, Any]) -> Dict[str, Any]:
        from ray_tpu_torch.core.worker import global_worker

        w = global_worker()
        task_id = TaskID(bytes.fromhex(spec["task_id"]))
        attempts = 0
        max_attempts = 1 + (spec.get("max_retries", 0) if spec.get("retry_exceptions") else 0)
        from ray_tpu_torch.util import tracing

        while True:
            w.set_task_context(task_id, None, spec.get("name", ""), attempt=attempts)
            try:
                with tracing.task_execution_span(spec):
                    fn = self._load_function(spec["function_id"])
                    args, kwargs = self._resolve_args(spec["args_payload"])
                    result = fn(*args, **kwargs)
                if spec.get("streaming"):
                    return self._drive_streaming(spec, result)
                inline: List[Dict[str, Any]] = []
                try:
                    self._store_returns(spec, result, collector=inline)
                except Exception as store_err:  # noqa: BLE001
                    if "ObjectStoreFullError" in repr(store_err):
                        # the task ran but its returns don't fit the local
                        # store right now: ask the agent to requeue (GC/spill
                        # frees space; already-sealed returns dedupe)
                        return {"state": "retry_store_full",
                                "inline_returns": inline}
                    raise
                return {"state": "ok", "inline_returns": inline}
            except BaseException as e:  # noqa: BLE001
                attempts += 1
                if attempts < max_attempts:
                    continue
                inline = []
                self._store_error_returns(spec, e, collector=inline)
                return {"state": "error", "inline_returns": inline}
            finally:
                w.set_task_context(None)
                self._flush_profile_spans()
                # borrows registered during execution must reach the GCS
                # while the task pin still protects them
                try:
                    self._runtime.flush_refs()
                except Exception:  # noqa: BLE001
                    pass

    # ------------------------------------------------------------ actor rpc
    async def rpc_start_actor(self, spec: Dict[str, Any]) -> Dict[str, Any]:
        if self.actor_id is not None and self.actor_id != spec["actor_id"]:
            return {"ok": False, "retryable": True,
                    "error": f"worker already hosts actor {self.actor_id[:8]}"}
        self.actor_id = spec["actor_id"]
        self._actor_max_concurrency = max(1, int(spec.get("max_concurrency", 1)))
        result = await self._loop.run_in_executor(None, self._construct_actor, spec)
        return result

    def _construct_actor(self, spec: Dict[str, Any]) -> Dict[str, Any]:
        from ray_tpu_torch.core.worker import global_worker

        w = global_worker()
        task_id = TaskID(bytes.fromhex(spec["task_id"]))
        w.set_task_context(task_id, ActorID.from_hex(spec["actor_id"]), spec.get("name", ""))
        try:
            cls = self._load_function(spec["function_id"])
            args, kwargs = self._resolve_args(spec["args_payload"])
            self.actor_instance = cls(*args, **kwargs)
            try:
                self._store_value(spec["returns"][0], None)
            except Exception:  # noqa: BLE001 - restart: marker already stored
                pass
            if self._actor_max_concurrency > 1:
                self._actor_pool = concurrent.futures.ThreadPoolExecutor(
                    max_workers=self._actor_max_concurrency
                )
            return {"ok": True}
        except BaseException as e:  # noqa: BLE001
            self.actor_dead_error = e
            self._store_error_returns(spec, e)
            return {"ok": False, "error": f"{type(e).__name__}: {e}"}
        finally:
            w.set_task_context(None)
            self._flush_profile_spans()

    async def rpc_run_actor_task(self, spec: Dict[str, Any],
                                 seq: Optional[int] = None,
                                 caller: str = "") -> Dict[str, Any]:
        if self.actor_instance is None:
            raise exc.ActorDiedError(self.actor_id or "", "actor not constructed")
        if spec.get("actor_id") != self.actor_id:
            # stale routing: this worker hosts a different actor
            raise ConnectionError(
                f"worker hosts actor {str(self.actor_id)[:8]}, not {spec.get('actor_id', '')[:8]}"
            )
        tid = spec.get("task_id", "")
        done = self._actor_done.get(tid)
        if done is not None:
            return done  # re-pushed completed call (caller retry): replay
        running = self._actor_inflight.get(tid)
        if running is not None:
            # duplicate push of a STILL-RUNNING call (caller deadline expired
            # and re-attached): wait on the original execution — never run a
            # non-idempotent method twice
            return await asyncio.shield(running)
        fut: asyncio.Future = self._loop.create_future()
        self._actor_inflight[tid] = fut
        try:
            if seq is not None and self._actor_pool is None:
                # windowed pipelining: frames normally arrive in seq order on
                # the persistent connection, but retries/reconnects reorder —
                # gate EXECUTOR SUBMISSION by seq; the single-thread executor
                # then runs jobs in submission order, so the turn advances at
                # submission time and consecutive calls pipeline through the
                # executor without a loop round trip between them
                await self._await_turn(caller, seq)
                try:
                    exec_fut = self._loop.run_in_executor(
                        self._ordered_executor(), self._execute_actor_task, spec)
                finally:
                    self._advance_turn(caller, seq)
                reply = await exec_fut
            else:
                pool = self._actor_pool or self._ordered_executor()
                reply = await self._loop.run_in_executor(
                    pool, self._execute_actor_task, spec)
            self._actor_done[tid] = reply
            while len(self._actor_done) > 512:
                self._actor_done.popitem(last=False)
            if not fut.done():
                fut.set_result(reply)
            return reply
        except BaseException as e:
            if not fut.done():
                fut.set_exception(e)
                fut.exception()  # piggybackers may be gone: mark retrieved
            raise
        finally:
            self._actor_inflight.pop(tid, None)

    async def _await_turn(self, caller: str, seq: int) -> None:
        """Block until `seq` is the next expected call from `caller`, or the
        reorder window expires (a lost/abandoned predecessor must not wedge
        the actor). First contact from a caller accepts its current seq
        (actor restarts join a caller's sequence mid-stream)."""
        st = self._actor_seq.get(caller)
        if st is None:
            st = self._actor_seq[caller] = {
                "next": seq, "ev": asyncio.Event(),
            }
            while len(self._actor_seq) > 256:  # bounded per-caller state
                oldest = next(iter(self._actor_seq))
                if oldest == caller:
                    break
                del self._actor_seq[oldest]
        deadline = self._loop.time() + config.actor_reorder_wait_s
        last_next = st["next"]
        while seq > st["next"]:
            if st["next"] != last_next:
                # predecessors ARE arriving: measure the stall, not the total
                # queue wait — a deep window must not trip the skip-forward
                last_next = st["next"]
                deadline = self._loop.time() + config.actor_reorder_wait_s
            remaining = deadline - self._loop.time()
            if remaining <= 0:
                # predecessor lost (failed call whose error objects the
                # caller already stored): skip forward, don't wedge
                st["next"] = seq
                break
            ev = st["ev"]
            try:
                await asyncio.wait_for(asyncio.shield(ev.wait()), remaining)
            except (asyncio.TimeoutError, TimeoutError):
                pass

    def _advance_turn(self, caller: str, seq: int) -> None:
        st = self._actor_seq.get(caller)
        if st is None:
            return
        if seq + 1 > st["next"]:
            st["next"] = seq + 1
        ev, st["ev"] = st["ev"], asyncio.Event()
        ev.set()  # wake every parked successor; each re-checks its turn

    _ordered: Optional[concurrent.futures.ThreadPoolExecutor] = None

    def _ordered_executor(self) -> concurrent.futures.ThreadPoolExecutor:
        if self._ordered is None:
            self._ordered = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        return self._ordered

    def _execute_actor_task(self, spec: Dict[str, Any]) -> Dict[str, Any]:
        from ray_tpu_torch.core.worker import global_worker

        w = global_worker()
        task_id = TaskID(bytes.fromhex(spec["task_id"]))
        w.set_task_context(
            task_id, ActorID.from_hex(spec["actor_id"]), spec.get("name", "")
        )
        try:
            if spec["method"] == "__rtpu_channel_loop__":
                # compiled-DAG stage loop (ray_tpu_torch/dag/compiled.py): a
                # framework-injected long-running method that takes over
                # this actor until its channels close
                from ray_tpu_torch.dag.compiled import channel_loop

                method = functools.partial(channel_loop, self.actor_instance)
            else:
                method = getattr(self.actor_instance, spec["method"])
            args, kwargs = self._resolve_args(spec["args_payload"])
            result = method(*args, **kwargs)
            if asyncio.iscoroutine(result):
                result = asyncio.run_coroutine_threadsafe(result, self._loop).result()
            if spec.get("streaming"):
                return self._drive_streaming(spec, result)
            # pipelined callers ask for small results IN the completion reply
            # (spec["inline_max"]): those payloads skip the arena write and
            # the caller's read RPC entirely
            inline_max = int(spec.get("inline_max") or 0)
            inline: Optional[List[Dict[str, Any]]] = [] if inline_max else None
            self._store_returns(spec, result, collector=inline,
                                inline_limit=inline_max or None)
            reply = {"state": "ok"}
            if inline:
                reply["inline_returns"] = inline
            return reply
        except BaseException as e:  # noqa: BLE001
            inline_max = int(spec.get("inline_max") or 0)
            inline = [] if inline_max else None
            self._store_error_returns(spec, e, collector=inline,
                                      inline_limit=inline_max or None)
            if isinstance(e, (SystemExit, KeyboardInterrupt)):
                os._exit(1)
            reply = {"state": "error"}
            if inline:
                reply["inline_returns"] = inline
            return reply
        finally:
            w.set_task_context(None)
            self._flush_profile_spans()
            try:
                self._runtime.flush_refs()
            except Exception:  # noqa: BLE001
                pass

    # ops endpoint: remote kill switch for `ray_tpu_torch` tooling, no in-tree caller
    async def rpc_terminate(self) -> bool:  # rtpulint: disable=rpc-drift
        asyncio.get_event_loop().call_later(0.05, os._exit, 0)
        return True

    async def rpc_dump_stacks(self) -> str:
        """All thread stacks of THIS process (`ray_tpu_torch stack` backend;
        reference capability: `ray stack` py-spy dump)."""
        from ray_tpu_torch.utils.debug import format_all_stacks

        return format_all_stacks()

    async def rpc_ping(self) -> str:
        return "pong"


def main() -> None:
    setup_component_logging("worker", os.environ.get("RAY_TPU_SESSION_DIR"), also_stderr=True)

    async def run() -> None:
        wp = WorkerProcess()
        await wp.start()
        await asyncio.Event().wait()

    asyncio.run(run())


if __name__ == "__main__":
    main()
