"""LocalRuntime: in-process task/actor/object runtime (own copy of
ray_tpu.core.local_runtime).

The single-process backend behind ``ray_tpu_torch.init(address="local")`` (and the
default for tests). Semantics match the cluster runtime with these documented
deltas:

- objects are stored **zero-copy in-process**: a CUDA tensor passed to
  ``put`` or to a task comes back as the same tensor, on the device, with
  the same ``data_ptr()`` (the cluster runtime serializes through the
  shared-memory plane instead);
- tasks run on threads; ``num_cpus``/``GPU``/custom resources are accounted
  against one virtual node so scheduling/backpressure behaves like a real
  node, but there is no process isolation (every task sees every card);
- actors are dedicated threads (or an asyncio event loop for async actors)
  consuming an ordered mailbox — submission order is execution order when
  ``max_concurrency == 1``, exactly the reference's ActorSchedulingQueue
  guarantee (reference: src/ray/core_worker/transport/actor_task_submitter.h).
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import inspect
import os
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ray_tpu_torch import exceptions as exc
from ray_tpu_torch.core.config import config
from ray_tpu_torch.core.ids import ActorID, JobID, NodeID, ObjectID, PlacementGroupID, TaskID
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.core.resources import (CPU, GPU, MEMORY, OBJECT_STORE_MEMORY,
                                         PlacementGroupSchedulingStrategy, ResourceSet)
from ray_tpu_torch.core.runtime import CoreRuntime
from ray_tpu_torch.core.task_spec import TaskSpec
from ray_tpu_torch.core.worker import global_worker
from ray_tpu_torch.utils.logging import get_logger
from ray_tpu_torch.utils import metrics

logger = get_logger("local_runtime")


class _ObjectEntry:
    __slots__ = ("future", "free_on_seal")

    def __init__(self) -> None:
        self.future: concurrent.futures.Future = concurrent.futures.Future()
        self.free_on_seal = False


class InProcessStore:
    """Object table: id -> future(value | error).

    The lock is an RLock as defense in depth: ``entry()`` allocates while
    holding it, and although ObjectRef.__del__ no longer does locked work
    (core/object_ref.py deferred releases), any OTHER finalizer running off
    a GC triggered inside the critical section must not self-deadlock."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._entries: Dict[ObjectID, _ObjectEntry] = {}
        self._closed_error: Optional[BaseException] = None

    def entry(self, oid: ObjectID, create: bool = True) -> Optional[_ObjectEntry]:
        with self._lock:
            e = self._entries.get(oid)
            if e is None and create:
                e = _ObjectEntry()
                if self._closed_error is not None:
                    # post-shutdown: never hand out a future that nothing
                    # will ever seal (an executor thread blocked on it would
                    # wedge interpreter exit via the futures atexit join)
                    e.future.set_result(_StoredError(self._closed_error))
                self._entries[oid] = e
            return e

    def close(self, error: BaseException) -> None:
        """Fail every unsealed entry and poison future ones: shutdown must
        WAKE all blocked get()/dependency waits (liveness over silence)."""
        with self._lock:
            self._closed_error = error
            entries = list(self._entries.values())
        for e in entries:
            if not e.future.done():
                e.future.set_result(_StoredError(error))

    def seal(self, oid: ObjectID, value: Any = None, error: Optional[BaseException] = None) -> None:
        e = self.entry(oid)
        if e.future.done():
            return  # idempotent (retries may re-seal)
        if error is not None:
            # store errors as values: gets inspect and raise
            e.future.set_result(_StoredError(error))
        else:
            e.future.set_result(value)
        if e.free_on_seal:
            self.free(oid)

    def free(self, oid: ObjectID) -> None:
        with self._lock:
            e = self._entries.get(oid)
            if e is not None and e.future.done():
                del self._entries[oid]
            elif e is not None:
                e.free_on_seal = True

    def contains_sealed(self, oid: ObjectID) -> bool:
        with self._lock:
            e = self._entries.get(oid)
        return e is not None and e.future.done()

    def size(self) -> int:
        with self._lock:
            return len(self._entries)


@dataclass
class _StoredError:
    error: BaseException


@dataclass
class _PendingTask:
    spec: TaskSpec
    func: Callable
    args: tuple
    kwargs: dict
    unresolved_deps: int = 0
    cancelled: bool = False
    dispatched: bool = False
    lock: threading.Lock = field(default_factory=threading.Lock)


class _ResourcePool:
    """One virtual node's resources with FIFO-ish dispatch."""

    def __init__(self, total: ResourceSet) -> None:
        self.total = total
        self.available = total.copy()
        self.lock = threading.Lock()

    def try_acquire(self, req: ResourceSet) -> bool:
        with self.lock:
            if req.is_subset_of(self.available):
                self.available.subtract(req)
                return True
            return False

    def release(self, req: ResourceSet) -> None:
        with self.lock:
            self.available.add(req)

    def feasible(self, req: ResourceSet) -> bool:
        return req.is_subset_of(self.total)


class _GrowingThreadPool:
    """Thread pool that caches idle workers but always grows when none are
    idle — tasks may block on nested get(), so a fixed-size pool would
    deadlock. The local-mode analogue of the reference's WorkerPool
    (reference: src/ray/raylet/worker_pool.h:174)."""

    def __init__(self, soft_limit: int = 256, idle_timeout: float = 30.0) -> None:
        self._q: "queue.SimpleQueue" = queue.SimpleQueue()
        self._lock = threading.Lock()
        self._idle = 0
        self._threads = 0
        self._idle_timeout = idle_timeout
        self._soft_limit = soft_limit

    def submit(self, fn, *args) -> None:
        # Enqueue BEFORE the idle check: a worker that times out re-checks the
        # queue under the same lock, so the item is either taken by an idle
        # worker or a new thread is spawned — never stranded.
        self._q.put((fn, args))
        with self._lock:
            spawn = self._idle == 0
            if spawn:
                self._threads += 1
        if spawn:
            threading.Thread(target=self._worker, daemon=True, name="ray-tpu-exec").start()

    def _worker(self) -> None:
        while True:
            with self._lock:
                self._idle += 1
            try:
                item = self._q.get(timeout=self._idle_timeout)
                with self._lock:
                    self._idle -= 1
            except queue.Empty:
                with self._lock:
                    try:
                        item = self._q.get_nowait()
                        self._idle -= 1
                    except queue.Empty:
                        self._idle -= 1
                        self._threads -= 1
                        return
            fn, args = item
            try:
                fn(*args)
            except Exception:  # noqa: BLE001 - executor must survive task bugs
                logger.exception("executor thread: unhandled error in %r", fn)


class _ActorCall:
    __slots__ = ("spec", "func_name", "args", "kwargs", "return_ids")

    def __init__(self, spec: TaskSpec, func_name: str, args: tuple, kwargs: dict):
        self.spec = spec
        self.func_name = func_name
        self.args = args
        self.kwargs = kwargs
        self.return_ids = spec.return_ids()


class _LocalActor:
    def __init__(self, runtime: "LocalRuntime", spec: TaskSpec, cls: type, args: tuple, kwargs: dict):
        self.runtime = runtime
        self.spec = spec
        self.actor_id = spec.actor_id
        self.cls = cls
        self.init_args = args
        self.init_kwargs = kwargs
        self.instance: Any = None
        self.state = "PENDING"  # PENDING | ALIVE | DEAD
        self.death_cause: Optional[BaseException] = None
        self.mailbox: "queue.Queue[Optional[_ActorCall]]" = queue.Queue()
        self.num_pending = 0
        self.is_async = any(
            asyncio.iscoroutinefunction(m) or inspect.isasyncgenfunction(m)
            for _, m in inspect.getmembers(cls, predicate=inspect.isfunction)
        )
        self.max_concurrency = max(1, spec.max_concurrency)
        self._threads: List[threading.Thread] = []
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._kill_event = threading.Event()

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> None:
        t = threading.Thread(target=self._main, name=f"actor-{self.actor_id.hex()[:8]}", daemon=True)
        self._threads.append(t)
        t.start()

    def _construct(self) -> None:
        w = global_worker()
        w.set_task_context(self.spec.task_id, self.actor_id, self.cls.__name__ + ".__init__")
        try:
            self.instance = self.cls(*self.init_args, **self.init_kwargs)
            self.state = "ALIVE"
            self.runtime._store.seal(self.spec.return_ids()[0], value=None)
        except BaseException as e:  # noqa: BLE001
            err = exc.TaskError.from_exception(e, f"{self.cls.__name__}.__init__", pid=os.getpid())
            self.state = "DEAD"
            self.death_cause = err
            self.runtime._store.seal(self.spec.return_ids()[0], error=err)
            self.runtime._on_actor_dead(self)
        finally:
            w.set_task_context(None)
            _flush_profile_local()

    def _main(self) -> None:
        self._construct()
        if self.state == "DEAD":
            self._drain_dead()
            return
        if self.is_async:
            self._loop = asyncio.new_event_loop()
            threading.Thread(target=self._loop.run_forever, daemon=True,
                             name=f"actor-loop-{self.actor_id.hex()[:8]}").start()
        pool = (
            concurrent.futures.ThreadPoolExecutor(self.max_concurrency)
            if self.max_concurrency > 1 and not self.is_async
            else None
        )
        sem = threading.Semaphore(self.max_concurrency) if self.is_async else None
        while not self._kill_event.is_set():
            call = self.mailbox.get()
            if call is None:
                break
            mfn = getattr(self.cls, call.func_name, None)
            if self.is_async and (
                asyncio.iscoroutinefunction(mfn) or inspect.isasyncgenfunction(mfn)
            ):
                sem.acquire()
                fut = asyncio.run_coroutine_threadsafe(self._run_async(call), self._loop)
                fut.add_done_callback(lambda _f: sem.release())
            elif pool is not None:
                pool.submit(self._run_sync, call)
            else:
                self._run_sync(call)
        if pool is not None:
            pool.shutdown(wait=False)
        if self._loop is not None:
            self._loop.call_soon_threadsafe(self._loop.stop)
        self._drain_dead()

    def _run_sync(self, call: _ActorCall) -> None:
        self.runtime._execute_actor_call(self, call)

    async def _run_async(self, call: _ActorCall) -> None:
        await self.runtime._execute_actor_call_async(self, call)

    def kill(self) -> None:
        self.state = "DEAD"
        self.death_cause = self.death_cause or exc.ActorDiedError(
            self.actor_id.hex(), "killed via ray_tpu_torch.kill"
        )
        self._kill_event.set()
        self.mailbox.put(None)

    def _drain_dead(self) -> None:
        while True:
            try:
                call = self.mailbox.get_nowait()
            except queue.Empty:
                return
            if call is None:
                continue
            err = self.death_cause or exc.ActorDiedError(self.actor_id.hex(), "actor is dead")
            for oid in call.return_ids:
                self.runtime._store.seal(oid, error=err)
            self.runtime._stream_mark_error(call.spec)
            w = global_worker()
            if w is not None:
                for dep in call.spec.dependencies():
                    w.ref_counter.remove_submitted(dep)


class _PlacementGroup:
    def __init__(self, pg_id: PlacementGroupID, bundles: List[ResourceSet], strategy: str, name: str):
        self.id = pg_id
        self.bundles = bundles
        self.bundle_available = [b.copy() for b in bundles]
        self.strategy = strategy
        self.name = name
        self.lock = threading.Lock()

    def try_acquire(self, bundle_index: int, req: ResourceSet) -> Optional[int]:
        """Acquire from a specific bundle, or any bundle when index==-1.
        Returns the bundle index used, or None."""
        if bundle_index >= len(self.bundles):
            raise ValueError(
                f"placement_group_bundle_index={bundle_index} out of range "
                f"(group has {len(self.bundles)} bundles)"
            )
        with self.lock:
            candidates = range(len(self.bundles)) if bundle_index < 0 else [bundle_index]
            for i in candidates:
                if req.is_subset_of(self.bundle_available[i]):
                    self.bundle_available[i].subtract(req)
                    return i
            return None

    def release(self, bundle_index: int, req: ResourceSet) -> None:
        with self.lock:
            self.bundle_available[bundle_index].add(req)


_TASKS_SUBMITTED = metrics.Counter("ray_tpu_tasks_submitted_total", "Tasks submitted")
_TASKS_FINISHED = metrics.Counter("ray_tpu_tasks_finished_total", "Tasks finished", tag_keys=("state",))
_TASK_EXEC_SECONDS = metrics.Histogram("ray_tpu_task_exec_seconds", "Task execution wall time")


class LocalRuntime(CoreRuntime):
    is_local = True

    def __init__(
        self,
        num_cpus: Optional[int] = None,
        num_gpus: Optional[int] = None,
        resources: Optional[Dict[str, float]] = None,
        job_id: Optional[JobID] = None,
    ) -> None:
        if num_cpus is None:
            # Threads carry no real isolation; a too-small default only causes
            # queueing, so floor at 8 for usable parallelism on small hosts.
            num_cpus = max(os.cpu_count() or 1, 8)
        if num_gpus is None:
            num_gpus = _detect_gpus()
        total = ResourceSet({CPU: num_cpus, **(resources or {})})
        if num_gpus:
            total[GPU] = float(num_gpus)
        try:
            import psutil

            total[MEMORY] = float(psutil.virtual_memory().available)
        except Exception:
            total[MEMORY] = 8 * 1024**3
        total[OBJECT_STORE_MEMORY] = float(config.object_store_memory_bytes)
        self.node_id = NodeID.from_random()
        total[f"node:{self.node_id.hex()}"] = 1.0
        self._pool = _ResourcePool(total)
        self._store = InProcessStore()
        self._job_id = job_id or JobID.from_int(1)
        self._pending: List[_PendingTask] = []
        self._pending_lock = threading.Lock()
        self._tasks: Dict[TaskID, _PendingTask] = {}
        self._actors: Dict[ActorID, _LocalActor] = {}
        self._named_actors: Dict[Tuple[str, str], ActorID] = {}
        self._actor_lock = threading.Lock()
        self._pgs: Dict[PlacementGroupID, _PlacementGroup] = {}
        # streaming generators: task hex -> in-process stream directory entry
        self._streams: Dict[str, Any] = {}
        self._shutdown = False
        self._started_at = time.time()
        # Reusable executor threads (the WorkerPool analogue). Sized well
        # above the CPU resource cap because tasks may block in nested get();
        # _GrowingThreadPool spawns past max_workers rather than deadlock.
        self._exec_pool = _GrowingThreadPool(soft_limit=256)

    # ------------------------------------------------------------------ objects
    def put(self, value: Any) -> ObjectRef:
        w = global_worker()
        oid = w.next_put_id()
        self._store.seal(oid, value=value)
        return ObjectRef(oid)

    def get(self, refs: Sequence[ObjectRef], timeout: Optional[float]) -> List[Any]:
        deadline = None if timeout is None else time.monotonic() + timeout
        out: List[Any] = []
        for ref in refs:
            e = self._store.entry(ref.id)
            remaining = None if deadline is None else max(0.0, deadline - time.monotonic())
            try:
                value = e.future.result(timeout=remaining)
            except concurrent.futures.TimeoutError:
                raise exc.GetTimeoutError(
                    f"get() timed out after {timeout}s waiting for {ref.id.hex()[:16]}"
                ) from None
            if isinstance(value, _StoredError):
                err = value.error
                if isinstance(err, exc.TaskError):
                    raise err.as_instanceof_cause()
                raise err
            out.append(value)
        return out

    def wait(
        self,
        refs: Sequence[ObjectRef],
        num_returns: int,
        timeout: Optional[float],
        fetch_local: bool,
    ) -> Tuple[List[ObjectRef], List[ObjectRef]]:
        futures = [self._store.entry(r.id).future for r in refs]
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            pending = [f for f in futures if not f.done()]
            n_done = len(futures) - len(pending)
            if n_done >= num_returns or not pending:
                break
            remaining = None if deadline is None else max(0.0, deadline - time.monotonic())
            if remaining == 0.0:
                break
            concurrent.futures.wait(
                pending, timeout=remaining, return_when=concurrent.futures.FIRST_COMPLETED
            )
        ready, not_ready = [], []
        for r, f in zip(refs, futures):
            (ready if f.done() and len(ready) < num_returns else not_ready).append(r)
        return ready, not_ready

    def free(self, refs: Sequence[ObjectRef]) -> None:
        for r in refs:
            self._store.free(r.id)

    def object_sizes(self, refs: Sequence[ObjectRef]) -> List[Optional[int]]:
        out: List[Optional[int]] = []
        for r in refs:
            e = self._store.entry(r.id, create=False)
            size = None
            if e is not None and e.future.done():
                v = e.future.result()
                size = getattr(v, "nbytes", None)
                if size is None:
                    try:
                        size = len(v)  # bytes-like
                    except TypeError:
                        size = None
            out.append(size)
        return out

    def release(self, oid: ObjectID) -> None:
        # Zero refcount in the only process: drop the value.
        self._store.free(oid)

    # ------------------------------------------------------------------- tasks
    def submit_task(self, spec: TaskSpec, func: Callable, args: tuple, kwargs: dict) -> List[ObjectRef]:
        if self._shutdown:
            raise RuntimeError("runtime is shut down")
        if not self._feasible(spec):
            raise ValueError(
                f"Task {spec.name} requires {dict(spec.resources)} which exceeds cluster capacity "
                f"{dict(self._pool.total)}"
            )
        _TASKS_SUBMITTED.inc()
        if spec.generator:
            from ray_tpu_torch.core.streaming import LocalStreamState

            self._streams[spec.task_id.binary().hex()] = LocalStreamState()
            return_refs: List[ObjectRef] = []
        else:
            return_refs = [ObjectRef(oid) for oid in spec.return_ids()]
        task = _PendingTask(spec=spec, func=func, args=args, kwargs=kwargs)
        self._tasks[spec.task_id] = task
        w = global_worker()
        deps = spec.dependencies()
        for dep in deps:
            w.ref_counter.add_submitted(dep)
        task.unresolved_deps = len(deps)
        if deps:
            for dep in deps:
                e = self._store.entry(dep)
                e.future.add_done_callback(lambda _f, t=task: self._dep_resolved(t))
        else:
            self._enqueue(task)
        return return_refs

    def _dep_resolved(self, task: _PendingTask) -> None:
        with task.lock:
            task.unresolved_deps -= 1
            if task.unresolved_deps > 0 or task.dispatched:
                return
        self._enqueue(task)

    def _enqueue(self, task: _PendingTask) -> None:
        with self._pending_lock:
            self._pending.append(task)
        self._drain_pending()

    def _acquire_for(self, spec: TaskSpec) -> Optional[Tuple[Optional[_PlacementGroup], int]]:
        """Acquire resources for a task: from its placement-group bundle when
        PG-scheduled, else from the node pool. Returns (pg, bundle_idx)."""
        strat = spec.strategy
        if isinstance(strat, PlacementGroupSchedulingStrategy) and strat.placement_group is not None:
            pg = self._pgs.get(getattr(strat.placement_group, "id", None))
            if pg is None:
                return None
            idx = pg.try_acquire(strat.placement_group_bundle_index, spec.resources)
            if idx is None:
                return None
            return (pg, idx)
        if self._pool.try_acquire(spec.resources):
            return (None, -1)
        return None

    def _drain_pending(self) -> None:
        while True:
            dispatched_one = False
            with self._pending_lock:
                for i, task in enumerate(self._pending):
                    with task.lock:
                        if task.dispatched or task.unresolved_deps > 0:
                            continue
                        if task.cancelled:
                            task.dispatched = True
                            self._pending.pop(i)
                            err = exc.TaskCancelledError(task.spec.task_id.hex())
                            for oid in task.spec.return_ids():
                                self._store.seal(oid, error=err)
                            self._stream_mark_error(task.spec)
                            self._tasks.pop(task.spec.task_id, None)
                            dispatched_one = True
                            break
                        grant = self._acquire_for(task.spec)
                        if grant is None:
                            continue
                        task.dispatched = True
                    self._pending.pop(i)
                    self._exec_pool.submit(self._execute_task, task, grant)
                    dispatched_one = True
                    break
            if not dispatched_one:
                return

    def _resolve_args(self, args: tuple, kwargs: dict) -> Tuple[tuple, dict, Optional[BaseException]]:
        def resolve(v: Any) -> Any:
            if isinstance(v, ObjectRef):
                value = self._store.entry(v.id).future.result()
                if isinstance(value, _StoredError):
                    raise _DepFailed(value.error)
                return value
            return v

        try:
            r_args = tuple(resolve(a) for a in args)
            r_kwargs = {k: resolve(v) for k, v in kwargs.items()}
            return r_args, r_kwargs, None
        except _DepFailed as d:
            return (), {}, d.error

    def _execute_task(self, task: _PendingTask, grant: Tuple[Optional[_PlacementGroup], int]) -> None:
        spec = task.spec
        w = global_worker()
        return_ids = spec.return_ids()
        attempts = 0
        try:
            while True:
                if task.cancelled:
                    err: BaseException = exc.TaskCancelledError(spec.task_id.hex())
                    for oid in return_ids:
                        self._store.seal(oid, error=err)
                    self._stream_mark_error(spec)
                    _TASKS_FINISHED.inc(tags={"state": "cancelled"})
                    return
                r_args, r_kwargs, dep_err = self._resolve_args(task.args, task.kwargs)
                if dep_err is not None:
                    for oid in return_ids:
                        self._store.seal(oid, error=dep_err)
                    self._stream_mark_error(spec)
                    _TASKS_FINISHED.inc(tags={"state": "dep_failed"})
                    return
                w.set_task_context(spec.task_id, None, spec.name, attempt=attempts)
                start = time.monotonic()
                try:
                    result = task.func(*r_args, **r_kwargs)
                    if spec.generator:
                        self._drive_generator(spec, result)
                    else:
                        self._store_returns(spec, return_ids, result)
                    _TASK_EXEC_SECONDS.observe(time.monotonic() - start)
                    _TASKS_FINISHED.inc(tags={"state": "ok"})
                    return
                except BaseException as e:  # noqa: BLE001
                    attempts += 1
                    retryable = spec.retry_exceptions and attempts <= spec.max_retries
                    if retryable and not spec.generator:
                        logger.info("Task %s failed (attempt %d), retrying: %s", spec.name, attempts, e)
                        continue
                    err = exc.TaskError.from_exception(e, spec.name, pid=os.getpid(),
                                                       node_id=self.node_id.hex())
                    for oid in return_ids:
                        self._store.seal(oid, error=err)
                    self._stream_mark_error(spec)
                    _TASKS_FINISHED.inc(tags={"state": "error"})
                    return
                finally:
                    w.set_task_context(None)
            _flush_profile_local()
        finally:
            pg, idx = grant
            if pg is not None:
                pg.release(idx, spec.resources)
            else:
                self._pool.release(spec.resources)
            for dep in spec.dependencies():
                w.ref_counter.remove_submitted(dep)
            self._tasks.pop(spec.task_id, None)
            self._drain_pending()

    def _store_returns(self, spec: TaskSpec, return_ids: List[ObjectID], result: Any) -> None:
        if spec.num_returns == 1:
            self._store.seal(return_ids[0], value=result)
            return
        if not isinstance(result, (tuple, list)) or len(result) != spec.num_returns:
            err = exc.TaskError(
                spec.name,
                f"Task declared num_returns={spec.num_returns} but returned "
                f"{type(result).__name__} of length "
                f"{len(result) if isinstance(result, (tuple, list)) else 'n/a'}",
            )
            for oid in return_ids:
                self._store.seal(oid, error=err)
            return
        for oid, v in zip(return_ids, result):
            self._store.seal(oid, value=v)

    # ------------------------------------------------------------- streaming
    def _drive_generator(self, spec: TaskSpec, result: Any) -> None:
        """Producer side of num_returns='streaming': seal each yielded item
        as its own object, report it to the stream directory, respect
        consumer backpressure. Mid-stream exceptions become an error ITEM
        followed by end-of-stream (no retries of partially-consumed streams)."""
        import inspect

        from ray_tpu_torch.core.streaming import stream_item_id

        task_hex = spec.task_id.binary().hex()
        st = self._streams.get(task_hex)
        if inspect.isasyncgen(result):
            from ray_tpu_torch.core.streaming import iter_async_gen

            result = iter_async_gen(result)
        elif not inspect.isgenerator(result):
            raise TypeError(
                f"num_returns='streaming' requires a generator function; "
                f"{spec.name} returned {type(result).__name__}"
            )
        if st is None:  # stream already closed+reaped before execution began
            result.close()
            return
        idx = 0
        try:
            for item in result:
                oid = stream_item_id(task_hex, idx)
                self._store.seal(oid, value=item)
                alive = st.put(idx, oid.hex(), spec.generator_backpressure)
                idx += 1
                if not alive:
                    result.close()
                    break
        except BaseException as e:  # noqa: BLE001 - delivered as an error item
            err = exc.TaskError.from_exception(e, spec.name, pid=os.getpid(),
                                               node_id=self.node_id.hex())
            oid = stream_item_id(task_hex, idx)
            self._store.seal(oid, error=err)
            st.put(idx, oid.hex(), 0)
            st.end(idx + 1)
            return
        st.end(idx)

    async def _drive_async_generator(self, spec: TaskSpec, agen: Any) -> None:
        """Async-actor variant of _drive_generator (async-generator methods).
        Backpressure waits run off-loop so other coroutine calls proceed."""
        from ray_tpu_torch.core.streaming import stream_item_id

        task_hex = spec.task_id.binary().hex()
        st = self._streams.get(task_hex)
        if st is None:
            await agen.aclose()
            return
        loop = asyncio.get_running_loop()
        idx = 0
        try:
            async for item in agen:
                oid = stream_item_id(task_hex, idx)
                self._store.seal(oid, value=item)
                alive = await loop.run_in_executor(
                    None, st.put, idx, oid.hex(), spec.generator_backpressure
                )
                idx += 1
                if not alive:
                    await agen.aclose()
                    break
        except BaseException as e:  # noqa: BLE001 - delivered as an error item
            err = exc.TaskError.from_exception(e, spec.name, pid=os.getpid(),
                                               node_id=self.node_id.hex())
            oid = stream_item_id(task_hex, idx)
            self._store.seal(oid, error=err)
            st.put(idx, oid.hex(), 0)
            st.end(idx + 1)
            return
        st.end(idx)

    def _stream_mark_error(self, spec: TaskSpec) -> None:
        """A pre-execution failure sealed error objects into the fixed
        returns; surface it to a streaming consumer as item 0 + end."""
        if not spec.generator:
            return
        st = self._streams.get(spec.task_id.binary().hex())
        if st is None or st.finished:
            return
        st.put(0, spec.return_ids()[0].hex(), 0)
        st.end(1)

    def stream_next(self, task_hex: str, index: int, timeout: Optional[float]):
        st = self._streams.get(task_hex)
        if st is None:
            raise ValueError(f"unknown or closed stream {task_hex[:16]}")
        try:
            kind, value = st.next(index, timeout)
        except TimeoutError:
            raise exc.GetTimeoutError(
                f"stream item {index} of {task_hex[:16]} not ready in {timeout}s"
            ) from None
        if kind == "end" and index >= value:
            self._streams.pop(task_hex, None)  # fully consumed: reap state
        return kind, value

    def stream_close(self, task_hex: str) -> None:
        st = self._streams.pop(task_hex, None)
        if st is None:
            return
        st.close()
        with st.cond:
            for idx, oid_hex in st.items.items():
                if idx >= st.delivered:  # never handed to the consumer
                    self._store.free(ObjectID.from_hex(oid_hex))

    def cancel(self, ref: ObjectRef, force: bool, recursive: bool) -> None:
        task = self._tasks.get(ref.id.task_id())
        if task is None:
            return
        task.cancelled = True
        # Lock order everywhere else is _pending_lock -> task.lock
        # (_drain_pending); never nest _pending_lock inside task.lock here or
        # a concurrent cancel + dispatch can deadlock the whole runtime.
        with task.lock:
            claimed = not task.dispatched
            if claimed:
                task.dispatched = True
        if claimed:
            err = exc.TaskCancelledError(task.spec.task_id.hex())
            for oid in task.spec.return_ids():
                self._store.seal(oid, error=err)
            self._stream_mark_error(task.spec)
            with self._pending_lock:
                if task in self._pending:
                    self._pending.remove(task)

    # ------------------------------------------------------------------ actors
    def create_actor(self, spec: TaskSpec, cls: type, args: tuple, kwargs: dict) -> ActorID:
        if not self._feasible(spec):
            raise ValueError(
                f"Actor {spec.name} requires {dict(spec.resources)} which exceeds capacity "
                f"{dict(self._pool.total)}"
            )
        grant = None
        deadline = time.monotonic() + 60.0
        while grant is None:
            grant = self._acquire_for(spec)
            if grant is None:
                if time.monotonic() > deadline:
                    raise exc.PlacementGroupError(
                        f"Could not acquire resources {dict(spec.resources)} for actor {spec.name}"
                    )
                time.sleep(0.005)
        actor = _LocalActor(self, spec, cls, args, kwargs)
        actor._grant = grant  # released on death
        with self._actor_lock:
            name = (spec.runtime_env or {}).get("__actor_name__")
            if name:
                ns = (spec.runtime_env or {}).get("__actor_namespace__", "default")
                if (ns, name) in self._named_actors:
                    pg, idx = grant
                    (pg.release(idx, spec.resources) if pg else self._pool.release(spec.resources))
                    raise ValueError(f"Actor name '{name}' already taken in namespace '{ns}'")
                self._named_actors[(ns, name)] = spec.actor_id
            self._actors[spec.actor_id] = actor
        # creation return: sealed by actor thread
        ObjectRef(spec.return_ids()[0])  # register ref for the creation object
        actor.start()
        return spec.actor_id

    def submit_actor_task(self, actor_id: ActorID, spec: TaskSpec, args: tuple, kwargs: dict) -> List[ObjectRef]:
        actor = self._actors.get(actor_id)
        if spec.generator:
            from ray_tpu_torch.core.streaming import LocalStreamState

            self._streams[spec.task_id.binary().hex()] = LocalStreamState()
            refs: List[ObjectRef] = []
        else:
            refs = [ObjectRef(oid) for oid in spec.return_ids()]
        if actor is None:
            err = exc.ActorDiedError(actor_id.hex(), "unknown or shut down actor")
            for oid in spec.return_ids():
                self._store.seal(oid, error=err)
            self._stream_mark_error(spec)
            return refs
        if spec.max_pending_calls > 0 and actor.mailbox.qsize() >= spec.max_pending_calls:
            raise exc.PendingCallsLimitExceededError(
                f"Actor {actor_id.hex()[:8]} has {actor.mailbox.qsize()} pending calls "
                f"(max_pending_calls={spec.max_pending_calls})"
            )
        w = global_worker()
        for dep in spec.dependencies():
            w.ref_counter.add_submitted(dep)
        call = _ActorCall(spec, spec.actor_method_name, args, kwargs)
        if actor.state == "DEAD":
            err = actor.death_cause or exc.ActorDiedError(actor_id.hex(), "actor is dead")
            for oid in spec.return_ids():
                self._store.seal(oid, error=err)
            self._stream_mark_error(spec)
            return refs
        actor.mailbox.put(call)
        # Re-check after enqueue: if the actor died between the check and the
        # put, the consumer loop may already have drained — drain again so the
        # call's returns are error-sealed rather than hanging (seal is
        # idempotent, so double-drain is safe).
        if actor.state == "DEAD":
            actor._drain_dead()
        return refs

    def _execute_actor_call(self, actor: _LocalActor, call: _ActorCall) -> None:
        w = global_worker()
        spec = call.spec
        r_args, r_kwargs, dep_err = self._resolve_args(call.args, call.kwargs)
        if dep_err is not None:
            for oid in call.return_ids:
                self._store.seal(oid, error=dep_err)
            self._stream_mark_error(spec)
            for dep in spec.dependencies():
                w.ref_counter.remove_submitted(dep)
            return
        w.set_task_context(spec.task_id, actor.actor_id, spec.name)
        start = time.monotonic()
        try:
            if call.func_name == "__rtpu_channel_loop__":
                # compiled-DAG stage loop hook (ray_tpu_torch/dag/compiled.py)
                import functools as _functools

                from ray_tpu_torch.dag.compiled import channel_loop

                method = _functools.partial(channel_loop, actor.instance)
            else:
                method = getattr(actor.instance, call.func_name)
            result = method(*r_args, **r_kwargs)
            if spec.generator:
                self._drive_generator(spec, result)
            else:
                self._store_returns(spec, call.return_ids, result)
            _TASK_EXEC_SECONDS.observe(time.monotonic() - start)
        except BaseException as e:  # noqa: BLE001
            err = exc.TaskError.from_exception(e, spec.name, pid=os.getpid(), node_id=self.node_id.hex())
            for oid in call.return_ids:
                self._store.seal(oid, error=err)
            self._stream_mark_error(spec)
            if isinstance(e, (SystemExit, KeyboardInterrupt)):
                actor.kill()
        finally:
            w.set_task_context(None)
            _flush_profile_local()
            for dep in spec.dependencies():
                w.ref_counter.remove_submitted(dep)

    async def _execute_actor_call_async(self, actor: _LocalActor, call: _ActorCall) -> None:
        w = global_worker()
        spec = call.spec
        loop = asyncio.get_running_loop()
        # Resolve ObjectRef args off-loop so dependency waits don't stall
        # other concurrent coroutine calls on this actor.
        r_args, r_kwargs, dep_err = await loop.run_in_executor(
            None, self._resolve_args, call.args, call.kwargs
        )
        if dep_err is not None:
            for oid in call.return_ids:
                self._store.seal(oid, error=dep_err)
            for dep in spec.dependencies():
                w.ref_counter.remove_submitted(dep)
            return
        try:
            import inspect

            method = getattr(actor.instance, call.func_name)
            w.set_task_context(spec.task_id, actor.actor_id, spec.name)
            if spec.generator and inspect.isasyncgenfunction(method):
                await self._drive_async_generator(spec, method(*r_args, **r_kwargs))
            else:
                result = await method(*r_args, **r_kwargs)
                if spec.generator:
                    # run the (sync) generator off-loop: its body is user code
                    await asyncio.get_running_loop().run_in_executor(
                        None, self._drive_generator, spec, result
                    )
                else:
                    self._store_returns(spec, call.return_ids, result)
        except BaseException as e:  # noqa: BLE001
            err = exc.TaskError.from_exception(e, spec.name, pid=os.getpid(), node_id=self.node_id.hex())
            for oid in call.return_ids:
                self._store.seal(oid, error=err)
            self._stream_mark_error(spec)
        finally:
            w.set_task_context(None)
            _flush_profile_local()
            for dep in spec.dependencies():
                w.ref_counter.remove_submitted(dep)

    def kill_actor(self, actor_id: ActorID, no_restart: bool) -> None:
        actor = self._actors.get(actor_id)
        if actor is None:
            return
        actor.kill()
        self._on_actor_dead(actor)

    def _on_actor_dead(self, actor: _LocalActor) -> None:
        grant = getattr(actor, "_grant", None)
        if grant is not None:
            actor._grant = None
            pg, idx = grant
            if pg is not None:
                pg.release(idx, actor.spec.resources)
            else:
                self._pool.release(actor.spec.resources)
            self._drain_pending()
        with self._actor_lock:
            for key, aid in list(self._named_actors.items()):
                if aid == actor.actor_id:
                    del self._named_actors[key]

    def get_named_actor(self, name: str, namespace: Optional[str]) -> ActorID:
        ns = namespace or "default"
        with self._actor_lock:
            aid = self._named_actors.get((ns, name))
        if aid is None:
            raise ValueError(f"Failed to look up actor '{name}' in namespace '{ns}'")
        return aid

    def list_named_actors(self, all_namespaces: bool = False, namespace: str = "default") -> List[str]:
        with self._actor_lock:
            if all_namespaces:
                return [name for (_ns, name) in self._named_actors]
            return [name for (ns, name) in self._named_actors if ns == namespace]

    def actor_state(self, actor_id: ActorID) -> str:
        a = self._actors.get(actor_id)
        return a.state if a else "DEAD"

    # --------------------------------------------------------------- placement
    def create_placement_group(self, bundles: List[Dict[str, float]], strategy: str, name: str) -> PlacementGroupID:
        pg_id = PlacementGroupID.of(self._job_id)
        sets = [ResourceSet(b) for b in bundles]
        need = ResourceSet()
        for s in sets:
            need.add(s)
        # Reserve against the node pool (single virtual node: every strategy
        # is satisfiable iff the total fits).
        if not self._pool.try_acquire(need):
            if not need.is_subset_of(self._pool.total):
                raise exc.PlacementGroupError(
                    f"Infeasible placement group: needs {dict(need)}, cluster has {dict(self._pool.total)}"
                )
            # feasible but busy: reserve lazily by waiting
            deadline = time.monotonic() + 60.0
            while not self._pool.try_acquire(need):
                if time.monotonic() > deadline:
                    raise exc.PlacementGroupError("Timed out reserving placement group resources")
                time.sleep(0.005)
        self._pgs[pg_id] = _PlacementGroup(pg_id, sets, strategy, name)
        return pg_id

    def remove_placement_group(self, pg_id: PlacementGroupID) -> None:
        pg = self._pgs.pop(pg_id, None)
        if pg is not None:
            total = ResourceSet()
            for b in pg.bundles:
                total.add(b)
            self._pool.release(total)
            self._drain_pending()

    def placement_group_ready(self, pg_id: PlacementGroupID, timeout: Optional[float]) -> bool:
        return pg_id in self._pgs

    def placement_group_table(self) -> Dict[str, Dict]:
        return {
            pg.id.hex(): {
                "name": pg.name,
                "strategy": pg.strategy,
                "bundles": [dict(b) for b in pg.bundles],
                "state": "CREATED",
            }
            for pg in self._pgs.values()
        }

    # ----------------------------------------------------------------- cluster
    def _feasible(self, spec: TaskSpec) -> bool:
        strat = spec.strategy
        if isinstance(strat, PlacementGroupSchedulingStrategy) and strat.placement_group is not None:
            pg = self._pgs.get(getattr(strat.placement_group, "id", None))
            if pg is None:
                return False
            idx = strat.placement_group_bundle_index
            if idx >= len(pg.bundles):
                raise ValueError(
                    f"placement_group_bundle_index={idx} out of range "
                    f"(group has {len(pg.bundles)} bundles)"
                )
            if idx >= 0:
                return spec.resources.is_subset_of(pg.bundles[idx])
            return any(spec.resources.is_subset_of(b) for b in pg.bundles)
        return self._pool.feasible(spec.resources)

    def nodes(self) -> List[Dict[str, Any]]:
        return [
            {
                "NodeID": self.node_id.hex(),
                "Alive": True,
                "NodeManagerAddress": "127.0.0.1",
                "Resources": dict(self._pool.total),
                "Labels": {},
                "is_head": True,
            }
        ]

    def cluster_resources(self) -> Dict[str, float]:
        return dict(self._pool.total)

    def available_resources(self) -> Dict[str, float]:
        with self._pool.lock:
            return dict(self._pool.available)

    def shutdown(self) -> None:
        self._shutdown = True
        for actor in list(self._actors.values()):
            actor.kill()
        self._actors.clear()
        self._pgs.clear()
        # wake every blocked waiter (get(), _resolve_args, nested task
        # dependencies): leaving them parked would block interpreter exit —
        # concurrent.futures' atexit joins ALL executor threads, including
        # an actor-pool thread stuck resolving an object that will now never
        # be sealed (observed as a post-suite interpreter hang, r5)
        self._store.close(exc.RayTpuError("ray_tpu_torch runtime is shut down"))

    # ---------------------------------------------------------------------- kv
    _kv: Dict[str, bytes]

    def kv_put(self, key: str, value: bytes) -> None:
        if not hasattr(self, "_kv"):
            self._kv = {}
        self._kv[key] = value

    def kv_get(self, key: str) -> Optional[bytes]:
        return getattr(self, "_kv", {}).get(key)

    def kv_del(self, key: str) -> None:
        getattr(self, "_kv", {}).pop(key, None)

    def kv_keys(self, prefix: str = "") -> List[str]:
        return [k for k in getattr(self, "_kv", {}) if k.startswith(prefix)]


class _DepFailed(Exception):
    def __init__(self, error: BaseException):
        self.error = error


def _detect_gpus() -> int:
    """The CUDA cards this process sees (``torch.cuda.device_count()``: no
    CUDA context is created); 0 without a card."""
    import torch

    return torch.cuda.device_count()


def _flush_profile_local() -> None:
    """Move any ray_tpu_torch.profile() spans into the local-runtime span log
    (no agent in-process; read back via ray_tpu_torch.profiling.local_spans())."""
    try:
        from ray_tpu_torch import profiling

        profiling.flush_local()
    except Exception:  # noqa: BLE001 - observability is best-effort
        pass
