"""Public API: init/remote/get/put/wait and friends (own copy of
ray_tpu.api).

Reference capability: python/ray/_private/worker.py:1260 (init), :2617 (get),
:2785 (put), :2850 (wait), :3031 (kill), :3062 (cancel), :3239 (remote) —
over the port's two CoreRuntime backends (in-process, and a driver
connected to a cluster), with ``GPU`` as the accelerator.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict, List, Optional, Sequence, Union

from ray_tpu_torch.core.actor import ActorClass, ActorHandle
from ray_tpu_torch.core.ids import JobID
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.core.remote_function import RemoteFunction
from ray_tpu_torch.core.worker import Worker, global_worker, require_worker, set_global_worker
from ray_tpu_torch.utils.logging import get_logger

logger = get_logger("api")
_init_lock = threading.RLock()


def init(
    address: Optional[str] = None,
    *,
    num_cpus: Optional[int] = None,
    num_gpus: Optional[int] = None,
    resources: Optional[Dict[str, float]] = None,
    namespace: Optional[str] = None,
    system_config: Optional[Dict[str, Any]] = None,
    ignore_reinit_error: bool = False,
    log_to_driver: bool = True,
    _node_config: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Start (or connect to) a ray_tpu_torch runtime.

    - ``address=None`` / ``"local"``: in-process LocalRuntime, with
      ``num_gpus`` cards (``None``: ``torch.cuda.device_count()``).
    - ``address="host:port"`` (a ``Cluster``'s ``gcs_address``, or one
      exported in ``RAY_TPU_ADDRESS``), optionally ``client://host:port``:
      connect as a driver to a running cluster of the port
      (``ray_tpu_torch.cluster``); the cluster's nodes own the resources.
    """
    with _init_lock:
        if global_worker() is not None:
            if ignore_reinit_error:
                return {"address": "existing"}
            raise RuntimeError("ray_tpu_torch.init() called twice; pass ignore_reinit_error=True")
        from ray_tpu_torch.core.config import config

        config.apply_overrides(system_config)
        if address is None:
            # submitted jobs export the cluster address; init() then
            # auto-connects like the reference's RAY_ADDRESS behavior
            address = os.environ.get("RAY_TPU_ADDRESS") or None
        if address in (None, "local"):
            from ray_tpu_torch.core.local_runtime import LocalRuntime

            runtime = LocalRuntime(num_cpus=num_cpus, num_gpus=num_gpus, resources=resources)
            worker = Worker(runtime, JobID.from_int(1), node_id=runtime.node_id, is_driver=True)
        else:
            from ray_tpu_torch.core.cluster_runtime import connect_driver

            runtime, worker = connect_driver(address, namespace=namespace,
                                             log_to_driver=log_to_driver)
        worker.namespace = namespace or "default"
        runtime_ref = runtime
        worker.ref_counter.set_on_zero(lambda oid: runtime_ref.release(oid))
        set_global_worker(worker)
        return {
            "address": address or "local",
            "node_id": worker.node_id.hex(),
            "namespace": worker.namespace,
        }


def is_initialized() -> bool:
    return global_worker() is not None


def shutdown() -> None:
    with _init_lock:
        w = global_worker()
        if w is None:
            return
        try:
            w.runtime.shutdown()
        finally:
            set_global_worker(None)


def remote(*args, **options):
    """``@remote`` / ``@remote(**options)`` for functions and classes."""
    if len(args) == 1 and not options and callable(args[0]):
        target = args[0]
        if isinstance(target, type):
            return ActorClass(target)
        return RemoteFunction(target)
    if args:
        raise TypeError("@remote takes keyword options only, e.g. @remote(num_cpus=2)")

    def decorator(target):
        if isinstance(target, type):
            return ActorClass(target, options)
        return RemoteFunction(target, options)

    return decorator


def put(value: Any) -> ObjectRef:
    if isinstance(value, ObjectRef):
        raise TypeError("Calling put() on an ObjectRef is not allowed")
    return require_worker().runtime.put(value)


def get(
    refs: Union[ObjectRef, Sequence[ObjectRef]],
    *,
    timeout: Optional[float] = None,
) -> Any:
    w = require_worker()
    single = isinstance(refs, ObjectRef)
    ref_list = [refs] if single else list(refs)
    for r in ref_list:
        if not isinstance(r, ObjectRef):
            raise TypeError(f"get() expects ObjectRef(s), got {type(r).__name__}")
    values = w.runtime.get(ref_list, timeout)
    return values[0] if single else values


def wait(
    refs: Sequence[ObjectRef],
    *,
    num_returns: int = 1,
    timeout: Optional[float] = None,
    fetch_local: bool = True,
):
    if isinstance(refs, ObjectRef):
        raise TypeError("wait() expects a list of ObjectRefs")
    refs = list(refs)
    if len(set(refs)) != len(refs):
        raise ValueError("wait() got duplicate ObjectRefs")
    if num_returns <= 0 or num_returns > len(refs):
        raise ValueError(f"num_returns must be in [1, {len(refs)}]")
    return require_worker().runtime.wait(refs, num_returns, timeout, fetch_local)


def kill(actor: ActorHandle, *, no_restart: bool = True) -> None:
    if not isinstance(actor, ActorHandle):
        raise TypeError("kill() expects an ActorHandle")
    require_worker().runtime.kill_actor(actor.actor_id, no_restart)


def cancel(ref: ObjectRef, *, force: bool = False, recursive: bool = True) -> None:
    require_worker().runtime.cancel(ref, force, recursive)


def free(refs: Sequence[ObjectRef]) -> None:
    if isinstance(refs, ObjectRef):
        refs = [refs]
    require_worker().runtime.free(list(refs))


def get_actor(name: str, namespace: Optional[str] = None) -> ActorHandle:
    w = require_worker()
    actor_id = w.runtime.get_named_actor(name, namespace or getattr(w, "namespace", "default"))
    return ActorHandle(actor_id, name)


def list_named_actors(all_namespaces: bool = False) -> List[str]:
    w = require_worker()
    return w.runtime.list_named_actors(
        all_namespaces, namespace=getattr(w, "namespace", "default")
    )


def nodes() -> List[Dict[str, Any]]:
    return require_worker().runtime.nodes()


def cluster_resources() -> Dict[str, float]:
    return require_worker().runtime.cluster_resources()


def available_resources() -> Dict[str, float]:
    return require_worker().runtime.available_resources()


class RuntimeContext:
    def __init__(self, worker: Worker):
        self._worker = worker

    def get_job_id(self) -> str:
        return self._worker.job_id.hex()

    def get_node_id(self) -> str:
        return self._worker.node_id.hex()

    def get_worker_id(self) -> str:
        return self._worker.worker_id.hex()

    def get_task_id(self) -> Optional[str]:
        tid = self._worker.current_task_id
        return tid.hex() if tid else None

    def get_actor_id(self) -> Optional[str]:
        aid = self._worker.current_actor_id
        return aid.hex() if aid else None

    def get_task_name(self) -> str:
        return self._worker.current_task_name

    @property
    def namespace(self) -> str:
        return getattr(self._worker, "namespace", "default")

    def get_accelerator_ids(self) -> Dict[str, List[str]]:
        from ray_tpu_torch.core.resources import GPU

        n = int(self._worker.runtime.cluster_resources().get(GPU, 0))
        return {GPU: [str(i) for i in range(n)]}


def get_runtime_context() -> RuntimeContext:
    return RuntimeContext(require_worker())


# Internal KV (reference: ray.experimental.internal_kv)
def kv_put(key: str, value: bytes) -> None:
    require_worker().runtime.kv_put(key, value)


def kv_get(key: str) -> Optional[bytes]:
    return require_worker().runtime.kv_get(key)


def kv_del(key: str) -> None:
    require_worker().runtime.kv_del(key)


def kv_keys(prefix: str = "") -> List[str]:
    return require_worker().runtime.kv_keys(prefix)
