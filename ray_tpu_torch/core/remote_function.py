"""@ray_tpu_torch.remote function descriptors (own copy of
ray_tpu.core.remote_function; ``num_gpus`` is the accelerator's name).

Reference capability: python/ray/remote_function.py (RemoteFunction._remote →
core_worker.submit_task) — option validation, ``.options()`` chaining, task
spec construction with ownership + retry metadata.
"""

from __future__ import annotations

import hashlib
import threading
import weakref
from typing import Any, Dict, List, Optional, Union

import cloudpickle

from ray_tpu_torch.core.ids import TaskID
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.core.resources import (
    CPU,
    GPU,
    MEMORY,
    TPU,
    DefaultSchedulingStrategy,
    PlacementGroupSchedulingStrategy,
    ResourceSet,
    SchedulingStrategy,
)
from ray_tpu_torch.core.task_spec import FunctionDescriptor, TaskArg, TaskSpec, TaskType
from ray_tpu_torch.core.worker import require_worker

_VALID_TASK_OPTIONS = {
    "num_cpus", "num_tpus", "num_gpus", "resources", "memory", "num_returns",
    "max_retries", "retry_exceptions", "name", "scheduling_strategy",
    "runtime_env", "placement_group", "placement_group_bundle_index",
    "max_calls", "_metadata", "_generator_backpressure",
}

# Keyed by a weak reference to the function object itself: the cache entry
# dies with the function, so a new function that CPython allocates at a
# recycled id() can never inherit a dead function's descriptor (which would
# make workers silently execute the wrong code).
_fd_cache: "weakref.WeakKeyDictionary[Any, FunctionDescriptor]" = weakref.WeakKeyDictionary()
_fd_lock = threading.Lock()


def make_function_descriptor(func: Any, is_class: bool = False) -> FunctionDescriptor:
    try:
        with _fd_lock:
            fd = _fd_cache.get(func)
        if fd is not None:
            return fd
        cacheable = True
    except TypeError:
        cacheable = False  # unhashable/non-weakrefable callable: skip caching
    try:
        payload = cloudpickle.dumps(func)
        fid = hashlib.sha1(payload).hexdigest()
    except Exception:
        fid = hashlib.sha1(repr(func).encode()).hexdigest()
    fd = FunctionDescriptor(
        module=getattr(func, "__module__", "") or "",
        qualname=getattr(func, "__qualname__", repr(func)),
        function_id=fid,
        is_class=is_class,
    )
    if cacheable:
        try:
            with _fd_lock:
                _fd_cache[func] = fd
        except TypeError:
            pass
    return fd


def build_resources(options: Dict[str, Any], default_num_cpus: float = 1.0) -> ResourceSet:
    res = ResourceSet()
    num_cpus = options.get("num_cpus")
    res[CPU] = float(default_num_cpus if num_cpus is None else num_cpus)
    if res.get(CPU) == 0:
        res.pop(CPU, None)
    # num_tpus accepted as an alias for GPUs so code written against the
    # JAX package ports over; GPU is the native name.
    num_gpus = options.get("num_gpus", options.get("num_tpus"))
    if num_gpus:
        res[GPU] = float(num_gpus)
    if options.get("memory"):
        res[MEMORY] = float(options["memory"])
    for k, v in (options.get("resources") or {}).items():
        if k in (CPU, GPU, TPU):
            raise ValueError(f"Pass {k} via num_cpus/num_gpus, not resources=")
        res[k] = float(v)
    return res


def resolve_strategy(options: Dict[str, Any]) -> SchedulingStrategy:
    strat = options.get("scheduling_strategy")
    if strat is None:
        pg = options.get("placement_group")
        if pg is not None:
            return PlacementGroupSchedulingStrategy(
                placement_group=pg,
                placement_group_bundle_index=options.get("placement_group_bundle_index", -1),
            )
        return DefaultSchedulingStrategy()
    if isinstance(strat, str):
        if strat == "SPREAD":
            from ray_tpu_torch.core.resources import SpreadSchedulingStrategy

            return SpreadSchedulingStrategy()
        if strat == "DEFAULT":
            return DefaultSchedulingStrategy()
        raise ValueError(f"Unknown scheduling_strategy string: {strat}")
    return strat


def build_task_args(args: tuple, kwargs: dict) -> tuple[List[TaskArg], Dict[str, TaskArg]]:
    def conv(v: Any) -> TaskArg:
        if isinstance(v, ObjectRef):
            return TaskArg(is_ref=True, object_id=v.id, owner_hint=v.owner_hint)
        return TaskArg(is_ref=False, value=None)

    return [conv(a) for a in args], {k: conv(v) for k, v in kwargs.items()}


class RemoteFunction:
    def __init__(self, func, options: Optional[Dict[str, Any]] = None):
        self._function = func
        self._options = dict(options or {})
        unknown = set(self._options) - _VALID_TASK_OPTIONS
        if unknown:
            raise ValueError(f"Invalid @remote options: {sorted(unknown)}")
        self._descriptor = make_function_descriptor(func)
        self.__name__ = getattr(func, "__name__", "remote_function")
        self.__doc__ = getattr(func, "__doc__", None)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Remote function '{self.__name__}' cannot be called directly; "
            f"use {self.__name__}.remote()."
        )

    def options(self, **new_options) -> "RemoteFunction":
        merged = {**self._options, **new_options}
        return RemoteFunction(self._function, merged)

    def bind(self, *args, **kwargs):
        """Lazy DAG construction (reference: dag/function_node.py — bind
        builds a FunctionNode; nothing executes until dag.execute())."""
        from ray_tpu_torch.dag import FunctionNode

        return FunctionNode(self, args, kwargs)

    def remote(self, *args, **kwargs) -> Union[ObjectRef, List[ObjectRef], "Any"]:
        worker = require_worker()
        opts = self._options
        num_returns = opts.get("num_returns", 1)
        streaming = num_returns in ("streaming", "dynamic")
        task_id = TaskID.for_normal_task(worker.job_id)
        spec_args, spec_kwargs = build_task_args(args, kwargs)
        from ray_tpu_torch.core.config import config

        max_retries = opts.get("max_retries")
        if max_retries is None:
            max_retries = config.task_max_retries_default
        backpressure = 0
        if streaming:
            backpressure = int(
                opts.get("_generator_backpressure", config.generator_backpressure_items)
            )
        spec = TaskSpec(
            task_id=task_id,
            job_id=worker.job_id,
            task_type=TaskType.NORMAL_TASK,
            name=opts.get("name") or self._descriptor.repr_name,
            function=self._descriptor,
            args=spec_args,
            kwargs=spec_kwargs,
            num_returns=1 if streaming else num_returns,
            resources=build_resources(opts),
            strategy=resolve_strategy(opts),
            owner_worker=worker.worker_id,
            max_retries=max_retries,
            retry_exceptions=bool(opts.get("retry_exceptions", False)),
            runtime_env=opts.get("runtime_env"),
            generator=streaming,
            generator_backpressure=backpressure,
        )
        refs = worker.runtime.submit_task(spec, self._function, args, kwargs)
        if streaming:
            from ray_tpu_torch.core.streaming import ObjectRefGenerator

            return ObjectRefGenerator(task_id.binary().hex(), worker.runtime)
        if num_returns == 1:
            return refs[0]
        return refs
