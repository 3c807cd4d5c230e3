"""Actor descriptors and handles (own copy of ray_tpu.core.actor).

Reference capability: python/ray/actor.py (ActorClass._remote:869,
ActorMethod, ActorHandle) — option chaining, named/detached actors, handle
serialization, per-method num_returns overrides.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Union

from ray_tpu_torch.core.ids import ActorID, TaskID
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.core.remote_function import (
    build_resources,
    build_task_args,
    make_function_descriptor,
    resolve_strategy,
)
from ray_tpu_torch.core.task_spec import FunctionDescriptor, TaskSpec, TaskType
from ray_tpu_torch.core.worker import require_worker

_VALID_ACTOR_OPTIONS = {
    "num_cpus", "num_tpus", "num_gpus", "resources", "memory",
    "max_restarts", "max_task_retries", "max_concurrency", "max_pending_calls",
    "name", "namespace", "lifetime", "scheduling_strategy", "runtime_env",
    "placement_group", "placement_group_bundle_index", "_metadata",
}


class ActorMethod:
    def __init__(self, handle: "ActorHandle", method_name: str, num_returns: int = 1,
                 generator_backpressure: Optional[int] = None):
        self._handle = handle
        self._method_name = method_name
        self._num_returns = num_returns
        self._generator_backpressure = generator_backpressure

    def options(self, **opts) -> "ActorMethod":
        return ActorMethod(
            self._handle, self._method_name,
            num_returns=opts.get("num_returns", self._num_returns),
            generator_backpressure=opts.get(
                "_generator_backpressure", self._generator_backpressure
            ),
        )

    def remote(self, *args, **kwargs) -> Union[ObjectRef, List[ObjectRef]]:
        return self._handle._submit(
            self._method_name, args, kwargs, self._num_returns,
            generator_backpressure=self._generator_backpressure,
        )

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor method '{self._method_name}' cannot be called directly; use .remote()."
        )


class ActorHandle:
    def __init__(self, actor_id: ActorID, class_name: str, actor_options: Optional[Dict] = None):
        self._actor_id = actor_id
        self._class_name = class_name
        self._actor_options = dict(actor_options or {})

    @property
    def actor_id(self) -> ActorID:
        return self._actor_id

    def _submit(self, method_name: str, args: tuple, kwargs: dict, num_returns,
                generator_backpressure: Optional[int] = None):
        worker = require_worker()
        streaming = num_returns in ("streaming", "dynamic")
        task_id = TaskID.for_actor_task(self._actor_id)
        spec_args, spec_kwargs = build_task_args(args, kwargs)
        opts = self._actor_options
        backpressure = 0
        if streaming:
            if generator_backpressure is not None:
                backpressure = int(generator_backpressure)
            else:
                from ray_tpu_torch.core.config import config

                backpressure = int(config.generator_backpressure_items)
        spec = TaskSpec(
            task_id=task_id,
            job_id=worker.job_id,
            task_type=TaskType.ACTOR_TASK,
            name=f"{self._class_name}.{method_name}",
            function=FunctionDescriptor(module="", qualname=method_name, function_id=""),
            args=spec_args,
            kwargs=spec_kwargs,
            num_returns=1 if streaming else num_returns,
            resources=build_resources({"num_cpus": 0}, default_num_cpus=0),
            strategy=resolve_strategy({}),
            owner_worker=worker.worker_id,
            actor_id=self._actor_id,
            actor_method_name=method_name,
            max_task_retries=opts.get("max_task_retries", 0),
            max_pending_calls=opts.get("max_pending_calls", -1),
            generator=streaming,
            generator_backpressure=backpressure,
        )
        refs = worker.runtime.submit_actor_task(self._actor_id, spec, args, kwargs)
        if streaming:
            from ray_tpu_torch.core.streaming import ObjectRefGenerator

            return ObjectRefGenerator(task_id.binary().hex(), worker.runtime)
        if num_returns == 1:
            return refs[0]
        return refs

    def __getattr__(self, name: str) -> ActorMethod:
        if name.startswith("_"):
            raise AttributeError(name)
        return ActorMethod(self, name)

    def __repr__(self) -> str:
        return f"ActorHandle({self._class_name}, {self._actor_id.hex()[:16]})"

    def __hash__(self) -> int:
        return hash(self._actor_id)

    def __eq__(self, other: object) -> bool:
        return isinstance(other, ActorHandle) and other._actor_id == self._actor_id

    def __reduce__(self):
        return (ActorHandle, (self._actor_id, self._class_name, self._actor_options))


class ActorClass:
    def __init__(self, cls: type, options: Optional[Dict[str, Any]] = None):
        self._cls = cls
        self._options = dict(options or {})
        unknown = set(self._options) - _VALID_ACTOR_OPTIONS
        if unknown:
            raise ValueError(f"Invalid actor options: {sorted(unknown)}")
        self._descriptor = make_function_descriptor(cls, is_class=True)
        self.__name__ = cls.__name__
        self.__doc__ = cls.__doc__

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor class '{self.__name__}' cannot be instantiated directly; "
            f"use {self.__name__}.remote()."
        )

    def options(self, **new_options) -> "ActorClass":
        return ActorClass(self._cls, {**self._options, **new_options})

    def bind(self, *args, **kwargs):
        """Lazy DAG construction (reference: dag/class_node.py — bind builds
        a ClassNode; method .bind()s on it chain ClassMethodNodes)."""
        from ray_tpu_torch.dag import ClassNode

        return ClassNode(self, args, kwargs)

    def remote(self, *args, **kwargs) -> ActorHandle:
        worker = require_worker()
        opts = self._options
        actor_id = ActorID.of(worker.job_id)
        task_id = TaskID.for_actor_creation(actor_id)
        # Actors hold their explicit resources for their lifetime; the default
        # is zero CPUs while alive (reference semantics: 1 CPU to schedule,
        # 0 CPU held while running).
        resources = build_resources(opts, default_num_cpus=0)
        runtime_env = dict(opts.get("runtime_env") or {})
        if opts.get("name"):
            runtime_env["__actor_name__"] = opts["name"]
            runtime_env["__actor_namespace__"] = opts.get("namespace") or getattr(
                worker, "namespace", "default"
            )
        spec_args, spec_kwargs = build_task_args(args, kwargs)
        spec = TaskSpec(
            task_id=task_id,
            job_id=worker.job_id,
            task_type=TaskType.ACTOR_CREATION_TASK,
            name=f"{self.__name__}.__init__",
            function=self._descriptor,
            args=spec_args,
            kwargs=spec_kwargs,
            num_returns=1,
            resources=resources,
            strategy=resolve_strategy(opts),
            owner_worker=worker.worker_id,
            actor_id=actor_id,
            max_restarts=opts.get("max_restarts", 0),
            max_task_retries=opts.get("max_task_retries", 0),
            max_concurrency=opts.get("max_concurrency", 1),
            max_pending_calls=opts.get("max_pending_calls", -1),
            runtime_env=runtime_env,
        )
        worker.runtime.create_actor(spec, self._cls, args, kwargs)
        return ActorHandle(actor_id, self.__name__, actor_options=opts)


def method(**options):
    """@ray_tpu_torch.method(num_returns=...) decorator for actor methods."""

    def decorator(fn):
        fn.__ray_tpu_method_options__ = options
        return fn

    return decorator
