"""Task and actor specifications — the unit the scheduler and lineage store
operate on (reference capability: src/ray/common/task/task_spec.h and
protobuf/common.proto TaskSpec)."""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.core.ids import ActorID, JobID, NodeID, ObjectID, PlacementGroupID, TaskID, WorkerID
from ray_tpu_torch.core.resources import ResourceSet, SchedulingStrategy


class TaskType(Enum):
    NORMAL_TASK = 0
    ACTOR_CREATION_TASK = 1
    ACTOR_TASK = 2
    DRIVER_TASK = 3


@dataclass
class FunctionDescriptor:
    """Identifies user code. In cluster mode the pickled payload is exported
    once to the control-service KV (keyed by function_id) and loaded on demand
    by workers (reference: FunctionManager / fun-table in GCS KV)."""

    module: str
    qualname: str
    function_id: str  # sha1 of the pickled payload
    is_class: bool = False

    @property
    def repr_name(self) -> str:
        return f"{self.module}.{self.qualname}"


@dataclass
class TaskArg:
    """Either an inlined serialized value or an ObjectRef dependency."""

    is_ref: bool
    object_id: Optional[ObjectID] = None
    owner_hint: Optional[str] = None
    value: Any = None  # inlined (already-serialized in cluster mode)


@dataclass
class SchedulingClass:
    """Tasks with equal (resources, strategy, function) share worker leases
    (reference: SchedulingKey in transport/normal_task_submitter.h:53)."""

    resources_key: Tuple[Tuple[str, float], ...]
    strategy_key: str
    function_id: str

    @classmethod
    def of(cls, resources: ResourceSet, strategy: SchedulingStrategy, function_id: str) -> "SchedulingClass":
        return cls(tuple(sorted(resources.items())), repr(strategy), function_id)

    def __hash__(self) -> int:
        return hash((self.resources_key, self.strategy_key, self.function_id))


@dataclass
class TaskSpec:
    task_id: TaskID
    job_id: JobID
    task_type: TaskType
    name: str
    function: FunctionDescriptor
    args: List[TaskArg]
    kwargs: Dict[str, "TaskArg"]
    num_returns: int
    resources: ResourceSet
    strategy: SchedulingStrategy
    # ownership
    owner_worker: Optional[WorkerID] = None
    owner_node: Optional[NodeID] = None
    # fault tolerance
    max_retries: int = 0
    retry_exceptions: bool = False
    # actor fields
    actor_id: Optional[ActorID] = None
    actor_method_name: str = ""
    actor_seq_no: int = -1
    max_restarts: int = 0
    max_task_retries: int = 0
    max_concurrency: int = 1
    max_pending_calls: int = -1
    # environment / placement
    runtime_env: Optional[Dict[str, Any]] = None
    placement_group_id: Optional[PlacementGroupID] = None
    bundle_index: int = -1
    # observability
    submitted_at: float = field(default_factory=time.time)
    # streaming generators (num_returns="streaming"): yield items sealed
    # one at a time; backpressure = max unconsumed items before the producer
    # blocks (0 = unlimited)
    generator: bool = False
    generator_backpressure: int = 0

    def return_ids(self) -> List[ObjectID]:
        return [ObjectID.for_task_return(self.task_id, i + 1) for i in range(self.num_returns)]

    def dependencies(self) -> List[ObjectID]:
        deps = [a.object_id for a in self.args if a.is_ref and a.object_id is not None]
        deps += [a.object_id for a in self.kwargs.values() if a.is_ref and a.object_id is not None]
        return deps

    def scheduling_class(self) -> SchedulingClass:
        return SchedulingClass.of(self.resources, self.strategy, self.function.function_id)
