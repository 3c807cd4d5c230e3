from ray_tpu_torch.data.execution.backpressure import (
    BackpressurePolicy,
    ConcurrencyCapBackpressurePolicy,
    DownstreamCapacityBackpressurePolicy,
    default_policies,
)
from ray_tpu_torch.data.execution.interfaces import (
    ExecutionContext,
    PhysicalOperator,
    ReadTaskSource,
    RefBundle,
)
from ray_tpu_torch.data.execution.operators import (
    ActorPoolMapOp,
    AllToAllOp,
    InputDataOp,
    LimitOp,
    OutputSplitOp,
    TaskPoolMapOp,
)
from ray_tpu_torch.data.execution.planner import build_physical_plan
from ray_tpu_torch.data.execution.resource_manager import ResourceManager
from ray_tpu_torch.data.execution.stats import OpStats, format_stats_table
from ray_tpu_torch.data.execution.streaming_executor import StreamingExecutor

__all__ = [
    "ActorPoolMapOp",
    "AllToAllOp",
    "BackpressurePolicy",
    "ConcurrencyCapBackpressurePolicy",
    "DownstreamCapacityBackpressurePolicy",
    "ExecutionContext",
    "InputDataOp",
    "LimitOp",
    "OpStats",
    "OutputSplitOp",
    "PhysicalOperator",
    "ReadTaskSource",
    "RefBundle",
    "ResourceManager",
    "StreamingExecutor",
    "TaskPoolMapOp",
    "build_physical_plan",
    "default_policies",
    "format_stats_table",
]
