"""Logical plan -> physical operator compilation (reference:
python/ray/data/_internal/planner/planner.py: logical operators map 1:1
onto physical operators).

All-to-all stages now compile two ways:

- streaming (default): a ``ShuffleMapOp`` + ``ShuffleReduceOp`` pair
  sharing one ``ShuffleCoordinator`` — map-side partitioner tasks run as
  each upstream block lands, reduce admission is spill-aware
  (``ray_tpu_torch/data/shuffle/``);
- barrier (``RTPU_STREAMING_SHUFFLE=0``, or stages with no ShuffleSpec —
  zip, keyless aggregate): the stage's ``execute()`` bulk exchange behind
  an ``AllToAllOp``.
"""

from __future__ import annotations

from typing import Any, List, Optional

from ray_tpu_torch.data.execution.interfaces import PhysicalOperator, ReadTaskSource
from ray_tpu_torch.data.execution.operators import (
    ActorPoolMapOp,
    AllToAllOp,
    InputDataOp,
    LimitOp,
    OutputSplitOp,
    TaskPoolMapOp,
)


def build_physical_plan(source: Any, stages: List[Any],
                        output_split: Optional[int] = None,
                        equal_split: bool = True) -> List[PhysicalOperator]:
    """``source`` is a ReadTaskSource or a callable returning a ref
    iterator (Dataset._source_fn); ``stages`` are the logical stages from
    ``ray_tpu_torch.data.executor``."""
    from ray_tpu_torch.core.config import streaming_shuffle_enabled
    from ray_tpu_torch.data.executor import LimitStage, MapStage

    ops: List[PhysicalOperator] = [InputDataOp(source)]
    # upstream block-count estimate, threaded through the plan so a shuffle
    # can fix its reducer count BEFORE the first block arrives (streaming
    # mapping needs num_returns up front); map stages are 1:1, a limit only
    # truncates, so the hint stays a sound upper bound
    block_hint: Optional[int] = (
        len(source) if isinstance(source, ReadTaskSource) else None)
    for stage in stages:
        if isinstance(stage, MapStage):
            if stage.fn_constructor is not None:
                ops.append(ActorPoolMapOp(
                    stage.name, stage.block_fn, stage.fn_constructor,
                    concurrency=stage.concurrency, num_cpus=stage.num_cpus,
                ))
            else:
                ops.append(TaskPoolMapOp(
                    stage.name, stage.block_fn, num_cpus=stage.num_cpus,
                    concurrency=stage.concurrency,
                ))
        elif isinstance(stage, LimitStage):
            ops.append(LimitOp(stage.limit))
        else:
            spec = stage.shuffle_spec() if hasattr(stage, "shuffle_spec") \
                else None
            if spec is not None and streaming_shuffle_enabled():
                from ray_tpu_torch.data.shuffle import (
                    ShuffleCoordinator,
                    ShuffleMapOp,
                    ShuffleReduceOp,
                )

                n_out = spec.resolve_partitions(block_hint)
                coord = ShuffleCoordinator(spec.name, n_out)
                ops.append(ShuffleMapOp(spec, coord))
                ops.append(ShuffleReduceOp(spec, coord))
                block_hint = n_out
            else:
                # zip / keyless aggregate / explicit barrier fallback: the
                # stage's execute() IS the bulk exchange
                ops.append(AllToAllOp(stage.name, stage.execute))
                block_hint = None
    if output_split is not None:
        ops.append(OutputSplitOp(output_split, equal=equal_split))
    return ops
