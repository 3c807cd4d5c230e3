"""Streaming distributed shuffle subsystem on the raw-frame data plane.

Reference capability: Exoshuffle (shuffle as a library over a generic
object store) + the push/pull hybrid architecture of Magnet. The subsystem
replaces the ``AllToAllOp`` barrier for sort / groupby / repartition /
random_shuffle:

- ``spec.ShuffleSpec``: the partition functions of one exchange (map-side
  split, reduce-side combine, optional boundary-sampling plan), shared by
  the streaming operators AND the legacy barrier path so A/B runs produce
  identical data;
- ``coordinator.ShuffleCoordinator``: the driver-side partition table —
  which map produced which per-reducer block, admission accounting, and
  per-shuffle stats (bytes exchanged, spill, admission stalls);
- ``operators.ShuffleMapOp`` / ``ShuffleReduceOp``: the physical operators
  the planner compiles shuffle stages into when
  ``config.streaming_shuffle_enabled()`` (env ``RTPU_STREAMING_SHUFFLE=0``
  falls back to the barrier exchange).
"""

from ray_tpu_torch.data.shuffle.coordinator import ShuffleCoordinator
from ray_tpu_torch.data.shuffle.operators import ShuffleMapOp, ShuffleReduceOp
from ray_tpu_torch.data.shuffle.spec import ShuffleSpec

__all__ = [
    "ShuffleCoordinator",
    "ShuffleMapOp",
    "ShuffleReduceOp",
    "ShuffleSpec",
]
