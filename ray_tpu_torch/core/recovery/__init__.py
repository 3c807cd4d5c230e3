"""GCS crash-restart recovery subsystem.

Three cooperating pieces, one per control-plane tier (see DESIGN.md):

- ``window``   — GCS-side: the post-restart reconstruction window that
  treats snapshot-restored object locations as provisional until the
  holding agent re-reports them (and drops the rest at the deadline).
- ``resync``   — agent-side: full re-registration after a GCS epoch bump
  (node, every sealed local object, live actors, in-progress task pins).
- ``envelope`` — driver-side: the epoch-aware park-and-retry envelope for
  control RPCs plus the sealed-channel catch-up after a reconnect.
"""

from ray_tpu_torch.core.recovery.envelope import RetryEnvelope
from ray_tpu_torch.core.recovery.resync import full_resync, trigger_resync
from ray_tpu_torch.core.recovery.window import ReconstructionWindow

__all__ = [
    "ReconstructionWindow",
    "RetryEnvelope",
    "full_resync",
    "trigger_resync",
]
