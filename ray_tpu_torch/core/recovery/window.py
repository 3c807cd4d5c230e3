"""GCS-side reconstruction window.

A restarted GCS restores its snapshot, but the snapshot's object directory
is authoritative-but-stale: nodes may have died (their copies are gone) or
dropped/evicted objects while the GCS was down. Rather than trust it, the
restored locations become PROVISIONAL and the directory is rebuilt from
agent re-registration (reference: Ray GCS FT rebuilds the in-memory object
directory from raylet reports after a failover, it does not persist it).

Lifecycle:

- built by ``GcsServer._restore_snapshot`` when recovery is enabled and the
  snapshot carried any object locations;
- ``confirm(object_id, node_id)`` — every registration (single or batched)
  confirms that (object, node) pair, making it authoritative;
- ``node_registered(node_id)`` — an agent's re-register marks its node
  incarnation live this epoch;
- while the window is OPEN, lookups must not report ``lost`` (a provisional
  object with zero confirmed copies may be re-reported any moment; a
  premature loss signal would fire spurious lineage reconstructions);
- ``run(gcs)`` (spawned from ``GcsServer.start``) closes the window as soon
  as every provisional pair is confirmed or owned by a dead node, else at
  the ``gcs_reconstruction_window_s`` deadline — then SWEEPS: unconfirmed
  provisional locations are dropped (waking long-poll waiters so loss
  surfaces promptly) and provisional nodes that never re-registered are
  marked dead.
"""

from __future__ import annotations

import asyncio
import time
from typing import Dict, Set

from ray_tpu_torch.core.config import config
from ray_tpu_torch.utils.logging import get_logger

logger = get_logger("gcs_recovery")


class ReconstructionWindow:
    def __init__(self, objects: Dict[str, Dict], nodes: Dict[str, Dict]):
        # (object hex -> unconfirmed provisional holder nodes); pairs leave
        # the map as agents re-report, so "empty" means converged
        self.provisional: Dict[str, Set[str]] = {
            o: set(rec["locations"])
            for o, rec in objects.items() if rec["locations"]
        }
        # snapshot-restored live nodes that have not re-registered this epoch
        self.unconfirmed_nodes: Set[str] = {
            n for n, info in nodes.items() if info.get("Alive")
        }
        self.opened_at = time.monotonic()
        self.deadline = self.opened_at + config.gcs_reconstruction_window_s
        self.open = bool(self.provisional) or bool(self.unconfirmed_nodes)
        self.converged_in_s: float = 0.0

    def confirm(self, object_id: str, node_id: str) -> None:
        pending = self.provisional.get(object_id)
        if pending is not None:
            pending.discard(node_id)
            if not pending:
                del self.provisional[object_id]

    def node_registered(self, node_id: str) -> None:
        self.unconfirmed_nodes.discard(node_id)

    def node_dead(self, node_id: str) -> None:
        # _mark_node_dead already drops the node's directory locations;
        # nothing left for the sweep to decide about them
        self.unconfirmed_nodes.discard(node_id)
        for object_id in [o for o, pending in self.provisional.items()
                          if node_id in pending]:
            self.confirm(object_id, node_id)

    def remaining(self) -> int:
        return sum(len(p) for p in self.provisional.values())

    async def run(self, gcs) -> None:
        """Close the window on convergence or at the deadline, then sweep.
        Spawned as a named task so ``dump_stacks`` shows a wedged recovery
        as ``ReconstructionWindow.run`` with this frame."""
        try:
            while time.monotonic() < self.deadline:
                if not self.provisional and not self.unconfirmed_nodes:
                    break
                await asyncio.sleep(0.1)
        except asyncio.CancelledError:
            self.open = False  # GCS shutting down: no sweep
            raise
        self.converged_in_s = time.monotonic() - self.opened_at
        self.open = False
        await self._sweep(gcs)

    async def _sweep(self, gcs) -> None:
        stale_pairs = 0
        for object_id, pending in list(self.provisional.items()):
            rec = gcs.objects.get(object_id)
            if rec is None:
                continue
            doomed = rec["locations"] & pending
            if doomed:
                stale_pairs += len(doomed)
                rec["locations"] -= doomed
                # loss (if this was the last copy) must surface promptly so
                # waiters start lineage reconstruction instead of polling out
                gcs._wake_object_waiters(object_id)  # noqa: SLF001
        self.provisional.clear()
        dead_nodes = list(self.unconfirmed_nodes)
        self.unconfirmed_nodes.clear()
        for node_id in dead_nodes:
            logger.warning(
                "node %s never re-registered after GCS restart; marking dead",
                node_id[:8])
            await gcs._mark_node_dead(  # noqa: SLF001
                node_id, "no re-registration after GCS restart")
        if stale_pairs or dead_nodes:
            logger.info(
                "reconstruction window closed in %.2fs: dropped %d stale "
                "location(s), %d silent node(s)",
                self.converged_in_s, stale_pairs, len(dead_nodes))
        else:
            logger.info("reconstruction window converged in %.2fs",
                        self.converged_in_s)
