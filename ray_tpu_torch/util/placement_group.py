"""Placement groups: gang reservation of resource bundles (own copy of
ray_tpu.util.placement_group).

Reference capability: python/ray/util/placement_group.py (+ GCS 2-phase
bundle reservation, src/ray/gcs/gcs_server/gcs_placement_group_*). Strategies:

- PACK / STRICT_PACK: co-locate bundles (STRICT_PACK = one node, so the
  gang's cards share one host's NVLink).
- SPREAD / STRICT_SPREAD: distribute across nodes.

The in-process runtime is one virtual node: every strategy is satisfiable
iff the bundles' total fits it.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

from ray_tpu_torch.core.ids import PlacementGroupID
from ray_tpu_torch.core.worker import require_worker

VALID_STRATEGIES = ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD")


class PlacementGroup:
    def __init__(self, pg_id: PlacementGroupID, bundles: List[Dict[str, float]], strategy: str):
        self.id = pg_id
        self._bundles = bundles
        self._strategy = strategy

    @property
    def bundle_specs(self) -> List[Dict[str, float]]:
        return list(self._bundles)

    @property
    def bundle_count(self) -> int:
        return len(self._bundles)

    @property
    def strategy(self) -> str:
        return self._strategy

    def ready(self, timeout: Optional[float] = None) -> bool:
        """Block until the group is reserved (reference: pg.ready() returns an
        ObjectRef; here it blocks directly — await-style use goes through
        wait_until_ready)."""
        w = require_worker()
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if w.runtime.placement_group_ready(self.id, timeout):
                return True
            if deadline is not None and time.monotonic() > deadline:
                return False
            time.sleep(0.01)

    def wait(self, timeout_seconds: float = 30.0) -> bool:
        return self.ready(timeout=timeout_seconds)

    def __reduce__(self):
        return (PlacementGroup, (self.id, self._bundles, self._strategy))

    def __repr__(self) -> str:
        return f"PlacementGroup(id={self.id.hex()[:16]}, {len(self._bundles)} bundles, {self._strategy})"


def placement_group(
    bundles: List[Dict[str, float]],
    strategy: str = "PACK",
    name: str = "",
    lifetime: Optional[str] = None,
) -> PlacementGroup:
    if strategy not in VALID_STRATEGIES:
        raise ValueError(f"strategy must be one of {VALID_STRATEGIES}, got {strategy!r}")
    if not bundles:
        raise ValueError("placement group requires at least one bundle")
    for b in bundles:
        if not b or any(v < 0 for v in b.values()):
            raise ValueError(f"invalid bundle: {b}")
    w = require_worker()
    pg_id = w.runtime.create_placement_group(bundles, strategy, name)
    return PlacementGroup(pg_id, bundles, strategy)


def remove_placement_group(pg: PlacementGroup) -> None:
    require_worker().runtime.remove_placement_group(pg.id)


def placement_group_table() -> Dict[str, Dict]:
    w = require_worker()
    table = getattr(w.runtime, "placement_group_table", None)
    return table() if table else {}


def get_current_placement_group() -> Optional[PlacementGroup]:
    # Set for tasks/actors scheduled with capture_child_tasks; local runtime
    # does not propagate it yet.
    return None
