"""Resource sets and scheduling strategies (own copy of
ray_tpu.core.resources).

Reference capability: src/ray/common/scheduling/ (ResourceRequest,
ResourceSet) + python/ray/util/scheduling_strategies.py. ``GPU`` cards are
the accelerator resource, alongside CPU/memory, where the JAX package
counts ``TPU`` chips. Its ``SliceSchedulingStrategy`` (ICI-domain gang
placement) has no counterpart; a GPU node's labels (its card's name, its
host as the slice) come from ``core/accelerators.py``, and the GCS keeps a
``STRICT_PACK`` gang on one slice.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

CPU = "CPU"
GPU = "GPU"
# The JAX package's accelerator name: accepted as ``num_tpus=`` (an alias of
# ``num_gpus=``) so reference-shaped code ports over, never as a resource.
TPU = "TPU"
MEMORY = "memory"
OBJECT_STORE_MEMORY = "object_store_memory"


class ResourceSet(dict):
    """A {resource_name: quantity} multiset with arithmetic and feasibility."""

    def __init__(self, items: Optional[Dict[str, float]] = None):
        super().__init__()
        for k, v in (items or {}).items():
            if v:
                self[k] = float(v)

    def copy(self) -> "ResourceSet":
        return ResourceSet(self)

    def is_subset_of(self, other: "ResourceSet") -> bool:
        return all(other.get(k, 0.0) + 1e-9 >= v for k, v in self.items())

    def add(self, other: Dict[str, float]) -> None:
        for k, v in other.items():
            self[k] = self.get(k, 0.0) + v
            if abs(self[k]) < 1e-9:
                del self[k]

    def subtract(self, other: Dict[str, float]) -> None:
        for k, v in other.items():
            self[k] = self.get(k, 0.0) - v
            if abs(self[k]) < 1e-9:
                del self[k]

    def utilization(self, total: "ResourceSet") -> float:
        """Max over resources of used/total (used = total - self-as-available)."""
        util = 0.0
        for k, tot in total.items():
            if tot <= 0:
                continue
            avail = self.get(k, 0.0)
            util = max(util, (tot - avail) / tot)
        return util


@dataclass
class SchedulingStrategy:
    """Base: default hybrid pack-then-spread."""


@dataclass
class DefaultSchedulingStrategy(SchedulingStrategy):
    pass


@dataclass
class SpreadSchedulingStrategy(SchedulingStrategy):
    """Round-robin over feasible nodes (reference: spread_scheduling_policy.h)."""


@dataclass
class NodeAffinitySchedulingStrategy(SchedulingStrategy):
    node_id: str = ""
    soft: bool = False


@dataclass
class NodeLabelSchedulingStrategy(SchedulingStrategy):
    hard: Dict[str, str] = field(default_factory=dict)
    soft: Dict[str, str] = field(default_factory=dict)


@dataclass
class PlacementGroupSchedulingStrategy(SchedulingStrategy):
    placement_group: object = None
    placement_group_bundle_index: int = -1
    placement_group_capture_child_tasks: bool = False
