from ray_tpu_torch.util.actor_pool import ActorPool
from ray_tpu_torch.util.placement_group import (
    PlacementGroup,
    get_current_placement_group,
    placement_group,
    placement_group_table,
    remove_placement_group,
)
from ray_tpu_torch.util.queue import Empty, Full, Queue

__all__ = [
    "ActorPool",
    "Empty",
    "Full",
    "PlacementGroup",
    "Queue",
    "get_current_placement_group",
    "placement_group",
    "placement_group_table",
    "remove_placement_group",
]
