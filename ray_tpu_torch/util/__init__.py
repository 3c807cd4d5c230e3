from ray_tpu_torch.util.placement_group import (
    PlacementGroup,
    get_current_placement_group,
    placement_group,
    placement_group_table,
    remove_placement_group,
)

__all__ = [
    "PlacementGroup",
    "get_current_placement_group",
    "placement_group",
    "placement_group_table",
    "remove_placement_group",
]
