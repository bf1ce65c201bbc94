"""ray_tpu_torch.util — the runtime's user utilities (reference:
python/ray/util/)."""

from ray_tpu_torch.util.actor_pool import ActorPool
from ray_tpu_torch.util.placement_group import (PlacementGroup,
                                                placement_group,
                                                placement_group_table,
                                                remove_placement_group)
from ray_tpu_torch.util.queue import Empty, Full, Queue
from ray_tpu_torch.util.scheduling_strategies import (
    NodeAffinitySchedulingStrategy, PlacementGroupSchedulingStrategy)

__all__ = [
    "ActorPool", "Queue", "Empty", "Full", "placement_group",
    "PlacementGroup", "remove_placement_group", "placement_group_table",
    "PlacementGroupSchedulingStrategy", "NodeAffinitySchedulingStrategy",
]
