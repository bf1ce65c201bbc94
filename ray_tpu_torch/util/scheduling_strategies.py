"""User-facing scheduling strategies.

Reference analogue: python/ray/util/scheduling_strategies.py
(PlacementGroupSchedulingStrategy, NodeAffinitySchedulingStrategy).
Copied from the JAX package's ``ray_tpu/util/scheduling_strategies.py``
without its TPU-slice strategy.
"""

from __future__ import annotations


class PlacementGroupSchedulingStrategy:
    def __init__(self, placement_group,
                 placement_group_bundle_index: int = -1,
                 placement_group_capture_child_tasks: bool = False):
        self.placement_group = placement_group
        self.placement_group_bundle_index = \
            0 if placement_group_bundle_index < 0 \
            else placement_group_bundle_index
        self.placement_group_capture_child_tasks = \
            placement_group_capture_child_tasks


class NodeAffinitySchedulingStrategy:
    def __init__(self, node_id: str, soft: bool = False):
        self.node_id = node_id
        self.soft = soft


SPREAD = "SPREAD"
DEFAULT = "DEFAULT"
