"""The port's copy of the JAX package's
``ray_tpu/experimental/state/__init__.py`` (imports renamed to
``ray_tpu_torch``, env vars ``RTPU_*`` to ``RTT_*``)."""

from ray_tpu_torch.experimental.state.api import (
    StateListResult, list_actors, list_jobs, list_nodes, list_objects,
    list_placement_groups, list_tasks, summarize_cluster, summarize_tasks)

__all__ = ["StateListResult", "list_actors", "list_jobs", "list_nodes",
           "list_objects", "list_placement_groups", "list_tasks",
           "summarize_cluster", "summarize_tasks"]
