"""Placement group user API.

Reference analogue: python/ray/util/placement_group.py (placement_group():128)
backed by the GCS 2-phase bundle commit (gcs_placement_group_scheduler.cc).
A STRICT_PACK group over TPU bundles lands all bundles on one host; gang
scheduling across a slice uses one bundle per host with SPREAD/STRICT_SPREAD.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

from ray_tpu_torch._private.worker import ObjectRef, global_worker
from ray_tpu_torch.common.ids import PlacementGroupID


class PlacementGroup:
    def __init__(self, id_hex: str, bundles: List[Dict[str, float]],
                 strategy: str, name: str = ""):
        self.id_hex = id_hex
        self.bundles = bundles
        self.strategy = strategy
        self.name = name

    @property
    def bundle_count(self) -> int:
        return len(self.bundles)

    @property
    def bundle_specs(self) -> List[Dict[str, float]]:
        return list(self.bundles)

    def ready(self, timeout: float = 60.0) -> bool:
        w = global_worker()
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            info = w.call_sync(w.gcs, "get_placement_group",
                               {"pg_id": self.id_hex})
            if info.get("state") == "CREATED":
                return True
            if info.get("error"):
                return False
            time.sleep(0.05)
        return False

    def wait(self, timeout_seconds: float = 30.0) -> bool:
        return self.ready(timeout=timeout_seconds)


def placement_group(bundles: List[Dict[str, float]],
                    strategy: str = "PACK",
                    name: str = "",
                    lifetime: Optional[str] = None) -> PlacementGroup:
    if strategy not in ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD"):
        raise ValueError(f"invalid strategy {strategy}")
    for b in bundles:
        if not b or any(v < 0 for v in b.values()):
            raise ValueError(f"invalid bundle {b}")
    w = global_worker()
    pg_id = PlacementGroupID.of(w.job_id).hex()
    w.call_sync(w.gcs, "create_placement_group", {
        "pg_id": pg_id, "bundles": bundles, "strategy": strategy,
        "name": name, "lifetime": lifetime})
    return PlacementGroup(pg_id, bundles, strategy, name)


def remove_placement_group(pg: PlacementGroup):
    w = global_worker()
    w.call_sync(w.gcs, "remove_placement_group", {"pg_id": pg.id_hex})


def get_placement_group(name: str) -> PlacementGroup:
    w = global_worker()
    pgs = w.call_sync(w.gcs, "list_placement_groups", {})
    for info in pgs:
        if info.get("name") == name:
            return PlacementGroup(info["pg_id"], info["bundles"],
                                  info["strategy"], name)
    raise ValueError(f"no placement group named {name!r}")


def placement_group_table() -> List[Dict]:
    w = global_worker()
    return w.call_sync(w.gcs, "list_placement_groups", {})
