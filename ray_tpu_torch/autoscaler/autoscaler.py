"""StandardAutoscaler — demand-driven node scaling.

Reference analogue: autoscaler/_private/autoscaler.py:167 (update:358)
+ load_metrics.py + resource_demand_scheduler.py: read load from the
GCS, bin-pack outstanding demand (explicit ``request_resources`` +
utilization pressure) against ``available_node_types``, launch or
terminate through the NodeProvider plugin.

GPU note: a node type with ``{"GPU": 8, ...}`` resources scales whole
multi-GPU hosts — the provider is handed the full node_config so a real
provider (``gcp_gpu``, ``aws``, ...) requests the machine type at once.

Copied from the JAX package's ``ray_tpu/autoscaler/autoscaler.py``.
Differences:

* ``request_resources`` bundles are packed against each node's TOTAL
  resources (and a pending launch's node type), not its available ones:
  the request says what the cluster must be able to hold, so a request
  that running work already uses is met (Ray's ``sdk.request_resources``
  rule). JAX's packing counts it as unmet, launches a node for it that
  sits idle, reaps it, and launches it again while the request stands.
* ``AutoscalerMonitor`` counts the updates that raised and keeps the
  last exception (``failed_updates``, ``last_error``), where JAX's loop
  swallows them unseen.
"""

from __future__ import annotations

import json
import math
import time
from typing import Any, Dict, List, Optional

from ray_tpu_torch.autoscaler.node_provider import NodeProvider

_REQUEST_KEY = "@autoscaler/resource_requests"


def request_resources(bundles: List[Dict[str, float]]):
    """Explicit demand hint (reference:
    autoscaler/sdk.request_resources)."""
    import ray_tpu_torch
    w = ray_tpu_torch._worker_mod.global_worker()
    w.call_sync(w.gcs, "kv_put",
                {"key": _REQUEST_KEY,
                 "value": json.dumps(bundles).encode(),
                 "overwrite": True}, timeout=30)


class LoadMetrics:
    """Cluster load snapshot pulled from the GCS."""

    def __init__(self, gcs_call):
        self._call = gcs_call

    def snapshot(self) -> Dict[str, Any]:
        nodes = self._call("get_nodes", {})
        reqs_raw = self._call("kv_get",
                              {"key": _REQUEST_KEY}).get("value")
        requests = json.loads(reqs_raw) if reqs_raw else []
        return {"nodes": [n for n in nodes if n.get("alive")],
                "resource_requests": requests}


class StandardAutoscaler:
    """One `update()` per tick: launch for unmet demand, reap idle."""

    def __init__(self, provider: NodeProvider,
                 available_node_types: Dict[str, Dict[str, Any]],
                 gcs_call,
                 idle_timeout_s: float = 60.0,
                 max_launch_batch: int = 4):
        self.provider = provider
        self.node_types = available_node_types
        self.load_metrics = LoadMetrics(gcs_call)
        self.idle_timeout_s = idle_timeout_s
        self.max_launch_batch = max_launch_batch
        self._idle_since: Dict[str, float] = {}
        self._launched_type: Dict[str, str] = {}
        # node_id -> launch time; counts as capacity until it registers
        # in the GCS (or times out), so booting nodes aren't re-launched
        # for the same demand every tick
        self._pending_launches: Dict[str, float] = {}
        self.launch_timeout_s = 180.0

    # ---- demand math ----

    @staticmethod
    def _fits(bundle: Dict[str, float],
              free: Dict[str, float]) -> bool:
        return all(free.get(k, 0.0) >= v for k, v in bundle.items())

    @staticmethod
    def _sub(free: Dict[str, float], bundle: Dict[str, float]):
        for k, v in bundle.items():
            free[k] = free.get(k, 0.0) - v

    def _unmet_demand(self, snapshot) -> List[Dict[str, float]]:
        """Bundles that don't fit in the cluster's total capacity
        (including capacity of launched-but-not-yet-registered nodes).
        Totals, not what is free: a request is the shape the cluster
        must hold, and work already running inside it is part of it."""
        free_per_node = [dict(n.get("resources") or {})
                         for n in snapshot["nodes"]]
        registered = {n["node_id"] for n in snapshot["nodes"]}
        now = time.time()
        for nid, t0 in list(self._pending_launches.items()):
            if nid in registered or now - t0 > self.launch_timeout_s:
                del self._pending_launches[nid]
                continue
            tname = self._launched_type.get(nid)
            res = (self.node_types.get(tname, {}).get("resources")
                   or {})
            free_per_node.append(dict(res))
        unmet = []
        for bundle in snapshot["resource_requests"]:
            placed = False
            for free in free_per_node:
                if self._fits(bundle, free):
                    self._sub(free, bundle)
                    placed = True
                    break
            if not placed:
                unmet.append(dict(bundle))
        return unmet

    def _plan_launches(self, unmet: List[Dict[str, float]]
                       ) -> Dict[str, int]:
        """Greedy bin-pack of unmet bundles onto new node instances
        (reference: resource_demand_scheduler.get_nodes_to_launch)."""
        plan: Dict[str, int] = {}
        counts = self._current_counts()
        fresh: List[Dict[str, float]] = []
        for bundle in unmet:
            for free in fresh:
                if self._fits(bundle, free):
                    self._sub(free, bundle)
                    break
            else:
                # pick the cheapest node type that can hold the bundle
                for tname, tcfg in sorted(
                        self.node_types.items(),
                        key=lambda kv: sum(
                            (kv[1].get("resources") or {}).values())):
                    res = tcfg.get("resources") or {}
                    maxw = tcfg.get("max_workers", 10)
                    if (self._fits(bundle, dict(res))
                            and counts.get(tname, 0)
                            + plan.get(tname, 0) < maxw):
                        plan[tname] = plan.get(tname, 0) + 1
                        free = dict(res)
                        self._sub(free, bundle)
                        fresh.append(free)
                        break
        return plan

    def _current_counts(self) -> Dict[str, int]:
        counts: Dict[str, int] = {}
        for nid in self.provider.non_terminated_nodes():
            t = self._launched_type.get(nid, "_unknown")
            counts[t] = counts.get(t, 0) + 1
        return counts

    # ---- the control step ----

    def update(self) -> Dict[str, Any]:
        snapshot = self.load_metrics.snapshot()
        now = time.time()
        # 1. enforce min_workers
        counts = self._current_counts()
        launches: Dict[str, int] = {}
        for tname, tcfg in self.node_types.items():
            deficit = tcfg.get("min_workers", 0) - counts.get(tname, 0)
            if deficit > 0:
                launches[tname] = deficit
        # 2. launch for unmet explicit demand
        unmet = self._unmet_demand(snapshot)
        for tname, n in self._plan_launches(unmet).items():
            launches[tname] = launches.get(tname, 0) + n
        launched_ids: List[str] = []
        now = time.time()
        for tname, n in launches.items():
            n = min(n, self.max_launch_batch)
            cfg = self.node_types[tname]
            ids = self.provider.create_node(cfg, n)
            for nid in ids:
                self._launched_type[nid] = tname
                self._pending_launches[nid] = now
            launched_ids += ids
        # 3. reap idle workers above min_workers
        terminated: List[str] = []
        provider_nodes = set(self.provider.non_terminated_nodes())
        by_gcs = {}
        for n in snapshot["nodes"]:
            by_gcs[n["node_id"]] = n
        counts = self._current_counts()
        for nid in list(provider_nodes):
            n = by_gcs.get(nid)
            if n is None:
                continue
            res = n.get("resources") or {}
            avail = n.get("available") or {}
            # float resources (memory = fraction of host bytes) can
            # differ in the last ulp between the registration snapshot
            # and heartbeat arithmetic — exact dict equality would then
            # never see the node as idle
            idle = all(
                abs(avail.get(k, 0.0) - v) <= 1e-6 * max(1.0, abs(v))
                for k, v in res.items())
            if not idle:
                self._idle_since.pop(nid, None)
                continue
            since = self._idle_since.setdefault(nid, now)
            tname = self._launched_type.get(nid, "_unknown")
            above_min = counts.get(tname, 0) > self.node_types.get(
                tname, {}).get("min_workers", 0)
            if now - since >= self.idle_timeout_s and above_min:
                self.provider.terminate_node(nid)
                self._idle_since.pop(nid, None)
                counts[tname] -= 1
                terminated.append(nid)
        return {"launched": launched_ids, "terminated": terminated,
                "unmet_demand": unmet}


class AutoscalerMonitor:
    """Background loop driving StandardAutoscaler
    (reference: monitor.py:126 on the head node)."""

    def __init__(self, autoscaler: StandardAutoscaler,
                 interval_s: float = 5.0):
        import threading
        self.autoscaler = autoscaler
        self.interval_s = interval_s
        self.updates = 0
        self.failed_updates = 0
        self.last_error: Optional[BaseException] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)

    def start(self):
        self._thread.start()
        return self

    def _loop(self):
        while not self._stop.is_set():
            try:
                self.autoscaler.update()
            except Exception as e:  # noqa: BLE001 - counted, kept
                self.failed_updates += 1
                self.last_error = e
            self.updates += 1
            self._stop.wait(self.interval_s)

    def stats(self) -> Dict[str, Any]:
        """Ticks run, ticks that raised, and the last exception's repr."""
        return {"updates": self.updates,
                "failed_updates": self.failed_updates,
                "last_error": (None if self.last_error is None
                               else repr(self.last_error))}

    def stop(self, timeout: Optional[float] = None):
        """Stop the loop; with ``timeout``, wait for its thread."""
        self._stop.set()
        if timeout is not None and self._thread.is_alive():
            self._thread.join(timeout)
