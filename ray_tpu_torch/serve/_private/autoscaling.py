"""Replica autoscaling from queue-length + LLM workload metrics.

Copy of ``ray_tpu/serve/_private/autoscaling.py``. Reference analogue:
serve/_private/autoscaling_policy.py (policy on
per-replica ongoing-request metrics from autoscaling_metrics.py).

The controller feeds ``get_decision`` the summed per-replica
``queue_len`` (executing requests + the bounded ingress waiting room,
from ``ReplicaActor.get_load``) rather than ongoing requests alone: a
replica whose execution slots are saturated keeps registering rising
load through its queue, so backpressure shows up as scale-out pressure
instead of being invisible behind the concurrency cap.

LLM deployments (serve/llm) additionally report ``signals`` — the
aggregated engine telemetry the replica load rows carry
(``tokens_per_s``, ``kv_occupancy``, running/waiting sequences).
Queue depth alone is a poor LLM signal: a decode batch of long
sequences holds few *requests* but saturates the KV pool and the
chip. With ``target_tokens_per_s_per_replica`` and/or
``target_kv_occupancy`` set, desired capacity is the MAX over all
configured signals — the binding constraint scales the fleet.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class AutoscalingConfig:
    min_replicas: int = 1
    max_replicas: int = 10
    target_num_ongoing_requests_per_replica: float = 1.0
    upscale_delay_s: float = 3.0
    downscale_delay_s: float = 30.0
    smoothing_factor: float = 1.0
    # LLM signals (None = queue depth only). tokens/s is a THROUGHPUT
    # target per replica; occupancy is the fraction of the paged KV
    # pool in use a replica should sit at (0 < target <= 1).
    target_tokens_per_s_per_replica: Optional[float] = None
    target_kv_occupancy: Optional[float] = None


class AutoscalingPolicy:
    """Desired replicas ∝ observed ongoing requests / target-per-replica,
    with hysteresis delays so transient spikes don't flap the fleet."""

    def __init__(self, config: AutoscalingConfig):
        self.config = config
        self._above_since = None
        self._below_since = None

    def _desired_from_signals(self, current: int,
                              signals: Optional[Dict[str, Any]]
                              ) -> float:
        """Raw desired replica count from the LLM telemetry, before
        smoothing/clamping: the max over configured targets."""
        c = self.config
        raw = 0.0
        if not signals:
            return raw
        if c.target_tokens_per_s_per_replica:
            # tokens/s the fleet PRODUCED; cache-hit tokens/s (prefix
            # cache skipping prefill work) count as served demand the
            # fleet absorbed without compute — both are throughput the
            # target has to cover (docs/LLM_SERVING.md)
            served = (float(signals.get("tokens_per_s", 0.0))
                      + float(signals.get("cache_hit_tokens_per_s", 0.0)))
            raw = max(raw, served / c.target_tokens_per_s_per_replica)
        if c.target_kv_occupancy:
            # occupancy is per-replica-average: current fleet holding
            # occ of its pools needs current * occ / target replicas
            occ = float(signals.get("kv_occupancy", 0.0))
            raw = max(raw, current * occ / c.target_kv_occupancy)
        per_role = signals.get("per_role")
        if per_role and c.target_tokens_per_s_per_replica:
            # disaggregated fleets: size each role sub-fleet for ITS
            # load, then sum — a saturated decode tier must not hide
            # behind idle prefill replicas in the fleet-wide mean
            need = 0.0
            for role_row in per_role.values():
                need += max(1.0, math.ceil(
                    float(role_row.get("tokens_per_s", 0.0))
                    / c.target_tokens_per_s_per_replica))
            raw = max(raw, need)
        return raw

    def get_decision(self, current_replicas: int,
                     total_ongoing: float, now: float,
                     signals: Optional[Dict[str, Any]] = None) -> int:
        """``total_ongoing`` is the deployment-wide queue depth
        (executing + queued across replicas); ``signals`` the
        aggregated LLM telemetry when the deployment reports it."""
        c = self.config
        if current_replicas == 0:
            return c.min_replicas
        raw = total_ongoing / max(
            c.target_num_ongoing_requests_per_replica, 1e-9)
        raw = max(raw, self._desired_from_signals(current_replicas,
                                                  signals))
        desired = current_replicas + c.smoothing_factor * (
            raw - current_replicas)
        desired = int(min(max(math.ceil(desired), c.min_replicas),
                          c.max_replicas))
        if desired > current_replicas:
            self._below_since = None
            if self._above_since is None:
                self._above_since = now
            if now - self._above_since >= c.upscale_delay_s:
                self._above_since = None
                return desired
            return current_replicas
        if desired < current_replicas:
            self._above_since = None
            if self._below_since is None:
                self._below_since = now
            if now - self._below_since >= c.downscale_delay_s:
                self._below_since = None
                return desired
            return current_replicas
        self._above_since = self._below_since = None
        return current_replicas
