"""Grafana dashboard generation from the metric registry.

Reference analogue: dashboard/modules/metrics/grafana_dashboard_factory.py
— curated Grafana boards generated from the declared metric set, so the
Prometheus endpoint (dashboard.py /metrics) comes with ready-to-import
dashboards instead of a bare scrape target.

The panel inventory mirrors the gauge families exported by
``_cluster_gauges``/``_node_gauges``/``util.metrics``; regenerate with
``write_dashboards()`` (the CLI exposes it as
``ray-tpu-torch grafana --out DIR``).

Copied from the JAX package's ``ray_tpu/dashboard/grafana.py`` (metric
names ``ray_tpu_*`` to ``ray_tpu_torch_*``); the resource panels read
``CPU|GPU`` and the node board draws the GPU gauges where JAX's draws
its TPU ones.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Tuple

_DATASOURCE = {"type": "prometheus", "uid": "${datasource}"}


def _panel(title: str, exprs: List[Tuple[str, str]], *, unit: str = "short",
           stacked: bool = False) -> Dict[str, Any]:
    # id/gridPos are assigned by _layout(), which owns placement
    return {
        "title": title,
        "type": "timeseries",
        "datasource": dict(_DATASOURCE),
        "fieldConfig": {
            "defaults": {
                "unit": unit,
                "custom": {"fillOpacity": 10,
                           "stacking": {"mode": "normal"}
                           if stacked else {"mode": "none"}},
            },
            "overrides": [],
        },
        "targets": [
            {"expr": expr, "legendFormat": legend,
             "datasource": dict(_DATASOURCE), "refId": chr(ord("A") + i)}
            for i, (expr, legend) in enumerate(exprs)
        ],
    }


def _dashboard(uid: str, title: str,
               panels: List[Dict[str, Any]]) -> Dict[str, Any]:
    return {
        "uid": uid,
        "title": title,
        "tags": ["ray-tpu-torch", "generated"],
        "timezone": "browser",
        "schemaVersion": 39,
        "refresh": "15s",
        "time": {"from": "now-30m", "to": "now"},
        "templating": {"list": [{
            "name": "datasource",
            "type": "datasource",
            "query": "prometheus",
            "current": {},
        }]},
        "panels": panels,
    }


def _layout(panels: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Two-column grid; ids and positions assigned in order."""
    for i, p in enumerate(panels):
        p["id"] = i + 1
        p["gridPos"] = {"x": (i % 2) * 12, "y": (i // 2) * 8,
                        "w": 12, "h": 8}
    return panels


def core_dashboard() -> Dict[str, Any]:
    return _dashboard("ray-tpu-torch-core", "ray_tpu_torch // Core", _layout([
        _panel("Alive nodes", [
            ("ray_tpu_torch_cluster_nodes_alive", "alive"),
            ("ray_tpu_torch_cluster_nodes_total", "registered")]),
        _panel("Actors", [
            ("ray_tpu_torch_cluster_actors_alive", "alive"),
            ("ray_tpu_torch_cluster_actors_total", "total")]),
        _panel("Cluster resources", [
            ('ray_tpu_torch_cluster_resource_total{resource=~"CPU|GPU"}',
             "{{resource}} total"),
            ('ray_tpu_torch_cluster_resource_available{resource=~"CPU|GPU"}',
             "{{resource}} available")]),
        _panel("Task throughput (cluster)", [
            ("sum(rate("
             "ray_tpu_torch_node_scheduler_tasks_dispatched_total[1m]))",
             "dispatched/s")], unit="ops"),
    ]))


def scheduler_dashboard() -> Dict[str, Any]:
    return _dashboard("ray-tpu-torch-scheduler",
                      "ray_tpu_torch // Scheduler", _layout([
        _panel("Pending tasks by node", [
            ("ray_tpu_torch_node_scheduler_tasks_pending", "{{node}}")],
            stacked=True),
        _panel("Running tasks by node", [
            ("ray_tpu_torch_node_scheduler_tasks_running", "{{node}}")],
            stacked=True),
        _panel("Dispatch rate by node", [
            ("rate(ray_tpu_torch_node_scheduler_tasks_dispatched_total[1m])",
             "{{node}}")], unit="ops"),
        _panel("Spillbacks", [
            ("rate(ray_tpu_torch_node_scheduler_tasks_spilled_back_total[5m])",
             "{{node}}")], unit="ops"),
        _panel("Workers", [
            ("ray_tpu_torch_node_scheduler_workers_alive", "{{node}} alive"),
            ("ray_tpu_torch_node_scheduler_workers_idle", "{{node}} idle")]),
        _panel("Event-loop lag", [
            ("ray_tpu_torch_node_scheduler_event_loop_lag_s", "{{node}} lag"),
            ("ray_tpu_torch_node_scheduler_event_loop_lag_peak_s",
             "{{node}} peak")], unit="s"),
    ]))


def object_store_dashboard() -> Dict[str, Any]:
    return _dashboard("ray-tpu-torch-objects",
                      "ray_tpu_torch // Object store", _layout([
        _panel("Store bytes by node", [
            ("ray_tpu_torch_node_object_store_used_bytes", "{{node}} used"),
            ("ray_tpu_torch_node_object_store_capacity", "{{node}} capacity")],
            unit="bytes"),
        _panel("Objects created", [
            ("rate(ray_tpu_torch_node_object_store_num_created[1m])",
             "{{node}}")], unit="ops"),
        _panel("Spill activity", [
            ("ray_tpu_torch_node_object_store_spilled_objects",
             "{{node}} spilled"),
            ("rate(ray_tpu_torch_node_object_store_restored_bytes_total[1m])",
             "{{node}} restore B/s")]),
        _panel("Transfer in flight", [
            ("ray_tpu_torch_node_object_store_pull_inflight_bytes",
             "{{node}} pull bytes"),
            ("ray_tpu_torch_node_object_store_pushes_inflight",
             "{{node}} pushes")]),
    ]))


def node_dashboard() -> Dict[str, Any]:
    return _dashboard("ray-tpu-torch-nodes",
                      "ray_tpu_torch // Nodes & GPU", _layout([
        _panel("Host CPU", [
            ("ray_tpu_torch_node_cpu_percent", "{{node}}")], unit="percent"),
        _panel("Host memory", [
            ("ray_tpu_torch_node_mem_available_bytes", "{{node}} available"),
            ("ray_tpu_torch_node_mem_total_bytes", "{{node}} total")],
            unit="bytes"),
        _panel("GPUs", [
            ("ray_tpu_torch_node_gpu_num_gpus", "{{node}} GPUs"),
            ("ray_tpu_torch_node_gpu_gpus_available", "{{node}} free")]),
        _panel("Disk free", [
            ("ray_tpu_torch_node_disk_free_bytes", "{{node}}")], unit="bytes"),
    ]))


def generate_dashboards() -> Dict[str, Dict[str, Any]]:
    """All generated boards keyed by file stem."""
    return {
        "ray_tpu_torch_core": core_dashboard(),
        "ray_tpu_torch_scheduler": scheduler_dashboard(),
        "ray_tpu_torch_object_store": object_store_dashboard(),
        "ray_tpu_torch_nodes": node_dashboard(),
    }


def write_dashboards(out_dir: str) -> List[str]:
    """Write importable Grafana JSON files; returns the paths."""
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for stem, doc in generate_dashboards().items():
        path = os.path.join(out_dir, f"{stem}.json")
        with open(path, "w") as f:
            json.dump(doc, f, indent=2, sort_keys=True)
        paths.append(path)
    return paths
