"""`ray-tpu-torch up` / `ray-tpu-torch down`: cluster lifecycle from a
YAML config.

Reference analogue: autoscaler/_private/commands.py
(create_or_update_cluster:186, teardown_cluster:332). The fake_multinode
provider gives the full experience on one machine (detached head process
+ worker raylets); the gcp_gpu provider provisions Compute Engine VMs
with GPUs (in-VM bootstrap is printed, not SSH-executed — zero-egress
environments can't reach the VMs anyway).

Copied from the JAX package's ``ray_tpu/autoscaler/commands.py``.
Differences: ``gcp_gpu`` in ``gcp_tpu``'s place; the detached head gets
``--num-gpus`` (0 when its node type names no ``"GPU"``, so it never
claims a card by detection) where JAX passes ``--num-tpus``; the state
dir is ``~/.ray_tpu_torch/clusters``; ``down`` waits for the head and
the worker raylets to exit (they reap their workers on SIGTERM) and
kills any still alive after ``_REAP_S``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from typing import Any, Dict, Optional, Union

from ray_tpu_torch.autoscaler.config import (ConfigError, load_config,
                                             make_provider, prepare_config)

STATE_DIR = os.path.expanduser("~/.ray_tpu_torch/clusters")
# a raylet reaps its workers for up to 10 s on SIGTERM
_REAP_S = 15.0


def _state_path(cluster_name: str) -> str:
    os.makedirs(STATE_DIR, exist_ok=True)
    return os.path.join(STATE_DIR, f"{cluster_name}.json")


def _load_state(cluster_name: str) -> Optional[Dict[str, Any]]:
    p = _state_path(cluster_name)
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return json.load(f)


def _save_state(cluster_name: str, state: Dict[str, Any]):
    with open(_state_path(cluster_name), "w") as f:
        json.dump(state, f, indent=1)


def _running(pid: int) -> bool:
    """True while ``pid`` runs (a zombie, dead but not yet reaped by its
    parent, counts as gone)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except (OSError, IndexError):
        return False


def _wait_gone(pids, timeout: float):
    """Wait for ``pids`` to exit; SIGKILL those still running after
    ``timeout`` seconds."""
    import signal
    deadline = time.time() + timeout
    while any(_running(p) for p in pids) and time.time() < deadline:
        time.sleep(0.2)
    for p in pids:
        if _running(p):
            try:
                os.kill(p, signal.SIGKILL)
            except OSError:
                pass


def _resolve(config: Union[str, Dict[str, Any]]) -> Dict[str, Any]:
    if isinstance(config, str):
        return load_config(config)
    return prepare_config(config)


def _start_detached_head(config: Dict[str, Any]) -> Dict[str, Any]:
    """Spawn `ray-tpu-torch start --head --block` detached; wait for the GCS
    address to appear in its log."""
    import tempfile
    log = tempfile.NamedTemporaryFile(
        prefix="rtt_head_", suffix=".log", delete=False)
    head_type = config.get("head_node_type")
    res = {}
    if head_type:
        res = config["available_node_types"][head_type].get(
            "resources") or {}
    cmd = [sys.executable, "-m", "ray_tpu_torch.scripts.cli", "start",
           "--head", "--block"]
    if res.get("CPU"):
        cmd += ["--num-cpus", str(res["CPU"])]
    cmd += ["--num-gpus", str(res.get("GPU", 0))]
    proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                            start_new_session=True)
    deadline = time.time() + 120
    address = None
    while time.time() < deadline:
        with open(log.name) as f:
            for line in f:
                if line.startswith("export RTT_ADDRESS="):
                    address = line.strip().split("=", 1)[1]
                    break
        if address or proc.poll() is not None:
            break
        time.sleep(0.5)
    if address is None:
        proc.kill()
        raise RuntimeError(
            f"head failed to start; log: {log.name}")
    return {"pid": proc.pid, "gcs_address": address, "log": log.name}


def create_or_update_cluster(
        config: Union[str, Dict[str, Any]], *,
        api_client=None, ec2_client=None,
        compute_client=None) -> Dict[str, Any]:
    """Bring the cluster to its configured min size. Returns the state
    dict (also persisted for `ray-tpu-torch down`)."""
    provider_runtime = {"api_client": api_client,
                        "ec2_client": ec2_client,
                        "compute_client": compute_client}
    cfg = _resolve(config)
    name = cfg["cluster_name"]
    ptype = cfg["provider"]["type"]
    # IDEMPOTENT: re-running `up` reconciles against the persisted state
    # instead of provisioning a second (leaked, billable) cluster
    state: Dict[str, Any] = _load_state(name) or {
        "cluster_name": name, "provider": ptype, "nodes": {}}

    def _pid_alive(pid) -> bool:
        if not pid:
            return False
        try:
            os.kill(pid, 0)
            return True
        except OSError:
            return False

    if ptype == "fake_multinode":
        try:
            head = state.get("head")
            if not head or not _pid_alive(head.get("pid")):
                head = _start_detached_head(cfg)
                state["head"] = head
                # persist the head IMMEDIATELY: a later failure must not
                # orphan the process with no record for `down`
                _save_state(name, state)
            from ray_tpu_torch._private import node as node_mod
            session_dir = node_mod.new_session_dir()
            provider = make_provider(cfg, session_dir=session_dir,
                                     gcs_address=head["gcs_address"])
            # drop dead workers from the record before computing deltas
            state["nodes"] = {nid: info for nid, info
                              in state["nodes"].items()
                              if _pid_alive(info.get("pid"))}
            for tname, nt in cfg["available_node_types"].items():
                if tname == cfg.get("head_node_type"):
                    continue
                have = sum(1 for s in state["nodes"].values()
                           if s["type"] == tname)
                for _ in range(max(0, nt.get("min_workers", 0) - have)):
                    (nid,) = provider.create_node(
                        {"resources": nt.get("resources") or {"CPU": 1},
                         **nt.get("node_config", {})}, 1)
                    state["nodes"][nid] = {
                        "type": tname, "pid": provider.node_pid(nid)}
                    _save_state(name, state)
        finally:
            _save_state(name, state)
        return state

    if ptype == "gcp_gpu":
        provider = make_provider(cfg, api_client=api_client)
        try:
            live = set(provider.non_terminated_nodes())
            state["nodes"] = {nid: info for nid, info
                              in state["nodes"].items() if nid in live}
            for tname, nt in cfg["available_node_types"].items():
                target = nt.get("min_workers", 0)
                if tname == cfg.get("head_node_type"):
                    target = max(target, 1)  # the head VM must exist
                have = sum(1 for s in state["nodes"].values()
                           if s["type"] == tname)
                for _ in range(max(0, target - have)):
                    (nid,) = provider.create_node(
                        nt.get("node_config") or {}, 1)
                    state["nodes"][nid] = {"type": tname}
                    # every billable VM lands in the state file the
                    # moment it is requested
                    _save_state(name, state)
            state["bootstrap"] = (
                "instances requested; once RUNNING, run "
                "`ray-tpu-torch start --head` on the head VM and "
                "`ray-tpu-torch start --address <head>` on workers "
                "(setup_commands from the config apply)")
        finally:
            _save_state(name, state)
        return state

    if ptype in ("aws", "azure"):
        provider = make_provider(cfg, **provider_runtime)
        try:
            live = set(provider.non_terminated_nodes())
            state["nodes"] = {nid: info for nid, info
                              in state["nodes"].items() if nid in live}
            created: list = []
            # phase 1: create every missing node (fast API calls)
            for tname, nt in cfg["available_node_types"].items():
                target = nt.get("min_workers", 0)
                if tname == cfg.get("head_node_type"):
                    target = max(target, 1)
                have = sum(1 for s in state["nodes"].values()
                           if s["type"] == tname)
                for _ in range(max(0, target - have)):
                    (nid,) = provider.create_node(
                        nt.get("node_config") or {}, 1)
                    state["nodes"][nid] = {"type": tname}
                    created.append((nid, tname))
                    _save_state(name, state)
            # phase 2: bootstrap CONCURRENTLY (reference: one
            # NodeUpdaterThread per node — a single unreachable node
            # must not serialize the whole cluster behind its
            # ready_timeout)
            if created and (cfg.get("auth") or cfg.get(
                    "setup_commands") or cfg.get("file_mounts")):
                from concurrent.futures import ThreadPoolExecutor
                from ray_tpu_torch.autoscaler.updater import (
                    NodeUpdateError, update_node_from_config)

                def _bootstrap(item):
                    nid, tname = item
                    ip = provider.external_ip(nid)
                    if not ip:
                        return nid, None, "no reachable ip"
                    try:
                        upd = update_node_from_config(
                            ip, cfg, is_head=(
                                tname == cfg.get("head_node_type")))
                        return nid, upd.phases_done, None
                    except NodeUpdateError as e:
                        return nid, None, str(e)[:500]

                with ThreadPoolExecutor(max_workers=8) as pool:
                    for nid, phases, err in pool.map(_bootstrap,
                                                     created):
                        if phases is not None:
                            state["nodes"][nid]["bootstrap"] = phases
                        if err is not None:
                            state["nodes"][nid]["bootstrap_error"] = err
                        _save_state(name, state)
        finally:
            _save_state(name, state)
        return state

    raise ConfigError(
        f"ray-tpu-torch up does not support provider {ptype!r}")


def teardown_cluster(config: Union[str, Dict[str, Any]], *,
                     api_client=None, ec2_client=None,
                     compute_client=None) -> int:
    """Terminate every node `up` created. Returns nodes torn down."""
    provider_runtime = {"api_client": api_client,
                        "ec2_client": ec2_client,
                        "compute_client": compute_client}
    cfg = _resolve(config)
    name = cfg["cluster_name"]
    state = _load_state(name)
    if state is None:
        return 0
    n = 0
    ptype = state.get("provider")
    if ptype == "fake_multinode":
        import signal
        pids = []
        # workers: direct SIGTERM per pid (they may share the caller's
        # process group — killpg would take the caller down too)
        for nid, info in state.get("nodes", {}).items():
            pid = info.get("pid")
            if pid:
                try:
                    os.kill(pid, signal.SIGTERM)
                except Exception:
                    pass
                pids.append(pid)
                n += 1
        head = state.get("head") or {}
        if head.get("pid"):
            # the head got its own session (start_new_session=True): take
            # down its whole group (GCS/raylet/workers it spawned)
            try:
                os.killpg(os.getpgid(head["pid"]), signal.SIGTERM)
            except Exception:
                try:
                    os.kill(head["pid"], signal.SIGKILL)
                except Exception:
                    pass
            pids.append(head["pid"])
            n += 1
        _wait_gone(pids, _REAP_S)
    elif ptype in ("gcp_gpu", "aws", "azure"):
        provider = make_provider(cfg, **provider_runtime)
        for nid in list(state.get("nodes", {})):
            try:
                provider.terminate_node(nid)
                n += 1
                # prune per node: a failed later termination must not
                # lose the record of the ones still running (billable!)
                state["nodes"].pop(nid, None)
                _save_state(name, state)
            except Exception:
                pass
        if state.get("nodes"):
            # terminations failed: keep the state file so a retried
            # `down` still knows which nodes exist
            return n
    try:
        os.remove(_state_path(name))
    except OSError:
        pass
    return n
