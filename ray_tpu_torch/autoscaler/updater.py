"""Node updater: bootstrap a freshly-created node into the cluster.

Reference analogue: autoscaler/_private/updater.py NodeUpdaterThread —
wait for ssh, sync file mounts, then run initialization / setup /
start commands in order, surfacing which phase failed. Drives any
CommandRunner (ssh, ssh+docker, local), so the flow is testable with a
fake ssh binary.

The port's copy of the JAX package's ``ray_tpu/autoscaler/updater.py``
(imports renamed to ``ray_tpu_torch``, env vars ``RTPU_*`` to
``RTT_*``).
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.autoscaler.command_runner import CommandRunner

logger = logging.getLogger(__name__)


class NodeUpdateError(RuntimeError):
    def __init__(self, phase: str, cmd: str, rc: int, output: str):
        super().__init__(
            f"node update failed in {phase} (rc={rc}): {cmd}\n"
            f"{output[-2000:]}")
        self.phase = phase
        self.cmd = cmd
        self.rc = rc


class NodeUpdater:
    """One node's bootstrap. Phases mirror the reference's updater:
    wait_ready → file_mounts → initialization_commands →
    setup_commands → start_commands."""

    def __init__(self, runner: CommandRunner, *,
                 file_mounts: Optional[Dict[str, str]] = None,
                 initialization_commands: Optional[List[str]] = None,
                 setup_commands: Optional[List[str]] = None,
                 start_commands: Optional[List[str]] = None,
                 ready_timeout: float = 300.0):
        self.runner = runner
        self.file_mounts = dict(file_mounts or {})
        self.initialization_commands = list(initialization_commands or [])
        self.setup_commands = list(setup_commands or [])
        self.start_commands = list(start_commands or [])
        self.ready_timeout = ready_timeout
        self.phases_done: List[str] = []

    def wait_ready(self):
        deadline = time.monotonic() + self.ready_timeout
        delay = 2.0
        while True:
            rc, out = self.runner.run("uptime", timeout=30)
            if rc == 0:
                self.phases_done.append("wait_ready")
                return
            if time.monotonic() > deadline:
                raise NodeUpdateError("wait_ready", "uptime", rc, out)
            time.sleep(min(delay, max(0.0, deadline - time.monotonic())))
            delay = min(delay * 1.5, 15.0)

    def _run_phase(self, phase: str, commands: List[str]):
        for cmd in commands:
            rc, out = self.runner.run(cmd)
            if rc != 0:
                raise NodeUpdateError(phase, cmd, rc, out)
        self.phases_done.append(phase)

    def sync_file_mounts(self):
        for target, source in self.file_mounts.items():
            rc, out = self.runner.run_rsync_up(source, target)
            if rc != 0:
                raise NodeUpdateError("file_mounts",
                                      f"{source} -> {target}", rc, out)
        self.phases_done.append("file_mounts")

    def update(self):
        """The full bootstrap; raises NodeUpdateError naming the phase
        that failed."""
        self.wait_ready()
        if hasattr(self.runner, "ensure_container"):
            rc, out = self.runner.ensure_container()
            if rc != 0:
                raise NodeUpdateError("docker", "ensure_container", rc,
                                      out)
            self.phases_done.append("docker")
        self.sync_file_mounts()
        self._run_phase("initialization_commands",
                        self.initialization_commands)
        self._run_phase("setup_commands", self.setup_commands)
        self._run_phase("start_commands", self.start_commands)


def update_node_from_config(ip: str, cfg: Dict[str, Any], *,
                            is_head: bool) -> NodeUpdater:
    """Build and run the updater a cluster YAML describes for one node
    (reference: the up flow handing each created node to
    NodeUpdaterThread). Returns the updater (phases_done inspectable)."""
    from ray_tpu_torch.autoscaler.command_runner import runner_for_node
    runner = runner_for_node(ip, cfg.get("auth") or {},
                             docker=cfg.get("docker"))
    start = cfg.get("head_start_ray_commands" if is_head
                    else "worker_start_ray_commands") or \
        cfg.get("start_commands") or []
    updater = NodeUpdater(
        runner,
        file_mounts=cfg.get("file_mounts"),
        initialization_commands=cfg.get("initialization_commands"),
        setup_commands=cfg.get("setup_commands"),
        start_commands=start)
    updater.update()
    return updater
