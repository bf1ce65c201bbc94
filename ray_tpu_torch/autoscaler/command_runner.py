"""Command runners: how the launcher executes on cluster nodes.

Reference analogue: autoscaler/_private/command_runner.py
(SSHCommandRunner:243 — ssh/rsync with control-path reuse;
DockerCommandRunner:523 — the same surface inside a container). The
ssh binary is injectable so the updater logic is testable offline (a
fake "ssh" that drops the connection args and runs locally — the same
pattern the container runtime-env tests use).

The port's copy of the JAX package's
``ray_tpu/autoscaler/command_runner.py`` (imports renamed to
``ray_tpu_torch``, env vars ``RTPU_*`` to ``RTT_*``).
"""

from __future__ import annotations

import os
import shutil
import subprocess
from typing import Any, Dict, List, Optional, Tuple


class CommandRunner:
    def run(self, cmd: str, timeout: float = 600.0) -> Tuple[int, str]:
        raise NotImplementedError

    def run_rsync_up(self, source: str, target: str) -> Tuple[int, str]:
        raise NotImplementedError


class LocalCommandRunner(CommandRunner):
    """Runs on this host (head-node bootstrap / tests)."""

    def run(self, cmd: str, timeout: float = 600.0) -> Tuple[int, str]:
        p = subprocess.run(["bash", "-lc", cmd], capture_output=True,
                           text=True, timeout=timeout)
        return p.returncode, (p.stdout + p.stderr)

    def run_rsync_up(self, source: str, target: str) -> Tuple[int, str]:
        os.makedirs(os.path.dirname(target) or ".", exist_ok=True)
        if os.path.isdir(source):
            shutil.copytree(source, target, dirs_exist_ok=True)
        else:
            shutil.copy2(source, target)
        return 0, ""


class SSHCommandRunner(CommandRunner):
    """ssh/scp against a node (reference: SSHCommandRunner — options
    mirror its ControlMaster-less baseline)."""

    def __init__(self, ip: str, *, user: str = "",
                 key_path: Optional[str] = None,
                 ssh_binary: str = "ssh", scp_binary: str = "scp",
                 extra_options: Optional[List[str]] = None):
        self.ip = ip
        self.user = user
        self.key_path = key_path
        self.ssh_binary = ssh_binary
        self.scp_binary = scp_binary
        self.extra_options = list(extra_options or [])

    def _target(self) -> str:
        return f"{self.user}@{self.ip}" if self.user else self.ip

    def _base_options(self) -> List[str]:
        opts = ["-o", "StrictHostKeyChecking=no",
                "-o", "UserKnownHostsFile=/dev/null",
                "-o", "ConnectTimeout=10"]
        if self.key_path:
            opts += ["-i", self.key_path]
        return opts + self.extra_options

    def run(self, cmd: str, timeout: float = 600.0) -> Tuple[int, str]:
        # real ssh space-joins the remote args and the remote shell
        # re-splits them — the command must travel as ONE quoted word
        import shlex
        argv = ([self.ssh_binary] + self._base_options()
                + [self._target(), "--", "bash", "-lc",
                   shlex.quote(cmd)])
        try:
            p = subprocess.run(argv, capture_output=True, text=True,
                               timeout=timeout)
        except subprocess.TimeoutExpired:
            return 124, f"timed out after {timeout}s: {cmd}"
        return p.returncode, (p.stdout + p.stderr)

    def run_rsync_up(self, source: str, target: str) -> Tuple[int, str]:
        argv = ([self.scp_binary] + self._base_options()
                + (["-r"] if os.path.isdir(source) else [])
                + [source, f"{self._target()}:{target}"])
        try:
            p = subprocess.run(argv, capture_output=True, text=True,
                               timeout=600)
        except subprocess.TimeoutExpired:
            return 124, "scp timed out"
        return p.returncode, (p.stdout + p.stderr)


class DockerCommandRunner(CommandRunner):
    """Same surface, inside a container on the node (reference:
    DockerCommandRunner — commands run via ``docker exec``, files land
    on the host then ``docker cp`` into the container)."""

    def __init__(self, base: CommandRunner, *, image: str,
                 container_name: str = "ray_tpu_torch_container",
                 docker_binary: str = "docker",
                 run_options: Optional[List[str]] = None):
        self.base = base
        self.image = image
        self.container_name = container_name
        self.docker = docker_binary
        self.run_options = list(run_options or [])

    def ensure_container(self) -> Tuple[int, str]:
        opts = " ".join(self.run_options)
        return self.base.run(
            f"{self.docker} inspect {self.container_name} >/dev/null 2>&1"
            f" || {self.docker} run -d --name {self.container_name} "
            f"--network=host {opts} {self.image} sleep infinity")

    def run(self, cmd: str, timeout: float = 600.0) -> Tuple[int, str]:
        quoted = cmd.replace("'", "'\\''")
        return self.base.run(
            f"{self.docker} exec {self.container_name} "
            f"bash -lc '{quoted}'", timeout=timeout)

    def run_rsync_up(self, source: str, target: str) -> Tuple[int, str]:
        staged = f"/tmp/rtt_stage_{os.path.basename(target)}"
        rc, out = self.base.run_rsync_up(source, staged)
        if rc != 0:
            return rc, out
        return self.base.run(
            f"{self.docker} cp {staged} "
            f"{self.container_name}:{target}")


def runner_for_node(ip: str, auth: Dict[str, Any],
                    docker: Optional[Dict[str, Any]] = None
                    ) -> CommandRunner:
    """Build the runner stack a cluster config describes (reference:
    node_provider.get_command_runner): ssh auth from the config's
    ``auth`` section, optionally wrapped in docker."""
    base: CommandRunner = SSHCommandRunner(
        ip,
        user=auth.get("ssh_user", ""),
        key_path=auth.get("ssh_private_key"),
        ssh_binary=auth.get("ssh_binary", "ssh"),
        scp_binary=auth.get("scp_binary", "scp"),
        extra_options=auth.get("ssh_options"))
    if docker and docker.get("image"):
        return DockerCommandRunner(
            base, image=docker["image"],
            container_name=docker.get("container_name",
                                      "ray_tpu_torch_container"),
            docker_binary=docker.get("docker_binary", "docker"),
            run_options=docker.get("run_options"))
    return base
