"""Job submission: SDK client + supervisor actors.

Reference analogue: dashboard/modules/job/ (JobManager job_manager.py:431,
submit_job:691, per-job JobSupervisor:133 running the entrypoint as a
subprocess and streaming logs; REST in job_head.py, sdk.py, cli.py).
The JobSubmissionClient here talks either directly to the cluster
(``ray_tpu_torch://`` — in-process) or to the dashboard REST endpoint
(``http://host:port``).

Copied from the JAX package's ``ray_tpu/job_submission.py`` (imports
renamed to ``ray_tpu_torch``; the entrypoint's environment carries
``RTT_ADDRESS`` and ``RTT_JOB_ID``). The supervisor is a detached actor
that holds no GPU (its worker sees ``CUDA_VISIBLE_DEVICES=""``, and so
does the entrypoint it starts): a job that wants the card asks for it
with ``num_gpus`` on its own tasks and actors, as in Ray. A job's log
starts empty when its supervisor starts (JAX's appends to the file a
former job of the same id left).
"""

from __future__ import annotations

import json
import os
import subprocess
import tempfile
import time
import uuid
from typing import Any, Dict, List, Optional

import ray_tpu_torch

_JOB_KV_PREFIX = "@job/"


class JobStatus:
    PENDING = "PENDING"
    RUNNING = "RUNNING"
    SUCCEEDED = "SUCCEEDED"
    FAILED = "FAILED"
    STOPPED = "STOPPED"


class JobSupervisor:
    """Actor running one job's entrypoint as a subprocess
    (reference: job_manager.py:133)."""

    def __init__(self, job_id: str, entrypoint: str,
                 runtime_env: Optional[Dict[str, Any]] = None,
                 metadata: Optional[Dict[str, str]] = None):
        self.job_id = job_id
        self.entrypoint = entrypoint
        self.log_path = os.path.join(tempfile.gettempdir(),
                                     f"rtt-job-{job_id}.log")
        self.proc: Optional[subprocess.Popen] = None
        self._put_info({
            "job_id": job_id, "entrypoint": entrypoint,
            "status": JobStatus.PENDING, "metadata": metadata or {},
            "start_time": time.time(), "log_path": self.log_path,
        })
        env = dict(os.environ)
        env["RTT_ADDRESS"] = ray_tpu_torch._worker_mod.global_worker(
            ).gcs_address
        env["RTT_JOB_ID"] = job_id
        for k, v in (runtime_env or {}).get("env_vars", {}).items():
            env[k] = str(v)
        cwd = (runtime_env or {}).get("working_dir") or None
        # a job id names one job: its log starts empty (JAX's appends,
        # so a resubmitted id showed the earlier run's output first)
        logf = open(self.log_path, "wb")
        self.proc = subprocess.Popen(
            ["/bin/sh", "-c", entrypoint], stdout=logf, stderr=logf,
            env=env, cwd=cwd)
        self._update(status=JobStatus.RUNNING)

    def _put_info(self, info: Dict[str, Any]):
        w = ray_tpu_torch._worker_mod.global_worker()
        w.call_sync(w.gcs, "kv_put",
                    {"key": _JOB_KV_PREFIX + self.job_id,
                     "value": json.dumps(info).encode(),
                     "overwrite": True}, timeout=30)

    def _get_info(self) -> Dict[str, Any]:
        w = ray_tpu_torch._worker_mod.global_worker()
        r = w.call_sync(w.gcs, "kv_get",
                        {"key": _JOB_KV_PREFIX + self.job_id},
                        timeout=30)
        v = r.get("value")
        return json.loads(v) if v else {}

    def _update(self, **fields):
        info = self._get_info()
        info.update(fields)
        self._put_info(info)

    def poll(self) -> str:
        """Refresh and return the job status."""
        if self.proc is None:
            return JobStatus.PENDING
        rc = self.proc.poll()
        if rc is None:
            return JobStatus.RUNNING
        info = self._get_info()
        if info.get("status") in (JobStatus.RUNNING, JobStatus.PENDING):
            status = (JobStatus.SUCCEEDED if rc == 0
                      else JobStatus.FAILED)
            self._update(status=status, end_time=time.time(),
                         return_code=rc)
            return status
        return info.get("status", JobStatus.FAILED)

    def stop(self) -> str:
        # already-terminal jobs keep their status; stop only acts on a
        # live process
        current = self.poll()
        if current not in (JobStatus.RUNNING, JobStatus.PENDING):
            return current
        if self.proc is not None and self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self.proc.kill()
        self._update(status=JobStatus.STOPPED, end_time=time.time())
        return JobStatus.STOPPED

    def get_logs(self) -> str:
        try:
            with open(self.log_path, "r", errors="replace") as f:
                return f.read()
        except FileNotFoundError:
            return ""


def _kv(method: str, payload: dict) -> dict:
    w = ray_tpu_torch._worker_mod.global_worker()
    return w.call_sync(w.gcs, method, payload, timeout=30)


class JobSubmissionClient:
    """SDK entry point (reference: dashboard/modules/job/sdk.py).

    address=None / "ray_tpu_torch://..." → drive jobs in-cluster via actors;
    "http://host:port" → drive the dashboard REST API.
    """

    def __init__(self, address: Optional[str] = None):
        self._http = None
        if address and address.startswith("http"):
            self._http = address.rstrip("/")
        elif not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init(address=address.replace("ray_tpu_torch://", "")
                         if address else None)

    # ---- REST transport ----

    def _request(self, method: str, path: str,
                 body: Optional[dict] = None) -> dict:
        import urllib.request
        req = urllib.request.Request(
            self._http + path,
            data=json.dumps(body).encode() if body is not None else None,
            headers={"Content-Type": "application/json"},
            method=method)
        with urllib.request.urlopen(req, timeout=60) as resp:
            return json.loads(resp.read() or b"{}")

    # ---- API ----

    def submit_job(self, *, entrypoint: str,
                   job_id: Optional[str] = None,
                   runtime_env: Optional[Dict[str, Any]] = None,
                   metadata: Optional[Dict[str, str]] = None) -> str:
        job_id = job_id or f"rtt-job-{uuid.uuid4().hex[:8]}"
        if self._http:
            r = self._request("POST", "/api/jobs/", {
                "entrypoint": entrypoint, "job_id": job_id,
                "runtime_env": runtime_env, "metadata": metadata})
            return r["job_id"]
        sup_cls = ray_tpu_torch.remote(
            name=f"JOB_SUPERVISOR::{job_id}", lifetime="detached",
            max_concurrency=4)(JobSupervisor)
        sup = sup_cls.remote(job_id, entrypoint, runtime_env, metadata)
        # block until the supervisor has recorded the job and spawned the
        # entrypoint, so an immediate status/info query can't miss it
        ray_tpu_torch.get(sup.poll.remote(), timeout=60.0)
        return job_id

    def _supervisor(self, job_id: str):
        return ray_tpu_torch.get_actor(f"JOB_SUPERVISOR::{job_id}")

    def get_job_status(self, job_id: str) -> str:
        if self._http:
            return self._request("GET", f"/api/jobs/{job_id}")["status"]
        try:
            return ray_tpu_torch.get(self._supervisor(job_id).poll.remote(),
                               timeout=30)
        except Exception:
            info = self.get_job_info(job_id)
            return info.get("status", JobStatus.FAILED)

    def get_job_info(self, job_id: str) -> Dict[str, Any]:
        if self._http:
            return self._request("GET", f"/api/jobs/{job_id}")
        r = _kv("kv_get", {"key": _JOB_KV_PREFIX + job_id})
        v = r.get("value")
        if v is None:
            raise ValueError(f"unknown job {job_id!r}")
        return json.loads(v)

    def get_job_logs(self, job_id: str) -> str:
        if self._http:
            return self._request("GET",
                                 f"/api/jobs/{job_id}/logs")["logs"]
        try:
            return ray_tpu_torch.get(
                self._supervisor(job_id).get_logs.remote(), timeout=30)
        except Exception:
            info = self.get_job_info(job_id)
            try:
                with open(info["log_path"], errors="replace") as f:
                    return f.read()
            except Exception:
                return ""

    def stop_job(self, job_id: str) -> bool:
        if self._http:
            return self._request("POST",
                                 f"/api/jobs/{job_id}/stop")["stopped"]
        ray_tpu_torch.get(self._supervisor(job_id).stop.remote(), timeout=30)
        return True

    def list_jobs(self) -> List[Dict[str, Any]]:
        if self._http:
            return self._request("GET", "/api/jobs/")["jobs"]
        keys = _kv("kv_keys", {"prefix": _JOB_KV_PREFIX}).get("keys", [])
        out = []
        for k in keys:
            v = _kv("kv_get", {"key": k}).get("value")
            if v:
                out.append(json.loads(v))
        return out

    def wait_until_finish(self, job_id: str, timeout: float = 300.0
                          ) -> str:
        deadline = time.time() + timeout
        while time.time() < deadline:
            s = self.get_job_status(job_id)
            if s in (JobStatus.SUCCEEDED, JobStatus.FAILED,
                     JobStatus.STOPPED):
                return s
            time.sleep(0.5)
        raise TimeoutError(f"job {job_id} still running after {timeout}s")
