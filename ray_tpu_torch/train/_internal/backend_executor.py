"""BackendExecutor: drives a gang of TrainWorkers through one training run.

The port's copy of ``ray_tpu/train/_internal/backend_executor.py``
(reference analogue: train/_internal/backend_executor.py:42 — start:93
spawns the WorkerGroup, start_training:314 installs per-worker sessions
with world/local/node ranks and launches train_func threads,
get_next_results:411 streams result rounds). The backend config forms
the gang's process group (``TorchConfig.setup_worker_group``: a
``torch.distributed`` rendezvous on rank 0's host); each worker's GPUs
are its grant through ``CUDA_VISIBLE_DEVICES``.
"""

from __future__ import annotations

import logging
from collections import defaultdict
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch.air.session import TrainingResult
from ray_tpu_torch.train._internal.worker_group import WorkerGroup

logger = logging.getLogger(__name__)


class TrainingFailedError(RuntimeError):
    pass


class BackendExecutor:
    def __init__(self, scaling_config, backend_config=None):
        self.scaling = scaling_config
        self.backend_config = backend_config
        self.worker_group: Optional[WorkerGroup] = None

    def start(self):
        try:
            self.worker_group = WorkerGroup(
                num_workers=self.scaling.num_workers,
                resources_per_worker=self.scaling.worker_resources(),
                placement_strategy=self.scaling.placement_strategy)
            self._setup_backend()
        except TrainingFailedError:
            raise
        except Exception as e:
            # gang setup rides cluster state (PG placement, actor
            # creation): capacity lost to a preempted/killed node must
            # surface as a retryable training failure so the trainer's
            # failure policy gang-restarts, not as a raw crash of fit()
            raise TrainingFailedError(
                f"gang setup failed: {type(e).__name__}: {e}") from e

    def _setup_backend(self):
        # the backend config owns the rendezvous (TorchConfig: a process
        # group over rank 0's host; none for a gang of one)
        if self.backend_config is not None and hasattr(
                self.backend_config, "setup_worker_group"):
            self.backend_config.setup_worker_group(self.worker_group)

    def start_training(self, train_func: Callable, config: Dict[str, Any],
                       checkpoint=None, dataset_shards: Optional[Dict] = None,
                       trial_info: Optional[Dict[str, str]] = None,
                       checkpoint_root: Optional[str] = None,
                       ckpt_start_step: int = 0):
        wg = self.worker_group
        n = wg.num_workers
        # node/local ranks from sorted metadata
        node_ids = [m["node_id"] for m in wg.metadata]
        node_rank_map: Dict[str, int] = {}
        for nid in node_ids:
            if nid not in node_rank_map:
                node_rank_map[nid] = len(node_rank_map)
        local_counter: Dict[str, int] = defaultdict(int)
        trial_info = trial_info or {}
        import ray_tpu_torch
        refs = []
        for rank, w in enumerate(wg.workers):
            nid = node_ids[rank]
            refs.append(w.setup_session.remote(
                world_rank=rank, local_rank=local_counter[nid],
                node_rank=node_rank_map[nid], world_size=n,
                checkpoint=checkpoint,
                trial_name=trial_info.get("trial_name", ""),
                trial_id=trial_info.get("trial_id", ""),
                experiment_name=trial_info.get("experiment_name", ""),
                checkpoint_root=checkpoint_root,
                ckpt_start_step=ckpt_start_step))
            local_counter[nid] += 1
        ray_tpu_torch.get(refs, timeout=120)
        if dataset_shards:
            refs = []
            for name, shards in dataset_shards.items():
                for rank, w in enumerate(wg.workers):
                    shard = shards[rank] if isinstance(shards, list) \
                        else shards
                    refs.append(w.set_dataset_shard.remote(name, shard))
            ray_tpu_torch.get(refs, timeout=120)
        wg.execute("start_training", train_func, config, timeout=120)

    def get_next_results(self, timeout: float = 600.0
                         ) -> Optional[List[TrainingResult]]:
        """One result round: every worker reports once, or all finish.

        Returns None when training completed on all workers; raises on any
        worker error (gang semantics: one failure fails the round, matching
        ICI gang-fatality)."""
        import time
        import ray_tpu_torch
        wg = self.worker_group
        deadline = time.monotonic() + timeout
        results: List[Optional[Dict]] = [None] * wg.num_workers
        while time.monotonic() < deadline:
            pending = [i for i, r in enumerate(results) if r is None]
            if not pending:
                return [TrainingResult(r["metrics"], r.get("checkpoint"))
                        for r in results]
            finished = 0
            for i in pending:
                try:
                    r = ray_tpu_torch.get(
                        wg.workers[i].get_next_result.remote(2.0),
                        timeout=60)
                except Exception as e:
                    # a dead gang member (preempted node, killed actor)
                    # fails the round retryably — gang semantics, same
                    # as a worker-reported error
                    raise TrainingFailedError(
                        f"worker {i} unreachable: "
                        f"{type(e).__name__}: {e}") from e
                if r["status"] == "result":
                    results[i] = r
                elif r["status"] == "error":
                    raise TrainingFailedError(
                        f"worker {i} failed:\n{r['error']}")
                elif r["status"] == "finished":
                    finished += 1
            if finished == len(pending) and all(
                    r is None for r in results):
                return None
            if finished == len(pending) and any(
                    r is not None for r in results):
                # stragglers finished without reporting this round
                return [TrainingResult(r["metrics"], r.get("checkpoint"))
                        if r else TrainingResult({}) for r in results]
        raise TrainingFailedError("timed out waiting for worker results")

    def wait_for_checkpoints(self, timeout: float = 300.0) -> List[Any]:
        """Barrier over every rank's in-flight async checkpoint write —
        the precondition for the driver committing a step."""
        return self.worker_group.execute("wait_checkpoint", timeout=timeout)

    def finish(self) -> List[Any]:
        return self.worker_group.execute("get_error")

    def shutdown(self):
        if self.worker_group is not None:
            self.worker_group.shutdown()
            self.worker_group = None
