"""DataParallelTrainer + BaseTrainer.

The port's copy of ``ray_tpu/train/data_parallel_trainer.py``
(reference analogue: train/base_trainer.py:339, fit wraps into a Tune
trainable; train/data_parallel_trainer.py:56/329, training_loop drives
BackendExecutor). The default backend is ``TorchConfig``, in the role
the JAX package's ``JaxConfig`` plays: gang workers form one
``torch.distributed`` process group (NCCL with GPUs, gloo without), over
which a train_func builds its mesh (``parallel.mesh.MeshSpec.build``).
"""

from __future__ import annotations

import logging
import os
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch.air.config import (CheckpointConfig, FailureConfig, RunConfig,
                                ScalingConfig)
from ray_tpu_torch.train._internal.backend_executor import (BackendExecutor,
                                                      TrainingFailedError)

logger = logging.getLogger(__name__)


def _emit_train_event(severity: str, label: str, message: str, **fields):
    """Structured train-lifecycle event → local JSONL + GCS event ring.
    Gang restarts land in the same stream as PREEMPTION_NOTICE /
    NODE_DRAINING / WORKER_DIED, so recovery latency (fault → detect →
    resume) is measurable end to end from one event log."""
    try:
        from ray_tpu_torch._private.worker import global_worker
        from ray_tpu_torch.util import events as ev
        w = global_worker()
        ev.report(severity, label, message,
                  gcs_notify=lambda m, p: w.io.run_async(
                      w.gcs.notify(m, p)), **fields)
    except Exception:
        pass


@dataclass
class Result:
    """Reference analogue: ray.air.Result."""
    metrics: Dict[str, Any] = field(default_factory=dict)
    checkpoint: Optional[Any] = None
    error: Optional[str] = None
    metrics_history: List[Dict[str, Any]] = field(default_factory=list)

    @property
    def best_checkpoints(self):
        return [(self.checkpoint, self.metrics)] if self.checkpoint else []


class BaseTrainer:
    def __init__(self, *, scaling_config: Optional[ScalingConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 datasets: Optional[Dict[str, Any]] = None,
                 resume_from_checkpoint=None):
        self.scaling_config = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self.datasets = datasets or {}
        self.resume_from_checkpoint = resume_from_checkpoint

    def fit(self) -> Result:
        raise NotImplementedError

    def as_trainable(self):
        """Wrap into a Tune Trainable (reference: base_trainer.py:365)."""
        trainer = self

        def _train_fn(config):
            t = trainer._with_config_overrides(config)
            result = t._fit_internal(report_through_session=True)
            if result.error:
                raise TrainingFailedError(result.error)

        return _train_fn

    def _with_config_overrides(self, config: Dict[str, Any]):
        return self


class DataParallelTrainer(BaseTrainer):
    def __init__(self, train_loop_per_worker: Callable,
                 *, train_loop_config: Optional[Dict[str, Any]] = None,
                 backend_config=None,
                 scaling_config: Optional[ScalingConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 datasets: Optional[Dict[str, Any]] = None,
                 resume_from_checkpoint=None):
        super().__init__(scaling_config=scaling_config,
                         run_config=run_config, datasets=datasets,
                         resume_from_checkpoint=resume_from_checkpoint)
        self.train_loop_per_worker = train_loop_per_worker
        self.train_loop_config = train_loop_config or {}
        if backend_config is None:
            from ray_tpu_torch.train.torch_trainer import TorchConfig
            backend_config = TorchConfig()
        self.backend_config = backend_config

    def _with_config_overrides(self, config: Dict[str, Any]):
        merged = {**self.train_loop_config, **(config or {})}
        return DataParallelTrainer(
            self.train_loop_per_worker, train_loop_config=merged,
            backend_config=self.backend_config,
            scaling_config=self.scaling_config, run_config=self.run_config,
            datasets=self.datasets,
            resume_from_checkpoint=self.resume_from_checkpoint)

    # ------------------------------------------------------------------- fit

    def fit(self) -> Result:
        return self._fit_internal(report_through_session=False)

    def _checkpoint_root(self) -> Optional[str]:
        """Durable checkpoint root for this run, or None (in-band
        checkpoints, the pre-engine behavior). A run opts into the engine
        by having a stable identity: RunConfig.storage_path and/or name."""
        rc = self.run_config
        if rc.storage_path is None and rc.name is None:
            return None
        base = rc.storage_path or os.environ.get(
            "RTT_RESULTS_DIR", os.path.expanduser("~/ray_tpu_torch_results"))
        return os.path.join(os.path.expanduser(base), rc.name or "train",
                            "checkpoints")

    def _make_checkpoint_manager(self):
        root = self._checkpoint_root()
        if root is None:
            return None
        from ray_tpu_torch.checkpoint import CheckpointManager
        return CheckpointManager(
            root, checkpoint_config=self.run_config.checkpoint_config)

    def _fit_internal(self, report_through_session: bool) -> Result:
        failure_cfg = self.run_config.failure_config
        attempts_left = max(failure_cfg.max_failures, 0)
        infinite = failure_cfg.max_failures == -1
        checkpoint = self.resume_from_checkpoint
        manager = self._make_checkpoint_manager()
        if checkpoint is None and manager is not None:
            # gang restart across driver restarts: resume from the newest
            # fully-committed step (partial/corrupt steps are skipped)
            latest = manager.latest_committed()
            if latest is not None:
                checkpoint = manager.load(latest)
                logger.info("resuming from committed checkpoint step %d",
                            latest)
        attempt = 0
        while True:
            try:
                return self._run_once(checkpoint, report_through_session,
                                      manager, is_restart=attempt > 0)
            except TrainingFailedError as e:
                logger.warning("training attempt failed: %s", e)
                if not infinite and attempts_left <= 0:
                    return Result(error=str(e), checkpoint=checkpoint)
                attempts_left -= 1
                attempt += 1
                latest = None
                if manager is not None:
                    # a worker that died mid-save leaves an uncommitted
                    # tmp/step dir — latest_committed() skips it, so the
                    # gang restarts from the last *intact* step
                    latest = manager.latest_committed()
                    checkpoint = (manager.load(latest)
                                  if latest is not None
                                  else self.resume_from_checkpoint)
                else:
                    checkpoint = self._latest_checkpoint or checkpoint
                _emit_train_event(
                    "WARNING", "TRAIN_GANG_RESTART",
                    f"gang restart (attempt {attempt}) from committed "
                    f"step {latest}: {e}",
                    attempt=attempt, resumed_step=latest,
                    run_name=self.run_config.name or "")
                logger.warning(
                    "restarting gang from last checkpoint (%s retries left)",
                    "inf" if infinite else attempts_left)

    def _run_once(self, checkpoint, report_through_session: bool,
                  manager=None, is_restart: bool = False) -> Result:
        from ray_tpu_torch.air import session as air_session
        executor = BackendExecutor(self.scaling_config, self.backend_config)
        self._latest_checkpoint = checkpoint
        trial_id = uuid.uuid4().hex[:8]
        ckpt_start_step = 0
        if manager is not None:
            latest = manager.latest_committed()
            ckpt_start_step = latest + 1 if latest is not None else 0
        try:
            executor.start()
            dataset_shards = self._shard_datasets(
                self.scaling_config.num_workers)
            executor.start_training(
                self.train_loop_per_worker, self.train_loop_config,
                checkpoint=checkpoint, dataset_shards=dataset_shards,
                trial_info={"trial_id": trial_id,
                            "trial_name": self.run_config.name or
                            f"train-{trial_id}"},
                checkpoint_root=manager.root if manager else None,
                ckpt_start_step=ckpt_start_step)
            history: List[Dict[str, Any]] = []
            last_metrics: Dict[str, Any] = {}
            while True:
                round_results = executor.get_next_results()
                if is_restart:
                    # first round after a gang restart: the run is live
                    # again — this event closes the recovery window that
                    # opened at the fault (PREEMPTION_NOTICE/WORKER_DIED)
                    is_restart = False
                    _emit_train_event(
                        "INFO", "TRAIN_RESUMED",
                        "gang resumed after restart",
                        run_name=self.run_config.name or "",
                        ckpt_start_step=ckpt_start_step)
                if round_results is None:
                    break
                rank0 = round_results[0]
                last_metrics = rank0.metrics
                history.append(rank0.metrics)
                ckpt = next((r.checkpoint for r in round_results
                             if r.checkpoint is not None), None)
                if ckpt is not None:
                    ckpt = self._commit_round_checkpoint(
                        executor, manager, round_results, ckpt)
                if ckpt is not None:
                    self._latest_checkpoint = ckpt
                if report_through_session and air_session.in_session():
                    air_session.report(rank0.metrics,
                                       checkpoint=self._latest_checkpoint)
                if self._should_stop(last_metrics):
                    break
            return Result(metrics=last_metrics,
                          checkpoint=self._latest_checkpoint,
                          metrics_history=history)
        finally:
            executor.shutdown()

    def _commit_round_checkpoint(self, executor, manager, round_results,
                                 ckpt):
        """Seal a staged step once the whole gang has reported it. The
        round itself is the barrier: every rank staged (sync dict payloads)
        or enqueued (async sharded saves) before reporting; we wait out
        in-flight writers, then commit atomically. Returns the committed
        directory-backed Checkpoint, or None if the step can't be sealed
        (the previous intact step stays latest)."""
        from ray_tpu_torch.checkpoint import PendingCheckpoint
        if not isinstance(ckpt, PendingCheckpoint):
            return ckpt  # in-band payload (no manager configured)
        if manager is None:
            logger.warning("dropping PendingCheckpoint(step=%d): driver "
                           "has no checkpoint manager", ckpt.step)
            return None
        step = max(r.checkpoint.step for r in round_results
                   if isinstance(r.checkpoint, PendingCheckpoint))
        try:
            executor.wait_for_checkpoints()
            manager.commit_step(step)
            return manager.load(step)
        except Exception as e:  # noqa: BLE001 — a torn save must not
            # kill training; the previous committed step remains latest
            logger.warning("checkpoint step %d failed to commit: %r",
                           step, e)
            return None

    def _should_stop(self, metrics: Dict[str, Any]) -> bool:
        stop = self.run_config.stop
        if not stop:
            return False
        for k, v in stop.items():
            if k in metrics and metrics[k] >= v:
                return True
        return False

    def _shard_datasets(self, num_workers: int) -> Dict[str, Any]:
        """Split each dataset into per-worker shards (reference:
        RayDatasetSpec.get_dataset_shards).  With the streaming executor
        enabled, shards of a pending map chain carry the un-executed
        stages (Dataset.streaming_split) so each worker pipelines its own
        ingest instead of waiting for a driver-side materialization."""
        from ray_tpu_torch.data._internal.streaming_executor import (
            streaming_enabled)
        out: Dict[str, Any] = {}
        for name, ds in self.datasets.items():
            if streaming_enabled() and hasattr(ds, "streaming_split"):
                out[name] = ds.streaming_split(num_workers)
            elif hasattr(ds, "split"):
                out[name] = ds.split(num_workers)
            else:
                out[name] = ds
        return out
