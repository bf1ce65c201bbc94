"""TrialRunner event loop + tune.run().

Reference call stack (SURVEY.md §3.4): Tuner.fit → tune.run
(tune/tune.py:131) → TrialRunner.step (execution/trial_runner.py:962) with
one Trainable actor per trial (execution/ray_trial_executor.py:350).
Here the executor is folded into the runner: trials are ray_tpu_torch actors,
results stream back as object refs, schedulers/searchers see every result.

The port's copy of ``ray_tpu/tune/tune.py`` (imports renamed to
``ray_tpu_torch``, ``RTPU_*`` knobs to ``RTT_*``). Trial resources map
as in JAX, with the GPU as the accelerator: a ``{"GPU": n}`` trial is an
actor with ``num_gpus=n``, granted devices by index like any other
(``get_gpu_ids()``, ``CUDA_VISIBLE_DEVICES``). ``"TPU"`` is refused
(``_check_resources``), and a trial whose config asks for
``device="cuda"`` without a whole GPU fails before its actor starts:
nothing runs on the CPU in its place. ``with_resources`` attaches a
trainable's per-trial resources, for ``Tuner``, which has no
``resources_per_trial`` of its own. A result's checkpoint is registered
with its trial as it came, the scheduler decides, and only then is the
checkpoint persisted (JAX persists first), so a trial that stops frees
its card while its last checkpoint is written.
"""

from __future__ import annotations

import json
import logging
import os
import pickle
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Type, Union

logger = logging.getLogger(__name__)

import ray_tpu_torch
from ray_tpu_torch.tune import search as search_mod
from ray_tpu_torch.tune.sample import Domain, GridSearch
from ray_tpu_torch.tune.schedulers import (CONTINUE, STOP, FIFOScheduler,
                                     TrialScheduler)
from ray_tpu_torch.tune.search import BasicVariantGenerator, Searcher
from ray_tpu_torch.tune.trainable import (DONE, TRAINING_ITERATION, Trainable,
                                    wrap_function)
from ray_tpu_torch.tune.trial import (ERROR, PENDING, RUNNING, TERMINATED, Trial)


def _check_resources(resources: Optional[Dict[str, float]]):
    """Refuse what the port's runtime cannot grant: it has no TPU
    resource, and a custom ``TPU`` resource would leave the trial
    pending forever."""
    if resources and "TPU" in resources:
        raise ValueError(
            f"resources {dict(resources)!r} ask for 'TPU': the port's "
            "runtime grants GPUs; ask for 'GPU' instead")


def _check_device(trial: Trial):
    """A trial whose config puts its work on ``cuda`` needs a whole GPU:
    a fractional grant or none leaves ``CUDA_VISIBLE_DEVICES`` empty."""
    dev = trial.config.get("device") if isinstance(trial.config,
                                                   dict) else None
    if str(dev or "").startswith("cuda") and \
            float(trial.resources.get("GPU", 0)) < 1:
        raise ValueError(
            f"trial {trial.trial_name} asks for device {str(dev)!r} but "
            f"its resources {dict(trial.resources)!r} grant no whole GPU: "
            "pass resources_per_trial={'CPU': 1, 'GPU': 1} (or "
            "tune.with_resources)")


def with_resources(trainable: Union[Callable, Type[Trainable]],
                   resources: Dict[str, float]) -> Type[Trainable]:
    """``trainable`` (a function or a ``Trainable`` subclass) as a
    ``Trainable`` subclass whose trials ask for ``resources`` when
    ``tune.run`` gets no ``resources_per_trial`` (reference:
    tune/trainable/util.py ``with_resources``)."""
    _check_resources(resources)
    if isinstance(trainable, type) and issubclass(trainable, Trainable):
        cls = type(trainable.__name__, (trainable,), {})
    else:
        cls = wrap_function(trainable)
    cls._tune_resources = dict(resources)
    return cls


class _TrialActorShim:
    """The per-trial actor: hosts the Trainable instance."""

    def create(self, trainable_cls, config, start_iteration: int = 0) -> bool:
        self._t = trainable_cls(config)
        # restart continuity: training_iteration keeps counting across
        # failure-restarts (function trainables don't persist it themselves)
        if start_iteration:
            self._t._iteration = start_iteration
        return True

    def train(self) -> Dict[str, Any]:
        return self._t.train()

    def save(self):
        return self._t.save()

    def restore(self, ckpt) -> bool:
        self._t.restore(ckpt)
        return True

    def reset(self, config) -> bool:
        return bool(self._t.reset_config(config))

    def stop(self) -> bool:
        self._t.stop()
        return True


_TrialActor = ray_tpu_torch.remote(_TrialActorShim)


class TrialRunner:
    def __init__(self, trainable_cls: Type[Trainable],
                 searcher: Searcher,
                 scheduler: Optional[TrialScheduler] = None,
                 *,
                 experiment_name: str = "exp",
                 metric: Optional[str] = None, mode: str = "max",
                 stop: Optional[Dict[str, Any]] = None,
                 max_concurrent: int = 4,
                 resources_per_trial: Optional[Dict[str, float]] = None,
                 checkpoint_freq: int = 0,
                 num_to_keep: Optional[int] = None,
                 max_failures: int = 0,
                 callbacks: Optional[List] = None,
                 local_dir: Optional[str] = None):
        self.trainable_cls = trainable_cls
        self.searcher = searcher
        self.scheduler = scheduler or FIFOScheduler()
        self.scheduler.set_search_properties(metric, mode)
        self.experiment_name = experiment_name
        self.metric, self.mode = metric, mode
        self.stop_criteria = dict(stop or {})
        self.max_concurrent = max_concurrent
        self.resources_per_trial = resources_per_trial or {"CPU": 1.0}
        self.checkpoint_freq = checkpoint_freq
        self.num_to_keep = num_to_keep
        self.max_failures = max_failures
        self.callbacks = callbacks or []
        self.trials: List[Trial] = []
        self._exhausted = False
        self.experiment_dir: Optional[str] = None
        if local_dir is not None:
            self.experiment_dir = os.path.join(
                os.path.expanduser(local_dir), experiment_name)
            os.makedirs(self.experiment_dir, exist_ok=True)
        for cb in self.callbacks:
            if hasattr(cb, "setup"):
                cb.setup(experiment_dir=self.experiment_dir)

    # ------------------------------------------------- experiment state

    def _snapshot(self, force: bool = False):
        """Persist resumable experiment state (reference:
        tune/execution/trial_runner.py checkpoint + experiment_state-*.json
        in the experiment dir). Throttled: trials carry their checkpoint
        payloads in-memory, so a snapshot can be large — rewriting it on
        every result would stall the driver."""
        if self.experiment_dir is None:
            return
        now = time.time()
        period = float(os.environ.get("RTT_TUNE_SNAPSHOT_PERIOD", "10"))
        if not force and now - getattr(self, "_last_snapshot", 0.0) < period:
            return
        self._last_snapshot = now
        try:
            payload = {"trials": self.trials, "exhausted": self._exhausted,
                       "searcher": self.searcher,
                       "scheduler": self.scheduler,
                       "settings": {
                           "checkpoint_freq": self.checkpoint_freq,
                           "num_to_keep": self.num_to_keep,
                           "max_failures": self.max_failures,
                           "stop": self.stop_criteria,
                           "metric": self.metric, "mode": self.mode,
                       },
                       "timestamp": now}
            tmp = os.path.join(self.experiment_dir,
                               ".experiment_state.pkl.tmp")
            with open(tmp, "wb") as f:
                pickle.dump(payload, f)
            os.replace(tmp, os.path.join(self.experiment_dir,
                                         "experiment_state.pkl"))
        except Exception:
            return  # unpicklable user objects: skip resumability, not runs
        summary = [{"trial_id": t.trial_id, "name": t.trial_name,
                    "status": t.status, "iterations": len(t.results),
                    "last_result": {
                        k: v for k, v in (t.last_result or {}).items()
                        if isinstance(v, (int, float, str, bool))}}
                   for t in self.trials]
        with open(os.path.join(self.experiment_dir,
                               "experiment_state.json"), "w") as f:
            json.dump(summary, f, indent=1)

    def restore_from_dir(self, experiment_dir: str):
        """Rebuild trials from a prior run's snapshot; unfinished trials
        restart from their latest checkpoint."""
        path = os.path.join(experiment_dir, "experiment_state.pkl")
        with open(path, "rb") as f:
            payload = pickle.load(f)
        self.trials = payload["trials"]
        self._exhausted = payload["exhausted"]
        self.searcher = payload["searcher"]
        if payload.get("scheduler") is not None:
            # keep ASHA rungs / PBT scores etc. across the resume
            self.scheduler = payload["scheduler"]
        # the original run's settings win over the restoring runner's
        # defaults (Tuner.restore only knows the path)
        s = payload.get("settings", {})
        self.checkpoint_freq = s.get("checkpoint_freq",
                                     self.checkpoint_freq)
        self.num_to_keep = s.get("num_to_keep", self.num_to_keep)
        self.max_failures = s.get("max_failures", self.max_failures)
        self.stop_criteria = s.get("stop", self.stop_criteria)
        self.metric = s.get("metric", self.metric)
        self.mode = s.get("mode", self.mode)
        for t in self.trials:
            if t.status in (RUNNING, PENDING):
                t.status = PENDING
        # keep new trial names/dirs collision-free across the resume
        import itertools
        from ray_tpu_torch.tune import trial as trial_mod
        maxi = max((t.index for t in self.trials), default=-1)
        trial_mod._trial_counter = itertools.count(maxi + 1)

    # ------------------------------------------------------------- helpers

    def get_trial(self, trial_id: str) -> Optional[Trial]:
        for t in self.trials:
            if t.trial_id == trial_id:
                return t
        return None

    def _live_trials(self) -> List[Trial]:
        return [t for t in self.trials if t.status in (PENDING, RUNNING)]

    def _running(self) -> List[Trial]:
        return [t for t in self.trials if t.status == RUNNING]

    # -------------------------------------------------------------- driving

    def _maybe_create_trials(self):
        while (not self._exhausted and
               len(self._live_trials()) < self.max_concurrent):
            tentative = Trial({}, self.experiment_name)
            config = self.searcher.suggest(tentative.trial_id)
            if config is search_mod.PENDING:
                break
            if config is None:
                self._exhausted = True
                break
            trial = tentative
            trial.config = config
            trial.resources = dict(self.resources_per_trial)
            trial.max_failures = self.max_failures
            trial.ckpt_manager.num_to_keep = self.num_to_keep
            trial.ckpt_manager.metric = self.metric
            trial.ckpt_manager.mode = self.mode
            if self.experiment_dir is not None:
                trial.logdir = os.path.join(self.experiment_dir,
                                            trial.trial_name)
                os.makedirs(trial.logdir, exist_ok=True)
            self.trials.append(trial)

    def _start_trial(self, trial: Trial, checkpoint=None):
        _check_device(trial)
        opts: Dict[str, Any] = {}
        custom: Dict[str, float] = {}
        for k, v in trial.resources.items():
            if k == "CPU":
                opts["num_cpus"] = v
            elif k == "GPU":
                opts["num_gpus"] = v
            elif k == "memory":
                opts["memory"] = v
            else:
                custom[k] = v
        if custom:
            opts["resources"] = custom
        trial.actor = _TrialActor.options(**opts).remote()
        cfg = dict(trial.config)
        cfg["__trial_id__"] = trial.trial_id
        cfg["__trial_name__"] = trial.trial_name
        if checkpoint is not None:
            cfg["__checkpoint__"] = checkpoint
        # NO blocking gets here: per-actor call ordering sequences
        # create -> restore -> train on the actor, and the actor itself
        # may still be PENDING_CREATION behind running trials' resources.
        # A synchronous wait at this point deadlocks the runner: it can
        # never process the running trials' results, so the resources the
        # pending actor needs are never released (observed as a hang the
        # moment trials exceed cluster CPUs with prestarted workers).
        setup_refs = [trial.actor.create.remote(
            self.trainable_cls, cfg, len(trial.results))]
        if checkpoint is not None:
            setup_refs.append(trial.actor.restore.remote(checkpoint))
        # checked when train's first result lands (_check_setup_refs):
        # by per-actor ordering they are resolved by then, so a failed
        # restore surfaces as a trial failure instead of silently
        # training from scratch
        trial.setup_refs = setup_refs
        trial.status = RUNNING
        trial.future = trial.actor.train.remote()
        for cb in self.callbacks:
            cb.on_trial_start(trial)

    def _stop_trial(self, trial: Trial, status: str = TERMINATED):
        if trial.actor is not None:
            try:
                trial.actor.stop.remote()
                ray_tpu_torch.kill(trial.actor)
            except Exception:
                pass
            trial.actor = None
        trial.future = None
        trial.status = status
        self.searcher.on_trial_complete(
            trial.trial_id, trial.last_result, error=(status == ERROR))
        self.scheduler.on_trial_complete(self, trial, trial.last_result)
        for cb in self.callbacks:
            cb.on_trial_complete(trial)

    def _should_stop_trial(self, trial: Trial, result: Dict) -> bool:
        if result.get(DONE):
            return True
        for key, bound in self.stop_criteria.items():
            if key in result and float(result[key]) >= float(bound):
                return True
        return False

    def _take_checkpoint(self, trial: Trial, result: Dict):
        """The result's checkpoint (in band, or saved now by
        checkpoint_freq), registered with the trial as it came; returns
        it for ``_persist_taken`` or None."""
        ckpt = result.pop("__checkpoint__", None)
        if ckpt is None and self.checkpoint_freq and \
                result.get(TRAINING_ITERATION, 0) % self.checkpoint_freq == 0:
            try:
                ckpt = ray_tpu_torch.get(trial.actor.save.remote())
            except Exception:
                ckpt = None
        if ckpt is not None:
            trial.ckpt_manager.add(ckpt, result)
        return ckpt

    def _persist_taken(self, trial: Trial, ckpt, result: Dict):
        """Swap a taken checkpoint for its durable copy (the JAX runner
        persists before the trial's next train() and its scheduler
        decision; here they come first, so a stopped trial's card frees
        while its last checkpoint is written)."""
        durable = self._persist_checkpoint(trial, ckpt, result)
        if durable is not ckpt:
            trial.ckpt_manager.replace(ckpt, durable)

    def _persist_checkpoint(self, trial: Trial, ckpt, result: Dict):
        """Route trial checkpoints through the durable engine
        (<logdir>/checkpoints, atomic commit): a driver crash between
        result rounds can no longer lose every checkpoint with the
        process. Disk retention by recency only applies when no metric is
        set — score-based top-K stays the in-memory manager's call.
        RTT_TUNE_DISK_CKPT=0 restores the in-memory-only behavior."""
        if trial.logdir is None or \
                os.environ.get("RTT_TUNE_DISK_CKPT", "1") == "0":
            return ckpt
        try:
            from ray_tpu_torch.checkpoint import CheckpointManager
            mgr = getattr(trial, "_disk_ckpt_mgr", None)
            if mgr is None:
                mgr = CheckpointManager(
                    os.path.join(trial.logdir, "checkpoints"),
                    num_to_keep=(self.num_to_keep
                                 if self.metric is None else None))
                trial._disk_ckpt_mgr = mgr
            latest = mgr.latest_committed()
            step = max(result.get(TRAINING_ITERATION, 0),
                       (latest + 1) if latest is not None else 0)
            mgr.stage(step, ckpt)
            mgr.commit_step(step)
            return mgr.load(step)
        except Exception as e:  # noqa: BLE001 — durability is best-effort
            # here; the in-band payload still reaches the in-memory manager
            logger.warning("trial %s: disk checkpoint persist failed: %r",
                           trial.trial_id, e)
            return ckpt

    def _check_setup_refs(self, trial: Trial) -> bool:
        """Surface create/restore errors once train has produced its
        first signal (actor ordering guarantees they resolved first).
        True = setup was clean."""
        refs, trial.setup_refs = getattr(trial, "setup_refs", None), None
        if not refs:
            return True
        try:
            ray_tpu_torch.get(refs, timeout=10)
            return True
        except Exception as e:
            self._process_failure(trial, e)
            return False

    def _process_result(self, trial: Trial, result: Dict[str, Any]):
        if not self._check_setup_refs(trial):
            return
        auto_keys = {DONE, TRAINING_ITERATION, "time_total_s",
                     "__checkpoint__"}
        if result.get(DONE) and not (set(result) - auto_keys):
            # terminal sentinel from a finished function trainable — don't
            # let it clobber last_result's metrics
            self._stop_trial(trial, TERMINATED)
            return
        trial.results.append(result)
        self.searcher.on_trial_result(trial.trial_id, result)
        # pops the in-band __checkpoint__ payload so loggers see a clean
        # metrics dict
        taken = self._take_checkpoint(trial, result)
        try:
            self._decide(trial, result)
        finally:
            if taken is not None:
                self._persist_taken(trial, taken, result)

    def _decide(self, trial: Trial, result: Dict[str, Any]):
        for cb in self.callbacks:
            cb.on_trial_result(trial, result)
        if self._should_stop_trial(trial, result):
            # checkpoint-at-end so stop-criteria trials don't finish bare
            if self.checkpoint_freq and not result.get(DONE):
                try:
                    ckpt = ray_tpu_torch.get(trial.actor.save.remote())
                    trial.ckpt_manager.add(ckpt, result)
                except Exception:
                    pass
            self._stop_trial(trial, TERMINATED)
            return
        fut_before = trial.future
        decision = self.scheduler.on_trial_result(self, trial, result)
        if decision == STOP:
            self._stop_trial(trial, TERMINATED)
        elif trial.future is fut_before:
            # a PBT exploit may have restarted the actor and queued its
            # first train() already — don't double-schedule
            trial.future = trial.actor.train.remote()

    def _process_failure(self, trial: Trial, err: BaseException):
        trial.error = "".join(traceback.format_exception_only(
            type(err), err))
        trial.num_failures += 1
        if trial.num_failures <= trial.max_failures:
            # restart from the latest checkpoint (reference:
            # trial_runner.py:1336 restore-on-failure path)
            ckpt = trial.latest_checkpoint
            try:
                if trial.actor is not None:
                    ray_tpu_torch.kill(trial.actor)
            except Exception:
                pass
            trial.actor = None
            try:
                self._start_trial(trial, checkpoint=ckpt)
            except Exception as restart_err:
                trial.error += f"\nrestart failed: {restart_err!r}"
                self._stop_trial(trial, ERROR)
        else:
            self._stop_trial(trial, ERROR)

    # PBT exploit hook (called by the scheduler)
    def exploit(self, trial: Trial, donor: Trial,
                new_config: Dict[str, Any]):
        ckpt = donor.latest_checkpoint
        if ckpt is None:
            return
        trial.config = new_config
        in_place = False
        try:
            in_place = ray_tpu_torch.get(trial.actor.reset.remote(new_config))
        except Exception:
            in_place = False
        if in_place:
            ray_tpu_torch.get(trial.actor.restore.remote(ckpt))
        else:
            try:
                ray_tpu_torch.kill(trial.actor)
            except Exception:
                pass
            trial.actor = None
            self._start_trial(trial, checkpoint=ckpt)
        trial.ckpt_manager.add(ckpt, donor.last_result or {})

    # ResourceChangingScheduler hook (called by the scheduler)
    def update_trial_resources(self, trial: Trial,
                               resources: Dict[str, float]):
        """Restart the trial's actor with new resources from its own
        latest checkpoint (reference: ray_trial_executor's
        resource-update path used by ResourceChangingScheduler)."""
        if dict(trial.resources) == dict(resources):
            return False
        _check_resources(resources)
        ckpt = trial.latest_checkpoint
        if ckpt is None:
            # restarting without a checkpoint would discard all progress
            logger.warning(
                "skipping resource update for %s: no checkpoint yet "
                "(set checkpoint_freq>=1 to let resources change)",
                trial.trial_id)
            return False
        try:
            if trial.actor is not None:
                ray_tpu_torch.kill(trial.actor)
        except Exception:
            pass
        trial.actor = None
        trial.resources = dict(resources)
        self._start_trial(trial, checkpoint=ckpt)
        return True

    # ---------------------------------------------------------------- loop

    def step(self):
        self._maybe_create_trials()
        for trial in self.trials:
            if trial.status == PENDING and trial.actor is None:
                try:
                    # resumed trials restart from their latest checkpoint
                    self._start_trial(trial,
                                      checkpoint=trial.latest_checkpoint)
                except Exception as e:
                    self._process_failure(trial, e)
        futures = {t.future: t for t in self._running()
                   if t.future is not None}
        if not futures:
            return
        ready, _ = ray_tpu_torch.wait(list(futures), num_returns=1, timeout=30.0)
        for ref in ready:
            trial = futures[ref]
            try:
                result = ray_tpu_torch.get(ref)
            except Exception as e:
                self._process_failure(trial, e)
                continue
            self._process_result(trial, result)

    def is_finished(self) -> bool:
        return self._exhausted and not self._live_trials()

    def run_all(self):
        while not self.is_finished():
            self.step()
            self._snapshot()
        self._snapshot(force=True)
        for cb in self.callbacks:
            if hasattr(cb, "on_experiment_end"):
                cb.on_experiment_end(self.trials)
        return self.trials


# ---------------------------------------------------------------------------


def run(trainable: Union[Callable, Type[Trainable]],
        *,
        config: Optional[Dict[str, Any]] = None,
        num_samples: int = 1,
        metric: Optional[str] = None,
        mode: str = "max",
        stop: Optional[Dict[str, Any]] = None,
        search_alg: Optional[Searcher] = None,
        scheduler: Optional[TrialScheduler] = None,
        max_concurrent_trials: int = 4,
        resources_per_trial: Optional[Dict[str, float]] = None,
        checkpoint_freq: int = 0,
        keep_checkpoints_num: Optional[int] = None,
        max_failures: int = 0,
        name: str = "exp",
        callbacks: Optional[List] = None,
        local_dir: Optional[str] = None,
        sync_config=None,
        resume: bool = False,
        verbose: int = 0) -> "ExperimentAnalysis":
    """The reference's tune.run (tune/tune.py:131)."""
    from ray_tpu_torch._private import usage as _usage
    _usage.record_library_usage("tune")
    config = config or {}
    if isinstance(trainable, type) and issubclass(trainable, Trainable):
        trainable_cls = trainable
    elif callable(trainable):
        trainable_cls = wrap_function(trainable)
    else:
        raise TypeError(f"trainable must be a function or Trainable subclass,"
                        f" got {type(trainable)}")
    if resources_per_trial is None:
        resources_per_trial = getattr(trainable_cls, "_tune_resources", None)
    _check_resources(resources_per_trial)

    if search_alg is None:
        search_alg = BasicVariantGenerator(config, num_samples=num_samples,
                                           metric=metric, mode=mode)
    else:
        search_alg.set_search_properties(metric, mode, config)

    if local_dir is None:
        local_dir = os.environ.get(
            "RTT_RESULTS_DIR", os.path.expanduser("~/ray_tpu_torch_results"))
    if callbacks is None:
        from ray_tpu_torch.tune.logger import default_callbacks
        callbacks = default_callbacks()
    if sync_config is not None and getattr(
            sync_config, "upload_dir", None):
        from ray_tpu_torch.tune.syncer import SyncerCallback
        callbacks = list(callbacks) + [SyncerCallback(sync_config)]

    runner = TrialRunner(
        trainable_cls, search_alg, scheduler,
        experiment_name=name, metric=metric, mode=mode, stop=stop,
        max_concurrent=max_concurrent_trials,
        resources_per_trial=resources_per_trial,
        checkpoint_freq=checkpoint_freq,
        num_to_keep=keep_checkpoints_num,
        max_failures=max_failures, callbacks=callbacks,
        local_dir=local_dir)
    if resume:
        state = os.path.join(runner.experiment_dir or "",
                             "experiment_state.pkl")
        if not os.path.exists(state):
            # a silent fall-through would rerun the whole sweep from
            # scratch while the caller believes they resumed
            raise FileNotFoundError(
                f"resume requested but no experiment state at {state!r}")
        runner.restore_from_dir(runner.experiment_dir)
    trials = runner.run_all()
    return ExperimentAnalysis(trials, metric=metric, mode=mode)


class ExperimentAnalysis:
    """Result accessor (reference: tune/analysis/experiment_analysis.py)."""

    def __init__(self, trials: List[Trial], metric: Optional[str] = None,
                 mode: str = "max"):
        self.trials = trials
        self.default_metric, self.default_mode = metric, mode

    def get_best_trial(self, metric: Optional[str] = None,
                       mode: Optional[str] = None,
                       scope: str = "last") -> Optional[Trial]:
        metric = metric or self.default_metric
        mode = mode or self.default_mode
        sign = 1.0 if mode == "max" else -1.0
        best, best_v = None, None
        for t in self.trials:
            hist = t.metric_history(metric)
            if not hist:
                continue
            candidates = hist if scope == "all" else hist[-1:]
            v = max(sign * h for h in candidates)
            if best_v is None or v > best_v:
                best, best_v = t, v
        return best

    @property
    def best_trial(self) -> Optional[Trial]:
        return self.get_best_trial()

    @property
    def best_config(self) -> Optional[Dict[str, Any]]:
        t = self.best_trial
        return t.config if t else None

    @property
    def best_result(self) -> Optional[Dict[str, Any]]:
        t = self.best_trial
        return t.last_result if t else None

    @property
    def best_checkpoint(self):
        t = self.best_trial
        return t.best_checkpoint if t else None

    def dataframe(self):
        import pandas as pd
        rows = []
        for t in self.trials:
            row = dict(t.last_result or {})
            row["trial_id"] = t.trial_id
            row["status"] = t.status
            for k, v in t.config.items():
                row[f"config/{k}"] = v
            rows.append(row)
        return pd.DataFrame(rows)

    @property
    def results(self) -> List[Optional[Dict[str, Any]]]:
        return [t.last_result for t in self.trials]
