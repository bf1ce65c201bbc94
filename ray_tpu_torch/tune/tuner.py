"""Tuner: the modern entry point (reference: tune/tuner.py:44, fit:249).

The port's copy of ``ray_tpu/tune/tuner.py``
(imports renamed to ``ray_tpu_torch``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Union

from ray_tpu_torch.tune.schedulers import TrialScheduler
from ray_tpu_torch.tune.search import Searcher
from ray_tpu_torch.tune.tune import ExperimentAnalysis, run
from ray_tpu_torch.tune.trial import Trial


@dataclasses.dataclass
class TuneConfig:
    """Reference: tune/tune_config.py."""
    metric: Optional[str] = None
    mode: str = "max"
    num_samples: int = 1
    search_alg: Optional[Searcher] = None
    scheduler: Optional[TrialScheduler] = None
    max_concurrent_trials: int = 4


class Result:
    """One trial's outcome (reference: air/result.py)."""

    def __init__(self, trial: Trial):
        self.metrics = trial.last_result or {}
        self.checkpoint = trial.best_checkpoint
        self.config = trial.config
        self.error = trial.error
        self.trial = trial

    @property
    def best_checkpoints(self):
        return trial_checkpoints(self.trial)


def trial_checkpoints(trial: Trial):
    return [(c, None) for c in trial.ckpt_manager.checkpoints]


class ResultGrid:
    """Reference: tune/result_grid.py."""

    def __init__(self, analysis: ExperimentAnalysis):
        self._analysis = analysis
        self._results = [Result(t) for t in analysis.trials]

    def __len__(self):
        return len(self._results)

    def __getitem__(self, i) -> Result:
        return self._results[i]

    def __iter__(self):
        return iter(self._results)

    def get_best_result(self, metric: Optional[str] = None,
                        mode: Optional[str] = None) -> Result:
        t = self._analysis.get_best_trial(metric, mode)
        if t is None:
            raise RuntimeError("no trial produced the requested metric")
        return Result(t)

    def get_dataframe(self):
        return self._analysis.dataframe()

    @property
    def errors(self) -> List[str]:
        return [r.error for r in self._results if r.error]


class Tuner:
    def __init__(self, trainable: Union[Callable, type],
                 *,
                 param_space: Optional[Dict[str, Any]] = None,
                 tune_config: Optional[TuneConfig] = None,
                 run_config=None,
                 _resume: bool = False):
        self._trainable = trainable
        self._param_space = param_space or {}
        self._tune_config = tune_config or TuneConfig()
        self._run_config = run_config
        self._resume = _resume

    @classmethod
    def restore(cls, path: str, trainable: Union[Callable, type],
                *, param_space: Optional[Dict[str, Any]] = None,
                tune_config: Optional[TuneConfig] = None,
                run_config=None) -> "Tuner":
        """Resume an interrupted experiment from its experiment dir
        (reference: tune/tuner.py Tuner.restore:149). `path` is
        <local_dir>/<name>; finished trials are kept, unfinished ones
        restart from their latest checkpoint. The original run's
        checkpoint/failure/stop settings are restored from the experiment
        snapshot; pass run_config to supply the non-persisted pieces
        (callbacks, sync_config)."""
        import os
        from ray_tpu_torch.air.config import RunConfig
        path = os.path.expanduser(path.rstrip("/"))
        if run_config is None:
            run_config = RunConfig()
        run_config.name = os.path.basename(path)
        run_config.storage_path = os.path.dirname(path)
        return cls(trainable, param_space=param_space,
                   tune_config=tune_config, run_config=run_config,
                   _resume=True)

    def fit(self) -> ResultGrid:
        tc = self._tune_config
        rc = self._run_config
        stop = None
        name = "exp"
        checkpoint_freq = 0
        num_to_keep = None
        max_failures = 0
        local_dir = None
        callbacks = None
        sync_config = None
        if rc is not None:
            stop = getattr(rc, "stop", None)
            name = getattr(rc, "name", None) or "exp"
            local_dir = getattr(rc, "storage_path", None)
            callbacks = getattr(rc, "callbacks", None)
            sync_config = getattr(rc, "sync_config", None)
            ckpt_cfg = getattr(rc, "checkpoint_config", None)
            if ckpt_cfg is not None:
                checkpoint_freq = getattr(
                    ckpt_cfg, "checkpoint_frequency", 0)
                num_to_keep = getattr(ckpt_cfg, "num_to_keep", None)
            fail_cfg = getattr(rc, "failure_config", None)
            if fail_cfg is not None:
                max_failures = getattr(fail_cfg, "max_failures", 0)
        analysis = run(
            self._trainable,
            config=self._param_space,
            num_samples=tc.num_samples,
            metric=tc.metric, mode=tc.mode,
            search_alg=tc.search_alg, scheduler=tc.scheduler,
            max_concurrent_trials=tc.max_concurrent_trials,
            stop=stop, name=name,
            checkpoint_freq=checkpoint_freq,
            keep_checkpoints_num=num_to_keep,
            max_failures=max_failures,
            local_dir=local_dir, callbacks=callbacks,
            sync_config=sync_config, resume=self._resume)
        return ResultGrid(analysis)
