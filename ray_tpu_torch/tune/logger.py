"""Experiment callbacks + result loggers (CSV / JSON / TensorBoard).

Reference: tune/callback.py (Callback hooks), tune/logger/csv.py,
logger/json.py, logger/tensorboardx.py. Loggers run driver-side inside the
TrialRunner loop; each writes into trial.logdir.

The port's copy of ``ray_tpu/tune/logger.py``
(imports renamed to ``ray_tpu_torch``).
"""

from __future__ import annotations

import csv
import json
import os
from typing import Any, Dict, List, Optional

VALID_SUMMARY_TYPES = (int, float, bool)


class Callback:
    """Driver-side experiment hooks (reference: tune/callback.py:83)."""

    def setup(self, experiment_dir: Optional[str] = None):
        pass

    def on_trial_start(self, trial):
        pass

    def on_trial_result(self, trial, result: Dict[str, Any]):
        pass

    def on_trial_complete(self, trial):
        pass

    def on_experiment_end(self, trials: List) -> None:
        pass


def _json_default(o):
    try:
        import numpy as np
        if isinstance(o, (np.integer,)):
            return int(o)
        if isinstance(o, (np.floating,)):
            return float(o)
        if isinstance(o, np.ndarray):
            return o.tolist()
    except ImportError:
        pass
    return str(o)


class LoggerCallback(Callback):
    """Base: tracks per-trial open state, closes on complete."""

    def on_trial_start(self, trial):
        if trial.logdir:
            os.makedirs(trial.logdir, exist_ok=True)
            self.log_trial_start(trial)

    def on_trial_result(self, trial, result):
        if trial.logdir:
            self.log_trial_result(trial, result)

    def on_trial_complete(self, trial):
        if trial.logdir:
            self.log_trial_end(trial)

    def log_trial_start(self, trial):
        pass

    def log_trial_result(self, trial, result):
        pass

    def log_trial_end(self, trial):
        pass


class JsonLoggerCallback(LoggerCallback):
    """params.json once + result.json (one JSON object per line).
    Reference: tune/logger/json.py."""

    def __init__(self):
        self._files: Dict[str, Any] = {}

    def log_trial_start(self, trial):
        # restarts (failure retry / PBT exploit) re-enter here: reuse the
        # open handle instead of leaking it
        with open(os.path.join(trial.logdir, "params.json"), "w") as f:
            json.dump(trial.config, f, default=_json_default)
        if trial.trial_id not in self._files:
            self._files[trial.trial_id] = open(
                os.path.join(trial.logdir, "result.json"), "a")

    def log_trial_result(self, trial, result):
        f = self._files.get(trial.trial_id)
        if f is None:
            return
        json.dump(result, f, default=_json_default)
        f.write("\n")
        f.flush()

    def log_trial_end(self, trial):
        f = self._files.pop(trial.trial_id, None)
        if f is not None:
            f.close()


class CSVLoggerCallback(LoggerCallback):
    """progress.csv with the first result's keys as the header.
    Reference: tune/logger/csv.py."""

    def __init__(self):
        self._writers: Dict[str, csv.DictWriter] = {}
        self._files: Dict[str, Any] = {}

    def log_trial_start(self, trial):
        if trial.trial_id in self._files:
            return  # trial restart: keep appending to the open file
        path = os.path.join(trial.logdir, "progress.csv")
        # resuming an experiment appends to an existing file: adopt its
        # header instead of writing a second one mid-stream
        fieldnames = None
        if os.path.exists(path) and os.path.getsize(path) > 0:
            with open(path, newline="") as existing:
                try:
                    fieldnames = next(csv.reader(existing))
                except StopIteration:
                    fieldnames = None
        self._files[trial.trial_id] = open(path, "a")
        if fieldnames:
            self._writers[trial.trial_id] = csv.DictWriter(
                self._files[trial.trial_id], fieldnames=fieldnames,
                extrasaction="ignore")

    def log_trial_result(self, trial, result):
        f = self._files.get(trial.trial_id)
        if f is None:
            return
        flat = {k: v for k, v in result.items()
                if isinstance(v, (*VALID_SUMMARY_TYPES, str))}
        w = self._writers.get(trial.trial_id)
        if w is None:
            w = csv.DictWriter(f, fieldnames=list(flat),
                               extrasaction="ignore")
            w.writeheader()
            self._writers[trial.trial_id] = w
        w.writerow({k: flat.get(k, "") for k in w.fieldnames})
        f.flush()

    def log_trial_end(self, trial):
        self._writers.pop(trial.trial_id, None)
        f = self._files.pop(trial.trial_id, None)
        if f is not None:
            f.close()


class TBXLoggerCallback(LoggerCallback):
    """TensorBoard events via tensorboardX.
    Reference: tune/logger/tensorboardx.py."""

    def __init__(self):
        self._writers: Dict[str, Any] = {}

    def log_trial_start(self, trial):
        if trial.trial_id in self._writers:
            return  # trial restart: keep the open writer
        from tensorboardX import SummaryWriter
        self._writers[trial.trial_id] = SummaryWriter(
            trial.logdir, flush_secs=10)

    def log_trial_result(self, trial, result):
        w = self._writers.get(trial.trial_id)
        if w is None:
            return
        step = result.get("training_iteration", 0)
        for k, v in result.items():
            if isinstance(v, VALID_SUMMARY_TYPES) and \
                    not isinstance(v, bool):
                w.add_scalar(f"ray/tune/{k}", float(v), global_step=step)
        w.flush()

    def log_trial_end(self, trial):
        w = self._writers.pop(trial.trial_id, None)
        if w is not None:
            # final hparams summary so TB's HPARAMS tab has the trial
            flat = {k: v for k, v in trial.config.items()
                    if isinstance(v, (*VALID_SUMMARY_TYPES, str))}
            metrics = {k: v for k, v in (trial.last_result or {}).items()
                       if isinstance(v, VALID_SUMMARY_TYPES) and
                       not isinstance(v, bool)}
            if flat and metrics:
                try:
                    w.add_hparams(flat, metrics)
                except Exception:
                    pass
            w.close()


def default_callbacks() -> List[Callback]:
    """CSV + JSON always; TBX when tensorboardX imports (reference:
    DEFAULT_LOGGERS in tune/logger/__init__.py)."""
    cbs: List[Callback] = [CSVLoggerCallback(), JsonLoggerCallback()]
    try:
        import tensorboardX  # noqa: F401
        cbs.append(TBXLoggerCallback())
    except ImportError:
        pass
    return cbs
