"""Trial state + per-trial checkpoint manager.

Reference: tune/experiment/trial.py (status machine) and
tune/execution/checkpoint_manager.py (top-K retention by metric,
CheckpointConfig air/config.py:513).

The port's copy of ``ray_tpu/tune/trial.py`` (imports renamed to
``ray_tpu_torch``), with ``CheckpointManager.replace`` for the runner's
persist after its decision (``tune.py`` ``_persist_taken``).
"""

from __future__ import annotations

import itertools
import uuid
from typing import Any, Dict, List, Optional, Tuple

PENDING = "PENDING"
RUNNING = "RUNNING"
PAUSED = "PAUSED"
TERMINATED = "TERMINATED"
ERROR = "ERROR"

_trial_counter = itertools.count()


class CheckpointManager:
    """Keep the top-K checkpoints by score (None = keep all)."""

    def __init__(self, num_to_keep: Optional[int] = None,
                 metric: Optional[str] = None, mode: str = "max"):
        self.num_to_keep = num_to_keep
        self.metric, self.mode = metric, mode
        self._items: List[Tuple[float, int, Any]] = []  # (score, seq, ckpt)
        self._seq = 0

    def add(self, checkpoint, metrics: Dict[str, Any]):
        score = 0.0
        if self.metric and self.metric in metrics:
            score = float(metrics[self.metric])
            if self.mode == "min":
                score = -score
        self._items.append((score, self._seq, checkpoint))
        self._seq += 1
        if self.num_to_keep is not None and \
                len(self._items) > self.num_to_keep:
            # evict the lowest-scored; on score ties the oldest goes first
            worst = min(self._items, key=lambda t: (t[0], t[1]))
            self._items.remove(worst)

    def replace(self, old, new):
        """Put ``new`` in the place of checkpoint ``old`` (its durable
        copy), keeping its score and order; nothing if ``old`` is gone."""
        for i, (score, seq, ckpt) in enumerate(self._items):
            if ckpt is old:
                self._items[i] = (score, seq, new)
                return

    @property
    def best(self):
        if not self._items:
            return None
        return max(self._items, key=lambda t: (t[0], t[1]))[2]

    @property
    def latest(self):
        if not self._items:
            return None
        return max(self._items, key=lambda t: t[1])[2]

    @property
    def checkpoints(self) -> List[Any]:
        return [c for _, _, c in sorted(self._items, key=lambda t: t[1])]


class Trial:
    def __init__(self, config: Dict[str, Any],
                 experiment_name: str = "exp",
                 resources: Optional[Dict[str, float]] = None,
                 num_to_keep: Optional[int] = None,
                 metric: Optional[str] = None, mode: str = "max",
                 max_failures: int = 0):
        self.index = next(_trial_counter)
        self.trial_id = f"{uuid.uuid4().hex[:8]}_{self.index}"
        self.trial_name = f"{experiment_name}_{self.index:05d}"
        self.config = config
        self.resources = dict(resources or {"CPU": 1.0})
        self.status = PENDING
        self.results: List[Dict[str, Any]] = []
        self.error: Optional[str] = None
        self.num_failures = 0
        self.max_failures = max_failures
        self.ckpt_manager = CheckpointManager(num_to_keep, metric, mode)
        self.logdir: Optional[str] = None  # set by the runner
        # runner-owned handles
        self.actor = None
        self.future = None

    def __getstate__(self):
        """Snapshot for experiment_state.pkl: drop live handles."""
        state = self.__dict__.copy()
        state["actor"] = None
        state["future"] = None
        return state

    @property
    def last_result(self) -> Optional[Dict[str, Any]]:
        return self.results[-1] if self.results else None

    @property
    def latest_checkpoint(self):
        return self.ckpt_manager.latest

    @property
    def best_checkpoint(self):
        return self.ckpt_manager.best

    def metric_history(self, metric: str) -> List[float]:
        return [float(r[metric]) for r in self.results if metric in r]

    def __repr__(self):
        return (f"Trial({self.trial_name}, {self.status}, "
                f"iters={len(self.results)})")
