"""Trainable class API.

Reference semantics: tune/trainable/trainable.py:66 (class API — setup/
step/save/restore, train():320 drives one iteration). The port's copy of
the class half of ``ray_tpu/tune/trainable.py`` (:23-80), which
``rllib.Algorithm`` subclasses. The function API (``FunctionTrainable``,
``wrap_function``, over ``air.session``) is not ported yet (ROADMAP.md,
A16, with ``Tuner``).
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

from ray_tpu_torch.air.checkpoint import Checkpoint

DONE = "done"
TRAINING_ITERATION = "training_iteration"


class Trainable:
    """Class API: subclass and override setup/step/save_checkpoint/
    load_checkpoint."""

    def __init__(self, config: Optional[Dict[str, Any]] = None):
        self.config = dict(config or {})
        self._iteration = 0
        self._start_time = time.time()
        self.setup(self.config)

    # -- override points ----------------------------------------------------

    def setup(self, config: Dict[str, Any]):
        pass

    def step(self) -> Dict[str, Any]:
        raise NotImplementedError

    def save_checkpoint(self) -> Dict[str, Any]:
        return {}

    def load_checkpoint(self, state: Dict[str, Any]):
        pass

    def reset_config(self, new_config: Dict[str, Any]) -> bool:
        """Return True if the trainable reconfigures in-place (PBT exploit
        without an actor restart — reference: trainable.py reset_config)."""
        return False

    def cleanup(self):
        pass

    # -- driver-facing ------------------------------------------------------

    def train(self) -> Dict[str, Any]:
        result = self.step() or {}
        self._iteration += 1
        result.setdefault(TRAINING_ITERATION, self._iteration)
        result.setdefault("time_total_s", time.time() - self._start_time)
        result.setdefault(DONE, False)
        return result

    def save(self) -> Checkpoint:
        state = self.save_checkpoint() or {}
        state["_iteration"] = self._iteration
        return Checkpoint.from_dict(state)

    def restore(self, checkpoint: Checkpoint):
        state = checkpoint.to_dict()
        # only class-API checkpoints carry _iteration; function-API
        # checkpoints rely on the runner seeding start_iteration, which
        # must not be clobbered here
        if "_iteration" in state:
            self._iteration = state.pop("_iteration")
        self.load_checkpoint(state)

    def stop(self):
        self.cleanup()
