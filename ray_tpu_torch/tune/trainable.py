"""Trainable API + function-trainable wrapper.

Reference semantics: tune/trainable/trainable.py:66 (class API — setup/
step/save/restore, train():320 drives one iteration) and
tune/trainable/function_trainable.py:284 (function API — the user fn runs
in a thread, session.report() yields results back to the driver).

The port's copy of ``ray_tpu/tune/trainable.py``: the class half, which
``rllib.Algorithm`` subclasses, and the function half over the port's
``air.session``, whose session also carries the trial's GPU grant
(``session.get_gpu_ids()``, as a train worker's does).
"""

from __future__ import annotations

import threading
import time
import traceback
from typing import Any, Callable, Dict, Optional

from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.air import session as air_session

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


def _gpu_grant() -> tuple:
    """The calling worker's GPU grant; () outside a cluster."""
    import ray_tpu_torch
    return (tuple(ray_tpu_torch.get_gpu_ids())
            if ray_tpu_torch.is_initialized() else ())


class FunctionTrainable(Trainable):
    """Wraps ``fn(config)`` (or ``fn(config, checkpoint)``): runs it in a
    thread with an installed session; each session.report() becomes one
    train() result."""

    _fn: Callable = None  # set by subclass factory

    def setup(self, config: Dict[str, Any]):
        self._session = air_session._Session(
            trial_id=config.pop("__trial_id__", ""),
            trial_name=config.pop("__trial_name__", ""),
            checkpoint=config.pop("__checkpoint__", None),
            gpu_ids=_gpu_grant())
        self._error: Optional[str] = None
        self._thread_done = threading.Event()

        def runner():
            air_session._set_session(self._session)
            try:
                self._fn(dict(config))
            except Exception:
                self._error = traceback.format_exc()
            finally:
                self._thread_done.set()
                # unblock a train() waiting on the queue
                self._session.result_queue.put(None)

        self._thread = threading.Thread(target=runner, daemon=True)
        self._thread.start()

    def step(self) -> Dict[str, Any]:
        item = self._session.result_queue.get()
        if item is None:
            if self._error:
                raise RuntimeError(f"trainable function failed:\n"
                                   f"{self._error}")
            return {DONE: True}
        result = dict(item.metrics)
        if item.checkpoint is not None:
            result["__checkpoint__"] = item.checkpoint
        return result

    def save_checkpoint(self) -> Dict[str, Any]:
        # function API checkpoints travel inside results via session.report
        return {}

    def load_checkpoint(self, state):
        pass

    def cleanup(self):
        self._session.stop_event.set()


def wrap_function(fn: Callable) -> type:
    """Build a FunctionTrainable subclass bound to ``fn``."""
    return type(f"func_{getattr(fn, '__name__', 'trainable')}",
                (FunctionTrainable,), {"_fn": staticmethod(fn)})
