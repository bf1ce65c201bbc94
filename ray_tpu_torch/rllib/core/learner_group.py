"""LearnerGroup — local mode.

Reference analogue: rllib/core/learner/learner_group.py. Counterpart of
``ray_tpu/rllib/core/learner_group.py``'s local mode
(``num_learners=0``, :40-41): the learner runs inline, the default for
single-host training and for tests. Data-parallel learner actors
(``num_learners > 0``) need the runtime's actors (ROADMAP.md Queue A,
A1) and raise; they never fall back to a local learner.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from ray_tpu_torch.rllib.core.learner import Learner


class LearnerGroup:
    def __init__(self, learner_cls, *, num_learners: int = 0,
                 learner_kwargs: Optional[Dict[str, Any]] = None):
        if num_learners > 0:
            raise NotImplementedError(
                "remote learners (num_learners > 0) need the runtime's "
                "actors, which the port does not have yet (ROADMAP.md "
                "Queue A, A1); use num_learners=0")
        self._local: Learner = learner_cls(**dict(learner_kwargs or {}))

    @property
    def is_local(self) -> bool:
        return True

    def update_from_batch(self, batch: Dict[str, Any]
                          ) -> Dict[str, Dict[str, float]]:
        return self._local.update_from_batch(batch)

    def get_state(self) -> Dict[str, Any]:
        return self._local.get_state()

    def set_state(self, state: Dict[str, Any]):
        self._local.set_state(state)

    def shutdown(self):
        pass
