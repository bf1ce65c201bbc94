"""SampleBatch / MultiAgentBatch — columnar trajectory storage.

Reference analogue: rllib/policy/sample_batch.py:125 (SampleBatch) and
:1164 (MultiAgentBatch). The port's copy of ``ray_tpu/rllib/sample_batch.py``
(which imports no JAX), kept whole: ``minibatches``' permutation and
``pad_to``'s ``_valid_mask`` are the JAX package's bit for bit, so both
sides train on the same minibatches in the same order.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional

import numpy as np

OBS = "obs"
NEXT_OBS = "new_obs"
ACTIONS = "actions"
REWARDS = "rewards"
DONES = "dones"
TRUNCATEDS = "truncateds"
INFOS = "infos"
EPS_ID = "eps_id"
ACTION_LOGP = "action_logp"
ACTION_DIST_INPUTS = "action_dist_inputs"
VF_PREDS = "vf_preds"
ADVANTAGES = "advantages"
VALUE_TARGETS = "value_targets"
SEQ_LENS = "seq_lens"


class SampleBatch(dict):
    """A dict of equal-length numpy columns holding trajectory data."""

    # Re-export column names on the class, as the reference does.
    OBS = OBS
    NEXT_OBS = NEXT_OBS
    ACTIONS = ACTIONS
    REWARDS = REWARDS
    DONES = DONES
    TRUNCATEDS = TRUNCATEDS
    INFOS = INFOS
    EPS_ID = EPS_ID
    ACTION_LOGP = ACTION_LOGP
    ACTION_DIST_INPUTS = ACTION_DIST_INPUTS
    VF_PREDS = VF_PREDS
    ADVANTAGES = ADVANTAGES
    VALUE_TARGETS = VALUE_TARGETS
    SEQ_LENS = SEQ_LENS

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        for k, v in list(self.items()):
            if isinstance(v, list):
                self[k] = np.asarray(v)

    @property
    def count(self) -> int:
        for v in self.values():
            if hasattr(v, "__len__"):
                return len(v)
        return 0

    def __len__(self) -> int:  # len(batch) == row count, as in the reference
        return self.count

    # ---- construction ----

    @staticmethod
    def concat_samples(batches: List["SampleBatch"]) -> "SampleBatch":
        batches = [b for b in batches if b is not None and b.count > 0]
        if not batches:
            return SampleBatch()
        keys = set(batches[0].keys())
        for b in batches[1:]:
            keys &= set(b.keys())
        out = {}
        for k in keys:
            out[k] = np.concatenate([np.asarray(b[k]) for b in batches],
                                    axis=0)
        return SampleBatch(out)

    def concat(self, other: "SampleBatch") -> "SampleBatch":
        return SampleBatch.concat_samples([self, other])

    def copy(self) -> "SampleBatch":
        return SampleBatch({k: np.copy(v) for k, v in self.items()})

    # ---- slicing / iteration ----

    def slice(self, start: int, end: int) -> "SampleBatch":
        return SampleBatch({k: v[start:end] for k, v in self.items()})

    def __getitem__(self, key):
        if isinstance(key, slice):
            return self.slice(key.start or 0,
                              key.stop if key.stop is not None else self.count)
        return super().__getitem__(key)

    def shuffle(self, rng: Optional[np.random.Generator] = None
                ) -> "SampleBatch":
        rng = rng or np.random.default_rng()
        perm = rng.permutation(self.count)
        return SampleBatch({k: np.asarray(v)[perm] for k, v in self.items()})

    def minibatches(self, minibatch_size: int,
                    shuffle: bool = True,
                    rng: Optional[np.random.Generator] = None
                    ) -> Iterator["SampleBatch"]:
        """Yield fixed-size minibatches (drops the ragged tail so every
        learner step has an identical shape)."""
        b = self.shuffle(rng) if shuffle else self
        n = (b.count // minibatch_size) * minibatch_size
        for i in range(0, n, minibatch_size):
            yield b.slice(i, i + minibatch_size)

    # ---- shape discipline ----

    def pad_to(self, size: int) -> "SampleBatch":
        """Pad every column to ``size`` rows (repeat-last padding); the
        padded rows carry ``_valid_mask`` 0, which the losses read."""
        n = self.count
        if n >= size:
            return self.slice(0, size)
        out = {}
        for k, v in self.items():
            v = np.asarray(v)
            pad = np.repeat(v[-1:], size - n, axis=0)
            out[k] = np.concatenate([v, pad], axis=0)
        out["_valid_mask"] = np.concatenate(
            [np.ones(n, np.float32), np.zeros(size - n, np.float32)])
        return SampleBatch(out)

    def split_by_episode(self) -> List["SampleBatch"]:
        if EPS_ID not in self:
            return [self]
        ids = np.asarray(self[EPS_ID])
        cuts = np.where(ids[1:] != ids[:-1])[0] + 1
        bounds = [0, *cuts.tolist(), len(ids)]
        return [self.slice(a, b) for a, b in zip(bounds[:-1], bounds[1:])]

    def total_reward(self) -> float:
        return float(np.sum(self.get(REWARDS, 0.0)))


class MultiAgentBatch:
    """Policy-id → SampleBatch mapping (reference: sample_batch.py:1164)."""

    def __init__(self, policy_batches: Dict[str, SampleBatch],
                 env_steps: int):
        self.policy_batches = policy_batches
        self._env_steps = env_steps

    @property
    def count(self) -> int:
        return self._env_steps

    def env_steps(self) -> int:
        return self._env_steps

    def agent_steps(self) -> int:
        return sum(b.count for b in self.policy_batches.values())

    @staticmethod
    def concat_samples(batches: List["MultiAgentBatch"]) -> "MultiAgentBatch":
        out: Dict[str, List[SampleBatch]] = {}
        steps = 0
        for mb in batches:
            steps += mb.env_steps()
            for pid, b in mb.policy_batches.items():
                out.setdefault(pid, []).append(b)
        return MultiAgentBatch(
            {pid: SampleBatch.concat_samples(bs) for pid, bs in out.items()},
            steps)


def convert_ma_batch_to_sample_batch(batch: Any) -> SampleBatch:
    if isinstance(batch, MultiAgentBatch):
        if len(batch.policy_batches) == 1:
            return next(iter(batch.policy_batches.values()))
        return SampleBatch.concat_samples(
            list(batch.policy_batches.values()))
    return batch
