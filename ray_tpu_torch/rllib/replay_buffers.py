"""Replay buffers — uniform ring buffer + prioritized (sum-tree).

Reference analogue: rllib/utils/replay_buffers/ and
rllib/execution/segment_tree.py. The port's copy of
``ray_tpu/rllib/replay_buffers.py`` (no JAX), kept whole: the numpy RNG
calls come in the same order, so the same seed gives the same indexes
and weights. Storage is preallocated contiguous numpy (not per-item
pickles) on the host, so sampled minibatches are already fixed-shape
columns ready for one copy to the device.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ray_tpu_torch.rllib.sample_batch import SampleBatch


class ReplayBuffer:
    """Uniform FIFO replay over preallocated column arrays."""

    def __init__(self, capacity: int = 100_000,
                 seed: Optional[int] = None):
        self.capacity = int(capacity)
        self._cols: Dict[str, np.ndarray] = {}
        self._idx = 0
        self._size = 0
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return self._size

    def add(self, batch: SampleBatch):
        n = batch.count
        if not self._cols:
            for k, v in batch.items():
                v = np.asarray(v)
                self._cols[k] = np.zeros((self.capacity, *v.shape[1:]),
                                         v.dtype)
        for k, col in self._cols.items():
            v = np.asarray(batch[k])
            idx = (self._idx + np.arange(n)) % self.capacity
            col[idx] = v
        self._idx = (self._idx + n) % self.capacity
        self._size = min(self._size + n, self.capacity)

    def sample(self, num_items: int) -> SampleBatch:
        idx = self._rng.integers(self._size, size=num_items)
        return SampleBatch({k: col[idx] for k, col in self._cols.items()})


class SumTree:
    """Flat-array segment tree for O(log n) prefix-sum sampling
    (reference: rllib/execution/segment_tree.py)."""

    def __init__(self, capacity: int):
        self.capacity = 1
        while self.capacity < capacity:
            self.capacity *= 2
        self.tree = np.zeros(2 * self.capacity, np.float64)

    def set(self, idx: int, value: float):
        i = idx + self.capacity
        self.tree[i] = value
        i //= 2
        while i >= 1:
            self.tree[i] = self.tree[2 * i] + self.tree[2 * i + 1]
            i //= 2

    def get(self, idx: int) -> float:
        return float(self.tree[idx + self.capacity])

    def total(self) -> float:
        return float(self.tree[1])

    def find_prefixsum_idx(self, prefixsum: float) -> int:
        i = 1
        while i < self.capacity:
            left = 2 * i
            if self.tree[left] > prefixsum:
                i = left
            else:
                prefixsum -= self.tree[left]
                i = left + 1
        return i - self.capacity


class PrioritizedReplayBuffer(ReplayBuffer):
    """Proportional prioritized replay (Schaul et al.) — reference:
    utils/replay_buffers/prioritized_replay_buffer.py."""

    def __init__(self, capacity: int = 100_000, alpha: float = 0.6,
                 seed: Optional[int] = None):
        super().__init__(capacity, seed)
        self.alpha = alpha
        self._tree = SumTree(self.capacity)
        self._max_priority = 1.0

    def add(self, batch: SampleBatch):
        n = batch.count
        start = self._idx
        super().add(batch)
        p = self._max_priority ** self.alpha
        for j in range(n):
            self._tree.set((start + j) % self.capacity, p)

    def sample(self, num_items: int, beta: float = 0.4) -> SampleBatch:
        idx = np.empty(num_items, np.int64)
        total = self._tree.total()
        for j in range(num_items):
            mass = self._rng.uniform(0, total)
            i = self._tree.find_prefixsum_idx(mass)
            idx[j] = min(i, self._size - 1)
        probs = np.array([max(self._tree.get(int(i)), 1e-12) for i in idx])
        probs /= max(total, 1e-12)
        weights = (self._size * probs) ** (-beta)
        weights /= weights.max()
        out = SampleBatch({k: col[idx] for k, col in self._cols.items()})
        out["weights"] = weights.astype(np.float32)
        out["batch_indexes"] = idx
        return out

    def update_priorities(self, idx: np.ndarray, priorities: np.ndarray):
        for i, p in zip(np.asarray(idx), np.asarray(priorities)):
            p = float(abs(p)) + 1e-6
            self._max_priority = max(self._max_priority, p)
            self._tree.set(int(i), p ** self.alpha)
