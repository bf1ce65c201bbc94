"""LearnerGroup — data-parallel learners.

Reference analogue: rllib/core/learner/learner_group.py. Counterpart of
``ray_tpu/rllib/core/learner_group.py``: ``num_learners=0`` runs the
learner inline (the default for single-host training and for tests);
``num_learners > 0`` makes that many learner actors on the port's
runtime, updated in data parallel. Learner 0's state is broadcast to
the others at construction; each step shards the batch, each learner
computes its shard's gradients, the driver averages the host grads
(star reduce through the object store) and every learner applies the
same average, so the replicas stay equal.

A learner whose module spec is on ``cuda`` asks for ``num_gpus=1`` (it
gets its card by index, ``CUDA_VISIBLE_DEVICES``); one on ``cpu`` asks
for nothing. More ``cuda`` learners than GPUs in the cluster raise at
construction: they would queue forever, and none moves to the CPU.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.rllib.core.learner import Learner
from ray_tpu_torch.rllib.rollout_worker import kill_actors


def _avg_host_grads(grads: List[Dict[str, Any]]) -> Dict[str, np.ndarray]:
    """The mean of host grad dicts by param name, summed in order and
    divided once (the JAX package's ``_avg_pytrees``)."""
    n = len(grads)
    return {k: sum(np.asarray(g[k]) for g in grads) / n for k in grads[0]}


def _wants_gpu(learner_kwargs: Dict[str, Any]) -> bool:
    specs = learner_kwargs.get("module_specs") or {}
    if learner_kwargs.get("module_spec") is not None:
        specs = {"default_policy": learner_kwargs["module_spec"]}
    return any(torch.device(s.device).type == "cuda"
               for s in specs.values())


class LearnerGroup:
    def __init__(self, learner_cls, *, num_learners: int = 0,
                 learner_kwargs: Optional[Dict[str, Any]] = None):
        self._kwargs = dict(learner_kwargs or {})
        self._local: Optional[Learner] = None
        self._workers: List[Any] = []
        if num_learners <= 0:
            self._local = learner_cls(**self._kwargs)
            return
        num_gpus = 1 if _wants_gpu(self._kwargs) else 0
        if num_gpus:
            have = ray_tpu_torch.cluster_resources().get("GPU", 0.0)
            if num_learners > have:
                raise ValueError(
                    f"{num_learners} learners on cuda need {num_learners} "
                    f"GPUs; the cluster has {have:g}")
        remote_cls = ray_tpu_torch.remote(num_gpus=num_gpus)(learner_cls)
        self._workers = [remote_cls.remote(**self._kwargs)
                         for _ in range(num_learners)]
        # identical init: broadcast learner 0's state
        state = ray_tpu_torch.get(self._workers[0].get_state.remote())
        ray_tpu_torch.get([w.set_state.remote(state)
                           for w in self._workers[1:]])

    @property
    def is_local(self) -> bool:
        return self._local is not None

    def update_from_batch(self, batch: Dict[str, Any]
                          ) -> Dict[str, Dict[str, float]]:
        """One synchronized step: local -> direct; distributed -> shard
        the batch, average the grads, apply the same averaged update on
        every learner."""
        if self._local is not None:
            return self._local.update_from_batch(batch)
        shards = self._shard(batch, len(self._workers))
        # a zero-row shard would give NaN grads (a mean over no rows)
        # and poison the average on every replica: a small final batch
        # uses fewer learners for the step
        pairs = [(w, s) for w, s in zip(self._workers, shards)
                 if self._shard_rows(s) > 0]
        grads = ray_tpu_torch.get([w.compute_gradients.remote(s)
                                   for w, s in pairs])
        avg = {mid: _avg_host_grads([g[mid] for g in grads])
               for mid in grads[0]}
        ray_tpu_torch.get([w.apply_gradients.remote(avg)
                           for w in self._workers])
        return {mid: {"workers": float(len(pairs))} for mid in avg}

    @staticmethod
    def _shard_rows(shard: Dict[str, Any]) -> int:
        first = next(iter(shard.values()))
        if isinstance(first, dict):
            return min((len(next(iter(cols.values())))
                        for cols in shard.values()), default=0)
        return len(first)

    @staticmethod
    def _shard(batch: Dict[str, Any], n: int) -> List[Dict[str, Any]]:
        def split_cols(cols):
            length = len(next(iter(cols.values())))
            cuts = [round(i * length / n) for i in range(n + 1)]
            return [{k: np.asarray(v)[cuts[i]:cuts[i + 1]]
                     for k, v in cols.items()} for i in range(n)]

        first = next(iter(batch.values()))
        if isinstance(first, dict):  # multi-module batch
            per_mid = {mid: split_cols(cols) for mid, cols in batch.items()}
            return [{mid: per_mid[mid][i] for mid in batch}
                    for i in range(n)]
        return split_cols(batch)

    def get_state(self) -> Dict[str, Any]:
        if self._local is not None:
            return self._local.get_state()
        return ray_tpu_torch.get(self._workers[0].get_state.remote())

    def set_state(self, state: Dict[str, Any]):
        if self._local is not None:
            self._local.set_state(state)
            return
        ray_tpu_torch.get([w.set_state.remote(state)
                           for w in self._workers])

    def shutdown(self):
        kill_actors(self._workers)
        self._workers = []
