"""IMPALA — importance-weighted actor-learner with V-trace.

Reference analogue: rllib/algorithms/impala/ (+ vtrace_torch.py, async
learner queues in execution/learner_thread.py). Counterpart of
``ray_tpu/rllib/algorithms/impala.py`` with the same loss, defaults and
cuts. V-trace is a reverse linear recurrence over the flat, env-major
batch; the JAX package runs it as a ``lax.scan``. Here ``vtrace`` runs
it as an associative scan: ⌈log₂ T⌉ rounds of a few elementwise ops on
the device (about 50 launches at T = 500) where a Python loop would
launch about three a row. It reorders the f32 rounding, so it agrees
with the scan within 1e-5 of scale, not bit for bit; ``vtrace_f64`` is
the row-by-row loop in f64 that the checks hold it to.

The local path is the sync one (``num_workers=0``): sample, mark cuts,
one ``learn_on_batch``. The async branch (remote samplers reaped as
they finish, batches through a ``LearnerThread``) keeps the JAX
structure but needs the runtime's actors (A1); the WorkerSet refuses
remote workers before it could run.
"""

from __future__ import annotations

import time
from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.policy import TorchPolicy
from ray_tpu_torch.rllib.rollout_worker import needs_runtime
from ray_tpu_torch.rllib.sample_batch import SampleBatch


def reverse_linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``acc_t = b_t + a_t · acc_{t+1}`` (``acc_T = 0``) over a [T]
    tensor, in ⌈log₂ T⌉ rounds: each round composes every row's affine
    map with the one ``k`` rows later (Hillis–Steele)."""
    k, n = 1, b.shape[0]
    while k < n:
        b = torch.cat([b[:-k] + a[:-k] * b[k:], b[-k:]])
        a = torch.cat([a[:-k] * a[k:], a[-k:]])
        k *= 2
    return b


@torch.no_grad()
def vtrace(behaviour_logp, target_logp, rewards, values, next_values,
           terms, cuts, gamma, clip_rho=1.0, clip_c=1.0):
    """V-trace targets over a flat time-ordered sequence (the JAX
    package's ``vtrace_scan``): (vs, pg_adv), no gradient.

    ``cuts`` marks the last row of each contiguous fragment (episode end
    or truncation): the reverse accumulator resets there, and
    ``next_values`` supplies the bootstrap."""
    ratio = torch.exp(target_logp - behaviour_logp)
    rho = torch.clamp(ratio, max=clip_rho)
    c = torch.clamp(ratio, max=clip_c)
    not_term = 1.0 - terms
    deltas = rho * (rewards + gamma * not_term * next_values - values)
    cont = gamma * (1.0 - cuts)
    vs = values + reverse_linear_scan(cont * c, deltas)
    # vs_{t+1}: within a fragment the next row's vs; at cuts the
    # bootstrap value
    vs_next = torch.cat([vs[1:], next_values[-1:]])
    vs_next = torch.where(cuts > 0, next_values, vs_next)
    pg_adv = rho * (rewards + gamma * not_term * vs_next - values)
    return vs, pg_adv


def vtrace_f64(behaviour_logp, target_logp, rewards, values, next_values,
               terms, cuts, gamma, clip_rho=1.0, clip_c=1.0):
    """``vtrace`` as a row-by-row loop in f64 on numpy arrays: the
    yardstick of the checks."""
    f = [np.asarray(x, np.float64) for x in (
        behaviour_logp, target_logp, rewards, values, next_values, terms,
        cuts)]
    blogp, tlogp, rew, val, nval, term, cut = f
    ratio = np.exp(tlogp - blogp)
    rho, c = np.minimum(ratio, clip_rho), np.minimum(ratio, clip_c)
    deltas = rho * (rew + gamma * (1 - term) * nval - val)
    acc = np.zeros_like(val)
    nxt = 0.0
    for t in range(len(val) - 1, -1, -1):
        nxt = deltas[t] + gamma * (1 - cut[t]) * c[t] * nxt
        acc[t] = nxt
    vs = val + acc
    vs_next = np.where(cut > 0, nval, np.append(vs[1:], nval[-1:]))
    return vs, rho * (rew + gamma * (1 - term) * vs_next - val)


class IMPALAPolicy(TorchPolicy):
    loss_columns = (SampleBatch.OBS, SampleBatch.NEXT_OBS,
                    SampleBatch.ACTIONS, SampleBatch.ACTION_LOGP,
                    SampleBatch.REWARDS, SampleBatch.DONES, "cuts")

    def _vtrace_terms(self, batch):
        """Shared V-trace computation: (dist_inputs, values, target_logp,
        vs, pg_adv). Subclasses (APPO) swap only the surrogate term."""
        cfg = self.config
        dist_inputs, values = self.model(batch[SampleBatch.OBS])
        with torch.no_grad():
            _, next_values = self.model(batch[SampleBatch.NEXT_OBS])
        target_logp = self.dist_logp(dist_inputs,
                                     batch[SampleBatch.ACTIONS])
        vs, pg_adv = vtrace(
            batch[SampleBatch.ACTION_LOGP], target_logp.detach(),
            batch[SampleBatch.REWARDS], values.detach(), next_values,
            batch[SampleBatch.DONES].to(torch.float32),
            batch["cuts"].to(torch.float32),
            cfg.get("gamma", 0.99),
            clip_rho=cfg.get("vtrace_clip_rho_threshold", 1.0),
            clip_c=cfg.get("vtrace_clip_c_threshold", 1.0))
        return dist_inputs, values, target_logp, vs, pg_adv

    def _assemble_loss(self, pg_loss, dist_inputs, values, vs):
        cfg = self.config
        vf_loss = 0.5 * torch.mean((values - vs) ** 2)
        entropy = torch.mean(self.dist_entropy(dist_inputs))
        total = (pg_loss
                 + cfg.get("vf_loss_coeff", 0.5) * vf_loss
                 - cfg.get("entropy_coeff", 0.01) * entropy)
        return total, {"policy_loss": pg_loss, "vf_loss": vf_loss,
                       "entropy": entropy}

    def loss(self, batch):
        dist_inputs, values, target_logp, vs, pg_adv = \
            self._vtrace_terms(batch)
        pg_loss = -torch.mean(target_logp * pg_adv)
        total, stats = self._assemble_loss(pg_loss, dist_inputs, values,
                                           vs)
        stats["mean_vtrace_adv"] = torch.mean(pg_adv)
        return total, stats


class IMPALAConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or IMPALA)
        self._config.update({
            "lr": 5e-4,
            "rollout_fragment_length": 50,
            "vf_loss_coeff": 0.5,
            "entropy_coeff": 0.01,
            "vtrace_clip_rho_threshold": 1.0,
            "vtrace_clip_c_threshold": 1.0,
            "grad_clip": 40.0,
            # the JAX default; the port raises on it (A1), so a local
            # config sets num_workers=0
            "num_workers": 1,
            "broadcast_interval": 1,
            "max_sample_batches_per_iter": 8,
            # decoupled learner thread (the defining IMPALA structure);
            # False falls back to learn-inline-with-reaping
            "async_learner": True,
            "learner_queue_size": 16,
        })


def _mark_cuts(batch: SampleBatch) -> SampleBatch:
    """Add the 'cuts' column: 1 on the last row of every contiguous
    per-episode fragment."""
    cuts = np.zeros(batch.count, np.float32)
    offset = 0
    for frag in batch.split_by_episode():
        offset += frag.count
        cuts[offset - 1] = 1.0
    batch["cuts"] = cuts
    return batch


class IMPALA(Algorithm):
    """``training_step`` also reports ``timers``: the host milliseconds
    of one iteration spent sampling, postprocessing (cutting fragments,
    marking cuts) and learning (the batch to the card, V-trace, loss,
    backward, Adam, the stats back)."""

    _policy_cls = IMPALAPolicy
    _default_config_cls = IMPALAConfig

    def setup(self, config):
        super().setup(config)
        self._in_flight: Dict[Any, Any] = {}  # future -> worker
        self._learn_count = 0
        self._learner = None
        if self.config.get("async_learner", True) and \
                self.workers.remote_workers:
            from ray_tpu_torch.rllib.execution import LearnerThread
            self._learner = LearnerThread(
                self.workers.local_worker.policy,
                max_queue_size=self.config.get("learner_queue_size", 16))
            self._learner.start()

    # the remote branch's calls into the runtime (A1): launch
    # ``worker.sample``; wait for the first finished sample (None on
    # timeout) and return (worker, batch); send the learner's weights
    _launch = _reap_one = _broadcast_weights = staticmethod(needs_runtime)

    def training_step(self) -> Dict[str, Any]:
        if not self.workers.remote_workers:
            return self._sync_step()
        return self._async_step()

    def _sync_step(self) -> Dict[str, Any]:
        """The degenerate sync path (num_workers=0)."""
        lw = self.workers.local_worker
        post0 = lw.postprocess_s
        t0 = time.perf_counter()
        batch = lw.sample()
        t1 = time.perf_counter()
        batch = _mark_cuts(batch)
        t2 = time.perf_counter()
        stats = lw.policy.learn_on_batch(batch)
        t3 = time.perf_counter()
        self._timesteps_total += batch.count
        post = lw.postprocess_s - post0
        return {
            "num_env_steps_sampled_this_iter": batch.count,
            **{f"learner/{k}": v for k, v in stats.items()},
            "timers": {"sample_time_ms": (t1 - t0 - post) * 1e3,
                       "postprocess_time_ms": (post + t2 - t1) * 1e3,
                       "learn_time_ms": (t3 - t2) * 1e3},
        }

    def _async_step(self) -> Dict[str, Any]:
        """The JAX package's async branch: keep every remote sampler
        busy, reap ``max_sample_batches_per_iter`` batches as they
        finish, feed the learner thread (or learn inline), broadcast
        weights to the worker that sampled."""
        cfg = self.config
        policy = self.workers.local_worker.policy
        stats: Dict[str, float] = {}
        sampled = 0
        for w in self.workers.remote_workers:
            if w not in self._in_flight.values():
                self._launch(w)
        n_target = cfg.get("max_sample_batches_per_iter", 8)
        for _ in range(n_target):
            reaped = self._reap_one(timeout=60.0)
            if reaped is None:
                break
            worker, batch = reaped
            batch = _mark_cuts(batch)
            if self._learner is not None:
                # a full queue applies backpressure: block until the
                # learner drains, never drop a counted batch
                while not self._learner.put(batch, timeout=5.0):
                    self._learner.check_error()
            else:
                stats = policy.learn_on_batch(batch)
            sampled += batch.count
            self._learn_count += 1
            if self._learn_count % cfg.get("broadcast_interval", 1) == 0:
                self._broadcast_weights(worker)
            self._launch(worker)
        if self._learner is not None:
            self._learner.check_error()
            stats = dict(self._learner.stats)
            stats.update(self._learner.metrics())
        self._timesteps_total += sampled
        return {
            "num_env_steps_sampled_this_iter": sampled,
            **{f"learner/{k}": v for k, v in stats.items()},
        }

    def cleanup(self):
        if self._learner is not None:
            self._learner.stop()
        self._in_flight.clear()
        super().cleanup()
