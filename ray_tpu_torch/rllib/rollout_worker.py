"""RolloutWorker + WorkerSet — sampling, local worker only.

Reference analogue: rllib/evaluation/rollout_worker.py:153 (sample :856)
and worker_set.py:77. Counterpart of ``ray_tpu/rllib/rollout_worker.py``:
the worker steps a synchronous VectorEnv and runs ONE batched policy
forward on the device per env-step; fragments are cut at
``rollout_fragment_length`` and GAE is computed worker-side (numpy, on
the host) so the learner only sees ready-to-train columns.

Remote rollout workers (``num_workers > 0``), evaluation workers and
the multi-agent worker need the runtime or a later slice: they raise
``NotImplementedError`` and never sample locally in their place.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np

from ray_tpu_torch.rllib.env import VectorEnv, make_env
from ray_tpu_torch.rllib.sample_batch import SampleBatch

REMOTE_WORKERS_NEED_RUNTIME = (
    "remote rollout workers need the runtime's tasks and actors, which "
    "the port does not have yet (ROADMAP.md Queue A, A1); use "
    "num_workers=0 and num_envs_per_worker for more envs")
MULTI_AGENT_LATER = ("multi-agent: a later slice of the port "
                     "(MultiAgentRolloutWorker, ROADMAP.md Queue A, A9)")


def needs_runtime(*_args, **_kwargs):
    """Stands where a remote branch (IMPALA's async reaping, A3C's grad
    requests) calls the runtime's remote calls, ``wait``, ``get`` and
    ``put``: the WorkerSet refuses remote workers first, so no local
    path reaches it."""
    raise NotImplementedError(REMOTE_WORKERS_NEED_RUNTIME)


class RolloutWorker:
    """Samples experience from a vectorized env with a local policy copy."""

    def __init__(self, config: Dict[str, Any], policy_cls,
                 worker_index: int = 0):
        self.config = config
        self.worker_index = worker_index
        env_fn = lambda: make_env(config["env"], config.get("env_config"))
        self.vector_env = VectorEnv(
            env_fn, config.get("num_envs_per_worker", 1),
            seed=(config.get("seed") or 0) * 10_000 + worker_index)
        # connector pipelines: obs transforms before the policy forward,
        # action transforms before env.step (rllib/connectors.py). The
        # policy sees the PIPELINE's output space (frame stacking /
        # resizing change shapes), not the raw env space.
        from ray_tpu_torch.rllib.connectors import build_connectors
        self.obs_connectors, self.action_connectors = \
            build_connectors(config)
        self.policy = policy_cls(
            self.obs_connectors.observation_space(
                self.vector_env.observation_space),
            self.vector_env.action_space, config)
        self._obs = self.vector_env.reset_all()
        # processed view of _obs, cached so stateful connectors (MeanStd)
        # see each observation exactly once
        self._proc_obs = self.obs_connectors(self._obs)
        n = self.vector_env.num_envs
        self._eps_ids = np.arange(n, dtype=np.int64) * 1_000_000 \
            + worker_index
        self._next_eps = self._eps_ids.max() + 1
        self._episode_rewards = np.zeros(n, np.float64)
        self._episode_lens = np.zeros(n, np.int64)
        self._completed_rewards: List[float] = []
        self._completed_lens: List[int] = []
        # host seconds spent cutting fragments and postprocessing them
        # (GAE), summed over every sample() call
        self.postprocess_s = 0.0

    def sample(self) -> SampleBatch:
        """Collect ``rollout_fragment_length`` steps from every sub-env."""
        frag_len = self.config.get("rollout_fragment_length", 200)
        n_envs = self.vector_env.num_envs
        cols: Dict[str, list] = {
            k: [] for k in (SampleBatch.OBS, SampleBatch.ACTIONS,
                            SampleBatch.REWARDS, SampleBatch.DONES,
                            SampleBatch.TRUNCATEDS, SampleBatch.NEXT_OBS,
                            SampleBatch.EPS_ID)}
        explore = self.config.get("explore", True)
        has_obs_conn = bool(self.obs_connectors.connectors)
        for _ in range(frag_len):
            proc_obs = self._proc_obs
            actions, extras = self.policy.compute_actions(
                proc_obs, explore=explore)
            env_actions = self.action_connectors(actions)
            next_obs, rews, terms, truncs, infos = self.vector_env.step(
                env_actions)
            true_next = next_obs.copy()
            for i, info in enumerate(infos):
                if "terminal_observation" in info:
                    true_next[i] = info["terminal_observation"]
            if has_obs_conn:
                # ORDER MATTERS: the TRUE next obs (incl.
                # terminal_observation rows, which truncated-episode
                # bootstrapping reads) goes through a state-preserving
                # transform against the PRE-step connector state (frame
                # stacks must not have restarted yet, running stats
                # must not count rows twice) — only then does the
                # stateful pass advance, restarting auto-reset slots
                true_next = np.asarray(
                    self.obs_connectors.transform(true_next))
            proc_next = self.obs_connectors(next_obs,
                                            dones=terms | truncs)
            # the batch records the PROCESSED obs (what the policy saw)
            # and the RAW actions (what logp corresponds to)
            cols[SampleBatch.OBS].append(np.asarray(proc_obs).copy())
            cols[SampleBatch.ACTIONS].append(actions)
            cols[SampleBatch.REWARDS].append(rews)
            cols[SampleBatch.DONES].append(terms)
            cols[SampleBatch.TRUNCATEDS].append(truncs)
            cols[SampleBatch.NEXT_OBS].append(true_next)
            cols[SampleBatch.EPS_ID].append(self._eps_ids.copy())
            # every policy extra (logp, dist inputs, vf preds, algo-
            # specific columns like SAC's raw_actions) becomes a column
            for k, v in extras.items():
                cols.setdefault(k, []).append(v)
            self._episode_rewards += rews
            self._episode_lens += 1
            finished = terms | truncs
            for i in np.nonzero(finished)[0]:
                self._completed_rewards.append(
                    float(self._episode_rewards[i]))
                self._completed_lens.append(int(self._episode_lens[i]))
                self._episode_rewards[i] = 0.0
                self._episode_lens[i] = 0
                self._eps_ids[i] = self._next_eps
                self._next_eps += 1
            self._obs = next_obs
            self._proc_obs = proc_next

        # [T, N, ...] → per-env trajectories → policy postprocess (GAE
        # for PPO, no-op for DQN/IMPALA) → concat.
        t0 = time.perf_counter()
        stacked = {k: np.stack(v) for k, v in cols.items()}
        frags = []
        for i in range(n_envs):
            env_cols = SampleBatch(
                {k: v[:, i] for k, v in stacked.items()})
            for ep in env_cols.split_by_episode():
                frags.append(self.policy.postprocess_trajectory(ep))
        out = SampleBatch.concat_samples(frags)
        self.postprocess_s += time.perf_counter() - t0
        return out

    def sample_with_count(self):
        b = self.sample()
        return b, b.count

    def evaluate_episodes(self, num_episodes: int) -> List[float]:
        """Greedy episodes on a fresh env (evaluation WorkerSet duty —
        reference: algorithm.py _evaluate_async worker rollouts)."""
        env = make_env(self.config["env"], self.config.get("env_config"))
        rewards = []
        for ep in range(num_episodes):
            obs, _ = env.reset(seed=50_000 + self.worker_index * 1000 + ep)
            # per-episode pipeline clone: running stats are shared with
            # training, per-episode state (frame stacks) restarts — and
            # the training-time stacks are never polluted
            pipeline = self.obs_connectors.clone_for_eval()
            total, done = 0.0, False
            while not done:
                proc = pipeline(np.asarray(obs)[None])
                a, _ = self.policy.compute_actions(proc, explore=False)
                a = self.action_connectors.transform(a)
                obs, r, term, trunc, _ = env.step(a[0])
                total += float(r)
                done = term or trunc
            rewards.append(total)
        return rewards

    def get_connector_state(self):
        return {"obs": self.obs_connectors.state(),
                "actions": self.action_connectors.state()}

    def set_connector_state(self, state):
        if not state:
            return
        self.obs_connectors.set_state(state.get("obs") or [])
        self.action_connectors.set_state(state.get("actions") or [])

    # ---- weights / metrics / state ----

    def get_weights(self):
        return self.policy.get_weights()

    def set_weights(self, weights):
        self.policy.set_weights(weights)

    def get_metrics(self) -> Dict[str, Any]:
        out = {
            "episode_rewards": list(self._completed_rewards),
            "episode_lens": list(self._completed_lens),
        }
        self._completed_rewards = []
        self._completed_lens = []
        return out

    def apply(self, fn, *args):
        """Run ``fn(worker, *args)`` inside this worker (reference:
        RolloutWorker.apply) — worker-side gradient computation (A3C),
        local SGD (DDPPO), knob propagation."""
        return fn(self, *args)

    def set_exploration(self, **attrs):
        for k, v in attrs.items():
            setattr(self.policy, k, v)

    def get_policy_state(self):
        return self.policy.get_state()

    def set_policy_state(self, state):
        self.policy.set_state(state)

    def ping(self) -> str:
        return "ok"

    def stop(self):
        pass


class WorkerSet:
    """The local worker (reference: rllib/evaluation/worker_set.py:77).
    The port has no remote workers yet: ``num_workers > 0`` and a
    multi-agent config raise."""

    def __init__(self, config: Dict[str, Any], policy_cls,
                 num_workers: int):
        if num_workers > 0:
            raise NotImplementedError(REMOTE_WORKERS_NEED_RUNTIME)
        if (config.get("multiagent") or {}).get("policies"):
            raise NotImplementedError(MULTI_AGENT_LATER)
        self.config = config
        self.policy_cls = policy_cls
        self.local_worker = RolloutWorker(config, policy_cls, worker_index=0)
        # none until the runtime's actors exist (A1); the algorithms'
        # remote branches test this as the JAX package's do
        self.remote_workers: List[Any] = []

    def sync_weights(self):
        """Nothing to broadcast: the local worker's policy is the
        learner's."""

    def set_exploration(self, **attrs):
        """Exploration knobs (e.g. DQN's epsilon) to the local worker's
        policy (the JAX method's local half)."""
        self.local_worker.set_exploration(**attrs)

    def sample_all(self) -> List[SampleBatch]:
        return [self.local_worker.sample()]

    def collect_metrics(self) -> List[Dict[str, Any]]:
        return [self.local_worker.get_metrics()]

    def stop(self):
        self.local_worker.stop()


def synchronous_parallel_sample(worker_set: WorkerSet,
                                max_env_steps: Optional[int] = None
                                ) -> SampleBatch:
    """Keep sampling rounds until ``max_env_steps`` collected
    (reference: rllib/execution/rollout_ops.py:21)."""
    batches: List[SampleBatch] = []
    steps = 0
    target = max_env_steps or 1
    while steps < target:
        round_batches = worker_set.sample_all()
        for b in round_batches:
            batches.append(b)
            steps += b.count
        if max_env_steps is None:
            break
    return SampleBatch.concat_samples(batches)
