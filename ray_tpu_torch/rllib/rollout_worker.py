"""RolloutWorker + WorkerSet — sampling, local and remote.

Reference analogue: rllib/evaluation/rollout_worker.py:153 (sample :856)
and worker_set.py:77. Counterpart of ``ray_tpu/rllib/rollout_worker.py``:
the worker steps a synchronous VectorEnv and runs ONE batched policy
forward on the device per env-step; fragments are cut at
``rollout_fragment_length`` and GAE is computed worker-side (numpy, on
the host) so the learner only sees ready-to-train columns.

``MultiAgentRolloutWorker`` samples a MultiAgentEnv with one policy per
policy id: live agents are grouped by their mapped policy each step, and
each policy runs ONE batched forward over its agents; the WorkerSet
takes it when ``config["multiagent"]["policies"]`` is set.

Remote rollout workers (``num_workers > 0``) are actors of the port's
runtime (``ray_tpu_torch.remote``), as the JAX package's are of its own:
each holds ``num_cpus_per_worker`` CPUs and no GPU, so its policy runs
on the CPU (``device="cpu"`` in its config) with as many torch threads
as CPUs; the learner's policy, the local worker's, stays on
``config["device"]``. With remote workers the local worker does not
sample. A remote worker's error surfaces through ``get``.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.rllib.env import VectorEnv, make_env
from ray_tpu_torch.rllib.sample_batch import MultiAgentBatch, SampleBatch


_thread_state = threading.local()


def set_torch_threads(num_threads: Optional[int]):
    """A remote worker's torch intra-op threads: as many as the CPUs it
    holds (the raylet sets no ``OMP_NUM_THREADS``, so each process would
    take every core). The count binds the calling thread's OpenMP pool,
    and an actor's methods run on another thread than its constructor,
    so each entry point that computes calls this first (it acts once a
    thread)."""
    if num_threads and getattr(_thread_state, "n", None) != num_threads:
        import torch
        torch.set_num_threads(max(1, int(num_threads)))
        _thread_state.n = num_threads


def remote_actors(cls, config: Dict[str, Any], n: int, *args):
    """``n`` actors of ``cls(config_on_cpu, *args, worker_index=i + 1,
    num_threads=...)``, each holding ``num_cpus_per_worker`` CPUs and no
    GPU: the config they get says ``device="cpu"``."""
    n_cpus = config.get("num_cpus_per_worker", 1)
    remote_cls = ray_tpu_torch.remote(num_cpus=n_cpus)(cls)
    on_cpu = dict(config, device="cpu")
    return [remote_cls.remote(on_cpu, *args, worker_index=i + 1,
                              num_threads=max(1, int(n_cpus)))
            for i in range(n)]


def kill_actors(actors):
    """``kill`` each actor (one that is already gone is passed over, as
    the JAX package's ``stop`` does)."""
    for a in actors:
        try:
            ray_tpu_torch.kill(a)
        except Exception:
            pass


class RolloutWorker:
    """Samples experience from a vectorized env with a local policy copy."""

    def __init__(self, config: Dict[str, Any], policy_cls,
                 worker_index: int = 0, num_threads: Optional[int] = None):
        self.num_threads = num_threads
        set_torch_threads(num_threads)
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
        set_torch_threads(self.num_threads)
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
        set_torch_threads(self.num_threads)
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
        set_torch_threads(self.num_threads)
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
    """The local (learner) worker + ``num_workers`` remote rollout actors
    (reference: rllib/evaluation/worker_set.py:77): a
    ``MultiAgentRolloutWorker`` when ``config["multiagent"]["policies"]``
    is set, else a ``RolloutWorker``. The remote ones are
    ``remote_actors`` with ``worker_index = i + 1``."""

    def __init__(self, config: Dict[str, Any], policy_cls,
                 num_workers: int):
        self.config = config
        self.policy_cls = policy_cls
        worker_cls: type = RolloutWorker
        if (config.get("multiagent") or {}).get("policies"):
            worker_cls = MultiAgentRolloutWorker
        self.local_worker = worker_cls(config, policy_cls, worker_index=0)
        self.remote_workers: List[Any] = []
        if num_workers > 0:
            self.remote_workers = remote_actors(worker_cls, config,
                                                num_workers, policy_cls)

    def sync_weights(self):
        """Broadcast the learner's host weights through ONE object-store
        put (reference: worker_set.py:381 + ppo.py:345)."""
        if not self.remote_workers:
            return
        ref = ray_tpu_torch.put(self.local_worker.get_weights())
        ray_tpu_torch.get([w.set_weights.remote(ref)
                           for w in self.remote_workers])

    def set_exploration(self, **attrs):
        """Exploration knobs (e.g. DQN's epsilon) to every policy copy,
        local and remote."""
        self.local_worker.set_exploration(**attrs)
        if self.remote_workers:
            ray_tpu_torch.get([w.set_exploration.remote(**attrs)
                               for w in self.remote_workers])

    def sample_all(self) -> List[SampleBatch]:
        if not self.remote_workers:
            return [self.local_worker.sample()]
        return ray_tpu_torch.get([w.sample.remote()
                                  for w in self.remote_workers])

    def collect_metrics(self) -> List[Dict[str, Any]]:
        out = [self.local_worker.get_metrics()]
        if self.remote_workers:
            out += ray_tpu_torch.get([w.get_metrics.remote()
                                      for w in self.remote_workers])
        return out

    def stop(self):
        self.local_worker.stop()
        kill_actors(self.remote_workers)
        self.remote_workers = []


def synchronous_parallel_sample(worker_set: WorkerSet,
                                max_env_steps: Optional[int] = None):
    """Keep sampling rounds until ``max_env_steps`` collected
    (reference: rllib/execution/rollout_ops.py:21). A multi-agent
    worker's ``MultiAgentBatch``es are concatenated as one; their count
    is env steps."""
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
    if batches and isinstance(batches[0], MultiAgentBatch):
        return MultiAgentBatch.concat_samples(batches)
    return SampleBatch.concat_samples(batches)


class MultiAgentRolloutWorker:
    """Samples a MultiAgentEnv with one policy per policy-id.

    Reference analogue: rollout_worker.py multi-agent path +
    policy_map.py. Per env-step, agents are grouped by mapped policy and
    each policy runs ONE batched forward over its agents (on its
    device); rows are kept per agent, and an agent that terminates
    early sits out until ``__all__``. Each policy is built from the
    worker's config updated by its own overrides (so two policies with
    the same seed start from the same weights, as in JAX).
    """

    def __init__(self, config: Dict[str, Any], policy_cls,
                 worker_index: int = 0, num_threads: Optional[int] = None):
        self.num_threads = num_threads
        set_torch_threads(num_threads)
        self.config = config
        self.worker_index = worker_index
        self.env = make_env(config["env"], config.get("env_config"))
        ma = config.get("multiagent") or {}
        self.policy_mapping_fn = ma.get(
            "policy_mapping_fn", lambda aid, **kw: "default_policy")
        self.policies_to_train = ma.get("policies_to_train")
        specs = ma.get("policies") or {"default_policy": (None, None,
                                                          None, {})}
        self.policy_map: Dict[str, Any] = {}
        for pid, spec in specs.items():
            cls, obs_space, act_space, overrides = (
                spec if isinstance(spec, tuple) else (None, None, None,
                                                      spec or {}))
            pconf = dict(config)
            pconf.update(overrides or {})
            self.policy_map[pid] = (cls or policy_cls)(
                obs_space or self.env.observation_space,
                act_space or self.env.action_space, pconf)
        # one shared connector pipeline pair at the env boundary (agents
        # are homogeneous here; per-policy pipelines would need per-policy
        # connector instances in the config)
        from ray_tpu_torch.rllib.connectors import build_connectors
        self.obs_connectors, self.action_connectors = \
            build_connectors(config)
        self._obs, _ = self.env.reset(
            seed=(config.get("seed") or 0) * 10_000 + worker_index)
        self._eps_id = worker_index * 1_000_000
        self._episode_reward = 0.0
        self._episode_len = 0
        self._completed_rewards: List[float] = []
        self._completed_lens: List[int] = []
        # host seconds spent cutting agent episodes and postprocessing
        # them (GAE), summed over every sample() call
        self.postprocess_s = 0.0

    @property
    def policy(self):
        """Single-policy accessor for code paths that expect one."""
        if "default_policy" in self.policy_map:
            return self.policy_map["default_policy"]
        return next(iter(self.policy_map.values()))

    def _end_episode(self):
        self._completed_rewards.append(self._episode_reward)
        self._completed_lens.append(self._episode_len)
        self._episode_reward = 0.0
        self._episode_len = 0
        self._eps_id += 1
        self._obs, _ = self.env.reset()

    def sample(self) -> MultiAgentBatch:
        set_torch_threads(self.num_threads)
        frag_len = self.config.get("rollout_fragment_length", 200)
        explore = self.config.get("explore", True)
        # per-agent row buffers
        rows: Dict[Any, Dict[str, list]] = {}
        agent_pid: Dict[Any, str] = {}
        env_steps = 0
        for _ in range(frag_len):
            # group live agents by policy for batched forwards
            by_policy: Dict[str, List[Any]] = {}
            for aid in self._obs:
                pid = agent_pid.get(aid)
                if pid is None:
                    pid = self.policy_mapping_fn(aid)
                    agent_pid[aid] = pid
                by_policy.setdefault(pid, []).append(aid)
            actions: Dict[Any, Any] = {}
            proc_by_agent: Dict[Any, Any] = {}
            extras_by_agent: Dict[Any, Dict[str, Any]] = {}
            for pid, aids in by_policy.items():
                obs_arr = self.obs_connectors(
                    np.stack([self._obs[a] for a in aids]))
                acts, extras = self.policy_map[pid].compute_actions(
                    obs_arr, explore=explore)
                acts = self.action_connectors(acts)
                for i, aid in enumerate(aids):
                    actions[aid] = acts[i]
                    proc_by_agent[aid] = obs_arr[i]
                    extras_by_agent[aid] = {k: v[i]
                                            for k, v in extras.items()}
            next_obs, rews, terms, truncs, infos = self.env.step(actions)
            env_steps += 1
            for aid, act in actions.items():
                r = rows.setdefault(aid, {})
                done = bool(terms.get(aid, False))
                trunc = bool(truncs.get(aid, False))
                n_obs = next_obs.get(aid, self._obs[aid])
                if self.obs_connectors.connectors:
                    n_obs = self.obs_connectors.transform(
                        np.asarray(n_obs)[None])[0]
                vals = {
                    SampleBatch.OBS: proc_by_agent[aid],
                    SampleBatch.ACTIONS: act,
                    SampleBatch.REWARDS: np.float32(rews.get(aid, 0.0)),
                    SampleBatch.DONES: done,
                    SampleBatch.TRUNCATEDS: trunc,
                    SampleBatch.NEXT_OBS: n_obs,
                    SampleBatch.EPS_ID: np.int64(self._eps_id),
                    **extras_by_agent[aid],
                }
                for k, v in vals.items():
                    r.setdefault(k, []).append(v)
                self._episode_reward += float(rews.get(aid, 0.0))
            self._episode_len += 1
            if terms.get("__all__") or truncs.get("__all__"):
                self._end_episode()
                agent_pid.clear()
            else:
                self._obs = {a: o for a, o in next_obs.items()
                             if not (terms.get(a) or truncs.get(a))}
                if not self._obs:
                    # every agent individually finished without the env
                    # reporting __all__: still a completed episode
                    self._end_episode()
                    agent_pid.clear()

        # per-agent trajectories -> policy postprocess -> per-policy concat
        t0 = time.perf_counter()
        per_policy: Dict[str, List[SampleBatch]] = {}
        for aid, cols in rows.items():
            pid = agent_pid.get(aid) or self.policy_mapping_fn(aid)
            b = SampleBatch({k: np.stack(v) if np.asarray(v[0]).ndim
                             else np.asarray(v)
                             for k, v in cols.items()})
            for ep in b.split_by_episode():
                per_policy.setdefault(pid, []).append(
                    self.policy_map[pid].postprocess_trajectory(ep))
        out = MultiAgentBatch(
            {pid: SampleBatch.concat_samples(bs)
             for pid, bs in per_policy.items()}, env_steps)
        self.postprocess_s += time.perf_counter() - t0
        return out

    # ---- weights / metrics / state (WorkerSet-compatible surface) ----

    def get_weights(self):
        return {pid: p.get_weights() for pid, p in self.policy_map.items()}

    def set_weights(self, weights):
        for pid, w in weights.items():
            if pid in self.policy_map:
                self.policy_map[pid].set_weights(w)

    def get_metrics(self) -> Dict[str, Any]:
        out = {"episode_rewards": list(self._completed_rewards),
               "episode_lens": list(self._completed_lens)}
        self._completed_rewards = []
        self._completed_lens = []
        return out

    def set_exploration(self, **attrs):
        for p in self.policy_map.values():
            for k, v in attrs.items():
                setattr(p, k, v)

    def apply(self, fn, *args):
        set_torch_threads(self.num_threads)
        return fn(self, *args)

    def get_policy_state(self):
        return {pid: p.get_state() for pid, p in self.policy_map.items()}

    def set_policy_state(self, state):
        for pid, s in state.items():
            if pid in self.policy_map:
                self.policy_map[pid].set_state(s)

    def evaluate_episodes(self, num_episodes: int) -> List[float]:
        """Greedy episodes; reward = sum over all agents."""
        set_torch_threads(self.num_threads)
        env = make_env(self.config["env"], self.config.get("env_config"))
        rewards = []
        for ep in range(num_episodes):
            obs, _ = env.reset(seed=50_000 + self.worker_index * 1000 + ep)
            total, done = 0.0, False
            pid_of = {}
            while not done and obs:
                actions = {}
                for aid, ob in obs.items():
                    pid = pid_of.setdefault(aid,
                                            self.policy_mapping_fn(aid))
                    proc = self.obs_connectors.transform(
                        np.asarray(ob)[None])
                    a, _ = self.policy_map[pid].compute_actions(
                        proc, explore=False)
                    actions[aid] = self.action_connectors.transform(a)[0]
                obs, rews, terms, truncs, _ = env.step(actions)
                total += float(sum(rews.values()))
                done = bool(terms.get("__all__") or truncs.get("__all__"))
                obs = {a: o for a, o in obs.items()
                       if not (terms.get(a) or truncs.get(a))}
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

    def ping(self) -> str:
        return "ok"

    def stop(self):
        pass
