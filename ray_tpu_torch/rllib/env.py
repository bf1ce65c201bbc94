"""Environment layer: spaces, builtin numpy envs, gymnasium adapter,
and a synchronous VectorEnv.

Reference analogue: rllib/env/ (BaseEnv, vector_env.py, gym wrappers).
The port's copy of ``ray_tpu/rllib/env.py`` (which imports no JAX), kept
whole: env stepping happens on the host; the vector env presents
*stacked numpy* observations so policies evaluate one batched forward
on the device per env-step across all sub-envs instead of per-env
Python calls.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np


class Box:
    def __init__(self, low, high, shape, dtype=np.float32):
        self.low, self.high = low, high
        self.shape = tuple(shape)
        self.dtype = dtype

    def sample(self, rng=None):
        rng = rng or np.random.default_rng()
        return rng.uniform(self.low, self.high, self.shape).astype(self.dtype)


class Discrete:
    def __init__(self, n: int):
        self.n = int(n)
        self.shape = ()
        self.dtype = np.int32

    def sample(self, rng=None):
        rng = rng or np.random.default_rng()
        return int(rng.integers(self.n))


class CartPoleEnv:
    """Pure-numpy CartPole-v1 (dynamics per the classic Barto/Sutton/
    Anderson formulation used by gym) — keeps RL tests dependency-free."""

    GRAVITY = 9.8
    MASSCART = 1.0
    MASSPOLE = 0.1
    LENGTH = 0.5
    FORCE_MAG = 10.0
    TAU = 0.02
    THETA_LIMIT = 12 * 2 * np.pi / 360
    X_LIMIT = 2.4
    MAX_STEPS = 500

    def __init__(self, config: Optional[Dict[str, Any]] = None):
        config = config or {}
        self.observation_space = Box(-np.inf, np.inf, (4,))
        self.action_space = Discrete(2)
        self._rng = np.random.default_rng(config.get("seed"))
        self._state = None
        self._t = 0

    def reset(self, *, seed: Optional[int] = None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._state = self._rng.uniform(-0.05, 0.05, size=4)
        self._t = 0
        return self._state.astype(np.float32), {}

    def step(self, action: int):
        x, x_dot, theta, theta_dot = self._state
        force = self.FORCE_MAG if action == 1 else -self.FORCE_MAG
        total_mass = self.MASSCART + self.MASSPOLE
        polemass_length = self.MASSPOLE * self.LENGTH
        costheta, sintheta = np.cos(theta), np.sin(theta)
        temp = (force + polemass_length * theta_dot ** 2 * sintheta
                ) / total_mass
        thetaacc = (self.GRAVITY * sintheta - costheta * temp) / (
            self.LENGTH * (4.0 / 3.0 - self.MASSPOLE * costheta ** 2
                           / total_mass))
        xacc = temp - polemass_length * thetaacc * costheta / total_mass
        x = x + self.TAU * x_dot
        x_dot = x_dot + self.TAU * xacc
        theta = theta + self.TAU * theta_dot
        theta_dot = theta_dot + self.TAU * thetaacc
        self._state = np.array([x, x_dot, theta, theta_dot])
        self._t += 1
        terminated = bool(abs(x) > self.X_LIMIT
                          or abs(theta) > self.THETA_LIMIT)
        truncated = self._t >= self.MAX_STEPS
        return (self._state.astype(np.float32), 1.0, terminated, truncated,
                {})


class PendulumEnv:
    """Pure-numpy Pendulum-v1 (continuous control smoke env)."""

    MAX_SPEED = 8.0
    MAX_TORQUE = 2.0
    DT = 0.05
    G = 10.0
    MAX_STEPS = 200

    def __init__(self, config: Optional[Dict[str, Any]] = None):
        config = config or {}
        self.observation_space = Box(-np.inf, np.inf, (3,))
        self.action_space = Box(-self.MAX_TORQUE, self.MAX_TORQUE, (1,))
        self._rng = np.random.default_rng(config.get("seed"))
        # balance mode: start near upright — the short-credit-horizon
        # variant (swing-up needs long-horizon planning; balancing is
        # the standard quick target for model-based smoke tests)
        self._balance = bool(config.get("balance_init"))
        self._th = self._thdot = 0.0
        self._t = 0

    def _obs(self):
        return np.array([np.cos(self._th), np.sin(self._th), self._thdot],
                        np.float32)

    def reset(self, *, seed: Optional[int] = None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        if self._balance:
            self._th = self._rng.uniform(-0.3, 0.3)
            self._thdot = self._rng.uniform(-0.2, 0.2)
        else:
            self._th = self._rng.uniform(-np.pi, np.pi)
            self._thdot = self._rng.uniform(-1.0, 1.0)
        self._t = 0
        return self._obs(), {}

    def step(self, action):
        u = float(np.clip(np.asarray(action).reshape(-1)[0],
                          -self.MAX_TORQUE, self.MAX_TORQUE))
        th, thdot = self._th, self._thdot
        norm_th = ((th + np.pi) % (2 * np.pi)) - np.pi
        cost = norm_th ** 2 + 0.1 * thdot ** 2 + 0.001 * u ** 2
        thdot = thdot + (3 * self.G / 2 * np.sin(th) + 3.0 * u) * self.DT
        thdot = float(np.clip(thdot, -self.MAX_SPEED, self.MAX_SPEED))
        th = th + thdot * self.DT
        self._th, self._thdot = th, thdot
        self._t += 1
        return self._obs(), -cost, False, self._t >= self.MAX_STEPS, {}


class PixelCatcher:
    """Procedurally generated Atari-class pixel env (ALE is not
    installable in this image; reference analogue: the pixel envs the
    reference's release tests run through atari_wrappers.py). An
    84x84x1 uint8 screen: a 4x4 ball falls from a random column; a
    12px paddle at the bottom moves left/stay/right by 6px. +1 for a
    catch, -1 for a miss; episode = ``drops`` balls. Exercises the full
    image path: CNN policy, grayscale/resize/frame-stack connectors."""

    SIZE = 84
    BALL = 4
    PADDLE_W = 12
    PADDLE_H = 4
    STEP_X = 6
    FALL = 6

    def __init__(self, config: Optional[Dict[str, Any]] = None):
        cfg = config or {}
        self.drops = int(cfg.get("drops", 4))
        self.observation_space = Box(0, 255, (self.SIZE, self.SIZE, 1),
                                     np.uint8)
        self.action_space = Discrete(3)
        self._rng = np.random.default_rng(cfg.get("seed"))
        self._ball = [0, 0]
        self._paddle_x = 0
        self._drops_left = 0

    def _spawn(self):
        self._ball = [0, int(self._rng.integers(
            0, self.SIZE - self.BALL))]

    def _obs(self) -> np.ndarray:
        img = np.zeros((self.SIZE, self.SIZE, 1), np.uint8)
        y, x = self._ball
        img[y:y + self.BALL, x:x + self.BALL, 0] = 255
        img[self.SIZE - self.PADDLE_H:,
            self._paddle_x:self._paddle_x + self.PADDLE_W, 0] = 160
        return img

    def reset(self, *, seed: Optional[int] = None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._paddle_x = (self.SIZE - self.PADDLE_W) // 2
        self._drops_left = self.drops
        self._spawn()
        return self._obs(), {}

    def step(self, action):
        a = int(action)
        self._paddle_x = int(np.clip(
            self._paddle_x + (a - 1) * self.STEP_X,
            0, self.SIZE - self.PADDLE_W))
        self._ball[0] += self.FALL
        reward, term = 0.0, False
        if self._ball[0] + self.BALL >= self.SIZE - self.PADDLE_H:
            bx = self._ball[1]
            caught = (bx + self.BALL > self._paddle_x and
                      bx < self._paddle_x + self.PADDLE_W)
            reward = 1.0 if caught else -1.0
            self._drops_left -= 1
            if self._drops_left <= 0:
                term = True
            else:
                self._spawn()
        return self._obs(), reward, term, False, {}


_BUILTIN_ENVS = {
    "CartPole-v1": CartPoleEnv,
    "Pendulum-v1": PendulumEnv,
    "PixelCatcher-v0": PixelCatcher,
}
# MultiAgentCartPole is appended below (class defined after make_env)


class _GymnasiumAdapter:
    """Wraps a gymnasium env into our 5-tuple step protocol + spaces."""

    def __init__(self, env):
        self._env = env
        self.observation_space = Box(
            getattr(env.observation_space, "low", -np.inf),
            getattr(env.observation_space, "high", np.inf),
            env.observation_space.shape or (),
            env.observation_space.dtype)
        if hasattr(env.action_space, "n"):
            self.action_space = Discrete(env.action_space.n)
        else:
            self.action_space = Box(env.action_space.low,
                                    env.action_space.high,
                                    env.action_space.shape,
                                    env.action_space.dtype)

    def reset(self, *, seed=None):
        return self._env.reset(seed=seed)

    def step(self, action):
        if hasattr(self._env.action_space, "n"):
            action = int(action)
        else:
            action = np.asarray(action, self._env.action_space.dtype).reshape(
                self._env.action_space.shape)
        return self._env.step(action)


def make_env(env_spec: Any, env_config: Optional[Dict[str, Any]] = None):
    """Resolve an env spec: builtin name, gymnasium id, or callable."""
    env_config = env_config or {}
    if callable(env_spec):
        return env_spec(env_config)
    if isinstance(env_spec, str):
        if env_spec in _BUILTIN_ENVS:
            return _BUILTIN_ENVS[env_spec](env_config)
        try:
            import gymnasium
            return _GymnasiumAdapter(gymnasium.make(env_spec, **env_config))
        except Exception as e:
            raise ValueError(f"unknown env {env_spec!r}: {e}") from e
    raise ValueError(f"bad env spec: {env_spec!r}")


class VectorEnv:
    """Synchronous vector of N sub-envs with auto-reset.

    Returns stacked numpy arrays so the policy runs ONE batched forward for
    all sub-envs per step (reference: rllib/env/vector_env.py, but there
    policies loop per-env in Python far more).
    """

    def __init__(self, env_fn: Callable[[], Any], num_envs: int,
                 seed: Optional[int] = None):
        self.envs = [env_fn() for _ in range(num_envs)]
        self.num_envs = num_envs
        self.observation_space = self.envs[0].observation_space
        self.action_space = self.envs[0].action_space
        self._seed = seed

    def reset_all(self) -> np.ndarray:
        obs = []
        for i, e in enumerate(self.envs):
            seed = None if self._seed is None else self._seed + i
            o, _ = e.reset(seed=seed)
            obs.append(o)
        return np.stack(obs)

    def step(self, actions: np.ndarray
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray,
                        List[dict]]:
        obs, rews, terms, truncs, infos = [], [], [], [], []
        for e, a in zip(self.envs, actions):
            o, r, term, trunc, info = e.step(a)
            if term or trunc:
                info = dict(info)
                info["terminal_observation"] = o
                o, _ = e.reset()
            obs.append(o)
            rews.append(r)
            terms.append(term)
            truncs.append(trunc)
            infos.append(info)
        return (np.stack(obs), np.asarray(rews, np.float32),
                np.asarray(terms), np.asarray(truncs), infos)


class MultiAgentEnv:
    """Multi-agent env API (reference: rllib/env/multi_agent_env.py:22).

    reset() -> ({agent_id: obs}, {agent_id: info})
    step({agent_id: action}) -> (obs, rewards, terminateds, truncateds,
    infos) dicts keyed by agent id; terminateds/truncateds carry the
    special "__all__" key ending the episode for everyone.
    """

    agent_ids: List[Any] = []

    def reset(self, *, seed: Optional[int] = None):
        raise NotImplementedError

    def step(self, action_dict: Dict[Any, Any]):
        raise NotImplementedError


class MultiAgentCartPole(MultiAgentEnv):
    """N independent CartPole instances keyed by agent id — the standard
    multi-agent smoke env (reference: rllib/examples/env/
    multi_agent.py MultiAgentCartPole)."""

    def __init__(self, config: Optional[Dict[str, Any]] = None):
        config = config or {}
        self.num_agents = int(config.get("num_agents", 2))
        self.agent_ids = [f"agent_{i}" for i in range(self.num_agents)]
        self._envs = {aid: CartPoleEnv() for aid in self.agent_ids}
        self._done: Dict[Any, bool] = {}
        e = next(iter(self._envs.values()))
        self.observation_space = e.observation_space
        self.action_space = e.action_space

    def reset(self, *, seed: Optional[int] = None):
        obs, infos = {}, {}
        self._done = {aid: False for aid in self.agent_ids}
        for i, (aid, e) in enumerate(self._envs.items()):
            s = None if seed is None else seed + i
            o, info = e.reset(seed=s)
            obs[aid] = o
            infos[aid] = info
        return obs, infos

    def step(self, action_dict: Dict[Any, Any]):
        obs, rews, terms, truncs, infos = {}, {}, {}, {}, {}
        for aid, a in action_dict.items():
            if self._done.get(aid):
                continue
            o, r, term, trunc, info = self._envs[aid].step(a)
            obs[aid], rews[aid] = o, r
            terms[aid], truncs[aid], infos[aid] = term, trunc, info
            if term or trunc:
                self._done[aid] = True
        all_done = all(self._done.values())
        terms["__all__"] = all_done
        truncs["__all__"] = False
        return obs, rews, terms, truncs, infos


_BUILTIN_ENVS["MultiAgentCartPole"] = MultiAgentCartPole
