"""Connector pipelines: composable obs/action transforms between env and
policy.

Reference analogue: rllib/connectors/ (agent + action connectors,
connector_pipeline_v2.py). A pipeline of small pure transforms applied
worker-side: agent connectors on observations BEFORE the policy forward,
action connectors on actions AFTER it — so preprocessing lives with the
sampling worker and is identical at train and serve time. The port's
copy of ``ray_tpu/rllib/connectors.py`` (no JAX), kept whole.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np


class Connector:
    def __call__(self, data: np.ndarray,
                 dones: Optional[np.ndarray] = None) -> np.ndarray:
        """Transform AND update any running state (training-time path).
        ``dones[i]`` marks rows whose sub-env auto-reset THIS step —
        stateful per-env connectors (frame stacking) restart those
        slots."""
        raise NotImplementedError

    def transform(self, data: np.ndarray) -> np.ndarray:
        """Transform WITHOUT updating state — for terminal/bootstrap
        observations and inference, where the data must not be counted
        twice into running statistics."""
        return self(data)

    def output_space(self, space):
        """Observation space AFTER this transform (the policy is built
        against the pipeline's output, not the raw env space)."""
        return space

    def clone_for_eval(self) -> "Connector":
        """A fresh-state copy for a single-env evaluation episode;
        running-statistics connectors share state (stats must match
        training), per-episode-state connectors restart."""
        return self

    def state(self) -> Dict[str, Any]:
        return {}

    def set_state(self, state: Dict[str, Any]):
        pass


class LambdaConnector(Connector):
    def __init__(self, fn: Callable[[np.ndarray], np.ndarray],
                 name: str = "lambda"):
        self.fn = fn
        self.name = name

    def __call__(self, data, dones=None):
        return self.fn(data)


class FlattenObsConnector(Connector):
    """[B, ...] -> [B, prod(...)] (reference: FlattenObservations)."""

    def __call__(self, obs, dones=None):
        obs = np.asarray(obs)
        return obs.reshape(obs.shape[0], -1)

    def output_space(self, space):
        from ray_tpu_torch.rllib.env import Box
        return Box(-np.inf, np.inf, (int(np.prod(space.shape)),))


class MeanStdObsConnector(Connector):
    """Running mean/std observation normalization (reference:
    MeanStdFilter agent connector). State ships with checkpoints."""

    def __init__(self, epsilon: float = 1e-8):
        self.eps = epsilon
        self._count = 0
        self._mean: Optional[np.ndarray] = None
        self._m2: Optional[np.ndarray] = None

    def __call__(self, obs, dones=None):
        obs = np.asarray(obs, np.float64)
        for row in obs:
            self._count += 1
            if self._mean is None:
                self._mean = np.zeros_like(row)
                self._m2 = np.zeros_like(row)
            delta = row - self._mean
            self._mean += delta / self._count
            self._m2 += delta * (row - self._mean)
        return self.transform(obs)

    def transform(self, obs):
        obs = np.asarray(obs, np.float64)
        if self._mean is None:
            return obs.astype(np.float32)
        std = np.sqrt(self._m2 / max(1, self._count - 1)) \
            if self._count > 1 else np.ones_like(self._mean)
        return ((obs - self._mean) / (std + self.eps)).astype(np.float32)

    def clone_for_eval(self):
        # frozen view: eval episodes read the training stats but must
        # not feed them
        return LambdaConnector(self.transform, name="frozen_meanstd")

    def state(self):
        return {"count": self._count,
                "mean": None if self._mean is None else self._mean.copy(),
                "m2": None if self._m2 is None else self._m2.copy()}

    def set_state(self, state):
        self._count = state["count"]
        self._mean = state["mean"]
        self._m2 = state["m2"]


class ClipActionConnector(Connector):
    """Clip continuous actions into [low, high] (reference:
    clip_actions action connector)."""

    def __init__(self, low, high):
        self.low, self.high = low, high

    def __call__(self, actions, dones=None):
        return np.clip(actions, self.low, self.high)


class GrayscaleObsConnector(Connector):
    """[B, H, W, C] -> [B, H, W, 1] luminance mean (reference: the
    atari_wrappers.py WarpFrame grayscale half)."""

    def __call__(self, obs, dones=None):
        obs = np.asarray(obs)
        return obs.mean(axis=-1, keepdims=True).astype(obs.dtype)

    def output_space(self, space):
        from ray_tpu_torch.rllib.env import Box
        h, w = space.shape[0], space.shape[1]
        return Box(0, 255, (h, w, 1), np.uint8)


class ResizeObsConnector(Connector):
    """[B, H, W, C] -> [B, h, w, C] by integer-factor average pooling
    (reference: atari_wrappers.py WarpFrame resize — cv2-free)."""

    def __init__(self, height: int, width: int):
        self.h, self.w = height, width

    def __call__(self, obs, dones=None):
        obs = np.asarray(obs)
        b, H, W, c = obs.shape
        fh, fw = H // self.h, W // self.w
        if fh * self.h != H or fw * self.w != W:
            raise ValueError(
                f"resize {H}x{W} -> {self.h}x{self.w}: factors must "
                "be integers")
        pooled = obs.reshape(b, self.h, fh, self.w, fw, c).mean((2, 4))
        return pooled.astype(obs.dtype)

    def output_space(self, space):
        from ray_tpu_torch.rllib.env import Box
        return Box(0, 255, (self.h, self.w, space.shape[-1]), np.uint8)


class FrameStackConnector(Connector):
    """[B, H, W, C] -> [B, H, W, C*k]: per-sub-env stacks of the last k
    frames along the channel axis (reference: atari_wrappers.py
    FrameStack). A slot whose episode auto-reset this step (``dones``)
    restarts its stack from the fresh observation."""

    def __init__(self, k: int = 4):
        self.k = k
        self._stacks: Optional[np.ndarray] = None  # [B, H, W, C*k]
        self._c = 0

    def _restart(self, obs_row):
        return np.concatenate([obs_row] * self.k, axis=-1)

    def __call__(self, obs, dones=None):
        obs = np.asarray(obs)
        if self._stacks is None or self._stacks.shape[0] != obs.shape[0]:
            self._c = obs.shape[-1]
            self._stacks = np.stack(
                [self._restart(o) for o in obs])
            return self._stacks.copy()
        shifted = np.concatenate(
            [self._stacks[..., self._c:], obs], axis=-1)
        if dones is not None:
            for i in np.nonzero(np.asarray(dones))[0]:
                shifted[i] = self._restart(obs[i])
        self._stacks = shifted
        return self._stacks.copy()

    def transform(self, obs):
        """Append to the CURRENT stacks without advancing state — the
        terminal/bootstrap observation path."""
        obs = np.asarray(obs)
        if self._stacks is None or self._stacks.shape[0] != obs.shape[0]:
            return np.concatenate([obs] * self.k, axis=-1)
        return np.concatenate([self._stacks[..., obs.shape[-1]:], obs],
                              axis=-1)

    def output_space(self, space):
        from ray_tpu_torch.rllib.env import Box
        h, w, c = space.shape
        return Box(0, 255, (h, w, c * self.k), np.uint8)

    def clone_for_eval(self):
        return FrameStackConnector(self.k)


class ConnectorPipeline:
    def __init__(self, connectors: Optional[List[Connector]] = None):
        self.connectors = list(connectors or [])

    def __call__(self, data, dones=None):
        for c in self.connectors:
            data = c(data, dones)
        return data

    def transform(self, data):
        """State-preserving application (see Connector.transform)."""
        for c in self.connectors:
            data = c.transform(data)
        return data

    def observation_space(self, space):
        for c in self.connectors:
            space = c.output_space(space)
        return space

    def clone_for_eval(self) -> "ConnectorPipeline":
        return ConnectorPipeline(
            [c.clone_for_eval() for c in self.connectors])

    def append(self, connector: Connector):
        self.connectors.append(connector)

    def state(self) -> List[Dict[str, Any]]:
        return [c.state() for c in self.connectors]

    def set_state(self, states: List[Dict[str, Any]]):
        for c, s in zip(self.connectors, states):
            c.set_state(s)


def build_connectors(config: Dict[str, Any]):
    """(obs_pipeline, action_pipeline) from config["connectors"]:
    {"obs": [Connector...], "actions": [Connector...]}."""
    spec = config.get("connectors") or {}
    return (ConnectorPipeline(spec.get("obs")),
            ConnectorPipeline(spec.get("actions")))
