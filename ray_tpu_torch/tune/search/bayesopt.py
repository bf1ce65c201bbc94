"""Native Gaussian-process Bayesian-optimization searcher.

Capability analogue of the reference's tune/search/bayesopt/bayesopt_search.py
(which wraps the `bayesian-optimization` package — not in this image, so the
GP is implemented here with numpy): RBF-kernel GP posterior on the warped
unit cube, expected-improvement acquisition maximized over a random
candidate sweep.

The port's copy of ``ray_tpu/tune/search/bayesopt.py``
(imports renamed to ``ray_tpu_torch``).
"""

from __future__ import annotations

import math
import random
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ray_tpu_torch.tune.sample import resolve
from ray_tpu_torch.tune.search._space import (Dimension, flatten_space, unflatten)
from ray_tpu_torch.tune.search.searcher import Searcher


class GP:
    """Minimal RBF-kernel GP with fixed hyperparameters on standardized y.

    Shared by BayesOptSearch and the PB2 scheduler (schedulers.py)."""

    def __init__(self, length_scale: float = 0.25, signal_var: float = 1.0,
                 noise_var: float = 1e-3):
        self.ls, self.sf2, self.sn2 = length_scale, signal_var, noise_var
        self._X: Optional[np.ndarray] = None

    def _k(self, A: np.ndarray, B: np.ndarray) -> np.ndarray:
        d2 = ((A[:, None, :] - B[None, :, :]) ** 2).sum(-1)
        return self.sf2 * np.exp(-0.5 * d2 / (self.ls ** 2))

    def fit(self, X: np.ndarray, y: np.ndarray):
        self._X = np.asarray(X, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        self._ymu = float(y.mean())
        self._ysd = float(y.std()) or 1.0
        yn = (y - self._ymu) / self._ysd
        K = self._k(self._X, self._X)
        K[np.diag_indices_from(K)] += self.sn2
        self._L = np.linalg.cholesky(K)
        self._alpha = np.linalg.solve(
            self._L.T, np.linalg.solve(self._L, yn))

    def predict(self, Xs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Posterior mean/std in the ORIGINAL y scale."""
        Ks = self._k(np.asarray(Xs, dtype=np.float64), self._X)
        mu = Ks @ self._alpha
        v = np.linalg.solve(self._L, Ks.T)
        var = np.maximum(self.sf2 - (v ** 2).sum(0), 1e-12)
        return mu * self._ysd + self._ymu, np.sqrt(var) * self._ysd


def _norm_cdf(z: np.ndarray) -> np.ndarray:
    return 0.5 * (1.0 + np.vectorize(math.erf)(z / math.sqrt(2.0)))


def _norm_pdf(z: np.ndarray) -> np.ndarray:
    return np.exp(-0.5 * z * z) / math.sqrt(2 * math.pi)


def expected_improvement(mu: np.ndarray, sd: np.ndarray,
                         best: float, xi: float = 0.01) -> np.ndarray:
    imp = mu - best - xi
    z = imp / sd
    return imp * _norm_cdf(z) + sd * _norm_pdf(z)


class BayesOptSearch(Searcher):
    """GP-EI over the numeric dims; categorical/function dims are sampled
    from their prior each suggestion (the reference's bayesopt wrapper has
    the same numeric-only restriction)."""

    def __init__(self, space: Optional[Dict[str, Any]] = None,
                 metric: Optional[str] = None, mode: str = "max",
                 num_samples: Optional[int] = None,
                 n_startup_trials: int = 8, n_candidates: int = 256,
                 xi: float = 0.01, seed: Optional[int] = None):
        super().__init__(metric=metric, mode=mode)
        self._rng = random.Random(seed)
        self._np_rng = np.random.default_rng(seed)
        self.n_startup = n_startup_trials
        self.n_cand = n_candidates
        self.xi = xi
        self.num_samples = num_samples
        self._suggested = 0
        self._space: Optional[Dict[str, Any]] = None
        self._live: Dict[str, List[float]] = {}
        self._X: List[List[float]] = []
        self._y: List[float] = []
        if space is not None:
            self._set_space(space)

    def _set_space(self, space):
        self._space = space
        dims, self._consts = flatten_space(space)
        self._num_dims = [d for d in dims if d.kind == "num"]
        self._other_dims = [d for d in dims if d.kind != "num"]

    def set_search_properties(self, metric, mode, space=None) -> bool:
        super().set_search_properties(metric, mode, space)
        if space and self._space is None:
            self._set_space(space)
        return True

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        if self._space is None:
            raise RuntimeError("BayesOptSearch needs a space")
        if self.num_samples is not None and \
                self._suggested >= self.num_samples:
            return None
        self._suggested += 1
        d = len(self._num_dims)
        if d == 0 or len(self._y) < self.n_startup:
            units = [self._rng.random() for _ in range(d)]
        else:
            cand = self._np_rng.random((self.n_cand, d))
            # seed candidates near the incumbent too
            best_x = np.asarray(self._X[int(np.argmax(self._y))])
            near = np.clip(best_x + self._np_rng.normal(
                0, 0.05, (16, d)), 0, 1)
            cand = np.vstack([cand, near])
            gp = GP()
            gp.fit(np.asarray(self._X), np.asarray(self._y))
            mu, sd = gp.predict(cand)
            ei = expected_improvement(mu, sd, float(np.max(self._y)),
                                      self.xi)
            units = cand[int(np.argmax(ei))].tolist()
        self._live[trial_id] = units
        values = dict(self._consts)
        for dim, u in zip(self._num_dims, units):
            values[dim.path] = dim.from_unit(u)
        for dim in self._other_dims:
            values[dim.path] = dim.sample_native(self._rng)
        return resolve(unflatten(values), self._rng)

    def on_trial_complete(self, trial_id, result=None, error=False):
        units = self._live.pop(trial_id, None)
        if error or units is None or not result or \
                self.metric not in result:
            return
        score = float(result[self.metric])
        if self.mode == "min":
            score = -score
        self._X.append(units)
        self._y.append(score)
