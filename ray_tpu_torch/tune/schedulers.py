"""Trial schedulers: early stopping + population-based training.

Reference: tune/schedulers/ — async_hyperband.py (ASHA, the workhorse),
median_stopping_rule.py, pbt.py, hyperband.py. Decisions are made per
result: CONTINUE / STOP / and for PBT an exploit-mutate step.

The port's copy of ``ray_tpu/tune/schedulers.py``
(imports renamed to ``ray_tpu_torch``).
"""

from __future__ import annotations

import math
import random
from typing import Any, Dict, List, Optional

CONTINUE = "CONTINUE"
STOP = "STOP"

TRAINING_ITERATION = "training_iteration"


class TrialScheduler:
    def set_search_properties(self, metric: Optional[str], mode: str):
        if metric:
            self.metric = metric
        if mode:
            self.mode = mode

    def on_trial_result(self, runner, trial, result) -> str:
        return CONTINUE

    def on_trial_complete(self, runner, trial, result):
        pass


class FIFOScheduler(TrialScheduler):
    """Run every trial to completion (default)."""

    metric: Optional[str] = None
    mode: str = "max"


class AsyncHyperBandScheduler(TrialScheduler):
    """ASHA (reference: schedulers/async_hyperband.py).

    At each rung (iteration = grace_period * reduction_factor^k) a trial
    must beat the rung's top 1/reduction_factor cutoff of previously
    recorded results or it is stopped. Asynchronous: no waiting for a full
    bracket — decisions use whatever has been recorded so far.
    """

    def __init__(self, metric: Optional[str] = None, mode: str = "max",
                 time_attr: str = TRAINING_ITERATION,
                 max_t: int = 100, grace_period: int = 1,
                 reduction_factor: float = 4):
        self.metric, self.mode = metric, mode
        self.time_attr = time_attr
        self.max_t, self.grace = max_t, grace_period
        self.rf = reduction_factor
        # rung iteration -> list of recorded metric values
        self._rungs: Dict[int, List[float]] = {}
        r = grace_period
        while r < max_t:
            self._rungs[int(r)] = []
            r *= reduction_factor

    def _val(self, result) -> Optional[float]:
        v = result.get(self.metric)
        if v is None:
            return None
        return float(v) if self.mode == "max" else -float(v)

    def on_trial_result(self, runner, trial, result) -> str:
        t = result.get(self.time_attr)
        if t is None or self.metric is None:
            return CONTINUE
        if t >= self.max_t:
            return STOP
        rung = self._current_rung(t)
        if rung is None:
            return CONTINUE
        v = self._val(result)
        if v is None:
            return CONTINUE
        recorded = self._rungs[rung]
        recorded.append(v)
        k = max(1, int(math.ceil(len(recorded) / self.rf)))
        cutoff = sorted(recorded, reverse=True)[k - 1]
        if v < cutoff:
            return STOP
        return CONTINUE

    def _current_rung(self, t: int) -> Optional[int]:
        best = None
        for r in self._rungs:
            if t >= r and (best is None or r > best):
                best = r
        return best


# Alias matching the reference's exported name
ASHAScheduler = AsyncHyperBandScheduler


class HyperBandScheduler(TrialScheduler):
    """HyperBand (reference: schedulers/hyperband.py).

    Incoming trials round-robin into brackets s = s_max..0; bracket s
    starts its trials with grace period eta^s — bracket 0 culls most
    aggressively (grace 1), bracket s_max (grace ≈ max_t) runs its
    trials essentially to full budget, preserving HyperBand's
    no-one-regime-wins-everywhere guarantee. Successive-halving rungs
    cull to the top 1/eta within the bracket. Decisions are made
    asynchronously per result (no global pause barrier — the
    ASHA-style relaxation of the synchronous algorithm, which composes
    with this runner's streaming result loop)."""

    def __init__(self, metric: Optional[str] = None, mode: str = "max",
                 time_attr: str = TRAINING_ITERATION,
                 max_t: int = 81, reduction_factor: float = 3):
        self.metric, self.mode = metric, mode
        self.time_attr = time_attr
        self.max_t = max_t
        self.rf = reduction_factor
        # integer power loop: float log truncates (log(1000,10)=2.999…)
        # and would drop the full-budget bracket
        s_max, r = 0, 1
        while r * reduction_factor <= max_t:
            r *= reduction_factor
            s_max += 1
        # one ASHA ladder per bracket, with bracket-specific grace
        self._brackets = [
            AsyncHyperBandScheduler(
                metric=metric, mode=mode, time_attr=time_attr,
                max_t=max_t,
                grace_period=max(1, int(reduction_factor ** s)),
                reduction_factor=reduction_factor)
            for s in range(s_max, -1, -1)]
        self._assignment: Dict[str, int] = {}
        self._next = 0

    def set_search_properties(self, metric, mode):
        super().set_search_properties(metric, mode)
        for b in self._brackets:
            b.set_search_properties(metric, mode)

    def _bracket_for(self, trial) -> "AsyncHyperBandScheduler":
        idx = self._assignment.get(trial.trial_id)
        if idx is None:
            idx = self._next % len(self._brackets)
            self._assignment[trial.trial_id] = idx
            self._next += 1
        return self._brackets[idx]

    def on_trial_result(self, runner, trial, result) -> str:
        return self._bracket_for(trial).on_trial_result(
            runner, trial, result)


class HyperBandForBOHB(HyperBandScheduler):
    """HyperBand variant paired with BOHBSearcher (reference:
    schedulers/hb_bohb.py). The bracket ladder is the async HyperBand
    above; BOHB's coupling lives in the SEARCHER (its KDE conditions on
    per-budget results arriving from these brackets), so this subclass
    exists as the documented pairing point and keeps the reference's
    class name."""


class ResourceChangingScheduler(TrialScheduler):
    """Wraps a base scheduler and reallocates per-trial resources while
    trials run (reference: schedulers/resource_changing_scheduler.py).

    ``resources_allocation_function(runner, trial, result, scheduler)``
    returns a resources dict (or None = keep); a change restarts the
    trial's actor from its latest checkpoint with the new allocation
    via runner.update_trial_resources."""

    def __init__(self, base_scheduler: Optional[TrialScheduler] = None,
                 resources_allocation_function=None):
        self.base = base_scheduler or FIFOScheduler()
        self.alloc_fn = resources_allocation_function
        self.metric = getattr(self.base, "metric", None)
        self.mode = getattr(self.base, "mode", "max")

    def set_search_properties(self, metric, mode):
        super().set_search_properties(metric, mode)
        self.base.set_search_properties(metric, mode)

    def on_trial_result(self, runner, trial, result) -> str:
        decision = self.base.on_trial_result(runner, trial, result)
        if decision == STOP or self.alloc_fn is None:
            return decision
        new = self.alloc_fn(runner, trial, result, self)
        if new:
            runner.update_trial_resources(trial, new)
        return decision

    def on_trial_complete(self, runner, trial, result):
        self.base.on_trial_complete(runner, trial, result)


class MedianStoppingRule(TrialScheduler):
    """Stop a trial whose running-average is below the median of the other
    trials' running averages at the same point (reference:
    schedulers/median_stopping_rule.py)."""

    def __init__(self, metric: Optional[str] = None, mode: str = "max",
                 time_attr: str = TRAINING_ITERATION,
                 grace_period: int = 1, min_samples_required: int = 3):
        self.metric, self.mode = metric, mode
        self.time_attr = time_attr
        self.grace = grace_period
        self.min_samples = min_samples_required
        self._avgs: Dict[str, List[float]] = {}

    def on_trial_result(self, runner, trial, result) -> str:
        if self.metric is None or self.metric not in result:
            return CONTINUE
        v = float(result[self.metric])
        if self.mode == "min":
            v = -v
        hist = self._avgs.setdefault(trial.trial_id, [])
        hist.append(v)
        if result.get(self.time_attr, 0) < self.grace:
            return CONTINUE
        others = [sum(h) / len(h) for tid, h in self._avgs.items()
                  if tid != trial.trial_id and h]
        if len(others) < self.min_samples:
            return CONTINUE
        others.sort()
        median = others[len(others) // 2]
        mine = sum(hist) / len(hist)
        return STOP if mine < median else CONTINUE


class PopulationBasedTraining(TrialScheduler):
    """PBT (reference: schedulers/pbt.py). Every perturbation_interval,
    bottom-quantile trials clone the checkpoint + config of a random
    top-quantile trial, with hyperparameters perturbed (x1.2 / x0.8 or
    resampled). The runner applies the exploit via trial restart/restore.
    """

    def __init__(self, metric: Optional[str] = None, mode: str = "max",
                 time_attr: str = TRAINING_ITERATION,
                 perturbation_interval: int = 4,
                 hyperparam_mutations: Optional[Dict[str, Any]] = None,
                 quantile_fraction: float = 0.25,
                 resample_probability: float = 0.25,
                 seed: Optional[int] = None):
        self.metric, self.mode = metric, mode
        self.time_attr = time_attr
        self.interval = perturbation_interval
        self.mutations = hyperparam_mutations or {}
        self.quantile = quantile_fraction
        self.resample_prob = resample_probability
        self._rng = random.Random(seed)
        self._last_perturb: Dict[str, int] = {}
        self._scores: Dict[str, float] = {}

    def on_trial_result(self, runner, trial, result) -> str:
        if self.metric is None or self.metric not in result:
            return CONTINUE
        v = float(result[self.metric])
        self._scores[trial.trial_id] = v if self.mode == "max" else -v
        t = result.get(self.time_attr, 0)
        if t - self._last_perturb.get(trial.trial_id, 0) < self.interval:
            return CONTINUE
        self._last_perturb[trial.trial_id] = t

        scores = sorted(self._scores.items(), key=lambda kv: kv[1])
        n = len(scores)
        k = max(1, int(n * self.quantile))
        if n < 2 * k:
            return CONTINUE
        bottom = {tid for tid, _ in scores[:k]}
        top = [tid for tid, _ in scores[-k:]]
        if trial.trial_id not in bottom:
            return CONTINUE
        donor_id = self._rng.choice(top)
        donor = runner.get_trial(donor_id)
        if donor is None or donor.latest_checkpoint is None:
            return CONTINUE
        new_config = self._explore(dict(donor.config))
        runner.exploit(trial, donor, new_config)
        return CONTINUE

    def _explore(self, config: Dict[str, Any]) -> Dict[str, Any]:
        from ray_tpu_torch.tune.sample import Domain
        for key, mut in self.mutations.items():
            if key not in config:
                continue
            if isinstance(mut, Domain):
                if self._rng.random() < self.resample_prob:
                    config[key] = mut.sample(self._rng)
                else:
                    config[key] = config[key] * self._rng.choice([0.8, 1.2])
            elif isinstance(mut, (list, tuple)):
                config[key] = self._rng.choice(list(mut))
            elif callable(mut):
                config[key] = mut()
        return config


class PB2(PopulationBasedTraining):
    """Population Based Bandits (reference: tune/schedulers/pb2.py).

    PBT's exploit step, but exploration picks new hyperparameters by
    maximizing a GP-UCB acquisition fit to (config → reward improvement)
    observations from the whole population, instead of random
    perturbation. The GP is the native one from search/bayesopt.py (the
    reference wraps GPy, which is not in this image).
    """

    def __init__(self, metric: Optional[str] = None, mode: str = "max",
                 time_attr: str = TRAINING_ITERATION,
                 perturbation_interval: int = 4,
                 hyperparam_bounds: Optional[
                     Dict[str, List[float]]] = None,
                 quantile_fraction: float = 0.25,
                 log_scale_keys: Optional[List[str]] = None,
                 kappa: float = 2.0,
                 seed: Optional[int] = None):
        if not hyperparam_bounds:
            raise ValueError("PB2 requires hyperparam_bounds: "
                             "{key: [min, max]}")
        super().__init__(
            metric=metric, mode=mode, time_attr=time_attr,
            perturbation_interval=perturbation_interval,
            hyperparam_mutations={}, quantile_fraction=quantile_fraction,
            seed=seed)
        self.bounds = {k: (float(lo), float(hi))
                       for k, (lo, hi) in hyperparam_bounds.items()}
        self.log_keys = set(log_scale_keys or [])
        self.kappa = kappa
        # observations: (warped config vector, normalized reward delta)
        self._X: List[List[float]] = []
        self._y: List[float] = []
        self._last_metric: Dict[str, float] = {}

    def _warp(self, key: str, v: float) -> float:
        lo, hi = self.bounds[key]
        if key in self.log_keys:
            lo, hi, v = math.log(lo), math.log(hi), math.log(max(v, 1e-12))
        return min(1.0, max(0.0, (v - lo) / (hi - lo)))

    def _unwarp(self, key: str, u: float) -> float:
        lo, hi = self.bounds[key]
        if key in self.log_keys:
            return math.exp(math.log(lo) + u * (math.log(hi) -
                                                math.log(lo)))
        return lo + u * (hi - lo)

    def on_trial_result(self, runner, trial, result) -> str:
        # record the reward delta this config produced since last result
        if self.metric is not None and self.metric in result:
            v = float(result[self.metric])
            if self.mode == "min":
                v = -v
            prev = self._last_metric.get(trial.trial_id)
            self._last_metric[trial.trial_id] = v
            if prev is not None and all(k in trial.config
                                        for k in self.bounds):
                x = [self._warp(k, float(trial.config[k]))
                     for k in sorted(self.bounds)]
                self._X.append(x)
                self._y.append(v - prev)
        config_before = id(trial.config)
        decision = super().on_trial_result(runner, trial, result)
        if id(trial.config) != config_before:
            # exploit happened: the next result's score jump comes from
            # the restored checkpoint, not the new config — recording it
            # as a delta would teach the GP a phantom improvement
            self._last_metric.pop(trial.trial_id, None)
        return decision

    def _explore(self, config: Dict[str, Any]) -> Dict[str, Any]:
        keys = sorted(self.bounds)
        if len(self._y) < 4:
            for k in keys:
                config[k] = self._unwarp(k, self._rng.random())
            return config
        import numpy as np
        from ray_tpu_torch.tune.search.bayesopt import GP
        n_keep = 256  # recent window: the reward landscape is time-varying
        X = np.asarray(self._X[-n_keep:])
        y = np.asarray(self._y[-n_keep:])
        gp = GP(length_scale=0.3)
        gp.fit(X, y)
        cand = np.random.default_rng(
            self._rng.randrange(1 << 31)).random((128, len(keys)))
        mu, sd = gp.predict(cand)
        best = cand[int(np.argmax(mu + self.kappa * sd))]
        for k, u in zip(keys, best):
            config[k] = self._unwarp(k, float(u))
        return config
