"""BOHB — Bayesian Optimization + HyperBand (Falkner et al. 2018).

Reference analogue: tune/search/bohb/bohb_search.py (TuneBOHB wrapping
hpbandster's KDE model) + tune/schedulers/hb_bohb.py (HyperBandForBOHB).
Neither hpbandster nor ConfigSpace ships in this image, so the model
component is implemented natively on top of the in-repo TPE machinery:
BOHB's model IS a TPE-style Parzen estimator, fit per BUDGET — the
searcher conditions its kernel-density split on the observations at the
LARGEST budget that has enough of them, so early low-fidelity results
guide sampling until high-fidelity results take over.

The port's copy of ``ray_tpu/tune/search/bohb.py``
(imports renamed to ``ray_tpu_torch``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.tune.search.tpe import TPESearcher


class BOHBSearcher(TPESearcher):
    """TPE model conditioned on the largest sufficiently-observed
    budget (the BOHB rule, Falkner et al. §4: "the model of the
    highest budget with at least d+1 observations")."""

    def __init__(self, space: Optional[Dict[str, Any]] = None,
                 metric: Optional[str] = None, mode: str = "max",
                 num_samples: Optional[int] = None,
                 time_attr: str = "training_iteration",
                 min_points_in_model: Optional[int] = None,
                 **kw):
        super().__init__(space, metric=metric, mode=mode,
                         num_samples=num_samples, **kw)
        self.time_attr = time_attr
        self._min_points = min_points_in_model
        # budget -> list of (flat values, score); a trial contributes its
        # LATEST observation per budget
        self._budget_obs: Dict[int, Dict[str, Tuple[List[Any], float]]] = {}

    def _min_pts(self) -> int:
        if self._min_points is not None:
            return self._min_points
        return max(3, len(self._dims) + 1)

    def _record(self, trial_id: str, budget: int, score: float):
        flat = self._live.get(trial_id)
        if flat is None:
            return
        row = [flat[d.path] for d in self._dims]
        self._budget_obs.setdefault(budget, {})[trial_id] = (row, score)

    def on_trial_result(self, trial_id: str, result: Dict[str, Any]):
        if self.metric in result and self.time_attr in result:
            score = result[self.metric]
            if self.mode == "min":
                score = -score
            self._record(trial_id, int(result[self.time_attr]), score)

    def on_trial_complete(self, trial_id: str, result=None, error=False):
        if result and self.metric in result:
            score = result[self.metric]
            if self.mode == "min":
                score = -score
            self._record(trial_id,
                         int(result.get(self.time_attr, 0)), score)
        self._live.pop(trial_id, None)

    def _suggest_flat(self) -> Dict[Tuple[str, ...], Any]:
        # BOHB rule: model the largest budget with enough observations
        need = self._min_pts()
        chosen: List[Tuple[List[Any], float]] = []
        for budget in sorted(self._budget_obs, reverse=True):
            obs = list(self._budget_obs[budget].values())
            if len(obs) >= need:
                chosen = obs
                break
        if not chosen:  # fall back to everything seen so far
            merged: Dict[str, Tuple[List[Any], float]] = {}
            for per_budget in self._budget_obs.values():
                merged.update(per_budget)
            chosen = list(merged.values())
        self._obs = chosen
        return super()._suggest_flat()
