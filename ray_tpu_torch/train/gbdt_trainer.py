"""GBDT trainers: XGBoost / LightGBM / sklearn gradient boosting.

Reference analogue: python/ray/train/gbdt_trainer.py (the shared
XGBoost/LightGBM trainer riding xgboost-ray/lightgbm-ray) plus
train/sklearn/sklearn_trainer.py. The shape is the reference's: a
trainer that materializes its Ray Datasets into matrices inside a
framework-managed worker, fits the booster, reports eval metrics
through the session, and checkpoints the fitted model. xgboost and
lightgbm are not baked into this image, so those subclasses gate on
import exactly like the reference does when its integrations are
missing; the sklearn backend is fully functional and exercises the
entire shared path.

The port's copy of ``ray_tpu/train/gbdt_trainer.py`` (imports renamed
to ``ray_tpu_torch``); sklearn, xgboost and lightgbm are imported only
inside the functions that fit.
"""

from __future__ import annotations

import pickle
from typing import Any, Dict, List, Optional

import numpy as np

from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.air.config import RunConfig, ScalingConfig
from ray_tpu_torch.train.data_parallel_trainer import (BaseTrainer,
                                                 DataParallelTrainer,
                                                 Result)

MODEL_KEY = "model.pkl"


def _dataset_to_xy(ds, label_column: str):
    """Materialize a Dataset (or plain dict/arrays) into X, y."""
    if hasattr(ds, "take_all"):
        rows = ds.take_all()
        if rows and isinstance(rows[0], dict):
            ys = np.asarray([r[label_column] for r in rows])
            feat_keys = [k for k in rows[0] if k != label_column]
            xs = np.asarray([[r[k] for k in feat_keys] for r in rows])
            return xs, ys
        arr = np.asarray(rows)
        return arr[:, :-1], arr[:, -1]
    if isinstance(ds, dict):
        return np.asarray(ds["X"]), np.asarray(ds["y"])
    raise TypeError(f"cannot turn {type(ds)} into a matrix")


class GBDTTrainer(BaseTrainer):
    """Shared GBDT orchestration (reference: gbdt_trainer.py): the fit
    runs in ONE framework-managed worker (boosting is not data-parallel
    here — the reference distributes via xgboost-ray's rabit ring; this
    image has no xgboost at all, so the gang stays size-1 and the seam
    is the `_fit_model` hook)."""

    _framework = "gbdt"

    def __init__(self, *, label_column: str,
                 params: Optional[Dict[str, Any]] = None,
                 num_boost_round: int = 50,
                 scaling_config: Optional[ScalingConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 datasets: Optional[Dict[str, Any]] = None,
                 resume_from_checkpoint=None):
        super().__init__(scaling_config=scaling_config,
                         run_config=run_config, datasets=datasets,
                         resume_from_checkpoint=resume_from_checkpoint)
        self.label_column = label_column
        self.params = params or {}
        self.num_boost_round = num_boost_round

    # subclasses override: fit + eval, return (model, metrics)
    def _fit_model(self, X, y, eval_sets, config):
        raise NotImplementedError

    def _with_config_overrides(self, config: Dict[str, Any]):
        merged = {**self.params, **(config or {})}
        clone = type(self)(
            label_column=self.label_column, params=merged,
            num_boost_round=self.num_boost_round,
            scaling_config=self.scaling_config,
            run_config=self.run_config, datasets=self.datasets,
            resume_from_checkpoint=self.resume_from_checkpoint)
        return clone

    def fit(self) -> Result:
        return self._fit_internal(report_through_session=False)

    def _fit_internal(self, report_through_session: bool) -> Result:
        trainer = self

        def train_loop(config):
            from ray_tpu_torch.air import session
            train_ds = session.get_dataset_shard("train")
            X, y = _dataset_to_xy(
                train_ds if train_ds is not None
                else trainer.datasets["train"], trainer.label_column)
            eval_sets = {}
            for name, ds in trainer.datasets.items():
                if name != "train":
                    eval_sets[name] = _dataset_to_xy(
                        ds, trainer.label_column)
            model, metrics = trainer._fit_model(X, y, eval_sets, config)
            ckpt = Checkpoint.from_dict(
                {MODEL_KEY: pickle.dumps(model),
                 "label_column": trainer.label_column})
            session.report(metrics, checkpoint=ckpt)

        inner = DataParallelTrainer(
            train_loop, train_loop_config=dict(self.params),
            scaling_config=self.scaling_config,
            run_config=self.run_config,
            datasets=self.datasets,
            resume_from_checkpoint=self.resume_from_checkpoint)
        return inner._fit_internal(report_through_session)

    @staticmethod
    def get_model(checkpoint: Checkpoint):
        d = checkpoint.to_dict()
        return pickle.loads(d[MODEL_KEY])


class SklearnGBDTTrainer(GBDTTrainer):
    """Gradient boosting via scikit-learn (fully functional in this
    image; reference analogue: train/sklearn/sklearn_trainer.py)."""

    _framework = "sklearn"

    def _fit_model(self, X, y, eval_sets, config):
        from sklearn.ensemble import (GradientBoostingClassifier,
                                      GradientBoostingRegressor)
        params = dict(config or {})
        objective = params.pop("objective", "classification")
        params.setdefault("n_estimators", self.num_boost_round)
        cls = (GradientBoostingRegressor if objective == "regression"
               else GradientBoostingClassifier)
        model = cls(**params)
        model.fit(X, y)
        metrics: Dict[str, Any] = {
            "train-score": float(model.score(X, y))}
        for name, (Xe, ye) in eval_sets.items():
            metrics[f"{name}-score"] = float(model.score(Xe, ye))
        return model, metrics


class XGBoostTrainer(GBDTTrainer):
    """XGBoost trainer (reference: train/xgboost/xgboost_trainer.py).
    Gated on the xgboost package, which this image does not bake."""

    _framework = "xgboost"

    def _fit_model(self, X, y, eval_sets, config):
        try:
            import xgboost as xgb
        except ImportError as e:
            raise ImportError(
                "XGBoostTrainer requires xgboost: pip install xgboost"
            ) from e
        dtrain = xgb.DMatrix(X, label=y)
        evals = [(xgb.DMatrix(Xe, label=ye), name)
                 for name, (Xe, ye) in eval_sets.items()]
        evals_result: Dict[str, Any] = {}
        model = xgb.train(dict(config or {}), dtrain,
                          num_boost_round=self.num_boost_round,
                          evals=evals, evals_result=evals_result)
        metrics = {f"{name}-{m}": vals[-1]
                   for name, per in evals_result.items()
                   for m, vals in per.items()}
        return model, metrics


class LightGBMTrainer(GBDTTrainer):
    """LightGBM trainer (reference: train/lightgbm/lightgbm_trainer.py).
    Gated on the lightgbm package, which this image does not bake."""

    _framework = "lightgbm"

    def _fit_model(self, X, y, eval_sets, config):
        try:
            import lightgbm as lgb
        except ImportError as e:
            raise ImportError(
                "LightGBMTrainer requires lightgbm: "
                "pip install lightgbm") from e
        train_set = lgb.Dataset(X, label=y)
        valid = [lgb.Dataset(Xe, label=ye)
                 for _, (Xe, ye) in eval_sets.items()]
        model = lgb.train(dict(config or {}), train_set,
                          num_boost_round=self.num_boost_round,
                          valid_sets=valid)
        return model, {"train-best-iter": model.best_iteration or 0}
