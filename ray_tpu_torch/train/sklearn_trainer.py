"""SklearnTrainer — fit an arbitrary scikit-learn estimator through the
Train API, with cluster-parallel cross-validation.

Reference analogue: python/ray/train/sklearn/sklearn_trainer.py — one
framework-managed worker fits the estimator (sklearn is not
data-parallel), `cv` folds are scored as separate cluster tasks (the
reference parallelizes them with joblib-on-ray via
``parallelize_cv=True``; here the folds ARE tasks), and the fitted
estimator rides an AIR Checkpoint.

The port's copy of ``ray_tpu/train/sklearn_trainer.py`` (imports
renamed to ``ray_tpu_torch``: the folds are ``ray_tpu_torch.remote``
tasks).
"""

from __future__ import annotations

import pickle
import time
from typing import Any, Dict, Optional

from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.air.config import RunConfig, ScalingConfig
from ray_tpu_torch.train.data_parallel_trainer import (BaseTrainer,
                                                 DataParallelTrainer, Result)
from ray_tpu_torch.train.gbdt_trainer import MODEL_KEY, _dataset_to_xy


class SklearnTrainer(BaseTrainer):
    """Fit any sklearn estimator; optionally k-fold cross-validate with
    each fold scored in its own cluster task."""

    _framework = "sklearn"

    def __init__(self, *, estimator=None, label_column: str,
                 params: Optional[Dict[str, Any]] = None,
                 cv: int = 0, parallelize_cv: bool = True,
                 scaling_config: Optional[ScalingConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 datasets: Optional[Dict[str, Any]] = None,
                 resume_from_checkpoint=None):
        super().__init__(scaling_config=scaling_config,
                         run_config=run_config, datasets=datasets,
                         resume_from_checkpoint=resume_from_checkpoint)
        self.estimator = estimator
        self.label_column = label_column
        self.params = params or {}
        self.cv = int(cv)
        self.parallelize_cv = parallelize_cv

    def _with_config_overrides(self, config: Dict[str, Any]):
        merged = {**self.params, **(config or {})}
        return type(self)(
            estimator=self.estimator, label_column=self.label_column,
            params=merged, cv=self.cv,
            parallelize_cv=self.parallelize_cv,
            scaling_config=self.scaling_config, run_config=self.run_config,
            datasets=self.datasets,
            resume_from_checkpoint=self.resume_from_checkpoint)

    def fit(self) -> Result:
        return self._fit_internal(report_through_session=False)

    def _fit_internal(self, report_through_session: bool) -> Result:
        trainer = self

        def train_loop(config):
            import numpy as np
            from sklearn.base import clone

            import ray_tpu_torch
            from ray_tpu_torch.air import session

            train_ds = session.get_dataset_shard("train")
            X, y = _dataset_to_xy(
                train_ds if train_ds is not None
                else trainer.datasets["train"], trainer.label_column)
            est = clone(trainer.estimator)
            if config:
                est.set_params(**{k: v for k, v in config.items()
                                  if k in est.get_params()})
            metrics: Dict[str, Any] = {}

            if trainer.cv and trainer.cv > 1:
                # k-fold CV: each fold is a cluster task (reference:
                # sklearn_trainer's parallelize_cv via joblib-on-ray)
                from sklearn.model_selection import KFold
                folds = list(KFold(n_splits=trainer.cv, shuffle=True,
                                   random_state=0).split(X))
                est_blob = pickle.dumps(est)

                @ray_tpu_torch.remote
                def _score_fold(blob, X, y, tr_idx, te_idx):
                    m = pickle.loads(blob)
                    m.fit(X[tr_idx], y[tr_idx])
                    return float(m.score(X[te_idx], y[te_idx]))

                if trainer.parallelize_cv:
                    refs = [_score_fold.remote(est_blob, X, y, tr, te)
                            for tr, te in folds]
                    scores = ray_tpu_torch.get(refs)
                else:
                    scores = [ray_tpu_torch.get(
                        _score_fold.remote(est_blob, X, y, tr, te))
                        for tr, te in folds]
                metrics["cv_scores"] = scores
                metrics["cv_score_mean"] = float(np.mean(scores))
                metrics["cv_score_std"] = float(np.std(scores))

            t0 = time.perf_counter()
            est.fit(X, y)
            metrics["fit_time"] = time.perf_counter() - t0
            metrics["train-score"] = float(est.score(X, y))
            for name, ds in trainer.datasets.items():
                if name == "train":
                    continue
                Xe, ye = _dataset_to_xy(ds, trainer.label_column)
                metrics[f"{name}-score"] = float(est.score(Xe, ye))
            ckpt = Checkpoint.from_dict(
                {MODEL_KEY: pickle.dumps(est),
                 "label_column": trainer.label_column})
            session.report(metrics, checkpoint=ckpt)

        inner = DataParallelTrainer(
            train_loop, train_loop_config=dict(self.params),
            scaling_config=self.scaling_config, run_config=self.run_config,
            datasets=self.datasets,
            resume_from_checkpoint=self.resume_from_checkpoint)
        return inner._fit_internal(report_through_session)

    @staticmethod
    def get_model(checkpoint: Checkpoint):
        return pickle.loads(checkpoint.to_dict()[MODEL_KEY])
