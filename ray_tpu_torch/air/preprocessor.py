"""Preprocessors — fit/transform over Datasets.

Reference analogue: ray.air preprocessor base + ray.data.preprocessors
(StandardScaler, MinMaxScaler, LabelEncoder, Chain, BatchMapper).
Fitting aggregates statistics across dataset blocks; transform maps
batches, so it parallelizes over the block tasks.

The port's copy of ``ray_tpu/air/preprocessor.py`` (numpy only, no
change but the package name).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np


class Preprocessor:
    _fitted = False

    def fit(self, dataset) -> "Preprocessor":
        self._fit(dataset)
        self._fitted = True
        return self

    def transform(self, dataset):
        if not self._fitted and self._needs_fit():
            raise RuntimeError(f"{type(self).__name__} not fitted")
        return dataset.map_batches(self._transform_batch)

    def fit_transform(self, dataset):
        return self.fit(dataset).transform(dataset)

    def transform_batch(self, batch: Dict[str, np.ndarray]
                        ) -> Dict[str, np.ndarray]:
        if not self._fitted and self._needs_fit():
            raise RuntimeError(f"{type(self).__name__} not fitted")
        return self._transform_batch(batch)

    def _needs_fit(self) -> bool:
        return True

    def _fit(self, dataset):
        raise NotImplementedError

    def _transform_batch(self, batch):
        raise NotImplementedError


def _iter_column(dataset, col: str):
    for batch in dataset.iter_batches():
        if col in batch:
            yield np.asarray(batch[col], np.float64)


def _fit_categories(dataset, columns: List[str]) -> Dict[str, List[Any]]:
    """One pass collecting the distinct values of several columns —
    shared by the categorical encoders.  Mixed-type columns sort by
    (typename, repr) so fitting never raises on e.g. {'x', 1.0}."""
    seen: Dict[str, set] = {c: set() for c in columns}
    for batch in dataset.iter_batches():
        for col in columns:
            if col in batch:
                seen[col].update(np.asarray(batch[col]).tolist())
    return {c: sorted(v, key=lambda x: (type(x).__name__, repr(x)))
            for c, v in seen.items()}


class StandardScaler(Preprocessor):
    """z-score scaling per column."""

    def __init__(self, columns: List[str]):
        self.columns = columns
        self.stats_: Dict[str, Any] = {}

    def _fit(self, dataset):
        for col in self.columns:
            n, s, s2 = 0, 0.0, 0.0
            for arr in _iter_column(dataset, col):
                n += arr.size
                s += float(arr.sum())
                s2 += float((arr ** 2).sum())
            mean = s / max(n, 1)
            var = max(s2 / max(n, 1) - mean ** 2, 0.0)
            self.stats_[col] = (mean, float(np.sqrt(var)) or 1.0)

    def _transform_batch(self, batch):
        out = dict(batch)
        for col, (mean, std) in self.stats_.items():
            if col in out:
                out[col] = ((np.asarray(out[col], np.float64) - mean)
                            / (std if std > 0 else 1.0)).astype(
                    np.float32)
        return out


class MinMaxScaler(Preprocessor):
    def __init__(self, columns: List[str]):
        self.columns = columns
        self.stats_: Dict[str, Any] = {}

    def _fit(self, dataset):
        for col in self.columns:
            lo, hi = np.inf, -np.inf
            for arr in _iter_column(dataset, col):
                lo = min(lo, float(arr.min()))
                hi = max(hi, float(arr.max()))
            self.stats_[col] = (lo, hi)

    def _transform_batch(self, batch):
        out = dict(batch)
        for col, (lo, hi) in self.stats_.items():
            if col in out:
                rng = (hi - lo) or 1.0
                out[col] = ((np.asarray(out[col], np.float64) - lo)
                            / rng).astype(np.float32)
        return out


class LabelEncoder(Preprocessor):
    def __init__(self, label_column: str):
        self.label_column = label_column
        self.classes_: List[Any] = []

    def _fit(self, dataset):
        self.classes_ = _fit_categories(
            dataset, [self.label_column])[self.label_column]

    def _transform_batch(self, batch):
        out = dict(batch)
        if self.label_column in out:
            idx = {c: i for i, c in enumerate(self.classes_)}
            out[self.label_column] = np.asarray(
                [idx[v] for v in np.asarray(
                    out[self.label_column]).tolist()], np.int64)
        return out


class OrdinalEncoder(Preprocessor):
    """Category -> index for several columns (reference:
    data.preprocessors.OrdinalEncoder)."""

    def __init__(self, columns: List[str]):
        self.columns = columns
        self.classes_: Dict[str, List[Any]] = {}

    def _fit(self, dataset):
        self.classes_ = _fit_categories(dataset, self.columns)

    def _transform_batch(self, batch):
        out = dict(batch)
        for col, classes in self.classes_.items():
            if col in out:
                idx = {c: i for i, c in enumerate(classes)}
                out[col] = np.asarray(
                    [idx[v] for v in np.asarray(out[col]).tolist()],
                    np.int64)
        return out


class OneHotEncoder(Preprocessor):
    """Category -> one-hot vector column ``<col>_onehot`` (reference:
    data.preprocessors.OneHotEncoder)."""

    def __init__(self, columns: List[str]):
        self.columns = columns
        self.classes_: Dict[str, List[Any]] = {}

    def _fit(self, dataset):
        self.classes_ = _fit_categories(dataset, self.columns)

    def _transform_batch(self, batch):
        out = dict(batch)
        for col, classes in self.classes_.items():
            if col in out:
                idx = {c: i for i, c in enumerate(classes)}
                vals = np.asarray(out.pop(col)).tolist()
                oh = np.zeros((len(vals), len(classes)), np.float32)
                for r, v in enumerate(vals):
                    if v in idx:
                        oh[r, idx[v]] = 1.0
                out[f"{col}_onehot"] = oh
        return out


class SimpleImputer(Preprocessor):
    """Fill NaNs with a per-column statistic (reference:
    data.preprocessors.SimpleImputer; strategies mean | most_frequent |
    constant)."""

    def __init__(self, columns: List[str], strategy: str = "mean",
                 fill_value: Optional[float] = None):
        if strategy not in ("mean", "most_frequent", "constant"):
            raise ValueError(f"unknown imputer strategy {strategy!r}")
        if strategy == "constant" and fill_value is None:
            raise ValueError("strategy='constant' requires fill_value")
        self.columns = columns
        self.strategy = strategy
        self.fill_value = fill_value
        self.stats_: Dict[str, Any] = {}

    def _needs_fit(self) -> bool:
        return self.strategy != "constant"

    def _fit(self, dataset):
        if self.strategy == "constant":
            return
        for col in self.columns:
            if self.strategy == "mean":
                n, s = 0, 0.0
                for arr in _iter_column(dataset, col):
                    good = arr[~np.isnan(arr)]
                    n += good.size
                    s += float(good.sum())
                self.stats_[col] = s / max(n, 1)
            else:  # most_frequent
                from collections import Counter
                counts: Counter = Counter()
                for batch in dataset.iter_batches():
                    if col in batch:
                        vals = np.asarray(batch[col])
                        if vals.dtype.kind == "f":
                            vals = vals[~np.isnan(vals)]
                        counts.update(
                            v for v in vals.tolist()
                            if v is not None and not (
                                isinstance(v, float) and np.isnan(v)))
                self.stats_[col] = counts.most_common(1)[0][0] \
                    if counts else 0.0

    def _transform_batch(self, batch):
        out = dict(batch)
        for col in self.columns:
            if col not in out:
                continue
            fill = self.fill_value if self.strategy == "constant" \
                else self.stats_.get(col, 0.0)
            arr = np.asarray(out[col])
            if arr.dtype.kind == "f":
                arr = np.where(np.isnan(arr), float(fill), arr)
                out[col] = arr.astype(np.float32)
            else:
                # categorical (string/object) columns: impute the
                # missing sentinels, keep the dtype
                vals = arr.tolist()
                out[col] = np.asarray(
                    [fill if v is None
                     or (isinstance(v, float) and np.isnan(v)) else v
                     for v in vals])
        return out


class RobustScaler(Preprocessor):
    """(x - median) / IQR scaling — outlier-insensitive (reference:
    data.preprocessors.RobustScaler).  Quantiles are computed on the
    concatenated column (datasets here are block-iterable in one
    process; the reference approximates the same way via aggregate)."""

    def __init__(self, columns: List[str],
                 quantile_range=(0.25, 0.75)):
        self.columns = columns
        self.quantile_range = quantile_range
        self.stats_: Dict[str, Any] = {}

    def _fit(self, dataset):
        lo_q, hi_q = self.quantile_range
        for col in self.columns:
            chunks = list(_iter_column(dataset, col))
            if not chunks:
                continue
            arr = np.concatenate([c.ravel() for c in chunks])
            med = float(np.median(arr))
            iqr = float(np.quantile(arr, hi_q) - np.quantile(arr, lo_q))
            self.stats_[col] = (med, iqr or 1.0)

    def _transform_batch(self, batch):
        out = dict(batch)
        for col, (med, iqr) in self.stats_.items():
            if col in out:
                out[col] = ((np.asarray(out[col], np.float64) - med)
                            / iqr).astype(np.float32)
        return out


class MaxAbsScaler(Preprocessor):
    """x / max|x| per column (reference: data.preprocessors.MaxAbsScaler)."""

    def __init__(self, columns: List[str]):
        self.columns = columns
        self.stats_: Dict[str, float] = {}

    def _fit(self, dataset):
        for col in self.columns:
            m = 0.0
            for arr in _iter_column(dataset, col):
                m = max(m, float(np.abs(arr).max()))
            self.stats_[col] = m or 1.0

    def _transform_batch(self, batch):
        out = dict(batch)
        for col, m in self.stats_.items():
            if col in out:
                out[col] = (np.asarray(out[col], np.float64) / m).astype(
                    np.float32)
        return out


class Normalizer(Preprocessor):
    """Row-wise unit-norm scaling across a set of columns — stateless
    (reference: data.preprocessors.Normalizer)."""

    def __init__(self, columns: List[str], norm: str = "l2"):
        if norm not in ("l1", "l2", "max"):
            raise ValueError(f"unknown norm {norm!r}")
        self.columns = columns
        self.norm = norm

    def _needs_fit(self) -> bool:
        return False

    def _fit(self, dataset):
        pass

    def _transform_batch(self, batch):
        out = dict(batch)
        cols = [np.asarray(out[c], np.float64) for c in self.columns
                if c in out]
        if not cols:
            return out
        mat = np.stack(cols, axis=-1)
        if self.norm == "l2":
            d = np.sqrt((mat ** 2).sum(-1))
        elif self.norm == "l1":
            d = np.abs(mat).sum(-1)
        else:
            d = np.abs(mat).max(-1)
        d = np.where(d == 0, 1.0, d)
        for i, c in enumerate([c for c in self.columns if c in out]):
            out[c] = (mat[..., i] / d).astype(np.float32)
        return out


class Concatenator(Preprocessor):
    """Pack feature columns into one 2-D matrix column — the shape
    models consume (reference: data.preprocessors.Concatenator)."""

    def __init__(self, columns: List[str], output_column: str = "x",
                 dtype=np.float32):
        self.columns = columns
        self.output_column = output_column
        self.dtype = dtype

    def _needs_fit(self) -> bool:
        return False

    def _fit(self, dataset):
        pass

    def _transform_batch(self, batch):
        out = dict(batch)
        parts = []
        for c in self.columns:
            if c in out:
                a = np.asarray(out.pop(c))
                parts.append(a if a.ndim > 1 else a[:, None])
        if parts:
            out[self.output_column] = np.concatenate(
                parts, axis=1).astype(self.dtype)
        return out


class BatchMapper(Preprocessor):
    """Stateless user-function preprocessor."""

    def __init__(self, fn: Callable[[Dict[str, np.ndarray]],
                                    Dict[str, np.ndarray]]):
        self.fn = fn

    def _needs_fit(self) -> bool:
        return False

    def _fit(self, dataset):
        pass

    def _transform_batch(self, batch):
        return self.fn(batch)


class Chain(Preprocessor):
    def __init__(self, *preprocessors: Preprocessor):
        self.preprocessors = list(preprocessors)

    def _fit(self, dataset):
        for p in self.preprocessors:
            dataset = p.fit_transform(dataset)

    def _transform_batch(self, batch):
        for p in self.preprocessors:
            batch = p.transform_batch(batch)
        return batch

    def transform(self, dataset):
        for p in self.preprocessors:
            dataset = p.transform(dataset)
        return dataset
