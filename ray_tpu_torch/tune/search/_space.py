"""Flattened view of a nested search space, shared by the model-based
searchers (TPE, BayesOpt, PB2).

Each leaf Domain becomes a Dimension with a numeric warped range [0, 1]
(log-warped for LogUniform) or a category list; model-based searchers
operate on the warped unit cube and unwarp before handing configs back.

The port's copy of ``ray_tpu/tune/search/_space.py``
(imports renamed to ``ray_tpu_torch``).
"""

from __future__ import annotations

import math
import random
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.tune.sample import (Categorical, Domain, Function, GridSearch,
                                 LogUniform, Normal, QUniform, Randint,
                                 Uniform)

Path = Tuple[str, ...]


class Dimension:
    """One search dimension: warp/unwarp between native values and [0,1]."""

    def __init__(self, path: Path, domain: Domain):
        self.path = path
        self.domain = domain
        d = domain
        if isinstance(d, Categorical):
            self.kind = "cat"
            self.categories = d.categories
        elif isinstance(d, LogUniform):
            self.kind = "num"
            self.lo, self.hi = d._log  # already in log_base space
            self.base = d.base
            self.quant = None
            self.integer = False
            self.log = True
        elif isinstance(d, Uniform):
            self.kind = "num"
            self.lo, self.hi = d.lower, d.upper
            self.quant, self.integer, self.log = None, False, False
        elif isinstance(d, QUniform):
            self.kind = "num"
            self.lo, self.hi = d.lower, d.upper
            self.quant, self.integer, self.log = d.q, False, False
        elif isinstance(d, Randint):
            self.kind = "num"
            self.lo, self.hi = float(d.lower), float(d.upper - 1)
            self.quant, self.integer, self.log = 1.0, True, False
        elif isinstance(d, Normal):
            # treat as numeric over ±4σ for modeling purposes
            self.kind = "num"
            self.lo = d.mean - 4 * d.sd
            self.hi = d.mean + 4 * d.sd
            self.quant, self.integer, self.log = None, False, False
        elif isinstance(d, Function):
            self.kind = "func"
        else:
            raise TypeError(f"unsupported domain {type(d).__name__}")

    # -- numeric warping ---------------------------------------------------

    def to_unit(self, value: Any) -> float:
        """Native value → [0,1] (numeric dims only)."""
        v = float(value)
        if self.log:
            v = math.log(v, self.base)
        if self.hi == self.lo:
            return 0.0
        return min(1.0, max(0.0, (v - self.lo) / (self.hi - self.lo)))

    def from_unit(self, u: float) -> Any:
        u = min(1.0, max(0.0, u))
        v = self.lo + u * (self.hi - self.lo)
        if self.log:
            v = self.base ** v
        if self.quant is not None:
            v = round(v / self.quant) * self.quant
        if self.integer:
            v = int(round(v))
        return v

    def sample_native(self, rng: random.Random) -> Any:
        return self.domain.sample(rng)


def flatten_space(space: Dict[str, Any]) -> Tuple[List[Dimension],
                                                  Dict[Path, Any]]:
    """Split a nested space into model-able Dimensions + constant leaves."""
    dims: List[Dimension] = []
    consts: Dict[Path, Any] = {}

    def walk(d: Dict[str, Any], prefix: Path):
        for k, v in d.items():
            p = prefix + (k,)
            if isinstance(v, GridSearch):
                raise ValueError(
                    "grid_search is only supported by BasicVariantGenerator;"
                    f" found one at {'.'.join(p)}")
            if isinstance(v, Domain):
                dims.append(Dimension(p, v))
            elif isinstance(v, dict):
                walk(v, p)
            else:
                consts[p] = v

    walk(space, ())
    return dims, consts


def unflatten(values: Dict[Path, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for path, v in values.items():
        d = out
        for p in path[:-1]:
            d = d.setdefault(p, {})
        d[path[-1]] = v
    return out


