"""Search-space primitives (reference: python/ray/tune/search/sample.py).

Usage parity with the reference:
    param_space = {"lr": tune.loguniform(1e-5, 1e-2),
                   "layers": tune.grid_search([2, 4, 8]),
                   "seed": tune.randint(0, 10_000)}

The port's copy of ``ray_tpu/tune/sample.py``
(imports renamed to ``ray_tpu_torch``).
"""

from __future__ import annotations

import random
from typing import Any, Callable, Dict, List, Sequence


class Domain:
    def sample(self, rng: random.Random) -> Any:
        raise NotImplementedError


class Categorical(Domain):
    def __init__(self, categories: Sequence[Any]):
        self.categories = list(categories)

    def sample(self, rng):
        return rng.choice(self.categories)


class Uniform(Domain):
    def __init__(self, lower: float, upper: float):
        self.lower, self.upper = float(lower), float(upper)

    def sample(self, rng):
        return rng.uniform(self.lower, self.upper)


class LogUniform(Domain):
    def __init__(self, lower: float, upper: float, base: float = 10.0):
        import math
        assert lower > 0 and upper > lower
        self.lower, self.upper, self.base = lower, upper, base
        self._log = (math.log(lower, base), math.log(upper, base))

    def sample(self, rng):
        return self.base ** rng.uniform(*self._log)


class Randint(Domain):
    """[lower, upper) like the reference's tune.randint."""

    def __init__(self, lower: int, upper: int):
        self.lower, self.upper = int(lower), int(upper)

    def sample(self, rng):
        return rng.randrange(self.lower, self.upper)


class QUniform(Domain):
    def __init__(self, lower: float, upper: float, q: float):
        self.lower, self.upper, self.q = lower, upper, q

    def sample(self, rng):
        v = rng.uniform(self.lower, self.upper)
        return round(v / self.q) * self.q


class Normal(Domain):
    def __init__(self, mean: float, sd: float):
        self.mean, self.sd = mean, sd

    def sample(self, rng):
        return rng.gauss(self.mean, self.sd)


class Function(Domain):
    def __init__(self, fn: Callable[[], Any]):
        self.fn = fn

    def sample(self, rng):
        return self.fn()


class GridSearch:
    """Marker expanded exhaustively by BasicVariantGenerator (cross product
    with other grid axes; reference: search/basic_variant.py)."""

    def __init__(self, values: Sequence[Any]):
        self.values = list(values)


def grid_search(values: Sequence[Any]) -> GridSearch:
    return GridSearch(values)


def choice(categories: Sequence[Any]) -> Categorical:
    return Categorical(categories)


def uniform(lower: float, upper: float) -> Uniform:
    return Uniform(lower, upper)


def loguniform(lower: float, upper: float, base: float = 10.0) -> LogUniform:
    return LogUniform(lower, upper, base)


def randint(lower: int, upper: int) -> Randint:
    return Randint(lower, upper)


def quniform(lower: float, upper: float, q: float) -> QUniform:
    return QUniform(lower, upper, q)


def randn(mean: float = 0.0, sd: float = 1.0) -> Normal:
    return Normal(mean, sd)


def sample_from(fn: Callable[[], Any]) -> Function:
    return Function(fn)


def resolve(space: Dict[str, Any], rng: random.Random) -> Dict[str, Any]:
    """Sample every Domain leaf; GridSearch must already be expanded."""
    out = {}
    for k, v in space.items():
        if isinstance(v, Domain):
            out[k] = v.sample(rng)
        elif isinstance(v, GridSearch):
            raise ValueError(
                f"unexpanded grid_search for {k!r} (searchers other than "
                "BasicVariantGenerator don't support grid_search)")
        elif isinstance(v, dict):
            out[k] = resolve(v, rng)
        else:
            out[k] = v
    return out


def expand_grid(space: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Cross-product of all GridSearch axes (nested dicts included);
    Domain leaves are left in place for later sampling."""
    import itertools

    paths: List[tuple] = []
    values: List[List[Any]] = []

    def walk(d: Dict[str, Any], prefix: tuple):
        for k, v in d.items():
            if isinstance(v, GridSearch):
                paths.append(prefix + (k,))
                values.append(v.values)
            elif isinstance(v, dict):
                walk(v, prefix + (k,))

    walk(space, ())
    if not paths:
        return [dict(space)]

    def set_path(d, path, value):
        for p in path[:-1]:
            d = d[p]
        d[path[-1]] = value

    import copy
    out = []
    for combo in itertools.product(*values):
        variant = copy.deepcopy(space)
        for path, value in zip(paths, combo):
            set_path(variant, path, value)
        out.append(variant)
    return out
