"""Default searchers: grid cross-product + random sampling.

Reference: tune/search/basic_variant.py (BasicVariantGenerator is the
default when no search_alg is given).

The port's copy of ``ray_tpu/tune/search/basic_variant.py``
(imports renamed to ``ray_tpu_torch``).
"""

from __future__ import annotations

import random
from typing import Any, Dict, List, Optional

from ray_tpu_torch.tune.sample import expand_grid, resolve
from ray_tpu_torch.tune.search.searcher import Searcher


class BasicVariantGenerator(Searcher):
    """Grid cross-product × num_samples random repeats (the default
    searcher; reference search/basic_variant.py)."""

    def __init__(self, space: Dict[str, Any], num_samples: int = 1,
                 seed: Optional[int] = None, **kw):
        super().__init__(**kw)
        self._rng = random.Random(seed)
        self._variants: List[Dict[str, Any]] = []
        for _ in range(num_samples):
            self._variants.extend(expand_grid(space))
        self._next = 0

    @property
    def total_trials(self) -> int:
        return len(self._variants)

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        if self._next >= len(self._variants):
            return None
        variant = self._variants[self._next]
        self._next += 1
        return resolve(variant, self._rng)


class RandomSearch(Searcher):
    """Pure random sampling of a Domain-only space (no grid axes)."""

    def __init__(self, space: Dict[str, Any], num_samples: int,
                 seed: Optional[int] = None, **kw):
        super().__init__(**kw)
        self._space = space
        self._remaining = num_samples
        self._rng = random.Random(seed)

    def suggest(self, trial_id):
        if self._remaining <= 0:
            return None
        self._remaining -= 1
        return resolve(self._space, self._rng)
