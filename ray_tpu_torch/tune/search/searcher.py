"""Searcher ABC + ConcurrencyLimiter.

Reference: tune/search/searcher.py (ABC), search/concurrency_limiter.py.

The port's copy of ``ray_tpu/tune/search/searcher.py``
(imports renamed to ``ray_tpu_torch``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

# Sentinel: searcher not ready to suggest yet (at capacity) — distinct from
# None, which means the search space is exhausted.
PENDING = object()


class Searcher:
    def __init__(self, metric: Optional[str] = None, mode: str = "max"):
        assert mode in ("min", "max")
        self.metric, self.mode = metric, mode

    def set_search_properties(self, metric, mode, space) -> bool:
        if metric:
            self.metric = metric
        if mode:
            self.mode = mode
        return True

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        """Next config, or None when exhausted."""
        raise NotImplementedError

    def on_trial_result(self, trial_id: str, result: Dict[str, Any]):
        pass

    def on_trial_complete(self, trial_id: str,
                          result: Optional[Dict[str, Any]] = None,
                          error: bool = False):
        pass


class ConcurrencyLimiter(Searcher):
    """Caps in-flight suggestions (reference: search/concurrency_limiter)."""

    def __init__(self, searcher: Searcher, max_concurrent: int):
        super().__init__(metric=searcher.metric, mode=searcher.mode)
        self.searcher = searcher
        self.max_concurrent = max_concurrent
        self._live: set = set()

    def suggest(self, trial_id):
        if len(self._live) >= self.max_concurrent:
            return PENDING  # runner retries later
        config = self.searcher.suggest(trial_id)
        if config is not None:
            self._live.add(trial_id)
        return config

    def on_trial_result(self, trial_id, result):
        self.searcher.on_trial_result(trial_id, result)

    def on_trial_complete(self, trial_id, result=None, error=False):
        self._live.discard(trial_id)
        self.searcher.on_trial_complete(trial_id, result, error)
