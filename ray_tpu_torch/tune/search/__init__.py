"""ray_tpu_torch.tune.search — config suggestion strategies.

Reference: python/ray/tune/search/ — basic_variant.py (default),
searcher.py (ABC), concurrency_limiter.py, and the model-based searchers
(hyperopt/optuna/bayesopt wrappers). The model-based searchers here are
native implementations (tpe.py, bayesopt.py) since the external libraries
aren't in this image; gated adapters live in external.py.

The port's copy of ``ray_tpu/tune/search/__init__.py``
(imports renamed to ``ray_tpu_torch``).
"""

from ray_tpu_torch.tune.search.searcher import (  # noqa: F401
    PENDING, ConcurrencyLimiter, Searcher)
from ray_tpu_torch.tune.search.basic_variant import (  # noqa: F401
    BasicVariantGenerator, RandomSearch)
from ray_tpu_torch.tune.search.bohb import BOHBSearcher  # noqa: F401
from ray_tpu_torch.tune.search.tpe import TPESearcher  # noqa: F401
from ray_tpu_torch.tune.search.bayesopt import BayesOptSearch  # noqa: F401
from ray_tpu_torch.tune.search.external import (  # noqa: F401
    AxSearch, DragonflySearch, FLAMLSearch, HEBOSearch, HyperOptSearch,
    NevergradSearch, OptunaSearch, SigOptSearch, SkOptSearch, ZOOptSearch)
