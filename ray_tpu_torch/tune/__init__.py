"""ray_tpu_torch.tune — hyperparameter search / experiment engine.

Reference: python/ray/tune — Tuner (tuner.py:44), tune.run (tune/tune.py:131),
Trainable (trainable/trainable.py:66), searchers (search/), schedulers
(schedulers/). Train and RLlib ride on this layer, as in the reference.

The port's copy of ``ray_tpu/tune/``, with the JAX package's public names,
on the port's runtime: each trial is an actor, and a ``{"GPU": 1}`` trial
is granted a card by index. ``with_resources`` is the port's addition: it
gives a ``Tuner``'s trials their resources (``tune.py``).
"""

from ray_tpu_torch.tune.sample import (  # noqa: F401
    choice, grid_search, loguniform, quniform, randint, randn, sample_from,
    uniform)
from ray_tpu_torch.tune.trainable import Trainable  # noqa: F401
from ray_tpu_torch.tune.search import (  # noqa: F401
    BasicVariantGenerator, BayesOptSearch, BOHBSearcher,
    ConcurrencyLimiter, HyperOptSearch, OptunaSearch, RandomSearch,
    Searcher, TPESearcher)
from ray_tpu_torch.tune.schedulers import (  # noqa: F401
    ASHAScheduler, AsyncHyperBandScheduler, FIFOScheduler,
    HyperBandForBOHB, HyperBandScheduler, MedianStoppingRule, PB2,
    PopulationBasedTraining, ResourceChangingScheduler, TrialScheduler)
from ray_tpu_torch.tune.logger import (  # noqa: F401
    Callback, CSVLoggerCallback, JsonLoggerCallback, LoggerCallback,
    TBXLoggerCallback)
from ray_tpu_torch.tune.syncer import (  # noqa: F401
    LocalSyncer, SyncConfig, Syncer, SyncerCallback)
from ray_tpu_torch.tune.trial import Trial  # noqa: F401
from ray_tpu_torch.tune.tune import (  # noqa: F401
    ExperimentAnalysis, TrialRunner, run, with_resources)
from ray_tpu_torch.tune.tuner import (  # noqa: F401
    Result, ResultGrid, TuneConfig, Tuner)

# session.report works inside function trainables too (reference: air.session)
from ray_tpu_torch.air.session import report  # noqa: F401
