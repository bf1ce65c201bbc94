"""ray_tpu_torch.tune — the class half of Tune's Trainable API (the
port's copy of ``ray_tpu/tune/trainable.py:23-80``). The function half
(``FunctionTrainable``), ``Tuner`` and the search and scheduling engine
are not ported yet (ROADMAP.md, A16); a trainer's ``as_trainable()``
already gives the function a ``Tuner`` would run."""

from ray_tpu_torch.tune.trainable import Trainable  # noqa: F401
