"""ray_tpu_torch.tune — the class half of Tune's Trainable API (the
port's copy of ``ray_tpu/tune/trainable.py:23-80``); the search and
scheduling engine needs the runtime (ROADMAP.md, A1)."""

from ray_tpu_torch.tune.trainable import Trainable  # noqa: F401
