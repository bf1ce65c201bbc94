"""Offline RL IO: JSON writers/readers of SampleBatches.

Reference analogue: rllib/offline/ (json_writer.py, json_reader.py,
dataset readers). The port's copy of ``ray_tpu/rllib/offline.py``
(numpy only), kept whole: batches serialize as JSON-lines with base64
numpy columns, partitioned into rolling files, byte for byte as the JAX
package writes them, so a file written by either package is read by the
other; ``OfflineAlgorithmMixin`` rescales the actions and draws the
minibatches with the same numpy calls in the same order. The port adds
``draw_minibatch``, the draw that MARWIL shares with the mixin, and
``learn_offline``: the offline algorithms' learn loop with host timers.
"""

from __future__ import annotations

import base64
import glob
import json
import os
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

from ray_tpu_torch.rllib.sample_batch import SampleBatch


def _encode_col(v: np.ndarray) -> dict:
    v = np.asarray(v)
    return {"dtype": str(v.dtype), "shape": list(v.shape),
            "data": base64.b64encode(v.tobytes()).decode()}


def _decode_col(doc: dict) -> np.ndarray:
    return np.frombuffer(
        base64.b64decode(doc["data"]),
        dtype=np.dtype(doc["dtype"])).reshape(doc["shape"]).copy()


class JsonWriter:
    def __init__(self, path: str, max_file_size: int = 64 * 1024 * 1024):
        self.path = path
        os.makedirs(path, exist_ok=True)
        self.max_file_size = max_file_size
        self._file = None
        self._file_index = 0

    def _rotate(self):
        if self._file is not None:
            self._file.close()
        self._file_index += 1
        self._file = open(os.path.join(
            self.path, f"output-{self._file_index:05d}.json"), "w")

    def write(self, batch: SampleBatch):
        if self._file is None or \
                self._file.tell() > self.max_file_size:
            self._rotate()
        doc = {k: _encode_col(v) for k, v in batch.items()
               if isinstance(v, np.ndarray) and v.dtype != object}
        self._file.write(json.dumps(doc) + "\n")
        self._file.flush()

    def close(self):
        if self._file is not None:
            self._file.close()
            self._file = None


class OfflineDataConfigMixin:
    """Fluent ``offline_data(input_path=...)`` config section shared by
    the offline algorithm configs (reference: AlgorithmConfig
    .offline_data())."""

    def offline_data(self, *, input_path=None, **kw):
        if input_path is not None:
            self._config["input_path"] = input_path
        self._config.update(kw)
        return self


class OfflineAlgorithmMixin:
    """Shared offline-dataset plumbing for CQL/CRR (reference:
    offline/json_reader.py usage inside those algorithms): load the
    JsonReader dataset once, rescale env-space actions into the
    policy's (-1, 1) raw space, and draw uniform minibatches."""

    def _load_offline_dataset(self):
        path = self.config.get("input_path")
        if not path:
            raise ValueError(
                f"{type(self).__name__} needs config['input_path']")
        self._data = JsonReader(path).read_all()
        policy = self.workers.local_worker.policy
        if "raw_actions" not in self._data:
            a = np.asarray(self._data[SampleBatch.ACTIONS], np.float32)
            a = a.reshape(a.shape[0], -1)
            span = np.maximum(policy.high - policy.low, 1e-8)
            raw = 2.0 * (a - policy.low) / span - 1.0
            self._data["raw_actions"] = np.clip(raw, -0.999, 0.999)
        self._rng = np.random.default_rng(self.config.get("seed"))

    def _offline_minibatch(self, batch_size: int) -> SampleBatch:
        return draw_minibatch(self._data, self._rng, batch_size)


def draw_minibatch(data: SampleBatch, rng: np.random.Generator,
                   batch_size: int) -> SampleBatch:
    """``batch_size`` rows of ``data`` drawn uniformly with replacement
    by ``rng.integers`` (the offline algorithms' minibatches)."""
    idx = rng.integers(data.count, size=batch_size)
    return SampleBatch({k: np.asarray(v)[idx] for k, v in data.items()})


class JsonReader:
    def __init__(self, path: str):
        self.files = sorted(glob.glob(os.path.join(path, "*.json"))) \
            if os.path.isdir(path) else [path]
        if not self.files:
            raise ValueError(f"no offline data under {path!r}")

    def read_all(self) -> SampleBatch:
        return SampleBatch.concat_samples(list(self))

    def __iter__(self) -> Iterator[SampleBatch]:
        for f in self.files:
            with open(f) as fh:
                for line in fh:
                    line = line.strip()
                    if not line:
                        continue
                    doc = json.loads(line)
                    yield SampleBatch(
                        {k: _decode_col(v) for k, v in doc.items()})


def learn_offline(algo, draw: Callable[[int], SampleBatch]
                  ) -> Tuple[Dict[str, Any], Dict[str, float]]:
    """``num_iters_per_step`` learn steps of ``algo``'s policy, each on
    ``draw(train_batch_size)``: (the last step's stats, ``timers``: the
    host milliseconds spent drawing minibatches and learning)."""
    policy = algo.workers.local_worker.policy
    bs = algo.config["train_batch_size"]
    stats: Dict[str, Any] = {}
    draw_s = learn_s = 0.0
    for _ in range(algo.config.get("num_iters_per_step", 10)):
        t0 = time.perf_counter()
        minibatch = draw(bs)
        t1 = time.perf_counter()
        stats = policy.learn_on_batch(minibatch)
        draw_s += t1 - t0
        learn_s += time.perf_counter() - t1
        algo._timesteps_total += bs
    algo.workers.sync_weights()
    return stats, {"replay_time_ms": draw_s * 1e3,
                   "learn_time_ms": learn_s * 1e3}
