"""The port's headline bench through the framework, on the CPU:
``bench.framework_main(device="cpu")`` starts a cluster, feeds 64 uint8
images at 32 x 32 (``bench.framework_items``, the JAX bench's recipe)
through ``data.from_items`` and a ``DataParallelTrainer`` of one worker,
whose train_func runs ``resnet_loop`` on the shard's batches from
``iter_device_batches`` and then ``gpt2_loop``. The worker's first
batch must hold the driver's rows, bytes for bytes, and both rows must
report finite losses.
"""

import hashlib
import math
import os
from unittest import mock

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch import bench

PORT_ENV = {"RTT_VALIDATE_WIRE": "1", "RTT_PRESTART_WORKERS": "0"}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def test_framework_main_on_cpu():
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    with mock.patch.dict(os.environ, PORT_ENV):
        out = bench.framework_main(device="cpu")
    assert not ray_tpu_torch.is_initialized()
    items = bench.framework_items(64, 32)
    assert (out["framework_n_images"], out["framework_image_size"]) == (64,
                                                                        32)
    # resnet_loop's CPU batch is 8: the first batch is the first 8 rows
    want = np.stack([it["image"] for it in items[:8]])
    assert out["first_batch_image_sha256"] == hashlib.sha256(
        want.tobytes()).hexdigest()
    assert out["first_batch_labels"] == [int(it["label"])
                                         for it in items[:8]]
    # uint8 images stay bytes; labels become int64, as put_batch makes them
    assert out["first_batch_dtypes"] == {"image": "torch.uint8",
                                         "label": "torch.int64"}
    assert out["first_batch_device"] == "cpu"
    assert out["feed_batches"] == 8
    assert out["platform"] == "cpu" and out["gpu_ids"] == []
    assert "gpt2_error" not in out
    for key in ("losses", "gpt2_losses", "gpt2_grad_norms"):
        assert out[key] and all(math.isfinite(x) for x in out[key]), key
    assert out["img_per_sec_per_chip"] > 0
    assert out["gpt2_tokens_per_sec_per_chip"] > 0
    assert out["launches"] == {} and out["gpt2_launches"] == {}
    for key in ("init_s", "ingest_s", "fit_s", "worker_start_s",
                "fit_to_first_batch_s", "fit_to_first_step_s"):
        assert 0 < out[key] < out["fit_s"] + out["init_s"] + 1, key
    assert (out["worker_start_s"] < out["fit_to_first_batch_s"]
            < out["fit_to_first_step_s"])
