"""Training throughput of the port on one card: the raw-control half of
the JAX package's headline bench (``bench.py:bench_loop``, ``gpt2_loop``).

    python -m ray_tpu_torch.bench      # on cuda; prints one JSON line
    torchrun --nproc_per_node=N -m ray_tpu_torch.bench   # N cards, dp=N

``resnet_loop``: ResNet-50 at its published widths (1,000 classes, bf16
compute, f32 params), batch 256 at 224 x 224, SGD-Nesterov through
``make_image_classifier_trainer``; ``gpt2_loop``: GPT-2 small at batch
16 x 1024 through ``make_causal_lm_trainer``; ``ppo_loop``: PPO on the
pixel env at the Atari widths (84 x 84 x 4, Nature CNN, batch 5,000,
minibatch 500 x 10) through ``rllib.PPO`` with one local worker of 50
envs, env steps per second (the host's env, connectors and GAE
included), and ``ppo_remote_loop`` the same at atari-ppo.yaml's 10
remote rollout workers x 5 envs on the port's runtime;
``impala_loop``: IMPALA (or APPO) on the same env and network,
fragments of 50 and a train batch of 500 (upstream Ray's
``rllib/tuned_examples/impala/atari-impala.yaml``) with one local
worker of 10 envs, so each learn step takes 500 rows, and
``impala_remote_loop`` the yaml's remote workers of 5 envs (cut to the
machine's CPUs) feeding the async learner thread; ``dqn_loop``: DQN on
the same env and network (the logits head as Q-values), the JAX
package's ``DQNConfig`` defaults (fragments of 4, train batch 32,
double-Q, a uniform replay
buffer of 50,000 rows on the host, 1,000 rows before learning, a target
sync every 500 env steps, epsilon over 10,000 steps) with 8 envs; cut
against upstream's ``rllib/tuned_examples/dqn/atari-dqn.yaml``: its
1,000,000-row buffer, its 20,000 steps before learning, its target sync
every 8,000 steps and its epsilon over 200,000 steps, so that a short
run learns, syncs the target and lowers epsilon; ``sac_loop`` /
``ddpg_loop``: SAC and TD3 on Pendulum-v1 at 256 x 256, batch 256
(``pendulum_sac_config``); ``offline_loop``: CQL, CRR, MARWIL or BC on a
100,000-row Pendulum set written by ``JsonWriter`` and read back
(``write_pendulum_dataset``, ``offline_config``); ``r2d2_loop``,
``slateq_loop``, ``dt_loop`` and ``bandit_loop``: R2D2 on CartPole-v1,
SlateQ on its interest-evolution simulator, DT on an offline CartPole
set written by ``JsonWriter`` (``write_cartpole_dataset``) and LinUCB /
LinTS on the host, each at its JAX config's defaults; ``qmix_loop``,
``maddpg_loop``, ``maml_loop`` and ``mbmpo_loop``: QMIX on CoopCartPole
and MADDPG on MultiAgentTarget1D (2 agents each), MAML and MBMPO on the
point-goal tasks, each at its JAX config's defaults; ``dreamer_loop``,
``alphazero_loop``, ``alphastar_loop`` and ``ma_ppo_loop``: Dreamer on
Pendulum-v1, AlphaZero and AlphaStar's league on TicTacToe, each at its
JAX config's defaults, and PPO with two policies on MultiAgentCartPole
(``ma_ppo_config``). The first two time steps on one resident batch (no
input cost: the compute ceiling), as windows of steps closed by a host
read of the loss, and report the best window.

``serve_loop`` serves GPT-2 small from a ``num_gpus=1`` replica of the
port's serve control plane: each prompt alone through the handle, then
16 concurrent SSE streams through the HTTP proxy (client-side tokens/s,
TTFT and ITL), the replica's launch counts read back from it.

``framework_main`` is the headline's framework path (the JAX bench's
``_framework_main``): ``init`` a cluster, 1,024 uint8 224 x 224 images
from ``default_rng(0)`` as a ``data.from_items`` Dataset, and a
``DataParallelTrainer`` of one GPU worker, whose train_func
(``_train_loop_per_worker``) runs ``resnet_loop`` on the shard's device
batches (``iter_device_batches``, cached and cycled) and then
``gpt2_loop``, and reports both. ``main`` runs the raw control
(``resnet_loop`` in this process), the framework path, then the PPO
and IMPALA loops (local and remote) and ``dqn_loop``, and prints one
JSON line
whose ``value`` is the framework's img/s/chip, beside
``raw_img_per_sec_per_chip`` and ``framework_vs_raw``.

The number of chips is the process group's world size where one exists
(the JAX bench's ``jax.device_count()``), else 1: the trainers run on
``MeshSpec(dp=n)`` with the per-chip batch fixed, so the global batch
grows with n. Under torchrun ``main`` forms the group (NCCL, one card
per rank), skips the framework path (a gang of one worker a process
would not be the torchrun ranks' mesh), and rank 0 prints the line with
the raw control's img/s as ``value``.

FLOPs per step come from ``torch.utils.flop_counter.FlopCounterMode``
over one step (convolutions and matrix products, forward and backward;
not the hand-written attention kernels, as XLA's ``cost_analysis``
counts no Pallas call); ``mfu`` divides them by the step time and the
card's dense bf16 peak, for the cards in ``_PEAK_BF16`` only.
"""

from __future__ import annotations

import contextlib
import copy
import itertools
import json
import os
import time
import urllib.request

import numpy as np
import torch

from ray_tpu_torch import kernels
from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.parallel import collectives

METRIC = "resnet50_images_per_sec_per_chip"
UNIT = "images/s/chip"
FLOPS_SOURCE = ("torch.utils.flop_counter.FlopCounterMode over one step "
                "(convolutions and matrix products, forward and backward)")

# dense bf16 peak by device name (lower case): NVIDIA's H100 SXM data sheet
_PEAK_BF16 = [("h100 80gb hbm3", 989e12)]


def _peak_flops(device_kind: str):
    kind = device_kind.lower()
    for key, peak in _PEAK_BF16:
        if key in kind:
            return peak
    return None


def _device_kind(dev: torch.device) -> str:
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return "cpu"


def _n_chips() -> int:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def _timed_run(step, warmup: int, windows: int, per_window: int,
               profile=None) -> dict:
    """``step()`` -> metrics dict of scalar tensors. Runs: one step
    timed alone (eager PyTorch compiles nothing; the allocator's growth
    and the libraries' first calls fall there), one under FlopCounterMode,
    ``warmup`` steps, then ``windows`` windows of ``per_window`` steps,
    each closed by a host read of the loss, with the kernels' launch
    counts and the collectives' call counts zeroed before the windows
    and read after them. ``profile``:
    a function called with ``step`` after the windows; its result is
    kept under ``profile``."""
    from torch.utils.flop_counter import FlopCounterMode

    history = []
    t0 = time.perf_counter()
    history.append(step())
    float(history[-1]["loss"])
    first_s = time.perf_counter() - t0
    with FlopCounterMode(display=False) as counter:
        history.append(step())
    flops = float(counter.get_total_flops())
    for _ in range(warmup):
        history.append(step())
    float(history[-1]["loss"])
    kernels.reset_launch_counts()
    collectives.reset_call_counts()
    window_s = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(per_window):
            history.append(step())
        float(history[-1]["loss"])
        window_s.append((time.perf_counter() - t0) / per_window)
    out = {"first_s": first_s, "flops": flops, "best_s": min(window_s),
           "ms_by_window": [s * 1e3 for s in window_s],
           "launches": kernels.launch_counts(),
           "collective_calls": collectives.call_counts(),
           "steps_timed": windows * per_window,
           "metrics": {k: [float(m[k]) for m in history]
                       for k in history[0]}}
    if profile is not None:
        out["profile"] = profile(step)
    return out


def resnet_loop(device="cuda", make_feed=None, profile=None) -> dict:
    """ResNet-50 training throughput, ``bench.py:bench_loop``'s keys.

    On ``cuda``: batch 256 at 224 x 224, bf16, 3 warm-up steps, best of
    8 windows of 10 steps. On ``cpu``: batch 8 at 32 x 32, f32, 1
    warm-up step, 1 window of 3. One resident batch of standard-normal
    f32 NHWC images and labels in [0, 1000) from
    ``np.random.default_rng(0)``. ``make_feed(trainer, batch_size)``:
    an endless iterator of device batches in place of the resident one
    (the framework path's feed, ``_train_loop_per_worker``). ``profile``:
    see ``_timed_run``."""
    from ray_tpu_torch.models.resnet import create_resnet
    from ray_tpu_torch.parallel.mesh import MeshSpec
    from ray_tpu_torch.train.spmd import (make_image_classifier_trainer,
                                          put_batch)

    dev = resolve_device(device)
    n_dev = _n_chips()
    if dev.type == "cuda":
        batch, image_size, dtype = 256 * n_dev, 224, torch.bfloat16
        windows, per_window, warmup = 8, 10, 3
    else:
        batch, image_size, dtype = 8 * n_dev, 32, torch.float32
        windows, per_window, warmup = 1, 3, 1

    t0 = time.perf_counter()
    model = create_resnet("resnet50", num_classes=1000, dtype=dtype)
    trainer = make_image_classifier_trainer(
        model, spec=MeshSpec(dp=n_dev),
        input_shape=(1, image_size, image_size, 3), device=dev)
    state = trainer.init(0)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    model_init_s = time.perf_counter() - t0
    if make_feed is None:
        rng = np.random.default_rng(0)
        images = rng.standard_normal((batch, image_size, image_size, 3),
                                     dtype=np.float32)
        labels = rng.integers(0, 1000, (batch,), dtype=np.int32)
        feed = itertools.repeat(put_batch(trainer, {"image": images,
                                                    "label": labels}))
    else:
        feed = make_feed(trainer, batch)

    def step():
        return trainer.step(state, next(feed))[1]

    # cuDNN's heuristics, not torch.backends.cudnn.benchmark: on an H100
    # the autotuned step was no faster and its first step took seconds
    # longer (PERF.md)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    run = _timed_run(step, warmup, windows, per_window, profile)
    best = run["best_s"]
    kind = _device_kind(dev)
    out = {
        "platform": dev.type, "device_kind": kind, "n_chips": n_dev,
        "batch_per_chip": batch // n_dev,
        "step_time_ms": best * 1e3, "compile_s": run["first_s"],
        "model_init_s": model_init_s, "img_per_sec": batch / best,
        "img_per_sec_per_chip": batch / best / n_dev,
        "flops_per_step": run["flops"], "flops_source": FLOPS_SOURCE,
        "ms_by_window": run["ms_by_window"],
        "steps_timed": run["steps_timed"], "launches": run["launches"],
        "collective_calls": run["collective_calls"],
        "losses": run["metrics"]["loss"],
    }
    if dev.type == "cuda":
        out["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated(
            dev)
    peak = _peak_flops(kind)
    if peak:
        out["mfu"] = run["flops"] / best / peak
        out["peak_bf16_flops_per_chip"] = peak
    if "profile" in run:
        out["profile"] = run["profile"]
    return out


def gpt2_train_shape(dev: torch.device):
    """(config, batch per chip, sequence length) of the GPT-2 loops: on
    ``cuda`` GPT-2 small (flash attention, bf16) at 16 x 1024; on
    ``cpu`` a tiny GPT-2 (2 layers, 64 wide, plain attention, f32) at
    2 x 32."""
    from ray_tpu_torch.models.gpt2 import GPT2Config
    if dev.type == "cuda":
        return GPT2Config(vocab_size=50257, n_positions=1024, n_embd=768,
                          n_layer=12, n_head=12, attention_backend="flash",
                          dtype=torch.bfloat16), 16, 1024
    return GPT2Config(vocab_size=256, n_positions=64, n_embd=64, n_layer=2,
                      n_head=4, attention_backend="reference",
                      dtype=torch.float32), 2, 32


def gpt2_loop(device="cuda", profile=None, config=None) -> dict:
    """GPT-2 small train-step throughput, ``bench.py:gpt2_loop``'s keys.

    On ``cuda``: GPT-2 small (flash attention, bf16), batch 16 x 1024,
    2 warm-up steps, best of 6 windows of 5 steps. On ``cpu``: a tiny
    GPT-2 (2 layers, 64 wide, plain attention, f32), batch 2 x 32, 1
    warm-up step, 1 window of 2. Seeded tokens, repeated. ``config``
    (a ``GPT2Config``) replaces the model's configuration (the batch
    and the windows stay). ``profile``: see ``_timed_run``."""
    from ray_tpu_torch.parallel.mesh import MeshSpec
    from ray_tpu_torch.train.spmd import make_causal_lm_trainer, put_batch

    dev = resolve_device(device)
    n_dev = _n_chips()
    cfg, batch, seq = gpt2_train_shape(dev)
    batch *= n_dev
    if dev.type == "cuda":
        windows, per_window, warmup = 6, 5, 2
    else:
        windows, per_window, warmup = 1, 2, 1
    cfg = config or cfg

    trainer = make_causal_lm_trainer(cfg, spec=MeshSpec(dp=n_dev),
                                     device=dev)
    state = trainer.init(0)
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (batch, seq), dtype=np.int32)
    resident = put_batch(trainer, {"input_ids": tokens, "labels": tokens})

    def step():
        return trainer.step(state, resident)[1]

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    run = _timed_run(step, warmup, windows, per_window, profile)
    best = run["best_s"]
    out = {
        "gpt2_n_chips": n_dev,
        "gpt2_batch_per_chip": batch // n_dev, "gpt2_seq_len": seq,
        "gpt2_step_time_ms": best * 1e3, "gpt2_compile_s": run["first_s"],
        "gpt2_tokens_per_sec_per_chip": batch * seq / best / n_dev,
        "gpt2_flops_per_step": run["flops"],
        "gpt2_ms_by_window": run["ms_by_window"],
        "gpt2_steps_timed": run["steps_timed"],
        "gpt2_launches": run["launches"],
        "gpt2_collective_calls": run["collective_calls"],
        "gpt2_losses": run["metrics"]["loss"],
        "gpt2_grad_norms": run["metrics"]["grad_norm"],
    }
    if dev.type == "cuda":
        out["gpt2_max_memory_allocated_bytes"] = (
            torch.cuda.max_memory_allocated(dev))
    peak = _peak_flops(_device_kind(dev))
    if peak:
        out["gpt2_mfu"] = run["flops"] / best / peak
    if "profile" in run:
        out["gpt2_profile"] = run["profile"]
    return out


def framework_items(n: int, image_size: int) -> list:
    """The framework path's synthetic ImageNet rows (``bench.py``'s
    ``_framework_main``): uint8 images, int32 labels, from
    ``np.random.default_rng(0)``."""
    rng = np.random.default_rng(0)
    return [{"image": rng.integers(0, 256, (image_size, image_size, 3),
                                   dtype=np.uint8),
             "label": np.int32(rng.integers(0, 1000))} for _ in range(n)]


def _train_loop_per_worker(config):
    """The framework path's train_func (``bench.py:379-411``), in a
    GPU-granted train worker: ``resnet_loop`` fed by the Dataset shard
    (its batches copied to the device once by ``iter_device_batches``,
    then cycled device-resident, as the JAX bench does), then
    ``gpt2_loop``; one ``session.report`` of both rows with the feed's
    timings and a digest of the first device batch."""
    import hashlib

    from ray_tpu_torch.air import session

    started = time.time()
    device = config["device"]
    if resolve_device(device).type == "cuda":
        # the driver's TF32 settings, so that its steps and these agree
        torch.backends.cuda.matmul.allow_tf32 = config["allow_tf32"]
        torch.backends.cudnn.allow_tf32 = config["allow_tf32"]
    shard = session.get_dataset_shard("train")
    feed = {}

    def make_feed(trainer, batch_size):
        t0 = time.perf_counter()
        cached = list(shard.iter_device_batches(
            batch_size=batch_size, trainer=trainer, drop_last=True,
            pad_to_batch=False))
        first = cached[0]
        feed.update({
            "feed_batches": len(cached),
            "feed_s": time.perf_counter() - t0,
            "feed_done_unix": time.time(),
            "first_batch_image_sha256": hashlib.sha256(
                first["image"].cpu().numpy().tobytes()).hexdigest(),
            "first_batch_labels": first["label"].cpu().tolist(),
            "first_batch_dtypes": {k: str(v.dtype)
                                   for k, v in first.items()},
            "first_batch_device": str(first["image"].device)})
        return itertools.cycle(cached)

    res = resnet_loop(device, make_feed=make_feed)
    res.update(feed)
    res["train_func_start_unix"] = started
    res["gpu_ids"] = list(session.get_gpu_ids())
    try:
        res.update(gpt2_loop(device))
    except Exception as e:  # the GPT-2 row must not sink the headline
        res["gpt2_error"] = f"{type(e).__name__}: {e}"[:200]
    session.report(res)


def framework_main(device="cuda") -> dict:
    """The headline's framework path (``bench.py:_framework_main``):
    ``init(num_cpus=4, num_gpus=1, object_store_memory=2 GiB)``, 1,024
    uint8 images at 224 x 224 (on ``cpu``: 64 at 32 x 32, no GPU) as
    ``data.from_items(items, parallelism=8)``, and
    ``DataParallelTrainer(..., ScalingConfig(num_workers=1,
    use_gpu=True)).fit()``. Returns the worker's report with the
    driver's timings: ``init_s``, ``ingest_s`` (the items into the
    object store), ``fit_s``, and from ``fit()``'s start: the train_func's
    start (``worker_start_s``), the feed's end (``fit_to_first_batch_s``)
    and the first step's end (``fit_to_first_step_s``)."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import data
    from ray_tpu_torch.air.config import ScalingConfig
    from ray_tpu_torch.train import DataParallelTrainer

    on_gpu = resolve_device(device).type == "cuda"
    n_imgs, image_size = (1024, 224) if on_gpu else (64, 32)
    t0 = time.perf_counter()
    rt.init(num_cpus=4, num_gpus=1 if on_gpu else 0,
            object_store_memory=2 * 1024**3)
    init_s = time.perf_counter() - t0
    try:
        items = framework_items(n_imgs, image_size)
        t0 = time.perf_counter()
        train_ds = data.from_items(items, parallelism=8)
        ingest_s = time.perf_counter() - t0
        trainer = DataParallelTrainer(
            _train_loop_per_worker,
            train_loop_config={
                "device": device,
                "allow_tf32": torch.backends.cuda.matmul.allow_tf32},
            datasets={"train": train_ds},
            scaling_config=ScalingConfig(num_workers=1, use_gpu=on_gpu))
        fit_start = time.time()
        t0 = time.perf_counter()
        result = trainer.fit()
        fit_s = time.perf_counter() - t0
        if result.error:
            raise RuntimeError(result.error)
        out = dict(result.metrics)
    finally:
        rt.shutdown()
    out.update({
        "framework_n_images": n_imgs, "framework_image_size": image_size,
        "init_s": init_s, "ingest_s": ingest_s,
        "ingest_bytes": n_imgs * image_size * image_size * 3,
        "fit_s": fit_s,
        "worker_start_s": out["train_func_start_unix"] - fit_start,
        "fit_to_first_batch_s": out["feed_done_unix"] - fit_start,
        "fit_to_first_step_s": (out["feed_done_unix"] - fit_start
                                + out["compile_s"])})
    return out


def _moved(w0, w1) -> float:
    return max(float(np.max(np.abs(w1[k] - w0[k]))) for k in w0)


def _launches_since(before) -> dict:
    return {k: n - before.get(k, 0) for k, n in kernels.launch_counts().items()
            if n != before.get(k, 0)}


def _median(runs, key, sub=None) -> float:
    """The median of ``key`` (of ``sub``) over an RL loop's results."""
    return float(np.median([(r[sub] if sub else r)[key] for r in runs]))


def usable_cpus() -> int:
    """The CPUs this process may use: its affinity, cut to the cgroup's
    quota where one is set (``/sys/fs/cgroup/cpu.max``)."""
    n = len(os.sched_getaffinity(0))
    try:
        with open("/sys/fs/cgroup/cpu.max") as f:
            quota, period = f.read().split()[:2]
        if quota != "max":
            n = min(n, max(1, int(quota) // int(period)))
    except (OSError, ValueError):
        pass
    return n


def store_bytes(cap: int = 2 << 30) -> int:
    """The object store's size for the RL loops: ``cap``, or half of
    ``/dev/shm``'s free bytes where that is less."""
    if not os.path.isdir("/dev/shm"):
        return cap
    st = os.statvfs("/dev/shm")
    return min(cap, st.f_bavail * st.f_frsize // 2)


@contextlib.contextmanager
def rl_cluster(num_cpus: int):
    """The port's runtime for a remote RL loop: the cluster that is up,
    or a new one of ``num_cpus`` CPUs (shut down on exit)."""
    import ray_tpu_torch as rt
    if rt.is_initialized():
        yield
        return
    rt.init(num_cpus=num_cpus, object_store_memory=store_bytes())
    try:
        yield
    finally:
        rt.shutdown()


def actor_starts(actors, since: float) -> list:
    """Seconds from ``since`` (a ``perf_counter`` reading taken before
    the actors were made) to each actor's first ``ping`` reply, in the
    order they answered."""
    import ray_tpu_torch as rt
    pending = [a.ping.remote() for a in actors]
    out = []
    while pending:
        done, pending = rt.wait(pending, num_returns=1, timeout=300)
        if not done:
            raise TimeoutError(f"{len(pending)} actors did not start")
        rt.get(done)
        out.append(time.perf_counter() - since)
    return out


def ppo_atari_config(device="cuda", num_workers=None,
                     num_envs_per_worker=None):
    """PPO on PixelCatcher-v0 at the standard Atari widths: 84 x 84
    grayscale frames, 4 stacked (``FrameStackConnector(4)``), the
    Nature-CNN policy (bf16 trunk, f32 heads). The settings are upstream
    Ray's ``rllib/tuned_examples/ppo/atari-ppo.yaml``: train batch 5,000,
    fragments of 100, 10 workers x 5 envs (the default on ``cuda``:
    remote rollout workers, each an actor on the CPU, the learner on
    the card), minibatch 500 x 10 epochs, clip 0.1, vf clip 10, entropy
    0.01, lambda 0.95. ``num_workers=0, num_envs_per_worker=50`` is the
    one-local-worker form, where the learner's process steps the 50
    envs itself. The yaml's ``kl_coeff`` has no counterpart in the loss
    (which only reports ``kl``). On ``cpu``: 21 x 21 frames
    (``ResizeObsConnector``), 2 stacked, fragments of 16, minibatch 32
    x 1, and by default one local worker of 4 envs (the tests' size)."""
    from ray_tpu_torch.rllib import (FrameStackConnector, PPOConfig,
                                     ResizeObsConnector)
    dev = resolve_device(device)
    if dev.type == "cuda":
        obs = [FrameStackConnector(4)]
        sizes = dict(train_batch_size=5000, rollout_fragment_length=100,
                     num_workers=10, num_envs_per_worker=5,
                     sgd_minibatch_size=500, num_sgd_iter=10)
    else:
        obs = [ResizeObsConnector(21, 21), FrameStackConnector(2)]
        sizes = dict(train_batch_size=64, rollout_fragment_length=16,
                     num_workers=0, num_envs_per_worker=4,
                     sgd_minibatch_size=32, num_sgd_iter=1)
    if num_workers is not None:
        sizes["num_workers"] = num_workers
    if num_envs_per_worker is not None:
        sizes["num_envs_per_worker"] = num_envs_per_worker
    return (PPOConfig().environment("PixelCatcher-v0")
            .rollouts(connectors={"obs": obs}, **sizes)
            .training(clip_param=0.1, vf_clip_param=10.0,
                      entropy_coeff=0.01, **{"lambda": 0.95})
            .resources(device=str(dev)).debugging(seed=0))


def _ppo_run(prefix, config, dev, timed, profile) -> dict:
    """Builds ``config`` and runs one warm-up and ``timed`` iterations of
    it through ``Algorithm.step``; the keys of ``ppo_loop`` under
    ``prefix``. With remote workers also: their count, each actor's
    start (``actor_starts`` from the build's start) and the sampling
    share of each timed iteration."""
    t0 = time.perf_counter()
    algo = config.build()
    remote = algo.workers.remote_workers
    starts = actor_starts(remote, t0) if remote else []
    policy = algo.get_policy()
    w0 = policy.get_weights()
    t0 = time.perf_counter()
    algo.step()
    warmup_s = time.perf_counter() - t0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    before = kernels.launch_counts()
    runs = [algo.step() for _ in range(timed)]
    launches = _launches_since(before)
    cfg = algo.config
    out = {
        "platform": dev.type, "device_kind": _device_kind(dev),
        "env": cfg["env"],
        "obs_shape": list(policy.observation_space.shape),
        "num_workers": len(remote),
        "num_envs": cfg["num_envs_per_worker"] * max(1, len(remote)),
        "num_envs_per_worker": cfg["num_envs_per_worker"],
        "env_steps_per_iter": runs[-1]["num_env_steps_sampled_this_iter"],
        "minibatch": cfg["sgd_minibatch_size"],
        "num_sgd_iter": cfg["num_sgd_iter"],
        "iters_timed": timed, "warmup_s": warmup_s,
        "env_steps_per_sec": _median(runs, "env_steps_per_sec"),
        "env_steps_per_sec_by_iter": [r["env_steps_per_sec"]
                                      for r in runs],
        **{k: _median(runs, k, "timers") for k in runs[0]["timers"]},
        "timers_by_iter": [r["timers"] for r in runs],
        "total_losses": [r["learner/total_loss"] for r in runs],
        "episode_reward_mean": runs[-1]["episode_reward_mean"],
        "weights_moved": _moved(w0, policy.get_weights()),
        "launches": launches,
    }
    if remote:
        shares = [r["timers"]["sample_time_ms"]
                  / sum(r["timers"].values()) for r in runs]
        out.update({"actor_start_s": starts, "sample_share_by_iter": shares,
                    "sample_share": float(np.median(shares)),
                    "workers_hold_learner_weights": all(
                        _same_weights(w, policy.get_weights()) for w in
                        _remote_weights(remote))})
    if dev.type == "cuda":
        out["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated(
            dev)
    if profile is not None:
        from ray_tpu_torch.rllib import synchronous_parallel_sample
        batch = synchronous_parallel_sample(
            algo.workers, max_env_steps=cfg["train_batch_size"])
        out["profile"] = profile(lambda: algo._sgd_epochs(policy, batch))
    algo.cleanup()
    return {f"{prefix}_{k}": v for k, v in out.items()}


def _remote_weights(workers) -> list:
    import ray_tpu_torch as rt
    return rt.get([w.get_weights.remote() for w in workers])


def _same_weights(a, b) -> bool:
    """Byte-equal weight dicts."""
    return a.keys() == b.keys() and all(
        a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]) for k in a)


def ppo_loop(device="cuda", profile=None) -> dict:
    """PPO-Atari throughput through ``Algorithm.step``
    (``ppo_atari_config``) in the one-local-worker form: one worker of
    50 envs in the learner's process on ``cuda`` (4 on ``cpu``).

    One warm-up iteration, then timed ones (3 on ``cuda``, 1 on
    ``cpu``); ``ppo_launches`` counts the kernels' launches in them (the
    counts are read, not zeroed, so a caller's count across the loop
    stays whole). ``ppo_env_steps_per_sec`` is the median of the timed
    iterations' ``env_steps_per_sec`` (``Algorithm.step``'s: env steps
    sampled over the iteration's host time); the split of an iteration
    into sampling, postprocessing (GAE) and learning comes from PPO's
    ``timers``. ``profile``: a function called with one learn phase
    (``num_sgd_iter`` epochs over a fresh train batch, after the timed
    iterations); its result is kept under ``ppo_profile``. The JAX
    package has no such bench, so these numbers stand alone."""
    dev = resolve_device(device)
    n_envs = 50 if dev.type == "cuda" else 4
    return _ppo_run("ppo", ppo_atari_config(dev, 0, n_envs), dev,
                    3 if dev.type == "cuda" else 1, profile)


def ppo_remote_loop(device="cuda", profile=None) -> dict:
    """``ppo_loop`` at atari-ppo.yaml's topology: 10 remote rollout
    workers x 5 envs (on ``cpu``: 2 x 2), each an actor of the port's
    runtime on the CPU with one torch thread, the learner on ``device``.
    Runs on the cluster that is up, else on a new one of as many CPUs
    as workers. Keys as ``ppo_loop``'s under ``ppo_remote_``, plus
    ``ppo_remote_num_workers``, ``ppo_remote_actor_start_s`` (each
    actor's first ``ping`` reply, from the build's start),
    ``ppo_remote_sample_share`` (the median share of a timed
    iteration's host time spent waiting for the workers' batches, GAE
    included: it runs in the workers) and whether every worker holds
    the learner's weights byte for byte after the last iteration's
    ``sync_weights``. Timed iterations: 3 on ``cuda``, 1 on ``cpu``."""
    dev = resolve_device(device)
    workers, envs = (10, 5) if dev.type == "cuda" else (2, 2)
    with rl_cluster(workers):
        return _ppo_run("ppo_remote", ppo_atari_config(dev, workers, envs),
                        dev, 3 if dev.type == "cuda" else 1, profile)


IMPALA_YAML_WORKERS = 32   # atari-impala.yaml's num_workers


def impala_atari_config(device="cuda", algo="IMPALA", num_workers=0):
    """IMPALA (``algo="APPO"``: APPO, clip 0.3) on PixelCatcher-v0 at the
    Atari widths: 84 x 84 grayscale frames, 4 stacked, the Nature-CNN
    policy (bf16 trunk, f32 heads); the loss coefficients, ``grad_clip``
    40 and ``lr`` 5e-4 are ``IMPALAConfig``'s defaults. The batch
    settings are upstream Ray's
    ``rllib/tuned_examples/impala/atari-impala.yaml``: fragments of 50
    and a train batch of 500. ``num_workers=0`` (the default): one local
    worker of 10 envs, so each iteration samples 500 rows and learns on
    them once (the sync path). ``num_workers > 0``: remote rollout
    workers of 5 envs each (the yaml's 32 x 5 at ``num_workers=32``)
    and the async learner thread; each reaped batch (5 x 50 = 250 rows)
    is one learn step, as the JAX package's async branch learns on each
    batch it reaps. On ``cpu``: 21 x 21 frames, 2 stacked, 2 envs x 16
    steps (the tests' size)."""
    from ray_tpu_torch.rllib import (FrameStackConnector,
                                     ResizeObsConnector)
    from ray_tpu_torch.rllib.algorithms import APPOConfig, IMPALAConfig
    dev = resolve_device(device)
    if dev.type == "cuda":
        obs = [FrameStackConnector(4)]
        sizes = dict(train_batch_size=500, rollout_fragment_length=50,
                     num_envs_per_worker=5 if num_workers else 10)
    else:
        obs = [ResizeObsConnector(21, 21), FrameStackConnector(2)]
        sizes = dict(train_batch_size=32, rollout_fragment_length=16,
                     num_envs_per_worker=2)
    config = {"IMPALA": IMPALAConfig, "APPO": APPOConfig}[algo]()
    return (config.environment("PixelCatcher-v0")
            .rollouts(connectors={"obs": obs}, num_workers=num_workers,
                      **sizes)
            .resources(device=str(dev)).debugging(seed=0))


def _impala_run(prefix, config, dev, timed, profile, algo) -> dict:
    """Builds ``config`` and runs one warm-up and ``timed`` iterations;
    the keys of ``impala_loop`` under ``prefix``. On the async path
    (remote workers) also their count and starts, the learner thread's
    steps, rows trained and empty-queue wait over the timed iterations
    and its queue's depth after each."""
    from ray_tpu_torch.rllib.algorithms.impala import _mark_cuts
    t0 = time.perf_counter()
    algo_obj = config.build()
    remote = algo_obj.workers.remote_workers
    starts = actor_starts(remote, t0) if remote else []
    policy = algo_obj.get_policy()
    w0 = policy.get_weights()
    t0 = time.perf_counter()
    algo_obj.step()
    warmup_s = time.perf_counter() - t0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    learner = algo_obj._learner
    m0 = learner.metrics() if learner is not None else None
    before = kernels.launch_counts()
    t0 = time.perf_counter()
    runs = [algo_obj.step() for _ in range(timed)]
    window_s = time.perf_counter() - t0
    launches = _launches_since(before)
    cfg = algo_obj.config
    out = {
        "algo": algo, "platform": dev.type,
        "device_kind": _device_kind(dev), "env": cfg["env"],
        "obs_shape": list(policy.observation_space.shape),
        "num_workers": len(remote),
        "num_envs": cfg["num_envs_per_worker"] * max(1, len(remote)),
        "num_envs_per_worker": cfg["num_envs_per_worker"],
        "env_steps_per_iter": runs[-1]["num_env_steps_sampled_this_iter"],
        "iters_timed": timed, "warmup_s": warmup_s,
        "env_steps_per_sec": _median(runs, "env_steps_per_sec"),
        "env_steps_per_sec_by_iter": [r["env_steps_per_sec"]
                                      for r in runs],
        **{k: _median(runs, k, "timers") for k in runs[0]["timers"]},
        "timers_by_iter": [r["timers"] for r in runs],
        "total_losses": [r["learner/total_loss"] for r in runs],
        "policy_losses": [r["learner/policy_loss"] for r in runs],
        "vf_losses": [r["learner/vf_loss"] for r in runs],
        "episode_reward_mean": runs[-1]["episode_reward_mean"],
        # the learner thread's weights are read under its lock
        "weights_moved": _moved(w0, (learner or policy).get_weights()),
        "launches": launches,
    }
    if learner is not None:
        m1 = learner.metrics()
        out.update({
            "actor_start_s": starts,
            "env_steps_sampled": sum(r["num_env_steps_sampled_this_iter"]
                                     for r in runs),
            "window_s": window_s,
            "learner_steps": m1["num_learner_steps"]
            - m0["num_learner_steps"],
            "learner_rows_trained": m1["num_samples_trained"]
            - m0["num_samples_trained"],
            "learner_time_s": m1["learn_time_total_s"]
            - m0["learn_time_total_s"],
            "learner_queue_wait_s": m1["learner_queue_wait_total_s"]
            - m0["learner_queue_wait_total_s"],
            "learner_queue_size_by_iter": [
                r["learner/learner_queue_size"] for r in runs],
            "learner_queue_capacity": cfg["learner_queue_size"]})
    if dev.type == "cuda":
        out["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated(
            dev)
    if profile is not None:
        if remote:
            import ray_tpu_torch as rt
            batch = _mark_cuts(rt.get(remote[0].sample.remote()))
            learner.stop()
            learner.join()
        else:
            batch = _mark_cuts(algo_obj.workers.local_worker.sample())
        out["profile"] = profile(lambda: policy.learn_on_batch(batch))
    algo_obj.cleanup()
    return {f"{prefix}_{k}": v for k, v in out.items()}


def impala_loop(device="cuda", profile=None, algo="IMPALA",
                timed=None) -> dict:
    """IMPALA-Atari (or APPO) throughput through ``Algorithm.step``
    (``impala_atari_config``, the one-local-worker form): one warm-up
    iteration, then ``timed`` ones (default 10 on ``cuda``, 1 on
    ``cpu``). Keys as ``ppo_loop``'s with the prefix ``impala_``: the
    median env steps/s, the split of an iteration (IMPALA's ``timers``:
    sample, postprocess, learn; V-trace is not timed apart here:
    chip_smoke.py times it alone), the losses, weights that moved, the
    kernels' launches in the timed iterations (read, not zeroed) and the
    peak memory. ``profile``: a function called with one learn phase
    (``learn_on_batch`` on a fresh 500-row batch with its cuts); its
    result is kept under ``impala_profile``."""
    dev = resolve_device(device)
    return _impala_run("impala", impala_atari_config(dev, algo), dev,
                       timed or (10 if dev.type == "cuda" else 1), profile,
                       algo)


def impala_remote_loop(device="cuda", profile=None) -> dict:
    """IMPALA-Atari at atari-impala.yaml's topology: remote rollout
    workers of 5 envs x fragments of 50 (on ``cpu``: 2 workers of 2 x
    16) feeding the async learner thread on ``device``, 8 reaped batches
    an iteration. The yaml's 32 workers are cut to ``usable_cpus() - 2``
    where the machine has fewer than 34 CPUs (the driver and the
    learner thread keep two); ``impala_remote_workers_cut`` says from
    how many to how many. Runs on the cluster that is up, else on a new
    one of as many CPUs as workers. Keys as ``impala_loop``'s under
    ``impala_remote_``, plus the worker count, each actor's start, the
    learner thread's steps, rows, time and empty-queue wait in the
    timed window and its queue's depth after each iteration. Timed
    iterations: 5 on ``cuda``, 1 on ``cpu``. ``profile``: one
    ``learn_on_batch`` on a batch from one worker, after the learner
    thread has stopped."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        workers = min(IMPALA_YAML_WORKERS, max(1, usable_cpus() - 2))
    else:
        workers = 2
    with rl_cluster(workers):
        out = _impala_run(
            "impala_remote", impala_atari_config(dev, "IMPALA", workers),
            dev, 5 if dev.type == "cuda" else 1, profile, "IMPALA")
    if dev.type == "cuda":
        out["impala_remote_workers_cut"] = (
            None if workers == IMPALA_YAML_WORKERS
            else {"yaml": IMPALA_YAML_WORKERS, "run": workers,
                  "usable_cpus": usable_cpus()})
    return out


REMOTE_ALGOS = ("DDPPO", "ApexDQN", "ApexDDPG", "A3C", "ES", "ARS",
                "PPO-eval")


def remote_algo_config(algo, device="cuda"):
    """The small remote configs: each algorithm's JAX config defaults
    (2 remote workers; ``device`` the learner's) on CartPole-v1 (Ape-X
    DDPG on Pendulum-v1), seed 0. ``"PPO-eval"``: PPO with 2 remote
    rollout workers (fragments of 100, a train batch of 400, minibatch
    128 x 5) and an evaluation WorkerSet of 2 greedy workers, 4 episodes
    every iteration."""
    from ray_tpu_torch.rllib import algorithms as A
    dev = resolve_device(device)
    config = {"DDPPO": A.DDPPOConfig, "ApexDQN": A.ApexDQNConfig,
              "ApexDDPG": A.ApexDDPGConfig, "A3C": A.A3CConfig,
              "ES": A.ESConfig, "ARS": A.ARSConfig,
              "PPO-eval": A.PPOConfig}[algo]()
    env = "Pendulum-v1" if algo == "ApexDDPG" else "CartPole-v1"
    config.environment(env).resources(device=str(dev)).debugging(seed=0)
    if algo == "PPO-eval":
        config.rollouts(num_workers=2, rollout_fragment_length=100)
        config.training(train_batch_size=400, sgd_minibatch_size=128,
                        num_sgd_iter=5)
        config.evaluation(evaluation_interval=1, evaluation_num_workers=2,
                          evaluation_num_episodes=4)
    return config


def _remote_algo_run(algo, algo_obj, starts, dev, timed) -> dict:
    """``remote_algo_loops``'s iterations and keys for one built
    algorithm whose actors answered at ``starts``; cleans it up."""
    from ray_tpu_torch.rllib.models import flat_params
    policy = algo_obj.get_policy()
    es = hasattr(algo_obj, "theta")
    w0 = algo_obj.theta.copy() if es else policy.get_weights()
    warm, t0 = 0, time.perf_counter()
    while True:
        r = algo_obj.step()
        warm += 1
        if r.get("num_learner_steps", 1) > 0 or warm >= 40:
            break
    warmup_s = time.perf_counter() - t0
    before = kernels.launch_counts()
    runs = [algo_obj.step() for _ in range(timed)]
    launches = _launches_since(before)
    counts = {k: [r[k] for r in runs] for k in (
        "num_learner_steps", "num_grads_applied", "num_ddppo_workers",
        "episodes_this_iter", "replay_size") if k in runs[0]}
    if "evaluation" in runs[0]:
        counts["evaluation_episodes"] = [
            r["evaluation"]["episodes_this_eval"] for r in runs]
    if es:
        moved = float(np.max(np.abs(algo_obj.theta - w0)))
        held = bool(np.array_equal(flat_params(policy.model),
                                   algo_obj.theta))
    else:
        moved = _moved(w0, policy.get_weights())
        algo_obj.workers.sync_weights()
        sets = [algo_obj.workers]
        if algo_obj.evaluation_workers is not None:
            sets.append(algo_obj.evaluation_workers)
        held = all(_same_weights(w, policy.get_weights())
                   for ws in sets for w in _remote_weights(ws.remote_workers))
    out = {
        "platform": dev.type, "device_kind": _device_kind(dev),
        "learner_device": str(getattr(policy, "device", dev)),
        "env": algo_obj.config["env"], "num_workers": len(starts),
        "actor_start_s": starts, "iters_before": warm,
        "warmup_s": warmup_s, "iters_timed": timed,
        "env_steps_per_iter": [r["num_env_steps_sampled_this_iter"]
                               for r in runs],
        "env_steps_per_sec": _median(runs, "env_steps_per_sec"),
        "counts": counts, "weights_moved": moved,
        "workers_hold_learner_weights": held, "launches": launches,
        "config": {k: algo_obj.config.get(k) for k in (
            "num_envs_per_worker", "rollout_fragment_length",
            "train_batch_size", "learning_starts",
            "train_intensity_per_iter", "max_grads_per_step",
            "rollouts_per_worker", "evaluation_num_episodes")
            if algo_obj.config.get(k) is not None},
    }
    algo_obj.cleanup()
    prefix = algo.lower().replace("-", "_")
    return {f"{prefix}_{k}": v for k, v in out.items()}


def _rollout_actors(algo_obj) -> list:
    """An algorithm's remote actors: its rollout workers (ES: its
    perturbation workers)."""
    if hasattr(algo_obj, "theta"):
        return list(algo_obj._es_workers)
    return list(algo_obj.workers.remote_workers)


def remote_algo_loops(device="cuda") -> dict:
    """Each of ``REMOTE_ALGOS`` (``remote_algo_config``) through
    ``Algorithm.step``, their actors started together: every algorithm
    is built first, so all their workers' processes start at once (each
    start is mostly ``import torch``), then each runs iterations until
    its learner has stepped once (Ape-X fills its replay to
    ``learning_starts`` first; at most 40) and 3 timed ones, and is
    cleaned up. A cluster that is up needs CPUs for all their rollout
    workers at once (2 an algorithm, 4 for ``"PPO-eval"``; ES's hold
    none: 12 in all); else one of 12 is started. Returns, under each
    algorithm's lower-case name (``ppo_eval`` for ``"PPO-eval"``): env
    steps/s (median), steps per iteration, the iterations before the
    timed ones, weights that moved (the learner's; ES's ``theta``), the
    workers' count and each one's start (from the first build's start),
    the counts each iteration reports (``num_learner_steps``,
    ``num_grads_applied``, ``num_ddppo_workers``,
    ``episodes_this_iter``, the evaluation's episodes) by timed
    iteration, whether every remote worker holds the learner's weights
    byte for byte after a ``sync_weights`` (ES: the local policy holds
    ``theta``; the evaluation workers too), the kernels' launches and
    the learner's device."""
    algos, timed = REMOTE_ALGOS, 3
    import ray_tpu_torch as rt
    dev = resolve_device(device)
    out = {}
    with rl_cluster(12):
        t0 = time.perf_counter()
        built = [remote_algo_config(a, dev).build() for a in algos]
        actors = [_rollout_actors(b) for b in built]
        owner = {}
        pending = []
        for i, acts in enumerate(actors):
            for a in acts:
                ref = a.ping.remote()
                owner[ref] = i
                pending.append(ref)
        starts = [[] for _ in algos]
        while pending:
            done, pending = rt.wait(pending, num_returns=1, timeout=300)
            if not done:
                raise TimeoutError(f"{len(pending)} actors did not start")
            rt.get(done)
            starts[owner[done[0]]].append(time.perf_counter() - t0)
        for a, b, st in zip(algos, built, starts):
            out.update(_remote_algo_run(a, b, st, dev, timed))
    return out


def dqn_atari_config(device="cuda"):
    """DQN on PixelCatcher-v0 at the Atari widths (84 x 84 x 4, the
    Nature CNN with its logits head as Q-values) with the JAX package's
    ``DQNConfig`` defaults: fragments of 4, a train batch of 32,
    double-Q, a uniform replay buffer of 50,000 rows (``obs`` and
    ``new_obs``: 2.8 GB of uint8 on the host, nothing on the card),
    1,000 rows before learning, a target sync every 500 env steps,
    epsilon from 1 to 0.02 over 10,000 steps; 8 envs, so an iteration
    samples 32 rows and learns once. Cut against upstream's
    ``atari-dqn.yaml``: the buffer (1,000,000 rows), the steps before
    learning (20,000), the target period (8,000) and the epsilon
    schedule (200,000). On ``cpu``: 21 x 21 frames, 2 stacked, 2 envs,
    a buffer of 1,000 rows, 64 before learning, a target sync every 32
    steps, epsilon over 256."""
    from ray_tpu_torch.rllib import (DQNConfig, FrameStackConnector,
                                     ResizeObsConnector)
    dev = resolve_device(device)
    if dev.type == "cuda":
        obs = [FrameStackConnector(4)]
        sizes = dict(num_envs_per_worker=8)
    else:
        obs = [ResizeObsConnector(21, 21), FrameStackConnector(2)]
        sizes = dict(num_envs_per_worker=2, replay_buffer_capacity=1000,
                     learning_starts=64, target_network_update_freq=32,
                     epsilon_timesteps=256)
    return (DQNConfig().environment("PixelCatcher-v0")
            .rollouts(connectors={"obs": obs}, num_workers=0,
                      rollout_fragment_length=4)
            .training(train_batch_size=32, double_q=True,
                      prioritized_replay=False, **sizes)
            .resources(device=str(dev)).debugging(seed=0))


def dqn_loop(device="cuda", profile=None) -> dict:
    """DQN-Atari throughput through ``Algorithm.step``
    (``dqn_atari_config``): iterations until the buffer holds
    ``learning_starts`` rows, one warm-up iteration that learns, then
    timed ones (200 on ``cuda``, 8 on ``cpu``). Keys as
    ``ppo_loop``'s with the prefix ``dqn_``: the median env steps/s and
    the rate over the whole timed run, DQN's ``timers`` (sample, replay,
    learn), the losses, weights that moved, the replay buffer's size,
    epsilon and the target syncs before and after, the kernels' launches
    (read, not zeroed) and the peak memory. ``profile``: a function
    called with one learn phase (10 updates, each a replay draw and a
    ``learn_on_batch``); its result is kept under ``dqn_profile``."""
    dev = resolve_device(device)
    algo = dqn_atari_config(dev).build()
    policy = algo.get_policy()
    cfg = algo.config
    w0 = policy.get_weights()
    timed = 200 if dev.type == "cuda" else 8
    t0 = time.perf_counter()
    fill = 0
    while len(algo.replay) < cfg["learning_starts"]:
        algo.step()
        fill += 1
    warm = algo.step()
    warmup_s = time.perf_counter() - t0
    start = {"replay_size": warm["replay_size"], "epsilon": warm["epsilon"],
             "target_updates": algo.num_target_updates}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    before = kernels.launch_counts()
    t0 = time.perf_counter()
    runs = [algo.step() for _ in range(timed)]
    timed_s = time.perf_counter() - t0
    launches = _launches_since(before)
    steps = sum(r["num_env_steps_sampled_this_iter"] for r in runs)
    out = {
        "dqn_platform": dev.type, "dqn_device_kind": _device_kind(dev),
        "dqn_env": cfg["env"],
        "dqn_obs_shape": list(policy.observation_space.shape),
        "dqn_num_envs": cfg["num_envs_per_worker"],
        "dqn_train_batch_size": cfg["train_batch_size"],
        "dqn_replay_capacity": cfg["replay_buffer_capacity"],
        "dqn_env_steps_per_iter": runs[-1]["num_env_steps_sampled_this_iter"],
        "dqn_fill_iters": fill, "dqn_iters_timed": timed,
        "dqn_warmup_s": warmup_s,
        "dqn_env_steps_per_sec": _median(runs, "env_steps_per_sec"),
        "dqn_env_steps_per_sec_whole": steps / timed_s,
        **{f"dqn_{k}": _median(runs, k, "timers")
           for k in runs[0]["timers"]},
        "dqn_total_losses": [r["learner/total_loss"] for r in runs],
        "dqn_mean_q": [runs[0]["learner/mean_q"], runs[-1]["learner/mean_q"]],
        "dqn_replay_size": [start["replay_size"], runs[-1]["replay_size"]],
        "dqn_epsilon": [start["epsilon"], runs[-1]["epsilon"]],
        "dqn_target_updates": [start["target_updates"],
                               algo.num_target_updates],
        "dqn_episode_reward_mean": runs[-1]["episode_reward_mean"],
        "dqn_weights_moved": _moved(w0, policy.get_weights()),
        "dqn_launches": launches,
    }
    if dev.type == "cuda":
        out["dqn_max_memory_allocated_bytes"] = (
            torch.cuda.max_memory_allocated(dev))
    if profile is not None:
        def learn():
            for _ in range(10):
                policy.learn_on_batch(algo.replay.sample(
                    cfg["train_batch_size"]))
        out["dqn_profile"] = profile(learn)
    algo.cleanup()
    return out


def pendulum_sac_config(device="cuda", algo="SAC"):
    """SAC (``algo="TD3"``/``"DDPG"``: those) on Pendulum-v1 (the
    pure-numpy env; no MuJoCo env can be installed on the card machine).
    SAC at upstream Ray's ``rllib/tuned_examples/sac/pendulum-sac.yaml``,
    uncut in what the JAX algorithm has: pi and Q of 256 x 256 ReLU, train
    batch 256, fragments of 1 on one env, 256 steps before learning, a
    buffer of 100,000 rows, tau 0.005, lr 3e-4 (``SACConfig``'s defaults;
    the yaml's three learning rates are the JAX package's one Adam, its
    prioritized buffer is uniform: the JAX SAC has none). TD3 and DDPG at
    the JAX ``TD3Config``'s / ``DDPGConfig``'s defaults (the same widths,
    batch and fragments). On ``cpu``: batch 32, 32 steps before learning,
    a buffer of 1,000 (the tests' size; the nets stay 256 x 256)."""
    from ray_tpu_torch.rllib.algorithms import DDPGConfig, SACConfig, TD3Config
    dev = resolve_device(device)
    config = {"SAC": SACConfig, "TD3": TD3Config, "DDPG": DDPGConfig}[algo]()
    if dev.type == "cpu":
        config.training(train_batch_size=32, learning_starts=32,
                        replay_buffer_capacity=1000)
    return (config.environment("Pendulum-v1")
            .rollouts(num_workers=0, num_envs_per_worker=1)
            .resources(device=str(dev)).debugging(seed=0))


def _replay_loop(prefix, config, dev, timed, profile) -> dict:
    """An off-policy algorithm through ``Algorithm.step``: iterations until
    the buffer holds ``learning_starts`` rows, one warm-up iteration that
    learns, then ``timed`` ones. Keys as ``dqn_loop``'s with ``prefix``;
    the losses of every timed iteration are summarised (first, last, all
    finite); the actions in the buffer against the Box's bounds.
    ``profile``: a function called with one learn phase (10 updates, each
    a replay draw and a ``learn_on_batch``)."""
    algo = config.build()
    policy = algo.get_policy()
    cfg = algo.config
    w0 = policy.get_weights()
    t0 = time.perf_counter()
    fill = 0
    while len(algo.replay) < cfg["learning_starts"]:
        algo.step()
        fill += 1
    warm = algo.step()
    warmup_s = time.perf_counter() - t0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    before = kernels.launch_counts()
    t0 = time.perf_counter()
    runs = [algo.step() for _ in range(timed)]
    timed_s = time.perf_counter() - t0
    launches = _launches_since(before)
    losses = [r["learner/critic_loss"] for r in runs]
    steps = sum(r["num_env_steps_sampled_this_iter"] for r in runs)
    acts = algo.replay._cols["actions"][:len(algo.replay)]
    totals = {k: float(sum(r["timers"][k] for r in runs))
              for k in runs[0]["timers"]}
    out = {
        f"{prefix}_platform": dev.type,
        f"{prefix}_device_kind": _device_kind(dev),
        f"{prefix}_env": cfg["env"],
        f"{prefix}_hidden": policy.model.pi_net[0].out_features,
        f"{prefix}_train_batch_size": cfg["train_batch_size"],
        f"{prefix}_replay_capacity": cfg["replay_buffer_capacity"],
        f"{prefix}_fill_iters": fill, f"{prefix}_iters_timed": timed,
        f"{prefix}_warmup_s": warmup_s,
        f"{prefix}_env_steps_per_sec": _median(runs, "env_steps_per_sec"),
        f"{prefix}_env_steps_per_sec_whole": steps / timed_s,
        **{f"{prefix}_{k}": _median(runs, k, "timers")
           for k in runs[0]["timers"]},
        f"{prefix}_split": {k: v / sum(totals.values())
                            for k, v in totals.items()},
        f"{prefix}_critic_loss": [losses[0], losses[-1]],
        f"{prefix}_losses_finite": bool(np.all(np.isfinite(losses))),
        f"{prefix}_replay_size": [warm["replay_size"],
                                  runs[-1]["replay_size"]],
        f"{prefix}_action_range": [float(acts.min()), float(acts.max())],
        f"{prefix}_action_bounds": [float(policy.low.min()),
                                    float(policy.high.max())],
        f"{prefix}_episode_reward_mean": runs[-1]["episode_reward_mean"],
        f"{prefix}_weights_moved": _moved(w0, policy.get_weights()),
        f"{prefix}_launches": launches,
    }
    if dev.type == "cuda":
        out[f"{prefix}_max_memory_allocated_bytes"] = (
            torch.cuda.max_memory_allocated(dev))
    if profile is not None:
        def learn():
            for _ in range(10):
                policy.learn_on_batch(algo.replay.sample(
                    cfg["train_batch_size"]))
        out[f"{prefix}_profile"] = profile(learn)
    algo.cleanup()
    return out


def sac_loop(device="cuda", profile=None, timed=None) -> dict:
    """SAC-Pendulum throughput through ``Algorithm.step``
    (``pendulum_sac_config``): one env step and one 256-row update an
    iteration; 1,000 timed iterations on ``cuda`` (one yaml iteration:
    its ``min_sample_timesteps_per_iteration`` 1000), 16 on ``cpu``.
    Keys ``sac_*`` (``_replay_loop``)."""
    dev = resolve_device(device)
    timed = timed or (1000 if dev.type == "cuda" else 16)
    return _replay_loop("sac", pendulum_sac_config(dev), dev, timed, profile)


def ddpg_loop(algo="TD3", device="cuda", profile=None, timed=None) -> dict:
    """TD3 (or DDPG) on Pendulum-v1 at the JAX config's defaults, as
    ``sac_loop``: keys ``td3_*`` / ``ddpg_*``."""
    dev = resolve_device(device)
    timed = timed or (1000 if dev.type == "cuda" else 16)
    return _replay_loop(algo.lower(), pendulum_sac_config(dev, algo), dev,
                        timed, profile)


def write_pendulum_dataset(path, episodes=500, steps=200, seed=0) -> int:
    """The offline Pendulum set, written by the port's ``JsonWriter`` to
    ``path`` as one batch: ``episodes`` episodes (reset seeds 0, 1, ...)
    of up to ``steps`` steps of the JAX package's test fixture's noisy PD
    law (``tests/test_rllib_algos4.py``'s ``pendulum_dataset``), torque
    clip(-8 theta - 2 theta_dot + N(0, 0.4), -2, 2) from
    ``np.random.default_rng(seed)``. Returns the number of rows."""
    from ray_tpu_torch.rllib.env import PendulumEnv
    from ray_tpu_torch.rllib.offline import JsonWriter
    from ray_tpu_torch.rllib.sample_batch import SampleBatch
    rng = np.random.default_rng(seed)
    env = PendulumEnv({"seed": seed})
    cols = {k: [] for k in ("obs", "actions", "rewards", "dones", "new_obs")}
    for ep in range(episodes):
        obs, _ = env.reset(seed=ep)
        for _ in range(steps):
            cos_th, sin_th, thdot = obs
            th = np.arctan2(sin_th, cos_th)
            a = np.clip(-8.0 * th - 2.0 * thdot + rng.normal(0, 0.4), -2, 2)
            nobs, r, term, trunc, _ = env.step(np.array([a], np.float32))
            for k, v in zip(cols, (obs, [a], r, term or trunc, nobs)):
                cols[k].append(v)
            obs = nobs
            if term or trunc:
                break
    dtypes = {"dones": bool}
    writer = JsonWriter(path)
    writer.write(SampleBatch({k: np.asarray(v, dtypes.get(k, np.float32))
                              for k, v in cols.items()}))
    writer.close()
    return len(cols["obs"])


def offline_config(algo, input_path, device="cuda"):
    """CQL, CRR, MARWIL or BC on ``input_path`` with Pendulum-v1's spaces
    at the JAX configs' defaults: batch 256, 10 learn steps an iteration,
    CQL's 200 BC steps, SAC's 256 x 256 nets (CQL, CRR) and the 256 x 256
    tanh MLP (MARWIL, BC). On ``cpu``: batch 32, 5 learn steps an
    iteration, 5 BC steps (the nets stay 256 x 256)."""
    from ray_tpu_torch.rllib.algorithms import (BCConfig, CQLConfig,
                                                CRRConfig, MARWILConfig)
    dev = resolve_device(device)
    config = {"CQL": CQLConfig, "CRR": CRRConfig, "MARWIL": MARWILConfig,
              "BC": BCConfig}[algo]()
    if dev.type == "cpu":
        config.training(train_batch_size=32, num_iters_per_step=5,
                        bc_iters=5)
    return (config.environment("Pendulum-v1")
            .offline_data(input_path=input_path)
            .resources(device=str(dev)).debugging(seed=0))


def offline_loop(algo="CQL", device="cuda", profile=None, data_dir=None,
                 timed=None) -> dict:
    """Offline learn-step throughput through ``Algorithm.step``: the
    Pendulum set (``write_pendulum_dataset``: 500 episodes x 200 steps =
    100,000 rows on ``cuda``, 4 x 200 on ``cpu``) written to a temporary
    directory (or read from ``data_dir``, written there before) and read
    back through the algorithm (``offline_config``); one warm-up
    iteration, then ``timed`` ones (CQL 25 on ``cuda``, so that it passes
    its 200 BC steps and switches over; the others 3; on ``cpu`` CQL 2,
    the others 1). Keys ``offline_*``: learn steps/s (median over the
    timed iterations), the draw / learn split, the losses, weights that
    moved, CQL's learn steps beside its ``bc_iters``, launches (read, not
    zeroed), peak memory. ``profile``: a function called with
    one iteration."""
    import tempfile
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    timed = timed or ((25 if algo == "CQL" else 3) if cuda
                      else (2 if algo == "CQL" else 1))
    out = {"offline_algo": algo, "offline_platform": dev.type,
           "offline_device_kind": _device_kind(dev)}
    with tempfile.TemporaryDirectory() as tmp:
        if data_dir is None:
            t0 = time.perf_counter()
            out["offline_rows"] = write_pendulum_dataset(
                tmp, episodes=500 if cuda else 4)
            out["offline_write_s"] = time.perf_counter() - t0
            data_dir = tmp
        t0 = time.perf_counter()
        algo_obj = offline_config(algo, data_dir, dev).build()
        out["offline_read_s"] = time.perf_counter() - t0
    policy = algo_obj.get_policy()
    cfg = algo_obj.config
    w0 = policy.get_weights()
    t0 = time.perf_counter()
    algo_obj.step()
    out["offline_warmup_s"] = time.perf_counter() - t0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    before = kernels.launch_counts()
    runs, secs = [], []
    for _ in range(timed):
        t0 = time.perf_counter()
        runs.append(algo_obj.step())
        secs.append(time.perf_counter() - t0)
    launches = _launches_since(before)
    per_iter = cfg["num_iters_per_step"]
    losses = [r["learner/total_loss"] for r in runs]
    totals = {k: float(sum(r["timers"][k] for r in runs))
              for k in runs[0]["timers"]}
    out.update({
        "offline_rows": algo_obj._data.count,
        "offline_train_batch_size": cfg["train_batch_size"],
        "offline_learn_steps_per_iter": per_iter,
        "offline_iters_timed": timed,
        "offline_learn_steps_per_sec": float(np.median(
            [per_iter / s for s in secs])),
        **{f"offline_{k}": _median(runs, k, "timers")
           for k in runs[0]["timers"]},
        "offline_split": {k: v / sum(totals.values())
                          for k, v in totals.items()},
        "offline_total_loss": [losses[0], losses[-1]],
        "offline_losses_finite": bool(np.all(np.isfinite(losses))),
        "offline_timesteps_total": runs[-1]["timesteps_total"],
        "offline_weights_moved": _moved(w0, policy.get_weights()),
        "offline_launches": launches,
    })
    if algo == "CQL":
        out["offline_learn_steps_total"] = runs[-1]["learn_steps_total"]
        out["offline_bc_iters"] = cfg["bc_iters"]
    if cuda:
        out["offline_max_memory_allocated_bytes"] = (
            torch.cuda.max_memory_allocated(dev))
    if profile is not None:
        out["offline_profile"] = profile(algo_obj.training_step)
    algo_obj.cleanup()
    return out


def r2d2_config(device="cuda"):
    """R2D2 on CartPole-v1 at the JAX ``R2D2Config``'s defaults: Dense 64
    -> LSTM 64 -> Q, sequences of 20 with a burn-in of 4, 32 sequences an
    update, 4 updates an iteration of 64 env steps, 500 env steps before
    learning, a target sync every 300 steps, epsilon over 5,000. On
    ``cpu``: 4 sequences of 8 with a burn-in of 2, 64 steps before
    learning, a target sync every 64 (the nets stay 64 wide)."""
    from ray_tpu_torch.rllib.algorithms import R2D2Config
    dev = resolve_device(device)
    config = R2D2Config()
    if dev.type == "cpu":
        config.training(train_batch_size=4, seq_len=8, burn_in=2,
                        learning_starts=64, target_network_update_freq=64)
    return (config.environment("CartPole-v1")
            .resources(device=str(dev)).debugging(seed=0))


def slateq_config(device="cuda"):
    """SlateQ on its interest-evolution simulator at the JAX
    ``SlateQConfig``'s defaults: 20 documents, slates of 3, 6 topics,
    q-net 64 x 64, batch 128, 4 updates an iteration of 200 env steps,
    500 steps before learning, a 50,000-row buffer, a target sync every
    500 steps. On ``cpu``: fragments of 32, batch 16, 64 steps before
    learning, a target sync every 64."""
    from ray_tpu_torch.rllib.algorithms import SlateQConfig
    dev = resolve_device(device)
    config = SlateQConfig()
    if dev.type == "cpu":
        config.training(rollout_fragment_length=32, train_batch_size=16,
                        learning_starts=64, target_network_update_freq=64)
    return config.resources(device=str(dev)).debugging(seed=0)


def _local_loop(prefix, algo, dev, timed, profile, replay_size) -> dict:
    """A ``LocalAlgorithm`` with a replay (R2D2, SlateQ, QMIX, MADDPG)
    through ``Algorithm.step``: iterations until ``replay_size(algo)``
    reaches ``learning_starts``, one warm-up iteration that learns, then
    ``timed`` ones. Keys as ``_replay_loop``'s with ``prefix``, plus the
    replay's size before and after and how far the target moved over the
    timed iterations; with an epsilon schedule, epsilon before and
    after; with a hard target sync (``target_network_update_freq``), the
    syncs in the timed iterations and whether the target equalled the
    online net right after the last one. ``profile``: a function called
    with one learn phase (``training_intensity`` updates, each a replay
    draw and an ``_update``, then the stats to the host)."""
    from ray_tpu_torch.rllib.policy import stats_to_host, weights_of
    cfg = algo.config
    hard_sync = "target_network_update_freq" in cfg
    w0 = weights_of(algo.model)
    t0 = time.perf_counter()
    fill = 0
    while replay_size(algo) < cfg["learning_starts"]:
        algo.step()
        fill += 1
    warm = algo.step()
    warmup_s = time.perf_counter() - t0
    start = (warm.get("epsilon"), replay_size(algo))
    target0 = weights_of(algo.target_model)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    before = kernels.launch_counts()
    runs, syncs, synced_equal = [], 0, None
    t0 = time.perf_counter()
    for _ in range(timed):
        pending = getattr(algo, "_steps_since_target_sync", 0)
        runs.append(algo.step())
        if hard_sync and (algo._steps_since_target_sync < pending
                          + runs[-1]["num_env_steps_sampled_this_iter"]):
            syncs += 1
            online, target = weights_of(algo.model), weights_of(
                algo.target_model)
            synced_equal = all(np.array_equal(online[k], target[k])
                               for k in online)
    timed_s = time.perf_counter() - t0
    launches = _launches_since(before)
    losses = [r["learner/loss"] for r in runs]
    steps = sum(r["num_env_steps_sampled_this_iter"] for r in runs)
    totals = {k: float(sum(r["timers"][k] for r in runs))
              for k in runs[0]["timers"]}
    target1 = weights_of(algo.target_model)
    out = {
        f"{prefix}_platform": dev.type,
        f"{prefix}_device_kind": _device_kind(dev),
        f"{prefix}_train_batch_size": cfg["train_batch_size"],
        f"{prefix}_training_intensity": cfg["training_intensity"],
        f"{prefix}_env_steps_per_iter": cfg["rollout_fragment_length"],
        f"{prefix}_fill_iters": fill, f"{prefix}_iters_timed": timed,
        f"{prefix}_warmup_s": warmup_s,
        f"{prefix}_env_steps_per_sec": _median(runs, "env_steps_per_sec"),
        f"{prefix}_env_steps_per_sec_whole": steps / timed_s,
        **{f"{prefix}_{k}": _median(runs, k, "timers")
           for k in runs[0]["timers"]},
        f"{prefix}_split": {k: v / sum(totals.values())
                            for k, v in totals.items()},
        f"{prefix}_loss": [losses[0], losses[-1]],
        f"{prefix}_losses_finite": bool(np.all(np.isfinite(losses))),
        f"{prefix}_replay_size": [start[1], replay_size(algo)],
        f"{prefix}_target_moved": _moved(target0, target1),
        f"{prefix}_episode_reward_mean": runs[-1]["episode_reward_mean"],
        f"{prefix}_weights_moved": _moved(w0, weights_of(algo.model)),
        f"{prefix}_launches": launches,
    }
    if start[0] is not None:
        out[f"{prefix}_epsilon"] = [start[0], runs[-1]["epsilon"]]
    if hard_sync:
        out.update({
            f"{prefix}_target_syncs": syncs,
            f"{prefix}_target_equals_online_after_sync": synced_equal,
            f"{prefix}_target_network_update_freq":
                cfg["target_network_update_freq"]})
    if dev.type == "cuda":
        out[f"{prefix}_max_memory_allocated_bytes"] = (
            torch.cuda.max_memory_allocated(dev))
    if profile is not None:
        def learn():
            for _ in range(cfg["training_intensity"]):
                stats = algo._update(algo.replay.sample(
                    cfg["train_batch_size"]))
            return stats_to_host(stats)
        out[f"{prefix}_profile"] = profile(learn)
    algo.cleanup()
    return out


def r2d2_loop(device="cuda", profile=None, timed=None) -> dict:
    """R2D2-CartPole throughput through ``Algorithm.step``
    (``r2d2_config``): 40 timed iterations on ``cuda``, 2 on ``cpu``.
    Keys ``r2d2_*`` (``_local_loop``) and the LSTM's width."""
    dev = resolve_device(device)
    algo = r2d2_config(dev).build()
    out = _local_loop("r2d2", algo, dev,
                      timed or (40 if dev.type == "cuda" else 2), profile,
                      lambda a: a.replay.num_steps)
    out.update(r2d2_lstm_size=algo.config["lstm_size"],
               r2d2_seq_len=algo.config["seq_len"],
               r2d2_burn_in=algo.config["burn_in"])
    return out


def slateq_loop(device="cuda", profile=None, timed=None) -> dict:
    """SlateQ throughput through ``Algorithm.step`` (``slateq_config``):
    20 timed iterations on ``cuda``, 2 on ``cpu``. Keys ``slateq_*``
    (``_local_loop``) and the env's sizes."""
    dev = resolve_device(device)
    algo = slateq_config(dev).build()
    out = _local_loop("slateq", algo, dev,
                      timed or (20 if dev.type == "cuda" else 2), profile,
                      lambda a: len(a.replay))
    out.update(slateq_num_docs=algo.num_docs, slateq_slate_size=algo.k,
               slateq_num_topics=algo.env.num_topics,
               slateq_hidden=algo.config["hidden"])
    return out


def qmix_config(device="cuda"):
    """QMIX on CoopCartPole with 2 agents at the JAX ``QMixConfig``'s
    defaults: agent net 64 x 64, mixer embedding 32, double-Q, 64 env
    steps and 2 updates of 64 rows an iteration past 500 rows, a target
    sync every 400 steps, epsilon over 8,000, a 50,000-row buffer. On
    ``cpu``: 64 rows before learning, batch 16, a target sync every 64."""
    from ray_tpu_torch.rllib.algorithms import QMixConfig
    dev = resolve_device(device)
    config = QMixConfig()
    if dev.type == "cpu":
        config.training(learning_starts=64, train_batch_size=16,
                        target_network_update_freq=64)
    return (config.environment("CoopCartPole", env_config={"num_agents": 2})
            .resources(device=str(dev)).debugging(seed=0))


def maddpg_config(device="cuda"):
    """MADDPG on MultiAgentTarget1D with 2 agents at the JAX
    ``MADDPGConfig``'s defaults: actors and centralized critics 64 x 64,
    stacked over the agents; 50 env steps and 2 updates of 128 rows an
    iteration past 500 rows, Polyak tau 0.01, exploration noise 0.3. On
    ``cpu``: 50 rows before learning, batch 16."""
    from ray_tpu_torch.rllib.algorithms import MADDPGConfig
    dev = resolve_device(device)
    config = MADDPGConfig()
    if dev.type == "cpu":
        config.training(learning_starts=50, train_batch_size=16)
    return (config.environment("MultiAgentTarget1D",
                               env_config={"num_agents": 2})
            .resources(device=str(dev)).debugging(seed=0))


def qmix_loop(device="cuda", profile=None, timed=None) -> dict:
    """QMIX throughput through ``Algorithm.step`` (``qmix_config``): 100
    timed iterations on ``cuda``, 2 on ``cpu``. Keys ``qmix_*``
    (``_local_loop``) and the agents and widths."""
    dev = resolve_device(device)
    algo = qmix_config(dev).build()
    out = _local_loop("qmix", algo, dev,
                      timed or (100 if dev.type == "cuda" else 2), profile,
                      lambda a: len(a.replay))
    out.update(qmix_agents=algo.n_agents,
               qmix_agent_hidden=algo.config["agent_hidden"],
               qmix_mixer_embed=algo.config["mixer_embed"])
    return out


def maddpg_loop(device="cuda", profile=None, timed=None) -> dict:
    """MADDPG throughput through ``Algorithm.step`` (``maddpg_config``):
    50 timed iterations on ``cuda``, 2 on ``cpu``. Keys ``maddpg_*``
    (``_local_loop``: no epsilon, no hard sync; ``maddpg_target_moved``
    is Polyak's) and the agents."""
    dev = resolve_device(device)
    algo = maddpg_config(dev).build()
    out = _local_loop("maddpg", algo, dev,
                      timed or (50 if dev.type == "cuda" else 2), profile,
                      lambda a: len(a.replay))
    out.update(maddpg_agents=algo.n, maddpg_tau=algo.config["tau"])
    return out


def _meta_loop(prefix, algo, dev, timed, profile, gather,
               rows=None) -> dict:
    """MAML or MBMPO through ``Algorithm.step``: one warm-up iteration,
    then ``timed`` ones. Keys ``{prefix}_*``: env steps/s (median and
    whole), meta-updates/s (one an iteration: the median of 1 / the
    iteration's time), the timers' medians and split, the meta-loss
    first and last, weights that moved, launches (read, not zeroed),
    peak memory; with ``rows(algo)`` (a real buffer), its rows after
    the warm-up and after the timed iterations. ``profile``: a function
    called with one learn phase, a meta-update on the pre/post batches
    that ``gather(algo)`` collects after the timed iterations."""
    from ray_tpu_torch.rllib.policy import stats_to_host, weights_of
    w0 = weights_of(algo.model)
    t0 = time.perf_counter()
    warm = algo.step()
    warmup_s = time.perf_counter() - t0
    rows0 = rows(algo) if rows else None
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    before = kernels.launch_counts()
    runs, secs = [], []
    for _ in range(timed):
        t0 = time.perf_counter()
        runs.append(algo.step())
        secs.append(time.perf_counter() - t0)
    launches = _launches_since(before)
    losses = [r["learner/meta_loss"] for r in runs]
    steps = sum(r["num_env_steps_sampled_this_iter"] for r in runs)
    totals = {k: float(sum(r["timers"][k] for r in runs))
              for k in runs[0]["timers"]}
    out = {
        f"{prefix}_platform": dev.type,
        f"{prefix}_device_kind": _device_kind(dev),
        f"{prefix}_env_steps_per_iter":
            runs[-1]["num_env_steps_sampled_this_iter"],
        f"{prefix}_iters_timed": timed, f"{prefix}_warmup_s": warmup_s,
        f"{prefix}_env_steps_per_sec": _median(runs, "env_steps_per_sec"),
        f"{prefix}_env_steps_per_sec_whole": steps / sum(secs),
        f"{prefix}_meta_updates_per_sec": float(np.median(
            [1.0 / s for s in secs])),
        **{f"{prefix}_{k}": _median(runs, k, "timers")
           for k in runs[0]["timers"]},
        f"{prefix}_split": {k: v / sum(totals.values())
                            for k, v in totals.items()},
        f"{prefix}_meta_loss": [warm["learner/meta_loss"], losses[-1]],
        f"{prefix}_losses_finite": bool(np.all(np.isfinite(
            losses + [r["learner/grad_norm"] for r in runs]))),
        f"{prefix}_weights_moved": _moved(w0, weights_of(algo.model)),
        f"{prefix}_launches": launches,
        "warm": warm, "runs": runs,
    }
    if rows:
        out[f"{prefix}_buffer_rows"] = [rows0, rows(algo)]
    if dev.type == "cuda":
        out[f"{prefix}_max_memory_allocated_bytes"] = (
            torch.cuda.max_memory_allocated(dev))
    if profile is not None:
        pre, post = gather(algo)
        out[f"{prefix}_profile"] = profile(
            lambda: stats_to_host(algo._meta_update(pre, post)))
    return out


def maml_loop(device="cuda", profile=None, timed=None) -> dict:
    """MAML at the JAX ``MAMLConfig``'s defaults on the point-goal task
    family: policy 64 x 64 tanh, 10 tasks x 10 episodes x 20 steps x
    (pre + post) = 4,000 env steps, 10 inner adaptations and one
    second-order meta-update an iteration; 5 timed iterations on
    ``cuda``, 1 on ``cpu`` (2 tasks x 2 episodes). Keys ``maml_*``
    (``_meta_loop``) and the adaptation gap of the first and last
    iteration."""
    from ray_tpu_torch.rllib.algorithms import MAMLConfig
    dev = resolve_device(device)
    config = MAMLConfig()
    if dev.type == "cpu":
        config.training(meta_batch_size=2, episodes_per_task=2)
    algo = config.resources(device=str(dev)).debugging(seed=0).build()
    cfg = algo.config

    def gather(a):
        pre_b, post_b = [], []
        for _ in range(cfg["meta_batch_size"]):
            goal = a.env.sample_task(a._np_rng)
            pre, _ = a._collect_task(a.params, goal)
            post, _ = a._collect_task(a._adapt(a.params, pre), goal)
            pre_b.append(pre)
            post_b.append(post)
        return pre_b, post_b

    out = _meta_loop("maml", algo, dev, timed or (5 if dev.type == "cuda"
                                                  else 1), profile, gather)
    warm, runs = out.pop("warm"), out.pop("runs")
    out.update(maml_tasks=cfg["meta_batch_size"],
               maml_episodes_per_task=cfg["episodes_per_task"],
               maml_hidden=cfg["hidden"],
               maml_adaptation_gap=[warm["adaptation_gap"],
                                    runs[-1]["adaptation_gap"]])
    algo.cleanup()
    return out


def mbmpo_loop(device="cuda", profile=None, timed=None) -> dict:
    """MBMPO at the JAX ``MBMPOConfig``'s defaults on the point-goal
    dynamics: an ensemble of K = 4 dynamics models 64 x 64 (stacked),
    an iteration of 16 real episodes of 20 steps, 60 model updates of 4
    x 256 bootstrap rows, 4 x 2 imaginations of 16 episodes x 20 steps,
    4 adaptations and one second-order meta-update; 10 timed iterations
    on ``cuda``, 1 on ``cpu`` (5 model updates, 2 real and 4 imagined
    episodes). Keys ``mbmpo_*`` (``_meta_loop``): the model loss of the
    untrained and of the final ensemble on one bootstrap draw of the
    final buffer (``mbmpo_model_loss``), the last update's loss of the
    warm-up and of the last iteration (``mbmpo_model_fit_loss``), the
    real and imagined rewards of the last iteration."""
    from ray_tpu_torch.rllib.algorithms import MBMPOConfig
    dev = resolve_device(device)
    config = MBMPOConfig()
    if dev.type == "cpu":
        config.training(model_train_iters=5, real_episodes_per_iter=2,
                        imagined_episodes=4)
    algo = config.resources(device=str(dev)).debugging(seed=0).build()
    cfg = algo.config
    untrained = copy.deepcopy(algo.dynamics)

    def gather(a):
        pre_b, post_b = [], []
        for k in range(cfg["ensemble_size"]):
            pre, _ = a._imagine(a.params, k)
            post, _ = a._imagine(a._adapt(a.params, pre), k)
            pre_b.append(pre)
            post_b.append(post)
        return pre_b, post_b

    out = _meta_loop("mbmpo", algo, dev, timed or (10 if dev.type == "cuda"
                                                   else 1), profile, gather,
                     rows=lambda a: len(a._buf_obs))
    warm, runs = out.pop("warm"), out.pop("runs")
    n = len(algo._buf_obs)
    idx = np.random.default_rng(1).integers(
        0, n, size=(cfg["ensemble_size"], min(n, 256)))
    held = (algo._buf_obs[idx], algo._buf_act[idx], algo._buf_next[idx])
    with torch.no_grad():
        held_loss = [float(algo._model_loss(d, *held))
                     for d in (untrained, algo.dynamics)]
    out.update(mbmpo_ensemble_size=cfg["ensemble_size"],
               mbmpo_hidden=cfg["hidden"],
               mbmpo_model_train_iters=cfg["model_train_iters"],
               mbmpo_model_loss=held_loss,
               mbmpo_model_fit_loss=[warm["model_loss"],
                                     runs[-1]["model_loss"]],
               mbmpo_real_reward_mean=runs[-1]["real_reward_mean"],
               mbmpo_imagined_reward_mean=runs[-1]["imagined_reward_mean"])
    algo.cleanup()
    return out


def write_cartpole_dataset(path, episodes=120, steps=120, seed=0) -> dict:
    """The offline CartPole set, written by the port's ``JsonWriter`` to
    ``path`` as one batch: ``episodes`` episodes (reset seeds 0, 1, ...)
    capped at ``steps`` steps of the JAX package's DT fixture's noisy
    heuristic (``tests/test_rllib_dt.py``): push toward the pole's lean
    (angle + 0.4 angular velocity), replaced by a uniform action with
    probability 0.6 on odd episodes and 0.15 on even ones, from
    ``np.random.default_rng(seed)``. Returns the rows and the episodes'
    mean and best return."""
    from ray_tpu_torch.rllib.env import CartPoleEnv
    from ray_tpu_torch.rllib.offline import JsonWriter
    from ray_tpu_torch.rllib.sample_batch import SampleBatch as SB
    rng = np.random.default_rng(seed)
    env = CartPoleEnv({"seed": seed})
    cols = {k: [] for k in ("obs", "act", "rew", "done")}
    rets = []
    for ep in range(episodes):
        o, _ = env.reset(seed=ep)
        tot = 0.0
        noise = 0.6 if ep % 2 else 0.15
        for t in range(steps):
            a = int(o[2] + 0.4 * o[3] > 0)
            if rng.random() < noise:
                a = int(rng.integers(2))
            no, r, term, trunc, _ = env.step(a)
            ended = term or trunc or t == steps - 1
            for k, v in zip(cols, (o, a, r, ended)):
                cols[k].append(v)
            o = no
            tot += r
            if ended:
                break
        rets.append(tot)
    w = JsonWriter(path)
    w.write(SB({SB.OBS: np.asarray(cols["obs"], np.float32),
                SB.ACTIONS: np.asarray(cols["act"], np.int64),
                SB.REWARDS: np.asarray(cols["rew"], np.float32),
                SB.DONES: np.asarray(cols["done"], bool)}))
    w.close()
    return {"rows": len(cols["obs"]), "mean_return": float(np.mean(rets)),
            "best_return": float(np.max(rets))}


def dt_loop(device="cuda", profile=None, timed=None) -> dict:
    """DT learn-step throughput through ``Algorithm.step``: the JAX
    ``DTConfig``'s defaults (context 8 = 24 tokens, width 64, 4 heads, 2
    layers, batch 64, 20 learn steps an iteration, AdamW 1e-3 after a
    clip at 1) on the offline CartPole set (``write_cartpole_dataset``:
    120 episodes capped at 120 steps; 12 on ``cpu``, with batch 8 and 2
    learn steps an iteration) written to a temporary directory and read
    back; one warm-up iteration, then ``timed`` ones (10 on ``cuda``, 1
    on ``cpu``). Keys ``dt_*``: learn steps/s (median over the timed
    iterations), the draw / learn split, the NLL first and last, the
    action accuracy, weights that moved, launches (read, not zeroed),
    peak memory. ``profile``: a function called with one iteration."""
    import tempfile
    from ray_tpu_torch.rllib.algorithms import DTConfig
    from ray_tpu_torch.rllib.policy import weights_of
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    timed = timed or (10 if cuda else 1)
    config = DTConfig()
    if not cuda:
        config.training(train_batch_size=8, num_iters_per_step=2)
    out = {"dt_platform": dev.type, "dt_device_kind": _device_kind(dev)}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        data = write_cartpole_dataset(tmp, episodes=120 if cuda else 12)
        out["dt_write_s"] = time.perf_counter() - t0
        out.update({f"dt_data_{k}": v for k, v in data.items()})
        algo = (config.environment("CartPole-v1")
                .offline_data(input_path=tmp)
                .resources(device=str(dev)).debugging(seed=0).build())
    cfg = algo.config
    w0 = weights_of(algo.model)
    t0 = time.perf_counter()
    algo.step()
    out["dt_warmup_s"] = time.perf_counter() - t0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    before = kernels.launch_counts()
    runs, secs = [], []
    for _ in range(timed):
        t0 = time.perf_counter()
        runs.append(algo.step())
        secs.append(time.perf_counter() - t0)
    launches = _launches_since(before)
    per_iter = cfg["num_iters_per_step"]
    nll = [r["learner/action_nll"] for r in runs]
    totals = {k: float(sum(r["timers"][k] for r in runs))
              for k in runs[0]["timers"]}
    out.update({
        "dt_context_length": cfg["context_length"],
        "dt_embed_dim": cfg["embed_dim"], "dt_num_heads": cfg["num_heads"],
        "dt_num_layers": cfg["num_layers"],
        "dt_train_batch_size": cfg["train_batch_size"],
        "dt_learn_steps_per_iter": per_iter, "dt_iters_timed": timed,
        "dt_episodes": len(algo._ep_lengths),
        "dt_learn_steps_per_sec": float(np.median(
            [per_iter / s for s in secs])),
        **{f"dt_{k}": _median(runs, k, "timers") for k in runs[0]["timers"]},
        "dt_split": {k: v / sum(totals.values()) for k, v in totals.items()},
        "dt_action_nll": [nll[0], nll[-1]],
        "dt_losses_finite": bool(np.all(np.isfinite(nll))),
        "dt_action_acc": runs[-1]["learner/action_acc"],
        "dt_target_return": algo.target_return,
        "dt_weights_moved": _moved(w0, weights_of(algo.model)),
        "dt_launches": launches,
    })
    if cuda:
        out["dt_max_memory_allocated_bytes"] = (
            torch.cuda.max_memory_allocated(dev))
    if profile is not None:
        out["dt_profile"] = profile(algo.training_step)
    algo.cleanup()
    return out


def bandit_loop(timed=None) -> dict:
    """LinUCB and LinTS at the JAX configs' defaults (8 features, 4
    arms, 32 env steps and one exact ridge update an iteration) through
    ``Algorithm.step``, on the host: the reference keeps them numpy and
    so does the port, so there is no device. ``timed`` iterations (50)
    after one warm-up; keys ``bandit_{linucb,lints}_*``: env steps/s
    (median and whole), the mean reward of the first and the last
    iteration."""
    from ray_tpu_torch.rllib.algorithms import (BanditLinTSConfig,
                                                BanditLinUCBConfig)
    timed = timed or 50
    out = {}
    for name, config in (("linucb", BanditLinUCBConfig),
                         ("lints", BanditLinTSConfig)):
        algo = config().debugging(seed=0).build()
        first = algo.step()
        t0 = time.perf_counter()
        runs = [algo.step() for _ in range(timed)]
        timed_s = time.perf_counter() - t0
        steps = sum(r["num_env_steps_sampled_this_iter"] for r in runs)
        policy = algo.get_policy()
        out.update({
            f"bandit_{name}_env_steps_per_iter":
                runs[-1]["num_env_steps_sampled_this_iter"],
            f"bandit_{name}_arms": policy.k,
            f"bandit_{name}_feature_dim": policy.d,
            f"bandit_{name}_iters_timed": timed,
            f"bandit_{name}_env_steps_per_sec":
                _median(runs, "env_steps_per_sec"),
            f"bandit_{name}_env_steps_per_sec_whole": steps / timed_s,
            f"bandit_{name}_mean_reward": [first["learner/mean_reward"],
                                           runs[-1]["learner/mean_reward"]],
        })
        algo.cleanup()
    return out


def _timed_iters(algo, dev, timed, step=None):
    """One warm-up iteration, then ``timed`` ones, each through
    ``step`` (``algo.step``): (warm-up result, the timed results, their
    host seconds, the warm-up's seconds, the kernels' launches in the
    timed ones, read and not zeroed). Peak memory restarts after the
    warm-up."""
    step = step or algo.step
    t0 = time.perf_counter()
    warm = step()
    warmup_s = time.perf_counter() - t0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    before = kernels.launch_counts()
    runs, secs = [], []
    for _ in range(timed):
        t0 = time.perf_counter()
        runs.append(step())
        secs.append(time.perf_counter() - t0)
    return warm, runs, secs, warmup_s, _launches_since(before)


def _loop_keys(prefix, dev, runs, secs, warmup_s, launches, steps_key):
    """The keys every one of the later loops reports: the device, the
    timed iterations, env steps/s (the median of steps / the
    iteration's host time, and the whole window's), the timers' medians
    and their split, launches, peak memory."""
    totals = {k: float(sum(r["timers"][k] for r in runs))
              for k in runs[0]["timers"]}
    steps = [r[steps_key] for r in runs]
    out = {
        f"{prefix}_platform": dev.type,
        f"{prefix}_device_kind": _device_kind(dev),
        f"{prefix}_iters_timed": len(runs), f"{prefix}_warmup_s": warmup_s,
        f"{prefix}_env_steps_per_iter": steps[-1],
        f"{prefix}_env_steps_per_sec": float(np.median(
            [n / s for n, s in zip(steps, secs)])),
        f"{prefix}_env_steps_per_sec_whole": sum(steps) / sum(secs),
        **{f"{prefix}_{k}": _median(runs, k, "timers")
           for k in runs[0]["timers"]},
        f"{prefix}_split": {k: v / sum(totals.values())
                            for k, v in totals.items()},
        f"{prefix}_launches": launches,
    }
    if dev.type == "cuda":
        out[f"{prefix}_max_memory_allocated_bytes"] = (
            torch.cuda.max_memory_allocated(dev))
    return out


def dreamer_config(device="cuda"):
    """Dreamer on Pendulum-v1 at the JAX ``DreamerConfig``'s defaults:
    RSSM deter 64, stoch 8, hidden 64; 24 sequences of 16 steps an
    update, imagination horizon 10; 1,000 prefill steps (noise 1.0),
    then 200 env steps (noise 0.3) and 20 updates an iteration. On
    ``cpu``: widths 16 / 4 / 16, 4 sequences of 8, horizon 4, 200
    prefill steps (one whole episode), then 50 env steps and 2 updates."""
    from ray_tpu_torch.rllib.algorithms import DreamerConfig
    dev = resolve_device(device)
    config = DreamerConfig()
    if dev.type == "cpu":
        config.training(deter_size=16, stoch_size=4, hidden=16, batch_size=4,
                        seq_len=8, imagine_horizon=4, prefill_steps=200,
                        rollout_fragment_length=50,
                        train_steps_per_iteration=2)
    return config.resources(device=str(dev)).debugging(seed=0)


def dreamer_loop(device="cuda", profile=None, timed=None) -> dict:
    """Dreamer throughput through ``Algorithm.step`` (``dreamer_config``):
    the prefill iteration, one warm-up iteration (``dreamer_warmup_s``),
    then ``timed`` ones (5 on ``cuda``, 1 on ``cpu``). Keys
    ``dreamer_*`` (``_loop_keys``),
    updates/s (an iteration's updates over its learn time, median), the
    reported losses of the warm-up and the last iteration, the
    reconstruction loss of one held sequence batch (drawn after the
    warm-up, fixed noise) under the world model before and after the
    timed window (``dreamer_recon_loss``), finite losses, weights that
    moved, the widths. ``profile``: a function called with one learn
    phase (``train_steps_per_iteration`` updates on sequence draws, then
    the stats to the host)."""
    from ray_tpu_torch.rllib.policy import stats_to_host
    dev = resolve_device(device)
    algo = dreamer_config(dev).build()
    cfg = algo.config
    w0 = algo._weights()
    warm = algo.step()
    held = algo._sample_sequences()
    held_noise = algo._draw_noise("update")

    @torch.no_grad()
    def recon():
        obs = torch.as_tensor(held["obs"], device=algo.device)
        feat, _ = algo.wm.observe(obs, torch.as_tensor(
            held["prev_actions"], device=algo.device), held_noise["obs"])
        return float(torch.mean(torch.sum((algo.wm.decode(feat) - obs) ** 2,
                                          -1)))

    recon0 = recon()
    _, runs, secs, warmup_s, launches = _timed_iters(
        algo, dev, timed or (5 if dev.type == "cuda" else 1))
    out = _loop_keys("dreamer", dev, runs, secs, warmup_s, launches,
                     "num_env_steps_sampled_this_iter")
    names = ("model_loss", "recon_loss", "reward_loss", "kl", "actor_loss",
             "value_loss")
    last = runs[-1]
    n_upd = cfg["train_steps_per_iteration"]
    out.update({
        "dreamer_env": cfg["env"], "dreamer_deter_size": cfg["deter_size"],
        "dreamer_stoch_size": cfg["stoch_size"],
        "dreamer_hidden": cfg["hidden"],
        "dreamer_batch_size": cfg["batch_size"],
        "dreamer_seq_len": cfg["seq_len"],
        "dreamer_imagine_horizon": cfg["imagine_horizon"],
        "dreamer_prefill_steps": cfg["prefill_steps"],
        "dreamer_updates_per_iter": n_upd,
        "dreamer_updates_per_sec": float(np.median(
            [n_upd / (r["timers"]["learn_time_ms"] / 1e3) for r in runs])),
        "dreamer_losses": {k: [warm[f"learner/{k}"], last[f"learner/{k}"]]
                           for k in names},
        "dreamer_losses_finite": bool(np.all(np.isfinite(
            [r[f"learner/{k}"] for r in [warm] + runs for k in names]))),
        "dreamer_recon_loss": [recon0, recon()],
        "dreamer_episodes": last["num_episodes"],
        "dreamer_episode_reward_mean": last["episode_reward_mean"],
        "dreamer_weights_moved": max(
            _moved(w0[k], w) for k, w in algo._weights().items()),
    })
    if profile is not None:
        def learn():
            for _ in range(n_upd):
                stats = algo._update(algo._sample_sequences())
            return stats_to_host(stats)
        out["dreamer_profile"] = profile(learn)
    algo.cleanup()
    return out


def alphazero_loop(device="cuda", profile=None, timed=None) -> dict:
    """AlphaZero on TicTacToe at the JAX ``AlphaZeroConfig``'s defaults:
    24 self-play games of 25 PUCT simulations an iteration (one net
    evaluation of one position a node, read back to the host), then 8
    Adam steps of 256 replay rows, net 128 x 128; one warm-up iteration,
    then ``timed`` ones (3 on ``cuda``, 1 on ``cpu``, where the games are
    4 of 8 simulations and the steps 2 of 32 rows). Keys ``alphazero_*``
    (``_loop_keys``: env steps are the positions played), net
    evaluations/s over the search time, the total loss of the warm-up
    and the last iteration, finite losses, weights that moved, the
    replay's size. ``profile``: a function called with one learn phase
    (``sgd_iters`` updates on replay draws, then the stats)."""
    from ray_tpu_torch.rllib.algorithms import AlphaZeroConfig
    from ray_tpu_torch.rllib.policy import stats_to_host, weights_of
    dev = resolve_device(device)
    config = AlphaZeroConfig()
    if dev.type == "cpu":
        config.training(games_per_iteration=4, num_sims=8, sgd_iters=2,
                        train_batch_size=32)
    algo = config.resources(device=str(dev)).debugging(seed=0).build()
    cfg = algo.config
    w0 = weights_of(algo.model)
    evals = []

    def step():
        e0 = algo.evaluations
        r = algo.step()
        evals.append(algo.evaluations - e0)
        return r

    warm, runs, secs, warmup_s, launches = _timed_iters(
        algo, dev, timed or (3 if dev.type == "cuda" else 1), step)
    out = _loop_keys("alphazero", dev, runs, secs, warmup_s, launches,
                     "num_env_steps_sampled_this_iter")
    losses = [r["learner/total_loss"] for r in [warm] + runs]
    out.update({
        "alphazero_env": cfg["env"],
        "alphazero_games_per_iter": cfg["games_per_iteration"],
        "alphazero_num_sims": cfg["num_sims"],
        "alphazero_train_batch_size": cfg["train_batch_size"],
        "alphazero_sgd_iters": cfg["sgd_iters"],
        "alphazero_hidden": cfg["hidden"],
        "alphazero_evals_per_iter": evals[-1],
        "alphazero_evals_per_sec": float(np.median(
            [n / (r["timers"]["search_time_ms"] / 1e3)
             for n, r in zip(evals[1:], runs)])),
        "alphazero_total_loss": [losses[0], losses[-1]],
        "alphazero_losses_finite": bool(np.all(np.isfinite(losses))),
        "alphazero_replay_size": runs[-1]["replay_size"],
        "alphazero_weights_moved": _moved(w0, weights_of(algo.model)),
    })
    if profile is not None:
        def learn():
            n = len(algo._replay)
            for _ in range(cfg["sgd_iters"]):
                idx = algo._np_rng.integers(
                    0, n, min(cfg["train_batch_size"], n))
                stats = algo._update(
                    np.stack([algo._replay[i][0] for i in idx]),
                    np.stack([algo._replay[i][1] for i in idx]),
                    np.asarray([algo._replay[i][2] for i in idx],
                               np.float32))
            return stats_to_host(stats)
        out["alphazero_profile"] = profile(learn)
    algo.cleanup()
    return out


def alphastar_loop(device="cuda", profile=None, timed=None) -> dict:
    """AlphaStar's league on TicTacToe at the JAX ``AlphaStarConfig``'s
    defaults: main, one main exploiter, one league exploiter (nets 64 x
    64, an Adam each), 64 matches an iteration (PFSP matchmaking, one
    REINFORCE update per game), a snapshot of main every 10 iterations,
    then 4 + 20 evaluation games against a random player; one warm-up
    iteration, then ``timed`` ones (10 on ``cuda``, so that the 10th
    iteration's snapshot falls inside the window and the 11th updates
    main after it; 2 on ``cpu`` with 8 matches and a snapshot every 2
    iterations). Keys ``alphastar_*`` (``_loop_keys``: env steps are
    games), games/s, the league before and after, how far main moved
    from the newest snapshot by the end (``alphastar_snapshot_gap``),
    each learner's last loss, finite losses, weights that moved (main),
    the win rate against a random player. ``profile``: a function called
    with one learn phase (one update of each learner on a game it plays
    against itself, then the losses to the host)."""
    from ray_tpu_torch.rllib.algorithms import AlphaStarConfig
    from ray_tpu_torch.rllib.algorithms.alpha_star import HISTORICAL, MAIN
    from ray_tpu_torch.rllib.policy import stats_to_host, weights_of
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    config = AlphaStarConfig()
    if not cuda:
        config.training(matches_per_iter=8, snapshot_interval=2)
    algo = config.resources(device=str(dev)).debugging(seed=0).build()
    cfg = algo.config
    w0 = weights_of(algo.model)
    warm, runs, secs, warmup_s, launches = _timed_iters(
        algo, dev, timed or (10 if cuda else 2))
    out = _loop_keys("alphastar", dev, runs, secs, warmup_s, launches,
                     "episodes_this_iter")
    hist = sorted((p for p in algo.league.values()
                   if p.ptype == HISTORICAL),
                  key=lambda p: int(p.pid.rsplit("_", 1)[-1]))
    losses = stats_to_host(algo.last_losses)
    main = weights_of(algo.league[MAIN].params)
    out.update({
        "alphastar_env": cfg["env"], "alphastar_hidden": cfg["hidden"],
        "alphastar_matches_per_iter": cfg["matches_per_iter"],
        "alphastar_snapshot_interval": cfg["snapshot_interval"],
        "alphastar_games_per_sec": out["alphastar_env_steps_per_sec"],
        "alphastar_league_size": [warm["league_size"],
                                  runs[-1]["league_size"]],
        "alphastar_num_historical": [warm["num_historical"],
                                     runs[-1]["num_historical"]],
        "alphastar_snapshot_gap": (_moved(weights_of(hist[-1].params), main)
                                   if hist else None),
        "alphastar_last_losses": losses,
        "alphastar_losses_finite": bool(np.all(np.isfinite(
            list(losses.values())))),
        "alphastar_weights_moved": _moved(w0, main),
        "alphastar_main_vs_random_win_rate":
            runs[-1]["main_vs_random_win_rate"],
    })
    if profile is not None:
        def learn():
            for pid, p in algo.league.items():
                if p.learnable:
                    out_a, ta, _ = algo._play_game(p.params, p.params)
                    algo._learn_from(pid, ta, out_a)
            return stats_to_host(algo.last_losses)
        out["alphastar_profile"] = profile(learn)
    algo.cleanup()
    return out


def ma_ppo_config(device="cuda"):
    """PPO on MultiAgentCartPole with 2 agents and 2 policies (agent_0
    -> pol_a, agent_1 -> pol_b) at tests/test_rllib_multiagent.py:59's
    settings: fragments of 64, a train batch of 512 env steps, minibatch
    128 x 6 epochs, lr 4e-3, seed 1, the default 256 x 256 tanh nets. On
    ``cpu``: fragments of 32, a batch of 64, minibatch 32 x 1, nets 32
    x 32."""
    from ray_tpu_torch.rllib.algorithms import PPOConfig
    dev = resolve_device(device)
    config = (PPOConfig().environment("MultiAgentCartPole",
                                      env_config={"num_agents": 2})
              .rollouts(num_workers=0, rollout_fragment_length=64)
              .training(train_batch_size=512, sgd_minibatch_size=128,
                        num_sgd_iter=6, lr=4e-3)
              .multi_agent(policies={"pol_a": {}, "pol_b": {}},
                           policy_mapping_fn=_ma_mapping))
    if dev.type == "cpu":
        config.rollouts(rollout_fragment_length=32).training(
            train_batch_size=64, sgd_minibatch_size=32, num_sgd_iter=1,
            model={"fcnet_hiddens": [32, 32]})
    return config.resources(device=str(dev)).debugging(seed=1)


def _ma_mapping(aid, **_kw):
    return "pol_a" if aid == "agent_0" else "pol_b"


def ma_ppo_loop(device="cuda", profile=None, timed=None) -> dict:
    """Multi-agent PPO throughput through ``Algorithm.step``
    (``ma_ppo_config``): one warm-up iteration, then ``timed`` ones (5
    on ``cuda``, 1 on ``cpu``). Keys ``ma_ppo_*`` (``_loop_keys``), agent
    steps/s (the agents' rows of each iteration's samples over its host
    time, median), the policies in the learner info, each policy's total
    loss of the warm-up and the last iteration, finite losses, weights
    that moved (both policies), the episode reward. ``profile``: a
    function called with one learn phase (``_sgd_epochs`` of each policy
    on a fresh train batch)."""
    from ray_tpu_torch.rllib import synchronous_parallel_sample
    dev = resolve_device(device)
    algo = ma_ppo_config(dev).build()
    cfg = algo.config
    lw = algo.workers.local_worker
    w0 = lw.get_weights()
    agent_steps = []
    sample = lw.sample

    def counting():
        b = sample()
        agent_steps[-1] += b.agent_steps()
        return b

    lw.sample = counting

    def step():
        agent_steps.append(0)
        return algo.step()

    warm, runs, secs, warmup_s, launches = _timed_iters(
        algo, dev, timed or (5 if dev.type == "cuda" else 1), step)
    out = _loop_keys("ma_ppo", dev, runs, secs, warmup_s, launches,
                     "num_env_steps_sampled_this_iter")
    pids = sorted(lw.policy_map)
    losses = {pid: [r["info"]["learner"][pid]["total_loss"]
                    for r in [warm] + runs] for pid in pids}
    w1 = lw.get_weights()
    out.update({
        "ma_ppo_env": cfg["env"], "ma_ppo_agents": 2,
        "ma_ppo_train_batch_size": cfg["train_batch_size"],
        "ma_ppo_sgd_minibatch_size": cfg["sgd_minibatch_size"],
        "ma_ppo_num_sgd_iter": cfg["num_sgd_iter"],
        "ma_ppo_agent_steps_per_iter": agent_steps[-1],
        "ma_ppo_agent_steps_per_sec": float(np.median(
            [n / s for n, s in zip(agent_steps[1:], secs)])),
        "ma_ppo_policies": sorted(runs[-1]["info"]["learner"]),
        "ma_ppo_total_loss": {pid: [v[0], v[-1]]
                              for pid, v in losses.items()},
        "ma_ppo_losses_finite": bool(np.all(np.isfinite(
            [x for v in losses.values() for x in v]))),
        "ma_ppo_weights_moved": min(_moved(w0[pid], w1[pid])
                                    for pid in pids),
        "ma_ppo_episode_reward_mean": runs[-1]["episode_reward_mean"],
    })
    if profile is not None:
        batch = synchronous_parallel_sample(
            algo.workers, max_env_steps=cfg["train_batch_size"])
        out["ma_ppo_profile"] = profile(lambda: {
            pid: algo._sgd_epochs(lw.policy_map[pid], b)
            for pid, b in batch.policy_batches.items()})
    algo.cleanup()
    return out


def ckpt_loop(device="cuda", saves: int = 2) -> dict:
    """Checkpoint microbench on the GPT-2 trainer's real state: the JAX
    package's ``bench.py:_ckpt_bench_main`` (how long the train step is
    blocked per save, sync against async), with real steps in place of
    its sleep and the trainer state in place of a numpy tree.

    The trainer of ``gpt2_loop`` (``gpt2_train_shape``) takes 2 warm-up
    steps and 5 timed ones (each closed by a host read of the loss: the
    step time without a write). Then, for each mode (``sync``:
    ``async_=False``, the write and commit inline; ``async``), ``saves``
    times: a step, a save of the state into a fresh
    ``CheckpointManager`` (fsync on, num_to_keep 2, in a temporary
    directory removed after), then steps until the write has landed (at
    most 80: on the card a write and commit take ~5.5 s), each timed; an async step that ends
    with the write still in flight counts as a step with a write in
    flight. Reports per mode the blocked, snapshot, write and commit ms
    a save (means; blocked also save by save: the first one allocates
    the checkpointer's pinned staging buffers), bytes a save,
    ``blocked_frac_vs_sync`` and the step times (medians) without a
    write and with one in flight."""
    import shutil
    import tempfile

    from ray_tpu_torch.checkpoint import AsyncCheckpointer, CheckpointManager
    from ray_tpu_torch.train.spmd import make_causal_lm_trainer, put_batch

    dev = resolve_device(device)
    cfg, batch, seq = gpt2_train_shape(dev)
    trainer = make_causal_lm_trainer(cfg, device=dev)
    state = trainer.init(0)
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (batch, seq), dtype=np.int32)
    resident = put_batch(trainer, {"input_ids": tokens, "labels": tokens})

    def step() -> float:
        t0 = time.perf_counter()
        float(trainer.step(state, resident)[1]["loss"])
        return (time.perf_counter() - t0) * 1e3

    for _ in range(2):
        step()
    out = {"ckpt_model": "gpt2", "ckpt_n_layer": cfg.n_layer,
           "ckpt_batch": batch, "ckpt_seq_len": seq, "ckpt_saves": saves,
           "ckpt_step_ms_no_write": float(np.median([step()
                                                     for _ in range(5)])),
           "ckpt_device_kind": _device_kind(dev)}
    in_flight_ms = []
    for mode in ("sync", "async"):
        base = tempfile.mkdtemp(prefix=f"ckpt_bench_{mode}_")
        try:
            mgr = CheckpointManager(base, num_to_keep=2)
            ck = AsyncCheckpointer(mgr, async_=mode == "async")
            for _ in range(saves):
                step()
                saved = state["step"]
                ck.save(saved, state)
                for _ in range(80):
                    if not ck.in_flight():
                        break
                    ms = step()
                    if ck.in_flight():
                        in_flight_ms.append(ms)
            ck.finalize()
            if mgr.latest_committed() != saved:
                raise RuntimeError(f"{mode}: step {saved} is not the "
                                   "latest committed")
            for k in ("blocked_ms", "snapshot_ms", "write_ms", "commit_ms"):
                out[f"ckpt_{mode}_{k}_per_save"] = float(np.mean(
                    [getattr(st, k) for st in ck.stats]))
            # the first save also allocates the pinned staging buffers
            out[f"ckpt_{mode}_blocked_ms_by_save"] = [st.blocked_ms
                                                      for st in ck.stats]
            out["ckpt_bytes_per_save"] = ck.stats[-1].bytes
            out["ckpt_files_per_save"] = ck.stats[-1].files
        finally:
            shutil.rmtree(base, ignore_errors=True)
    out["ckpt_blocked_frac_vs_sync"] = (
        out["ckpt_async_blocked_ms_per_save"]
        / max(out["ckpt_sync_blocked_ms_per_save"], 1e-9))
    out["ckpt_step_ms_write_in_flight"] = (
        float(np.median(in_flight_ms)) if in_flight_ms else None)
    out["ckpt_steps_with_write_in_flight"] = len(in_flight_ms)
    return out


def _time_calls(obj, name: str, sink: list):
    """Wrap ``obj.name`` (a bound method) so that each call appends its
    host milliseconds to ``sink``."""
    fn = getattr(obj, name)

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            sink.append((time.perf_counter() - t0) * 1e3)
    setattr(obj, name, timed)


def serve_prompts(vocab_size: int, n: int = 16, lo: int = 64,
                  hi: int = 768):
    """``n`` seeded prompts of ``lo``-``hi`` tokens."""
    rng = np.random.RandomState(0)
    return [rng.randint(0, vocab_size, size=k).tolist()
            for k in rng.randint(lo, hi + 1, size=n)]


def disagg_loop(device="cuda", prompts=None, new_tokens: int = 64) -> dict:
    """Prefill/decode disaggregation on one card: two ``LLMServer``s of
    the same GPT-2 (weights from seed 0), one in the prefill role
    (``__llm_prefill__``) and one in the decode role
    (``__llm_adopt__``), against the decode server alone (unified).

    On ``cuda`` GPT-2 small behind chip_smoke.py phase 4's engine
    (16 running, 1,025 pages of 16, max_seq_len 1024) and, unless
    given, ``serve_prompts``' 16 prompts of 64-768 tokens; on ``cpu``
    the tiny GPT-2, 4 prompts of 5-40. Each prompt asks for
    ``new_tokens`` greedy tokens. Runs: (1) unified: every prompt opened
    on the decode server at once, then drained; (2) disaggregated: one
    thread a prompt, each the two hops and then a drain of its stream on
    the decode server; (3) the first prompt once more with one byte of
    its frame flipped, which the decode server re-prefills; (4) each
    prompt alone, unified on the decode server and then through the
    two hops (one row in every prefill and decode step, so both runs
    compute the same shapes and must give the same tokens). Reports the
    handoff bytes a request; export, ship (pickle + CRC), receive (CRC +
    unpickle) and import ms (medians); TTFT: the unified engine's, the
    decode engine's (adoption to first token) and the client's (the
    prefill hop's start to the adoption's return), for runs (1)-(2) and
    alone (4); tokens/s of runs (1) and (2); each server's decode steps,
    the paged-decode launches of run (2) and each pool's used pages at
    the end; the tokens of every run."""
    import threading

    from ray_tpu_torch.serve.llm import LLMServer

    dev = resolve_device(device)
    if dev.type == "cuda":
        from ray_tpu_torch.models.gpt2 import GPT2Config
        model_config = {"config": GPT2Config.small(), "seed": 0}
        engine_config = {"max_running": 16, "max_seq_len": 1024,
                         "block_size": 16, "num_blocks": 1025}
        default = (16, 64, 768)
    else:
        model_config = {"seed": 0, "device": "cpu"}
        engine_config = {"max_running": 4, "max_seq_len": 256,
                         "block_size": 8, "num_blocks": 96}
        default = (4, 5, 40)
    servers = [LLMServer("gpt2", model_config, engine_config)
               for _ in range(2)]
    pre, dec = servers
    vocab = dec.adapter.vocab_size
    if prompts is None:
        prompts = serve_prompts(vocab, *default)

    def drain(server, sid):
        toks, cursor = [], 0
        while True:
            chunk = server.__llm_next__(sid, cursor, max_wait_s=60.0)
            toks += chunk["tokens"]
            cursor = chunk["cursor"]
            if chunk["done"]:
                if chunk.get("error"):
                    raise RuntimeError(f"stream failed: {chunk}")
                return toks, chunk

    def payload(p):
        return {"tokens": p, "max_new_tokens": new_tokens}

    timers = {k: [] for k in ("export", "ship", "receive", "import")}
    try:
        # (1) unified, on the decode server
        t0 = time.perf_counter()
        sids = [dec.__llm_open__(payload(p))["stream_id"] for p in prompts]
        unified = [drain(dec, sid) for sid in sids]
        unified_s = time.perf_counter() - t0
        # (2) disaggregated
        _time_calls(pre.adapter, "export_kv", timers["export"])
        _time_calls(pre._get_shipper(), "ship", timers["ship"])
        _time_calls(dec._get_shipper(), "receive", timers["receive"])
        _time_calls(dec.adapter, "import_kv", timers["import"])
        pre.adapter.decode_steps = dec.adapter.decode_steps = 0
        kernels.reset_launch_counts()
        rows = [None] * len(prompts)
        errors = []

        def request(i):
            try:
                t0 = time.perf_counter()
                h = pre.__llm_prefill__(payload(prompts[i]))
                t1 = time.perf_counter()
                r = dec.__llm_adopt__(h)
                t2 = time.perf_counter()
                toks, chunk = drain(dec, r["stream_id"])
                rows[i] = {"tokens": toks, "adopted": r["adopted"],
                           "bytes": h["kv"]["n"], "prefill_s": t1 - t0,
                           "client_ttft_s": t2 - t0,
                           "decode_ttft_s": chunk["ttft_s"],
                           "done_s": time.perf_counter() - start}
            except BaseException as e:   # raised below, in the caller
                errors.append(e)

        start = time.perf_counter()
        threads = [threading.Thread(target=request, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        disagg_s = time.perf_counter() - start
        if errors:
            raise errors[0]
        launches = kernels.launch_counts().get("paged_attention_decode", 0)
        steps = {"prefill": pre.adapter.decode_steps,
                 "decode": dec.adapter.decode_steps}
        # (3) a corrupted frame: the decode side re-prefills
        h = pre.__llm_prefill__(payload(prompts[0]))
        body = bytearray(h["kv"]["b"])
        body[len(body) // 2] ^= 0xFF
        h["kv"]["b"] = bytes(body)
        r = dec.__llm_adopt__(h)
        reprefill = drain(dec, r["stream_id"])[0]
        # (4) each prompt alone: unified, then the two hops
        solo = {"unified": [], "disagg": [], "unified_ttft_s": [],
                "client_ttft_s": [], "adopted": []}
        for p in prompts:
            toks, chunk = drain(dec, dec.__llm_open__(payload(p))
                                ["stream_id"])
            solo["unified"].append(toks)
            solo["unified_ttft_s"].append(chunk["ttft_s"])
            t0 = time.perf_counter()
            a = dec.__llm_adopt__(pre.__llm_prefill__(payload(p)))
            solo["client_ttft_s"].append(time.perf_counter() - t0)
            solo["adopted"].append(a["adopted"])
            solo["disagg"].append(drain(dec, a["stream_id"])[0])
        pages = {"prefill": pre.engine.metrics()["kv_blocks_used"],
                 "decode": dec.engine.metrics()["kv_blocks_used"]}
    finally:
        for s in servers:
            s.engine.stop()
    n_tok = sum(len(r["tokens"]) for r in rows)
    return {
        "disagg_device_kind": _device_kind(dev),
        "disagg_requests": len(prompts), "disagg_new_tokens": new_tokens,
        "disagg_prompt_tokens": [len(p) for p in prompts],
        "disagg_handoff_bytes": [r["bytes"] for r in rows],
        "disagg_handoff_bytes_mean": float(np.mean([r["bytes"]
                                                    for r in rows])),
        **{f"disagg_{k}_ms_median": float(np.median(v))
           for k, v in timers.items()},
        "disagg_calls": {k: len(v) for k, v in timers.items()},
        "disagg_unified_ttft_s": [c["ttft_s"] for _, c in unified],
        "disagg_decode_ttft_s": [r["decode_ttft_s"] for r in rows],
        "disagg_client_ttft_s": [r["client_ttft_s"] for r in rows],
        "disagg_prefill_hop_s": [r["prefill_s"] for r in rows],
        "disagg_unified_tokens_per_s": n_tok / unified_s,
        "disagg_tokens_per_s": n_tok / disagg_s,
        "disagg_unified_wall_s": unified_s, "disagg_wall_s": disagg_s,
        "disagg_decode_steps": steps, "disagg_paged_decode_launches": launches,
        "disagg_n_layer": dec.adapter.n_layers,
        "disagg_adopted": [r["adopted"] for r in rows],
        "disagg_pages_used_at_end": pages,
        "disagg_tokens": [r["tokens"] for r in rows],
        "disagg_unified_tokens": [t for t, _ in unified],
        "disagg_reprefill_adopted": r["adopted"],
        "disagg_reprefill_tokens": reprefill,
        "disagg_solo_unified_ttft_s": solo["unified_ttft_s"],
        "disagg_solo_client_ttft_s": solo["client_ttft_s"],
        "disagg_solo_adopted": solo["adopted"],
        "disagg_solo_tokens": solo["disagg"],
        "disagg_solo_unified_tokens": solo["unified"],
    }


def probed_server_cls():
    """``LLMServer`` with two more replica methods for ``serve_loop``:
    ``__bench_probe__`` (the process's GPU grant, its kernel libraries
    and launch counts, the adapter's decode steps, the engine's own
    TTFT and ITL quantiles) and ``__bench_reset__`` (zero the counts and
    the engine's latency samples). Built here, not at import, so the
    class travels to the replica by value."""
    from ray_tpu_torch.serve.llm import LLMServer

    class ProbedServer(LLMServer):
        def __bench_probe__(self):
            import ray_tpu_torch
            from ray_tpu_torch import kernels as k
            m = self.engine.metrics()
            return {"gpu_ids": ray_tpu_torch.get_gpu_ids(),
                    "cuda_visible_devices":
                        os.environ.get("CUDA_VISIBLE_DEVICES"),
                    "device": str(self.adapter.device),
                    "pid": os.getpid(),
                    "kernel_libraries": {n: lib._name for n, lib in
                                         k._libs.items()},
                    "launches": k.launch_counts(),
                    "decode_steps": self.adapter.decode_steps,
                    "n_layer": self.adapter.n_layers,
                    "engine": {key: m[key] for key in (
                        "ttft_p50_s", "ttft_p99_s", "itl_p50_s",
                        "itl_p99_s")}}

        def __bench_reset__(self):
            from ray_tpu_torch import kernels as k
            k.reset_launch_counts()
            self.adapter.decode_steps = 0
            with self.engine._lock:
                self.engine._ttft.clear()
                self.engine._itl.clear()
            return "ok"

    return ProbedServer


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _sse_stream(port: int, route: str, payload: dict,
                timeout: float) -> dict:
    """POST ``payload`` with ``"stream": true`` and read its SSE events:
    the tokens, each event's arrival (seconds from the request's start)
    and token count, whether ``[DONE]`` came, the status."""
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    t0 = time.perf_counter()
    try:
        conn.request("POST", route, json.dumps({**payload, "stream": True}),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        out = {"status": resp.status, "tokens": [], "events": [],
               "done_s": None, "error": None}
        while True:
            line = resp.fp.readline()
            if not line:
                break
            line = line.strip()
            if not line.startswith(b"data: "):
                continue
            now = time.perf_counter() - t0
            if line[6:] == b"[DONE]":
                out["done_s"] = now
                break
            ev = json.loads(line[6:])
            if ev.get("error"):
                out["error"] = ev["error"]
            toks = ev.get("tokens") or []
            out["tokens"] += toks
            if toks:
                out["events"].append((now, len(toks)))
        return out
    finally:
        conn.close()


def _quantiles(vals) -> dict:
    vals = sorted(vals)
    if not vals:
        return {"p50": None, "p99": None}
    return {"p50": vals[len(vals) // 2],
            "p99": vals[min(len(vals) - 1, int(0.99 * len(vals)))]}


def serve_loop(device="cuda", prompts=None, new_tokens: int = 64) -> dict:
    """The LLM server on the port's serve control plane, one replica.

    ``serve.start`` with the HTTP proxy on a free port, then
    ``serve.run`` of ``probed_server_cls()`` (an ``LLMServer``): on
    ``cuda`` GPT-2 small from seed 0 behind chip_smoke.py phase 4's
    engine (16 running, 1,025 pages of 16, max_seq_len 1024) in a
    ``num_gpus=1`` replica, and unless given ``serve_prompts``' 16
    prompts of 64-768 tokens; on ``cpu`` the tiny GPT-2 in a replica
    with no grant, 4 prompts of 5-40. Runs: (1) each prompt alone
    through the handle (``h.remote``); (2) the replica's counts zeroed,
    one SSE stream a prompt, all at once, through the proxy, and the
    counts read back; (3) one unary JSON POST of the first prompt.
    Then the pool's used pages, ``serve.shutdown``, and on ``cuda`` a
    ``num_gpus=1`` task that must start. Runs on the cluster that is
    up, or on a new one of 4 CPUs that it shuts down.

    Reports the replica's start (``serve.run`` until healthy), its probe
    (GPU grant, kernel libraries loaded, launches and decode steps of
    run (2)), tokens of every run, run (2)'s tokens/s (all tokens over
    the time to the last ``[DONE]``), TTFT (first token event) and ITL
    (gaps between token events, per token) p50/p99 as the client saw
    them, the replica engine's own TTFT and ITL over run (2) (in the
    probe), each stream's count of token events, and whether its first
    event came before its ``[DONE]``."""
    import threading

    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.actor import get_actor_by_id

    dev = resolve_device(device)
    if dev.type == "cuda":
        from ray_tpu_torch.models.gpt2 import GPT2Config
        model_config = {"config": GPT2Config.small(), "seed": 0}
        engine_config = {"max_running": 16, "max_seq_len": 1024,
                         "block_size": 16, "num_blocks": 1025}
        actor_options = {"num_gpus": 1}
        default = (16, 64, 768)
    else:
        model_config = {"seed": 0, "device": "cpu"}
        engine_config = {"max_running": 4, "max_seq_len": 256,
                         "block_size": 8, "num_blocks": 96}
        actor_options = None
        default = (4, 5, 40)
    if prompts is None:
        vocab = 50257 if dev.type == "cuda" else 512
        prompts = serve_prompts(vocab, *default)

    def payload(p):
        return {"tokens": p, "max_new_tokens": new_tokens}

    out = {"serve_device_kind": _device_kind(dev),
           "serve_streams": len(prompts), "serve_new_tokens": new_tokens,
           "serve_prompt_tokens": [len(p) for p in prompts]}
    with rl_cluster(4):
        t0 = time.perf_counter()
        serve.start(http_port=_free_port())
        port = rt.get(rt.get_actor("SERVE_PROXY").get_port.remote(),
                      timeout=60)
        try:
            dep = serve.deployment(
                name="llm", num_replicas=1, max_concurrent_queries=64,
                ray_actor_options=actor_options)(probed_server_cls())
            h = serve.run(dep.bind("gpt2", model_config, engine_config),
                          name="llm", route_prefix="/llm", http_port=port,
                          _blocking_timeout=300.0)
            out["serve_replica_start_s"] = time.perf_counter() - t0
            ctrl = rt.get_actor("SERVE_CONTROLLER")
            _, table = rt.get(ctrl.get_route_table.remote(), timeout=60)
            replica = get_actor_by_id(table["llm"]["replicas"][0])

            def call(method):
                return rt.get(replica.handle_request.remote(method, (), {}),
                              timeout=120)

            out["serve_probe_at_start"] = call("__bench_probe__")
            # (1) each prompt alone through the handle
            out["serve_alone_tokens"] = [
                rt.get(h.remote(payload(p)), timeout=600)["tokens"]
                for p in prompts]
            # (2) concurrent SSE streams through the proxy
            call("__bench_reset__")
            rows = [None] * len(prompts)
            errors = []

            def stream(i):
                try:
                    rows[i] = _sse_stream(port, "/llm", payload(prompts[i]),
                                          timeout=600)
                except BaseException as e:   # raised below, in the caller
                    errors.append(e)

            threads = [threading.Thread(target=stream, args=(i,))
                       for i in range(len(prompts))]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=900)
            wall = time.perf_counter() - t0
            if errors:
                raise errors[0]
            if any(r is None for r in rows):
                raise TimeoutError("an SSE stream did not finish")
            probe = call("__bench_probe__")
            # (3) one unary JSON POST
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/llm",
                json.dumps(payload(prompts[0])).encode(),
                {"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=600) as resp:
                out["serve_unary_post_tokens"] = json.loads(resp.read())[
                    "tokens"]
            out["serve_pages_used_at_end"] = rt.get(
                replica.handle_request.remote("__llm_metrics__", (), {}),
                timeout=120)["kv_blocks_used"]
        finally:
            serve.shutdown()
        if dev.type == "cuda":
            out["serve_gpu_task_after_shutdown"] = rt.get(
                rt.remote(num_gpus=1)(_granted_gpus).remote(), timeout=300)
    ttft = [r["events"][0][0] for r in rows if r["events"]]
    itl = []
    for r in rows:
        for (t_prev, _), (t, n) in zip(r["events"], r["events"][1:]):
            itl += [(t - t_prev) / n] * n
    n_tok = sum(len(r["tokens"]) for r in rows)
    last_done = max(r["done_s"] or wall for r in rows)
    q_ttft, q_itl = _quantiles(ttft), _quantiles(itl)
    out.update({
        "serve_probe": probe,
        "serve_stream_tokens": [r["tokens"] for r in rows],
        "serve_stream_status": [r["status"] for r in rows],
        "serve_stream_errors": [r["error"] for r in rows],
        "serve_events_per_stream": [len(r["events"]) for r in rows],
        "serve_first_event_before_done": [
            bool(r["events"]) and r["done_s"] is not None
            and r["events"][0][0] < r["done_s"] for r in rows],
        "serve_tokens_per_s": n_tok / last_done,
        "serve_wall_s": wall,
        "serve_ttft_p50_s": q_ttft["p50"], "serve_ttft_p99_s": q_ttft["p99"],
        "serve_itl_p50_s": q_itl["p50"], "serve_itl_p99_s": q_itl["p99"],
        "serve_decode_steps": probe["decode_steps"],
        "serve_paged_decode_launches": probe["launches"].get(
            "paged_attention_decode", 0),
        "serve_n_layer": probe["n_layer"],
    })
    return out


def _granted_gpus() -> list:
    import ray_tpu_torch
    return ray_tpu_torch.get_gpu_ids()


def main(device="cuda"):
    """The raw control, the framework path, PPO and IMPALA (one local
    worker, then remote workers), DQN; one JSON line. ``value`` is the framework path's img/s/chip, beside the raw
    control's (``raw_img_per_sec_per_chip``) and their ratio
    (``framework_vs_raw``); the GPT-2 row is the framework worker's.
    Under torchrun (``WORLD_SIZE`` in the environment) the process group
    is formed here first, NCCL with card ``LOCAL_RANK``, the framework
    path is skipped (``value`` is then the raw control's, with the
    driver's GPT-2 row), and only rank 0 prints."""
    import torch.distributed as dist
    if "WORLD_SIZE" in os.environ and not dist.is_initialized():
        collectives.initialize_distributed(
            local_device_ids=[int(os.environ.get("LOCAL_RANK", 0))])
    raw = resnet_loop(device)
    if dist.is_initialized():
        res = {**raw, **gpt2_loop(device)}
    else:
        # the worker is another process on the same card: hand it what
        # the raw loop left cached
        if resolve_device(device).type == "cuda":
            torch.cuda.empty_cache()
        res = framework_main(device)
        res["raw_img_per_sec_per_chip"] = raw["img_per_sec_per_chip"]
        res["framework_vs_raw"] = (res["img_per_sec_per_chip"]
                                   / raw["img_per_sec_per_chip"])
    res.update(ppo_loop(device))
    res.update(ppo_remote_loop(device))
    res.update(impala_loop(device))
    res.update(impala_remote_loop(device))
    res.update(dqn_loop(device))
    line = {"metric": METRIC, "value": res["img_per_sec_per_chip"],
            "unit": UNIT, **res}
    if not dist.is_initialized() or dist.get_rank() == 0:
        print(json.dumps(line), flush=True)
    if dist.is_initialized():
        dist.destroy_process_group()
    return line


if __name__ == "__main__":
    main()
