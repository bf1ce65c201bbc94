"""TransformersTrainer — Hugging Face transformers on the worker gang.

Reference analogue: train/huggingface/huggingface_trainer.py
(HuggingFaceTrainer:86): the user supplies ``trainer_init_per_worker``
building a ``transformers.Trainer``; each gang worker joins the torch
process group (gloo host-side, as in TorchTrainer) so HF's own
distributed handling shards the data and all-reduces gradients. EVERY
rank reports per logging step (the gang's result rounds complete only
when all workers report), rank 0 attaching portable checkpoints; gang
restarts resume from the last reported checkpoint.

The port's copy of ``ray_tpu/train/transformers_trainer.py`` over the
port's ``TorchTrainer``. ``transformers`` is imported only inside the
train loop that ``_make_train_loop`` returns, never at module level, so
``import ray_tpu_torch.train`` works where it is not installed.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, Optional

from ray_tpu_torch.train.torch_trainer import TorchTrainer


def _checkpoint_from_hf_dir(ckpt_dir: str):
    """Portable dict-checkpoint from a (flat) HF checkpoint directory —
    a path-only checkpoint is useless off the node that wrote it."""
    from ray_tpu_torch.air.checkpoint import Checkpoint
    data: Dict[str, Any] = {}
    for name in sorted(os.listdir(ckpt_dir)):
        p = os.path.join(ckpt_dir, name)
        if os.path.isfile(p):
            with open(p, "rb") as f:
                data[name] = f.read()
    return Checkpoint.from_dict(data)


def _hf_dir_from_checkpoint(ckpt) -> Optional[str]:
    import tempfile
    data = ckpt.to_dict()
    files = {k: v for k, v in data.items() if isinstance(v, bytes)}
    if not files:
        return None
    d = tempfile.mkdtemp(prefix="hf_resume_")
    for name, blob in files.items():
        with open(os.path.join(d, name), "wb") as f:
            f.write(blob)
    return d


def _make_train_loop(trainer_init_per_worker: Callable):
    def _loop(config: Dict[str, Any]):
        import transformers

        from ray_tpu_torch.air import session

        # HF/accelerate reads the process group from env vars; the gang
        # joined via an explicit tcp:// init_method (TorchConfig), so
        # mirror it into the env form accelerate expects
        try:
            import torch.distributed as dist
            if dist.is_available() and dist.is_initialized():
                os.environ.setdefault("RANK", str(dist.get_rank()))
                os.environ.setdefault("WORLD_SIZE",
                                      str(dist.get_world_size()))
                os.environ.setdefault("LOCAL_RANK",
                                      str(session.get_local_rank()))
                os.environ.setdefault("MASTER_ADDR", "127.0.0.1")
                os.environ.setdefault("MASTER_PORT", "29500")
        except ImportError:
            pass

        class _ReportCallback(transformers.TrainerCallback):
            """EVERY rank reports each on_log/on_save so the executor's
            per-round barrier (backend_executor.get_next_results) always
            completes; rank 0 carries the real metrics/checkpoint."""

            def on_log(self, args, state, control, logs=None, **kw):
                metrics = {k: v for k, v in (logs or {}).items()
                           if isinstance(v, (int, float))}
                metrics["step"] = state.global_step
                metrics["epoch"] = float(state.epoch or 0.0)
                session.report(metrics)

            def on_save(self, args, state, control, **kw):
                ckpt = None
                if state.is_world_process_zero:
                    ckpt_dir = \
                        transformers.trainer_utils.get_last_checkpoint(
                            args.output_dir)
                    if ckpt_dir:
                        ckpt = _checkpoint_from_hf_dir(ckpt_dir)
                session.report({"step": state.global_step,
                                "_checkpoint_saved": ckpt is not None},
                               checkpoint=ckpt)

        # shard keys routed through the Dataset pipeline
        for key, cfg_key in (("train", "_train_dataset"),
                             ("evaluation", "_eval_dataset")):
            if config.pop(f"_shard_{key}", False):
                config[cfg_key] = _shard_to_torch_dataset(
                    session.get_dataset_shard(key))

        trainer = trainer_init_per_worker(
            train_dataset=config.pop("_train_dataset", None),
            eval_dataset=config.pop("_eval_dataset", None),
            **config)
        if not isinstance(trainer, transformers.Trainer):
            raise TypeError(
                "trainer_init_per_worker must return a "
                f"transformers.Trainer, got {type(trainer).__name__}")
        trainer.add_callback(_ReportCallback())
        # gang restart: resume from the checkpoint the session carries
        resume_dir = None
        prev = session.get_checkpoint()
        if prev is not None:
            resume_dir = _hf_dir_from_checkpoint(prev)
        result = trainer.train(resume_from_checkpoint=resume_dir)
        metrics = {k: v for k, v in (result.metrics or {}).items()
                   if isinstance(v, (int, float))}
        metrics["done_training"] = True
        session.report(metrics)
    return _loop


def _shard_to_torch_dataset(shard):
    """Materialize a ray_tpu_torch.data shard as a torch map-style dataset
    (HF's Trainer wants __len__/__getitem__)."""
    import torch

    rows = shard.take_all()

    class _ShardDataset(torch.utils.data.Dataset):
        def __len__(self):
            return len(rows)

        def __getitem__(self, i):
            return rows[i]

    return _ShardDataset()


class TransformersTrainer(TorchTrainer):
    def __init__(self, trainer_init_per_worker: Callable,
                 *, trainer_init_config: Optional[Dict[str, Any]] = None,
                 datasets: Optional[Dict[str, Any]] = None,
                 **kwargs):
        loop_config = dict(trainer_init_config or {})
        # ray_tpu_torch Datasets flow through the standard get_dataset_shard
        # path (per-worker shards); anything else ships by value inside
        # the config — 'train'/'evaluation' map onto the trainer_init
        # arguments, other keys pass through as extra kwargs
        ds = dict(datasets or {})
        from ray_tpu_torch.data.dataset import Dataset as _RD
        rds = {}
        for key in list(ds):
            v = ds[key]
            if isinstance(v, _RD):
                rds[key] = ds.pop(key)
                if key in ("train", "evaluation"):
                    loop_config[f"_shard_{key}"] = True
        if "train" in ds:
            loop_config["_train_dataset"] = ds.pop("train")
        if "evaluation" in ds:
            loop_config["_eval_dataset"] = ds.pop("evaluation")
        loop_config.update(ds)  # remaining keys pass through verbatim
        super().__init__(
            _make_train_loop(trainer_init_per_worker),
            train_loop_config=loop_config,
            datasets=rds or None, **kwargs)


# exported alias matching the reference's class name
HuggingFaceTrainer = TransformersTrainer
