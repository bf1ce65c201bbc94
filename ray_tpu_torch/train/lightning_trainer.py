"""LightningTrainer — run a PyTorch Lightning fit inside the Train
worker gang.

Reference analogue: the `ray_lightning` shim the reference bundles
(SURVEY §2.4: train table, util/ray_lightning) and the later in-tree
``LightningTrainer``.  Lightning is not baked into this image, so the
constructor gates on the import exactly like the reference's optional
integrations; when present, each Train worker builds the module +
``pl.Trainer`` with the environment's rank info (the gloo process group
is already formed by TorchConfig, so Lightning's ddp strategy finds an
initialized backend) and checkpoints the module state dict.

The port's copy of ``ray_tpu/train/lightning_trainer.py`` over the port's
``TorchTrainer``, gated at construction on ``pytorch_lightning`` or
``lightning``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.air.config import RunConfig, ScalingConfig
from ray_tpu_torch.train.torch_trainer import TorchConfig, TorchTrainer


def _lightning():
    try:
        import pytorch_lightning as pl
        return pl
    except ImportError:
        try:
            import lightning.pytorch as pl
            return pl
        except ImportError:
            raise ImportError(
                "LightningTrainer requires `pytorch_lightning` (or "
                "`lightning`), which is not installed in this image. "
                "Use TorchTrainer with an explicit loop.") from None


class LightningTrainer(TorchTrainer):
    """Gang-run a ``LightningModule.fit`` (gated on lightning)."""

    _framework = "lightning"

    def __init__(self, *, lightning_module_cls=None,
                 module_init_config: Optional[Dict[str, Any]] = None,
                 trainer_init_config: Optional[Dict[str, Any]] = None,
                 datamodule_fn=None,
                 scaling_config: Optional[ScalingConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 torch_config: Optional[TorchConfig] = None,
                 datasets: Optional[Dict[str, Any]] = None,
                 resume_from_checkpoint=None):
        _lightning()  # gate early, like the reference's soft imports
        self._module_cls = lightning_module_cls
        self._module_cfg = dict(module_init_config or {})
        self._trainer_cfg = dict(trainer_init_config or {})
        self._datamodule_fn = datamodule_fn

        def train_loop(config):
            import torch

            from ray_tpu_torch.air import session
            pl = _lightning()
            module = self._module_cls(**self._module_cfg)
            kw = dict(self._trainer_cfg)
            kw.setdefault("enable_progress_bar", False)
            kw.setdefault("logger", False)
            kw.setdefault("enable_checkpointing", False)
            trainer = pl.Trainer(**kw)
            fit_kw = {}
            if self._datamodule_fn is not None:
                fit_kw["datamodule"] = self._datamodule_fn()
            trainer.fit(module, **fit_kw)
            metrics = {k: float(v) for k, v in
                       trainer.callback_metrics.items()
                       if hasattr(v, "__float__")}
            ckpt = Checkpoint.from_dict(
                {"state_dict": {k: v.cpu().numpy() for k, v in
                                module.state_dict().items()},
                 "torch": True})
            session.report(metrics or {"done": 1.0}, checkpoint=ckpt)

        super().__init__(
            train_loop_per_worker=train_loop,
            scaling_config=scaling_config, run_config=run_config,
            torch_config=torch_config, datasets=datasets,
            resume_from_checkpoint=resume_from_checkpoint)
