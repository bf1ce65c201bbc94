"""BatchPredictor — offline inference over a Dataset.

Reference analogue: air BatchPredictor + predictor base. A checkpoint's
model runs over dataset batches via map_batches actors.

The port's counterpart of ``ray_tpu/air/batch_predictor.py``:
``TorchPredictor`` takes ``JaxPredictor``'s role. It moves the params
to its device once, as tensors in the same tree, and calls ``apply_fn``
eagerly under ``torch.inference_mode()`` (the JAX package jits it; no
``torch.compile`` here). On ``cuda`` it needs a GPU granted to its
process: ``BatchPredictor.predict(num_gpus_per_worker=1)`` asks the
runtime for one per pool actor (Ray's argument); a process granted none
sees ``CUDA_VISIBLE_DEVICES=""`` and the predictor raises, never falling
back to the CPU.

Inside a Dataset actor pool the predictor is built once per actor: the
checkpoint goes into the object store once per ``predict`` call and each
actor keeps the predictor it built for that call.
"""

from __future__ import annotations

import os
import uuid
from typing import Any, Callable, Dict, Optional, Sequence, Type, Union

import numpy as np

from ray_tpu_torch.air.checkpoint import Checkpoint


class Predictor:
    """Base single-process predictor."""

    @classmethod
    def from_checkpoint(cls, checkpoint: Checkpoint, **kwargs
                        ) -> "Predictor":
        raise NotImplementedError

    def predict(self, batch: Dict[str, np.ndarray]
                ) -> Dict[str, np.ndarray]:
        raise NotImplementedError


def _to_device(tree, device):
    """The params tree with every array and tensor on ``device``; dicts,
    lists and tuples keep their structure, other leaves stay as they
    are."""
    import torch
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device) for v in tree)
    if isinstance(tree, np.ndarray):
        # a writable copy: an array read from the object store is a
        # read-only view of its pages
        return torch.from_numpy(np.array(tree)).to(device)
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree


def _to_numpy(x) -> np.ndarray:
    import torch
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class TorchPredictor(Predictor):
    """Predictor over a torch function ``apply_fn(params, x)`` and params
    from a checkpoint.

    ``input_column`` names one column (``x`` is its tensor) or a sequence
    of columns (``x`` is a dict of their tensors). ``apply_fn`` returns a
    tensor or array, stored under ``output_column``, or a dict of them,
    each stored under its own key."""

    def __init__(self, params: Any,
                 apply_fn: Callable[[Any, Any], Any],
                 input_column: Union[str, Sequence[str]] = "x",
                 output_column: str = "predictions",
                 device: str = "cuda"):
        import torch

        from ray_tpu_torch.device import resolve_device
        dev = torch.device(device)
        if dev.type == "cuda" and \
                os.environ.get("CUDA_VISIBLE_DEVICES") == "":
            raise RuntimeError(
                f"TorchPredictor runs on {str(dev)!r}, but this process "
                "holds no GPU grant (CUDA_VISIBLE_DEVICES is empty): pass "
                "num_gpus_per_worker=1 to BatchPredictor.predict, or "
                "device='cpu'")
        self.device = resolve_device(dev)
        self.params = _to_device(params, self.device)
        self.apply_fn = apply_fn
        self.input_column = input_column
        self.output_column = output_column

    @classmethod
    def from_checkpoint(cls, checkpoint: Checkpoint, *,
                        apply_fn: Callable,
                        input_column: Union[str, Sequence[str]] = "x",
                        output_column: str = "predictions",
                        device: str = "cuda") -> "TorchPredictor":
        state = checkpoint.to_dict()
        params = state.get("params") or state.get("state", {}).get(
            "params") or state
        return cls(params, apply_fn, input_column, output_column, device)

    def _tensor(self, column):
        import torch
        return torch.as_tensor(np.asarray(column)).to(self.device)

    def predict(self, batch):
        import torch
        if isinstance(self.input_column, str):
            x = self._tensor(batch[self.input_column])
        else:
            x = {c: self._tensor(batch[c]) for c in self.input_column}
        with torch.inference_mode():
            out = self.apply_fn(self.params, x)
        res = dict(batch)
        if isinstance(out, dict):
            res.update({k: _to_numpy(v) for k, v in out.items()})
        else:
            res[self.output_column] = _to_numpy(out)
        return res


# predictors built by this process's pool actor, by predict() call
_ACTOR_PREDICTORS: Dict[str, Predictor] = {}


def _actor_predictor(key: str, build: Callable[[], Predictor]
                     ) -> Predictor:
    """This process's predictor for ``key``, built on first use. A
    module-level function: a closure shipped by value would carry a
    copy of the cache, not the cache."""
    p = _ACTOR_PREDICTORS.get(key)
    if p is None:
        p = _ACTOR_PREDICTORS[key] = build()
    return p


class BatchPredictor:
    def __init__(self, checkpoint: Checkpoint,
                 predictor_cls: Type[Predictor], **predictor_kwargs):
        self.checkpoint = checkpoint
        self.predictor_cls = predictor_cls
        self.predictor_kwargs = predictor_kwargs

    @classmethod
    def from_checkpoint(cls, checkpoint: Checkpoint,
                        predictor_cls: Type[Predictor],
                        **predictor_kwargs) -> "BatchPredictor":
        return cls(checkpoint, predictor_cls, **predictor_kwargs)

    def predict(self, dataset, *, batch_size: int = 256,
                num_workers: Optional[int] = None,
                apply_preprocessor: bool = True,
                num_gpus_per_worker: float = 0):
        """Run inference over every batch of the dataset; returns a new
        Dataset with the prediction column appended.

        ``num_workers`` shards the work over a Dataset actor pool (each
        actor holds ONE predictor instance — the model loads once per
        worker, not once per block).  A preprocessor attached to the
        checkpoint (``Checkpoint.with_preprocessor``) is applied to each
        batch first, so inference sees the training-time features
        (reference: BatchPredictor.predict + separate_gpu_stage).
        ``num_gpus_per_worker`` > 0 grants each pool actor (or each task,
        without ``num_workers``) that many GPUs (Ray's argument)."""
        import ray_tpu_torch
        predictor_cls = self.predictor_cls
        kwargs = self.predictor_kwargs
        preprocessor = self.checkpoint.get_preprocessor() \
            if apply_preprocessor else None
        checkpoint_ref = ray_tpu_torch.put(self.checkpoint)
        # a pool actor keeps its predictor across blocks under this key;
        # a task builds one for its block
        key = uuid.uuid4().hex if num_workers is not None else None
        state = {"p": None}

        def _build():
            return predictor_cls.from_checkpoint(
                ray_tpu_torch.get(checkpoint_ref), **kwargs)

        def _predict(batch):
            if key is not None:
                p = _actor_predictor(key, _build)
            else:
                if state["p"] is None:  # one predictor per task
                    state["p"] = _build()
                p = state["p"]
            if preprocessor is not None:
                batch = preprocessor.transform_batch(batch)
            return p.predict(batch)

        compute = None
        if num_workers is not None:
            from ray_tpu_torch.data._internal.compute import (
                ActorPoolStrategy)
            compute = ActorPoolStrategy(size=num_workers)
        opts = {"num_gpus": num_gpus_per_worker} \
            if num_gpus_per_worker else {}
        return dataset.map_batches(_predict, batch_size=batch_size,
                                   compute=compute, **opts)
