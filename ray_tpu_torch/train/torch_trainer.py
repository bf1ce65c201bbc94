"""TorchTrainer and its backend config: torch training on the actor gang.

The port's counterpart of ``ray_tpu/train/torch_trainer.py`` (reference
analogue: train/torch/ — TorchTrainer, TorchConfig config.py:69,
prepare_model/prepare_data_loader train_loop_utils.py:51).
``TorchConfig`` is ``DataParallelTrainer``'s default backend, in the
role the JAX package's ``JaxConfig`` plays: the gang's rendezvous, a
``torch.distributed`` process group over TCP on rank 0's host.
"""

from __future__ import annotations

from typing import Callable, Optional

import ray_tpu_torch
from ray_tpu_torch.train.data_parallel_trainer import DataParallelTrainer


class TorchConfig:
    """Backend config forming the gang's ``torch.distributed`` group.
    ``backend`` None: NCCL when the workers hold GPUs, gloo otherwise
    (each worker decides from its grant). A gang of one forms no
    group."""

    def __init__(self, backend: Optional[str] = None,
                 timeout_s: float = 120.0):
        self.backend = backend
        self.timeout_s = timeout_s

    def setup_worker_group(self, worker_group):
        n = worker_group.num_workers
        if n <= 1:
            return
        ip = worker_group.execute_single(0, "get_ip")
        port = worker_group.execute_single(0, "get_free_port")
        init_method = f"tcp://{ip}:{port}"
        refs = [w.setup_process_group.remote(
                    init_method, n, rank, self.backend, self.timeout_s)
                for rank, w in enumerate(worker_group.workers)]
        ray_tpu_torch.get(refs, timeout=300)


class TorchTrainer(DataParallelTrainer):
    def __init__(self, train_loop_per_worker: Callable,
                 *, torch_config: Optional[TorchConfig] = None,
                 **kwargs):
        kwargs.setdefault("backend_config",
                          torch_config or TorchConfig())
        super().__init__(train_loop_per_worker, **kwargs)


def prepare_model(model):
    """Wrap in DDP when a process group exists (reference:
    train_loop_utils.py:51)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized() and \
            dist.get_world_size() > 1:
        from torch.nn.parallel import DistributedDataParallel
        return DistributedDataParallel(model)
    return model


def prepare_data_loader(data_loader):
    """Re-wrap a DataLoader with a DistributedSampler shard."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1):
        return data_loader
    from torch.utils.data import DataLoader
    from torch.utils.data.distributed import DistributedSampler
    return DataLoader(
        data_loader.dataset,
        batch_size=data_loader.batch_size,
        sampler=DistributedSampler(data_loader.dataset),
        num_workers=0,
        collate_fn=data_loader.collate_fn,
        drop_last=data_loader.drop_last)
