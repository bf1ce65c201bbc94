"""Gang worker group for Train.

The port's copy of ``ray_tpu/train/_internal/worker_group.py``
(reference analogue: train/_internal/worker_group.py:92): a set of
actors forming one training gang, placed in a placement group so the
whole gang schedules atomically. A worker's GPUs are its grant
(``get_gpu_ids()``, ``CUDA_VISIBLE_DEVICES``); the gang's process group
is ``torch.distributed`` over a TCP rendezvous on rank 0's host (NCCL
with GPUs, gloo without), in place of ``jax.distributed``."""

from __future__ import annotations

import threading
import traceback
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.air import session as air_session
from ray_tpu_torch.util.placement_group import (placement_group,
                                                remove_placement_group)
from ray_tpu_torch.util.scheduling_strategies import (
    PlacementGroupSchedulingStrategy)


# put on a session's result queue when its train thread ends
_THREAD_ENDED = object()


@ray_tpu_torch.remote
class TrainWorker:
    """One gang member. Runs the user's train_func in a thread and streams
    session results (reference: backend_executor start_training / session)."""

    def __init__(self):
        self._session = None
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[str] = None
        self._finished = False
        self._return_value = None

    def get_metadata(self) -> Dict[str, Any]:
        import os
        ctx = ray_tpu_torch.get_runtime_context()
        return {
            "node_id": ctx.get_node_id(),
            "pid": os.getpid(),
            "hostname": os.uname().nodename,
            "gpu_ids": ray_tpu_torch.get_gpu_ids(),
        }

    def setup_session(self, *, world_rank: int, local_rank: int,
                      node_rank: int, world_size: int,
                      trial_name: str = "", trial_id: str = "",
                      experiment_name: str = "",
                      checkpoint=None,
                      checkpoint_root: str = None,
                      ckpt_start_step: int = 0) -> bool:
        ckpt_manager = None
        if checkpoint_root:
            # workers only stage into the root; commit/retention is the
            # driver's job (it owns the all-ranks round barrier)
            from ray_tpu_torch.checkpoint import CheckpointManager
            ckpt_manager = CheckpointManager(checkpoint_root)
        self._session = air_session._Session(
            world_rank=world_rank, local_rank=local_rank,
            node_rank=node_rank, world_size=world_size,
            trial_name=trial_name, trial_id=trial_id,
            experiment_name=experiment_name, checkpoint=checkpoint,
            gpu_ids=tuple(ray_tpu_torch.get_gpu_ids()),
            checkpoint_manager=ckpt_manager,
            ckpt_next_step=ckpt_start_step)
        return True

    def wait_checkpoint(self):
        """Barrier until this worker's in-flight async checkpoint write
        (if any) has landed; returns its per-save stats. The driver calls
        this on every rank before committing a step."""
        s = self._session
        if s is None or s.async_checkpointer is None:
            return []
        s.async_checkpointer.wait()
        return [st.as_dict() for st in s.async_checkpointer.stats]

    def set_dataset_shard(self, name: str, shard) -> bool:
        self._session.dataset_shards[name] = shard
        return True

    def setup_process_group(self, init_method: str, world_size: int,
                            rank: int, backend: Optional[str] = None,
                            timeout_s: float = 120.0) -> bool:
        """Join the gang's ``torch.distributed`` process group (reference:
        train/torch/config.py:69 _setup_torch_process_group). ``backend``
        None: NCCL when this worker holds a GPU grant, gloo otherwise. A
        gang of one forms no group, as the JAX package skips
        ``jax.distributed`` for one process."""
        if world_size <= 1:
            return True
        import datetime
        import os
        import torch.distributed as dist
        if backend is None:
            backend = "nccl" if ray_tpu_torch.get_gpu_ids() else "gloo"
        if backend == "nccl":
            import torch
            torch.cuda.set_device(0)
        dist.init_process_group(
            backend=backend, init_method=init_method,
            world_size=world_size, rank=rank,
            timeout=datetime.timedelta(seconds=timeout_s))
        os.environ["WORLD_SIZE"] = str(world_size)
        os.environ["RANK"] = str(rank)
        return True

    def shutdown_process_group(self) -> bool:
        try:
            import torch.distributed as dist
            if dist.is_initialized():
                dist.destroy_process_group()
        except Exception:
            pass
        return True

    def get_free_port(self) -> int:
        import socket
        s = socket.socket()
        s.bind(("", 0))
        port = s.getsockname()[1]
        s.close()
        return port

    def get_ip(self) -> str:
        """This host's address for the rendezvous: the IP the node's
        raylet advertises."""
        from ray_tpu_torch._private import netx
        return netx.node_ip()

    def start_training(self, train_func: Callable, config: Dict[str, Any]
                       ) -> bool:
        air_session._set_session(self._session)
        gpu_ids = self._session.gpu_ids if self._session else ()

        def run():
            air_session._set_session(self._session)
            try:
                if gpu_ids:
                    # CUDA's current device is per thread: the grant is
                    # this process's only visible card
                    import torch
                    torch.cuda.set_device(0)
                import inspect
                sig = inspect.signature(train_func)
                if len(sig.parameters) >= 1:
                    self._return_value = train_func(config)
                else:
                    self._return_value = train_func()
            except StopIteration:
                pass
            except BaseException:  # noqa: BLE001
                self._error = traceback.format_exc()
            finally:
                self._finished = True
                # wake a get_next_result blocked on the queue
                self._session.result_queue.put(_THREAD_ENDED)

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="train_func")
        self._thread.start()
        return True

    def get_next_result(self, timeout: float = 5.0):
        """Long-poll one TrainingResult; returns dict or status marker.
        The train thread's end wakes the poll, so a finished or failed
        worker answers at once instead of after ``timeout``."""
        import queue as _q
        if self._session is None:
            return {"status": "no_session"}
        q = self._session.result_queue
        r = None
        if not (self._finished and q.empty()):
            try:
                r = q.get(timeout=timeout)
            except _q.Empty:
                pass
        if r is not None and r is not _THREAD_ENDED:
            return {"status": "result", "metrics": r.metrics,
                    "checkpoint": r.checkpoint}
        if self._error is not None:
            return {"status": "error", "error": self._error}
        if self._finished:
            return {"status": "finished",
                    "return_value": self._return_value}
        return {"status": "pending"}

    def is_finished(self) -> bool:
        return self._finished

    def get_error(self) -> Optional[str]:
        return self._error


class WorkerGroup:
    def __init__(self, num_workers: int,
                 resources_per_worker: Dict[str, float],
                 placement_strategy: str = "PACK"):
        self.num_workers = num_workers
        bundles = [dict(resources_per_worker) for _ in range(num_workers)]
        self.pg = placement_group(bundles, strategy=placement_strategy)
        if not self.pg.ready(timeout=120):
            remove_placement_group(self.pg)
            raise RuntimeError(
                f"placement group for {num_workers} x "
                f"{resources_per_worker} did not become ready")
        num_gpus = resources_per_worker.get("GPU", 0)
        num_cpus = resources_per_worker.get("CPU", 1)
        self.workers = []
        for i in range(num_workers):
            w = TrainWorker.options(
                num_cpus=num_cpus, num_gpus=num_gpus,
                scheduling_strategy=PlacementGroupSchedulingStrategy(
                    self.pg, placement_group_bundle_index=i),
            ).remote()
            self.workers.append(w)
        # stable rank ordering: sort by (node, pid) like the reference's
        # rank mapping (backend_executor.py:380)
        metas = ray_tpu_torch.get(
            [w.get_metadata.remote() for w in self.workers], timeout=180)
        order = sorted(range(num_workers),
                       key=lambda i: (metas[i]["node_id"], metas[i]["pid"]))
        self.workers = [self.workers[i] for i in order]
        self.metadata = [metas[i] for i in order]

    def execute(self, method_name: str, *args, timeout=180, **kwargs):
        refs = [getattr(w, method_name).remote(*args, **kwargs)
                for w in self.workers]
        return ray_tpu_torch.get(refs, timeout=timeout)

    def execute_single(self, rank: int, method_name: str, *args,
                       timeout=180, **kwargs):
        ref = getattr(self.workers[rank], method_name).remote(*args, **kwargs)
        return ray_tpu_torch.get(ref, timeout=timeout)

    def shutdown(self):
        for w in self.workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:
                pass
        try:
            remove_placement_group(self.pg)
        except Exception:
            pass
