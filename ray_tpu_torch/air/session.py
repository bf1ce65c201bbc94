"""Train/Tune session: the worker-side reporting API.

The port's copy of ``ray_tpu/air/session.py`` (the worker's GPU grant,
``get_gpu_ids``, in place of its TPU chips). Reference analogue:
python/ray/air/session.py — report:41, get_checkpoint:94,
get_dataset_shard:345, world_rank/local_rank accessors. A session is
installed thread-locally in each train worker (and in function trainables);
``report`` enqueues a TrainingResult consumed by the BackendExecutor/Tune.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, Optional


@dataclass
class TrainingResult:
    metrics: Dict[str, Any]
    checkpoint: Optional[Any] = None


@dataclass
class _Session:
    world_rank: int = 0
    local_rank: int = 0
    node_rank: int = 0
    world_size: int = 1
    trial_name: str = ""
    trial_id: str = ""
    experiment_name: str = ""
    checkpoint: Optional[Any] = None
    dataset_shards: Dict[str, Any] = field(default_factory=dict)
    result_queue: "queue.Queue[TrainingResult]" = field(
        default_factory=queue.Queue)
    stop_event: threading.Event = field(default_factory=threading.Event)
    gpu_ids: tuple = ()  # the worker's GPU grant (ledger indices)
    mesh: Any = None  # set by no backend, as in the JAX package
    # durable checkpoint engine (ray_tpu_torch.checkpoint): set up by the
    # backend when the run has a checkpoint root; report(checkpoint=...)
    # then stages through the manager instead of shipping payloads in-band
    checkpoint_manager: Any = None
    ckpt_next_step: int = 0
    async_checkpointer: Any = None


_tls = threading.local()

# Preemption state is PROCESS-global, not session-local: the raylet's
# preemption_notice lands on the worker's io thread while the train_func
# runs on its own thread — a thread-local could never cross that gap.
_preempt_lock = threading.Lock()
_preempt_state: Dict[str, Any] = {"deadline_unix": None, "grace_s": None}
_preempt_event = threading.Event()


def mark_preempted(deadline_unix: Optional[float] = None,
                   grace_s: Optional[float] = None):
    """Record a preemption notice for this process (called by the worker
    runtime when the raylet starts draining)."""
    with _preempt_lock:
        _preempt_state["deadline_unix"] = deadline_unix
        _preempt_state["grace_s"] = grace_s
    _preempt_event.set()


def preempted() -> bool:
    """True once this process received a preemption notice. Train loops
    poll this each step and commit an out-of-band checkpoint (via
    ``get_async_checkpointer()`` + ``report``) inside the grace window."""
    return _preempt_event.is_set()


def preemption_deadline() -> Optional[float]:
    """Unix time the node dies (None when not preempted / not given)."""
    with _preempt_lock:
        return _preempt_state["deadline_unix"]


def _clear_preempted():
    """Test/restart hook: a fresh worker process starts unpreempted;
    this resets the flag for in-process reuse."""
    with _preempt_lock:
        _preempt_state["deadline_unix"] = None
        _preempt_state["grace_s"] = None
    _preempt_event.clear()


def _set_session(s: Optional[_Session]):
    _tls.session = s


def _get_session(warn: bool = True) -> Optional[_Session]:
    s = getattr(_tls, "session", None)
    return s


def in_session() -> bool:
    return _get_session() is not None


def report(metrics: Dict[str, Any], *, checkpoint=None):
    s = _get_session()
    if s is None:
        raise RuntimeError("session.report() called outside a train session")
    if checkpoint is not None and s.checkpoint_manager is not None:
        checkpoint = _route_through_manager(s, checkpoint)
    s.result_queue.put(TrainingResult(dict(metrics), checkpoint))
    if s.stop_event.is_set():
        raise StopIteration("session stopped")


def _route_through_manager(s: _Session, checkpoint):
    """Stage the payload under the durable checkpoint root and ship only a
    PendingCheckpoint marker; the driver commits after the round barrier
    (all ranks staged). Replicated dict/dir payloads are written by rank 0
    only; a PendingCheckpoint (from an AsyncCheckpointer the train_func
    drives itself) passes through untouched."""
    from ray_tpu_torch.checkpoint import PendingCheckpoint
    if isinstance(checkpoint, PendingCheckpoint):
        s.ckpt_next_step = max(s.ckpt_next_step, checkpoint.step + 1)
        return checkpoint
    step = s.ckpt_next_step
    s.ckpt_next_step += 1
    if s.world_rank == 0:
        s.checkpoint_manager.stage(step, checkpoint)
    return PendingCheckpoint(step)


def get_checkpoint():
    s = _get_session()
    return s.checkpoint if s else None


def get_checkpoint_manager():
    """The run's durable CheckpointManager, or None when the run has no
    checkpoint root configured (RunConfig.name/storage_path)."""
    s = _get_session()
    return s.checkpoint_manager if s else None


def next_checkpoint_step() -> int:
    """The step number the next staged checkpoint will get (monotonic,
    continues across gang restarts)."""
    s = _get_session()
    return s.ckpt_next_step if s else 0


def get_async_checkpointer():
    """This worker's AsyncCheckpointer bound to the run's checkpoint root
    (lazily created). Train funcs use it for sharded SPMD state:
    ``pending = ckpter.save(session.next_checkpoint_step(), state)`` then
    ``session.report(metrics, checkpoint=pending)`` — the driver commits
    once every rank's write lands. Returns None without a manager."""
    s = _get_session()
    if s is None or s.checkpoint_manager is None:
        return None
    if s.async_checkpointer is None:
        from ray_tpu_torch.checkpoint import AsyncCheckpointer
        s.async_checkpointer = AsyncCheckpointer(
            s.checkpoint_manager, process_index=s.world_rank,
            process_count=s.world_size, commit=False)
    return s.async_checkpointer


def get_dataset_shard(name: str = "train"):
    s = _get_session()
    if s is None:
        return None
    return s.dataset_shards.get(name)


def get_world_rank() -> int:
    s = _get_session()
    return s.world_rank if s else 0


def get_local_rank() -> int:
    s = _get_session()
    return s.local_rank if s else 0


def get_node_rank() -> int:
    s = _get_session()
    return s.node_rank if s else 0


def get_world_size() -> int:
    s = _get_session()
    return s.world_size if s else 1


def get_trial_name() -> str:
    s = _get_session()
    return s.trial_name if s else ""


def get_trial_id() -> str:
    s = _get_session()
    return s.trial_id if s else ""


def get_experiment_name() -> str:
    s = _get_session()
    return s.experiment_name if s else ""


def get_mesh():
    """The gang's mesh: None, since no backend sets it (the JAX
    package's backend does not either); a train_func builds its own
    with ``parallel.mesh.MeshSpec.build`` over the process group."""
    s = _get_session()
    return s.mesh if s else None


def get_gpu_ids() -> tuple:
    """This worker's GPU grant (``ray_tpu_torch.get_gpu_ids()`` at
    session setup); () outside a session."""
    s = _get_session()
    return s.gpu_ids if s else ()
