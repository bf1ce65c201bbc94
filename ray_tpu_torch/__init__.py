"""ray_tpu_torch — the PyTorch/CUDA port of ray_tpu, slice by slice.

Beside the JAX package (``ray_tpu``, the reference), this package runs
the same system with PyTorch on an NVIDIA H100, with every TPU kernel
on a ported path rewritten by hand for Hopper (``kernels/csrc``). It
imports nothing of ``ray_tpu`` and nothing of JAX.

Ported so far:

  - LLM serving of GPT-2 and Llama-2-7B (``serve.llm``), with
    single-token decode attention in a CUDA kernel, speculative decoding
    with model drafts and the local HF imports;
  - GPT-2 training (``train.spmd.make_causal_lm_trainer``) through the
    whole-kv attention kernels (the streaming ones with ``exact=True``);
  - Llama training at 4,096 tokens (``models.llama``) through the
    streaming attention kernels;
  - ResNet image-classifier training (``models.resnet``,
    ``train.spmd.make_image_classifier_trainer``; cuDNN convolutions)
    and its throughput bench (``python -m ray_tpu_torch.bench``);
  - the mesh (``parallel.mesh``, ``parallel.collectives``): both
    trainers on dp x fsdp x tp over a process group (NCCL on the card,
    gloo on the CPU), and the multi-rank dry run
    (``parallel.dryrun``);
  - sequence, pipeline and expert parallelism: ring attention over sp
    (``ops.ring_attention``), the pipelined LM trainer over pp
    (``parallel.pipeline``), the MoE layer over ep (``parallel.moe``);
  - RLlib (``rllib``): PPO through ``Algorithm`` and its local
    rollout worker, and the RLModule / Learner stack, with the policy
    on the card and the envs, connectors and GAE on the host;
    ``bench.ppo_loop`` runs it at the Atari widths; on the runtime,
    remote rollout and evaluation workers (CPU actors), remote learners
    (one GPU each), IMPALA's async learner, A3C, DDPPO, Ape-X and
    ES/ARS (``bench.ppo_remote_loop``: atari-ppo.yaml's 10 workers x 5
    envs);
  - the runtime (``init``, ``remote``, ``get``, ``put``, ``wait``,
    ``kill``, actors, placement groups; the GCS, raylet and worker
    processes under ``_private/``), copied from the JAX package's, with
    the GPU as the resource granted by index: ``@remote(num_gpus=k)``
    gets k device indices in ``CUDA_VISIBLE_DEVICES`` (``get_gpu_ids``),
    and a task granted none sees ``CUDA_VISIBLE_DEVICES=""``;
  - the train gang and the Dataset feed on the runtime: ``train``
    (``DataParallelTrainer``, ``TorchTrainer``: a train_func in each of
    n actors, one GPU each with ``ScalingConfig(use_gpu=True)``, joined
    by a ``torch.distributed`` group), ``air.session`` (reports, ranks,
    dataset shards, checkpoints, the preemption notice) and ``data``
    (Datasets over object-store blocks; ``iter_device_batches`` copies
    batches to the card through pinned memory on a side stream);
    ``bench.framework_main`` runs the headline ResNet-50 bench through
    them;
  - Tune on the runtime (``tune``: ``tune.run``, ``Tuner``, function and
    class trainables, the searchers and schedulers, the loggers and the
    resumable experiment), each trial an actor, granted a GPU with
    ``resources_per_trial={"GPU": 1}`` or ``tune.with_resources``;
  - AIR's batch inference and the other trainers (``air``, ``train``),
    ``util``'s actor pool, queue and GPU profiler;
  - the multi-node test cluster (``_private.cluster_utils.Cluster``:
    raylets added on one host), compiled DAGs (``fn.bind()``,
    ``Actor.bind().method.bind()``, ``dag.execute()``, ``dag.compile()``
    over pre-wired channels with plasmax ring slots) and ``ray://``
    client drivers (``init("ray://host:port")`` against a
    ``util.client.server.ClientServer``).

ROADMAP.md lists the slices to come.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
Importing the package imports no torch: the GCS, the raylet and CPU-only
workers never load it.
"""

from __future__ import annotations

import atexit
import os
import threading
from typing import Any, Dict, List, Optional, Sequence, Union

from ray_tpu_torch.common.config import SystemConfig, global_config
from ray_tpu_torch.common.ids import JobID, NodeID, ObjectID, TaskID
from ray_tpu_torch.common.options import validate_options
from ray_tpu_torch import exceptions
from ray_tpu_torch._private import worker as _worker_mod
from ray_tpu_torch._private.worker import ObjectRef, Worker, MODE_DRIVER
from ray_tpu_torch._private import node as _node_mod
from ray_tpu_torch.actor import (ActorClass, ActorHandle, get_actor,
                                 kill as _kill)
from ray_tpu_torch.remote_function import RemoteFunction

__version__ = "0.1.0"

__all__ = [
    "init", "shutdown", "is_initialized", "remote", "get", "put", "wait",
    "kill", "cancel", "get_actor", "ObjectRef", "ActorHandle",
    "cluster_resources", "available_resources", "nodes", "get_gpu_ids",
    "get_runtime_context", "method", "exceptions", "timeline",
    "__version__",
]

_init_lock = threading.Lock()
_node_processes: Optional[_node_mod.NodeProcesses] = None
_storage_env_set = False  # init(storage=...) set RTT_STORAGE this run


def _client():
    """Active ray:// client connection, or None (reference:
    util/client_connect.py client-mode hooks)."""
    from ray_tpu_torch.util.client import worker as _cw
    c = _cw._client
    return c if (c is not None and c.connected) else None


def is_initialized() -> bool:
    if _client() is not None:
        return True
    w = _worker_mod._global_worker
    return w is not None and w.connected


def init(address: Optional[str] = None, *,
         num_cpus: Optional[float] = None,
         num_gpus: Optional[float] = None,
         resources: Optional[Dict[str, float]] = None,
         labels: Optional[Dict[str, str]] = None,
         object_store_memory: Optional[int] = None,
         namespace: str = "",
         storage: Optional[str] = None,
         ignore_reinit_error: bool = False,
         _system_config: Optional[Dict[str, Any]] = None,
         log_to_driver: bool = True) -> Dict[str, Any]:
    """Start a local cluster (head) or connect to an existing one.

    Reference analogue: ray.init (python/ray/_private/worker.py:1031).
    ``num_gpus`` overrides the GPU count the head's raylet detects
    (``raylet.detect_gpus``), so a CPU-only box can schedule a fake count;
    a worker granted GPUs sees their indices in ``CUDA_VISIBLE_DEVICES``.
    """
    global _node_processes, _storage_env_set
    with _init_lock:
        if is_initialized():
            if ignore_reinit_error:
                c = _client()
                if c is not None:
                    return dict(c.server_info)
                return _worker_mod._global_worker.runtime_context
            raise RuntimeError("ray_tpu_torch.init() called twice "
                               "(use ignore_reinit_error=True)")
        config = SystemConfig().apply_env_overrides()
        if _system_config:
            config.update(_system_config)
        if address is None:
            address = os.environ.get("RTT_ADDRESS")
        if address and address.startswith("ray://"):
            # remote driver: everything routes over the client protocol
            # (reference: ray.init("ray://...") → util/client_connect.py);
            # this process starts no worker and loads no torch
            from ray_tpu_torch.util.client import worker as _cw
            c = _cw.connect(address[len("ray://"):], namespace=namespace)
            if storage is not None:
                os.environ["RTT_STORAGE"] = storage
                _storage_env_set = True
                c._call("client_kv", {"op": "put", "key": "@storage/root",
                                      "value": storage.encode()})
            return {"address": address, "namespace": namespace,
                    **{k: v for k, v in c.server_info.items()}}
        res: Dict[str, float] = dict(resources or {})
        if num_cpus is not None:
            res["CPU"] = float(num_cpus)
        if num_gpus is not None:
            res["GPU"] = float(num_gpus)

        if storage is not None:
            # cluster-wide storage root (reference: ray.init(storage=) →
            # _private/storage.py): workflows and any component needing
            # durable shared storage resolve it from here
            os.environ["RTT_STORAGE"] = storage
            _storage_env_set = True

        w = Worker()
        w.log_to_driver = log_to_driver
        if address is None:
            procs = _node_mod.start_head(
                config, resources=res, labels=labels,
                object_store_memory=object_store_memory)
            _node_processes = procs
            w.connect(MODE_DRIVER, procs.gcs_address, procs.raylet_address,
                      procs.store_path, procs.node_id, procs.session_dir,
                      namespace=namespace)
        else:
            # connect to an existing cluster: find a raylet on this host
            import json as _json
            from ray_tpu_torch._private import protocol as _protocol
            io = _protocol.EventLoopThread("probe")
            conn = io.run(_protocol.connect(address))
            nodes_ = io.run(conn.call("get_nodes", {}))
            conn.close()
            io.stop()
            hostname = os.uname().nodename
            candidates = [n for n in nodes_ if n["alive"]]
            local = [n for n in candidates if n.get("hostname") == hostname
                     and os.path.exists(n["object_store_path"])]
            target = (local or candidates)[0]
            session_dir = os.environ.get(
                "RTT_SESSION_DIR", _node_mod.new_session_dir())
            w.connect(MODE_DRIVER, address,
                      target["raylet_address"].replace("127.0.0.1:", "")
                      if False else _raylet_unix_for(target, session_dir),
                      target["object_store_path"], target["node_id"],
                      session_dir, namespace=namespace)
        if storage is not None:
            from ray_tpu_torch._private.storage import _publish
            _publish(storage)
        w.config = config
        w.runtime_context = {
            "gcs_address": w.gcs and address or
            (_node_processes.gcs_address if _node_processes else address),
            "session_dir": w.session_dir,
            "node_id": w.node_id,
            "job_id": w.job_id.hex(),
            "namespace": namespace,
        }
        from ray_tpu_torch._private import usage as _usage
        _usage.write_report(w.session_dir,
                            {"node_id": w.node_id,
                             "namespace": namespace})
        atexit.register(shutdown)
        return w.runtime_context


def _raylet_unix_for(node_info: Dict[str, Any], session_dir: str) -> str:
    # Raylets listen on both a unix socket (intra-node) and TCP (inter-node).
    # When connecting by address we use TCP unless a local socket exists.
    sock = os.path.join(os.path.dirname(node_info["object_store_path"]),
                        f"raylet_{node_info['node_id'][:12]}.sock")
    if os.path.exists(sock):
        return f"unix:{sock}"
    return node_info["raylet_address"]


def shutdown():
    global _node_processes, _storage_env_set
    if _storage_env_set:
        # don't leak this run's storage root into the next init
        os.environ.pop("RTT_STORAGE", None)
        _storage_env_set = False
    if _client() is not None:
        from ray_tpu_torch.util.client import worker as _cw
        _cw.disconnect()
        return
    w = _worker_mod._global_worker
    if w is not None and w.connected:
        w.disconnect()
    _worker_mod._global_worker = None
    # drop any driver-side chaos engine so one chaos run cannot leak
    # faults into the next init in the same process
    from ray_tpu_torch._private import chaos as _chaos
    _chaos.clear()
    if _node_processes is not None:
        _node_processes.kill_all()
        _node_processes = None


def remote(*args, **kwargs):
    """``@remote`` / ``@remote(num_gpus=1, ...)`` for functions and classes."""
    if len(args) == 1 and not kwargs and (callable(args[0])):
        target = args[0]
        if isinstance(target, type):
            return ActorClass(target, {})
        return RemoteFunction(target, {})
    opts = kwargs

    def decorator(target):
        if isinstance(target, type):
            return ActorClass(target, opts)
        return RemoteFunction(target, opts)
    return decorator


def method(**opts):
    """Per-method options decorator (parity: ray.method)."""
    def decorator(m):
        m.__rtpu_method_opts__ = opts
        return m
    return decorator


def put(value: Any) -> ObjectRef:
    c = _client()
    if c is not None:
        return c.put(value)
    return _worker_mod.global_worker().put_object(value)


def get(refs: Union[ObjectRef, List[ObjectRef]], *,
        timeout: Optional[float] = None):
    c = _client()
    if c is not None:
        if isinstance(refs, list):
            return c.get(refs, timeout=timeout)
        return c.get([refs], timeout=timeout)[0]
    return _worker_mod.get(refs, timeout=timeout)


def wait(refs: Sequence[ObjectRef], *, num_returns: int = 1,
         timeout: Optional[float] = None, fetch_local: bool = True):
    refs = list(refs)
    if not refs:
        return [], []
    if num_returns > len(refs):
        raise ValueError("num_returns > len(refs)")
    c = _client()
    if c is not None:
        return c.wait(refs, num_returns, timeout)
    return _worker_mod.global_worker().wait(refs, num_returns, timeout)


def kill(actor, *, no_restart: bool = True):
    c = _client()
    if c is not None:
        c.kill_actor(actor._id_hex, no_restart=no_restart)
        return
    _kill(actor, no_restart=no_restart)


def cancel(ref: ObjectRef, *, force: bool = False):
    c = _client()
    if c is not None:
        c.cancel(ref.hex(), force=force)
        return
    w = _worker_mod.global_worker()
    task_id = ref.id().task_id().hex()
    # leased/parked tasks are invisible to the raylet (direct
    # owner->worker pushes) — cancel them owner-side first
    w.cancel_leased_task(task_id)
    w.call_sync(w.raylet, "cancel_task",
                {"task_id": task_id, "force": force})


def cluster_resources() -> Dict[str, float]:
    c = _client()
    if c is not None:
        return c.cluster_info("cluster_resources")
    w = _worker_mod.global_worker()
    return w.call_sync(w.gcs, "cluster_resources", {})


def available_resources() -> Dict[str, float]:
    c = _client()
    if c is not None:
        return c.cluster_info("available_resources")
    w = _worker_mod.global_worker()
    return w.call_sync(w.gcs, "available_resources", {})


def nodes() -> List[Dict[str, Any]]:
    c = _client()
    if c is not None:
        return c.cluster_info("nodes")
    w = _worker_mod.global_worker()
    return w.call_sync(w.gcs, "get_nodes", {})


def get_gpu_ids() -> List[int]:
    """GPU indices granted to the current task or actor (reference:
    ray.get_gpu_ids, worker.py:821); the worker's ``CUDA_VISIBLE_DEVICES``
    lists the same indices. ``[]`` in the driver and in a task granted
    none."""
    w = _worker_mod.global_worker()
    return list(w.gpu_ids)


class _RuntimeContext:
    @property
    def worker(self):
        return _worker_mod.global_worker()

    def get_node_id(self) -> str:
        return self.worker.node_id

    def get_job_id(self) -> str:
        return self.worker.job_id.hex()

    def get_task_id(self) -> Optional[str]:
        t = self.worker.current_task_id
        return t.hex() if t else None

    def get_actor_id(self) -> Optional[str]:
        a = self.worker.current_actor_id
        return a.hex() if a else None

    def get_worker_id(self) -> str:
        return self.worker.worker_id.hex()

    def get_assigned_resources(self) -> Dict[str, float]:
        return {}

    @property
    def namespace(self) -> str:
        return self.worker.namespace


def get_runtime_context() -> _RuntimeContext:
    return _RuntimeContext()


def timeline() -> List[Dict[str, Any]]:
    """Merged cross-process chrome-trace events (reference:
    ray timeline / state.py:414 chrome_tracing_dump)."""
    from ray_tpu_torch.util import timeline as _tl
    return _tl.timeline_dump()
