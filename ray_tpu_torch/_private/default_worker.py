"""Worker process entrypoint (reference:
python/ray/_private/workers/default_worker.py → RunTaskExecutionLoop)."""

import faulthandler
import logging
import os
import signal


def main():
    logging.basicConfig(level=os.environ.get("RTT_LOG_LEVEL", "WARNING"))
    # SIGUSR1 dumps all thread stacks to stderr (worker .err log) — the
    # hung-worker debugging hook (reference: ray SIGTERM stack traces).
    faulthandler.register(signal.SIGUSR1, all_threads=True)
    if os.environ.get("RTT_CPROFILE_DIR") and \
            "worker" in os.environ.get("RTT_CPROFILE_PROCS", "worker"):
        import atexit
        import cProfile
        profiler = cProfile.Profile()
        profiler.enable()
        atexit.register(lambda: profiler.dump_stats(os.path.join(
            os.environ["RTT_CPROFILE_DIR"],
            f"worker_{os.getpid()}.pstats")))
    from ray_tpu_torch._private import chaos
    eng = chaos.init_from_env("worker")
    from ray_tpu_torch._private.worker import Worker, MODE_WORKER

    w = Worker()
    w.connect(
        mode=MODE_WORKER,
        gcs_address=os.environ["RTT_GCS_ADDRESS"],
        raylet_address=os.environ["RTT_RAYLET_ADDRESS"],
        store_path=os.environ["RTT_STORE_PATH"],
        node_id=os.environ["RTT_NODE_ID"],
        session_dir=os.environ["RTT_SESSION_DIR"],
    )
    reply = w.call_sync(w.raylet, "worker_register", {
        "worker_id": os.environ["RTT_WORKER_ID"],
        "address": w.address,
        # 1.7: the native direct-call lane's socket (empty when the
        # pump is disabled/unbuildable); the raylet forwards it in
        # lease_worker replies so owners can skip the asyncio path
        "direct_address": w.direct_address,
        # 1.8: the lane's host:port twin (netx) for off-box owners
        "direct_tcp_address": w.direct_tcp_address,
    })
    from ray_tpu_torch.common.config import SystemConfig, set_global_config
    w.config = SystemConfig.from_json(reply["config"])
    set_global_config(w.config)
    if eng is not None:
        eng.set_notifier(
            lambda ev: w.io.run_async(w.gcs.notify("add_event", ev)))
    w.task_execution_loop()


if __name__ == "__main__":
    main()
