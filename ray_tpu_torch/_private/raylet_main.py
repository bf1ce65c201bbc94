"""Raylet process entrypoint (reference: src/ray/raylet/main.cc).

Copied from the JAX package's ``ray_tpu/_private/raylet_main.py``; loads
no torch and no CUDA (the GPU count comes from ``raylet.detect_gpus``)."""

import asyncio
import json
import logging
import os
import signal

from ray_tpu_torch._private.raylet import Raylet
from ray_tpu_torch.common.config import SystemConfig


async def main():
    logging.basicConfig(level=os.environ.get("RTT_LOG_LEVEL", "INFO"))
    session_dir = os.environ["RTT_SESSION_DIR"]
    profiler = None
    if os.environ.get("RTT_CPROFILE_DIR") and \
            "raylet" in os.environ.get("RTT_CPROFILE_PROCS", "raylet"):
        # perf-debug aid: RTT_CPROFILE_DIR=/tmp/prof dumps a pstats
        # file per process at exit (the driver can't see inside the
        # raylet hot path any other way)
        import cProfile
        profiler = cProfile.Profile()
        profiler.enable()
        import atexit
        atexit.register(lambda: profiler.dump_stats(os.path.join(
            os.environ["RTT_CPROFILE_DIR"],
            f"raylet_{os.getpid()}.pstats")))
    from ray_tpu_torch.util import events
    events.init_emitter("raylet", session_dir)
    node_id = os.environ["RTT_NODE_ID"]
    from ray_tpu_torch._private import chaos
    chaos.init_from_env("raylet",
                        is_head=os.environ.get("RTT_IS_HEAD") == "1")
    raylet = Raylet(
        config=SystemConfig().apply_env_overrides(),
        node_id=node_id,
        session_dir=session_dir,
        gcs_address=os.environ["RTT_GCS_ADDRESS"],
        resources=json.loads(os.environ.get("RTT_RESOURCES", "{}")),
        labels=json.loads(os.environ.get("RTT_LABELS", "{}")),
        is_head=os.environ.get("RTT_IS_HEAD") == "1",
        object_store_memory=int(os.environ["RTT_OBJECT_STORE_BYTES"])
        if os.environ.get("RTT_OBJECT_STORE_BYTES") else None,
    )
    await raylet.start()
    info = {"unix_address": raylet.unix_address,
            "tcp_address": raylet.address,
            "store_path": raylet.store_path,
            "node_id": node_id}
    tmp = os.path.join(session_dir, f".raylet_{node_id[:8]}.tmp")
    with open(tmp, "w") as f:
        json.dump(info, f)
    os.replace(tmp, os.path.join(session_dir, f"raylet_{node_id[:8]}.json"))
    # Graceful shutdown on SIGTERM/SIGINT: kill workers and unlink the shm
    # segment — otherwise every session leaks its plasmax file into /dev/shm
    # (a fixed-size tmpfs) until the host runs dry.
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGTERM, signal.SIGINT):
        loop.add_signal_handler(sig, stop.set)
    # SIGUSR2 = preemption notice (how a TPU spot/maintenance notice
    # reaches the host agent): graceful drain inside the grace window
    # instead of vanishing — see raylet._preempt_drain.
    loop.add_signal_handler(signal.SIGUSR2, raylet.preempt_from_signal)
    eng = chaos.engine()
    if eng is not None:
        # chaos faults land in the GCS event ring so fault→detect→
        # recover latency is measurable from one stream
        from ray_tpu_torch._private import protocol

        def _ship_chaos_event(ev):
            def _go():
                try:
                    if raylet.gcs is not None:
                        protocol.spawn(raylet.gcs.notify("add_event", ev))
                except Exception:
                    pass
            loop.call_soon_threadsafe(_go)

        eng.set_notifier(_ship_chaos_event)
    await stop.wait()
    raylet.shutdown()


if __name__ == "__main__":
    asyncio.run(main())
