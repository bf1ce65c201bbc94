"""GCS server process entrypoint (reference: gcs_server_main.cc).

Copied from the JAX package's ``ray_tpu/_private/gcs_main.py``; loads no
torch and no CUDA."""

import asyncio
import logging
import os

from ray_tpu_torch._private.gcs import GcsServer
from ray_tpu_torch.common.config import SystemConfig


async def main():
    logging.basicConfig(level=os.environ.get("RTT_LOG_LEVEL", "INFO"))
    session_dir = os.environ["RTT_SESSION_DIR"]
    port = int(os.environ.get("RTT_GCS_PORT", "0"))
    cfg_json = os.environ.get("RTT_SYSTEM_CONFIG")
    config = SystemConfig.from_json(cfg_json) if cfg_json else SystemConfig()
    store_dir = os.environ.get("RTT_GCS_STORE_DIR") or \
        os.path.join(session_dir, "gcs_store")
    from ray_tpu_torch.util import events
    events.init_emitter("gcs", session_dir)
    from ray_tpu_torch._private import chaos
    eng = chaos.init_from_env("gcs")
    gcs = GcsServer(config, store_path=store_dir)
    if eng is not None:
        eng.set_notifier(gcs.events.append)
    actual = await gcs.start("127.0.0.1", port)
    tmp = os.path.join(session_dir, ".gcs_port.tmp")
    with open(tmp, "w") as f:
        f.write(str(actual))
    os.replace(tmp, os.path.join(session_dir, "gcs_port"))
    await asyncio.Event().wait()


if __name__ == "__main__":
    asyncio.run(main())
