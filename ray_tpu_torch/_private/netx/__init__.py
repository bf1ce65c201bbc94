"""netx: the unified cross-node transport plane.

Every fast path in the runtime — the direct-execution lane (direct.py),
compiled-DAG channels (dag/channel.py), and bulk object transfer — was
same-host only: endpoints were unix socket paths, and the one TCP
surface (raylet pull_object) rode the asyncio control plane at
~63 MiB/s (SCALE.md).  netx takes them all off-box:

* **endpoints** — who am I (``RTT_NODE_IP`` → resolved hostname →
  loopback), which advertised endpoint to dial (unix for on-box peers,
  ``host:port`` otherwise), and the ``net.partition`` chaos gate.
* **client** — ONE shared native frame pump + IO thread per process:
  pooled request/reply connections to any pump server (raylet transfer
  servers, worker direct sockets) with keepalive pings, idle reaping
  and exponential-backoff redial, plus the ``px_*`` pull protocol that
  streams object chunks straight into a plasma create buffer.
* **server** — the raylet-side transfer server: ``px_get`` headers and
  windowed, round-robin-interleaved ``px_chunk`` streams served by the
  native pump (the asyncio loop is only consulted for store admission,
  spill restore and the serve-concurrency tree cap).

Wire frames are standard schema-1.x msgpack frames
(docs/WIRE_PROTOCOL.md §1.8); ``RTT_NETX=0`` turns the whole plane
off and every caller degrades to the unix/asyncio paths.
"""

from ray_tpu_torch._private.netx.endpoints import (  # noqa: F401
    enabled, force_tcp, host_of, node_ip, partitioned, pick, same_host)
from ray_tpu_torch._private.netx.client import (  # noqa: F401
    NetxClient, get_client, reset_client_for_tests)
from ray_tpu_torch._private.netx.server import NetxServer  # noqa: F401
