"""ray:// remote connectivity (reference: python/ray/util/client/).

Usage: ``ray_tpu_torch.init("ray://head-host:10001")`` on any machine that can
reach the head; the public API (remote/get/put/wait/actors) then routes
over the client protocol. Server side: ``ClientServer`` in a process with
a real driver connection (``ClientServer(port=10001)`` after ``init``, or
``ray-tpu-torch start --head --ray-client-server-port 10001``). A client
process imports neither torch nor the kernels: work that needs a card
runs in the cluster's GPU-granted processes.

Copied from the JAX package's ``ray_tpu/util/client/__init__.py``.
"""

from ray_tpu_torch.util.client.common import (  # noqa: F401
    ClientActorHandle, ClientObjectRef)
from ray_tpu_torch.util.client.worker import (  # noqa: F401
    ClientWorker, client_mode, connect, disconnect)
