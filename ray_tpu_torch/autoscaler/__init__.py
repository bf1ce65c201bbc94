"""ray_tpu_torch.autoscaler — demand-driven cluster scaling
(reference: autoscaler/_private/autoscaler.py + node providers).

Copied from the JAX package's ``ray_tpu/autoscaler/__init__.py``, with
``GCPGPUNodeProvider`` in ``GCPTPUNodeProvider``'s place."""

from ray_tpu_torch.autoscaler.autoscaler import (AutoscalerMonitor,
                                                 LoadMetrics,
                                                 StandardAutoscaler,
                                                 request_resources)
from ray_tpu_torch.autoscaler.node_provider import (FakeMultiNodeProvider,
                                                    NodeProvider)
from ray_tpu_torch.autoscaler.config import (ConfigError, load_config,
                                             make_provider, prepare_config,
                                             validate_config)
from ray_tpu_torch.autoscaler.gcp_gpu import GCPGPUNodeProvider
from ray_tpu_torch.autoscaler.commands import (create_or_update_cluster,
                                               teardown_cluster)

__all__ = ["StandardAutoscaler", "AutoscalerMonitor", "LoadMetrics",
           "request_resources", "NodeProvider", "FakeMultiNodeProvider",
           "GCPGPUNodeProvider", "load_config", "prepare_config",
           "validate_config", "make_provider", "ConfigError",
           "create_or_update_cluster", "teardown_cluster"]
