"""ray_tpu_torch.dashboard — HTTP observability + job REST
(reference: dashboard/).

Copied from the JAX package's ``ray_tpu/dashboard/__init__.py``."""

from ray_tpu_torch.dashboard.dashboard import (DASHBOARD_NAME, DashboardActor,
                                               start_dashboard)

__all__ = ["start_dashboard", "DashboardActor", "DASHBOARD_NAME"]
