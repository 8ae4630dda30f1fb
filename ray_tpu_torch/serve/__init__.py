# Copied from ray_tpu/serve/__init__.py (JAX-free): module names read ray_tpu_torch.
"""Model serving (reference: python/ray/serve)."""

from .api import (
    delete,
    get_app_handle,
    local_grpc_port,
    run,
    shutdown,
    proxy_ports,
    start,
    status,
    status_detail,
)
from .multiplex import get_multiplexed_model_id, multiplexed
from .observability import get_request_id
from .deployment import (
    Application,
    AutoscalingConfig,
    Deployment,
    batch,
    deployment,
)
from .proxy import Request
from .router import (
    DeploymentHandle,
    DeploymentOverloaded,
    DeploymentResponse,
)

__all__ = [
    "deployment",
    "multiplexed",
    "get_multiplexed_model_id",
    "local_grpc_port",
    "Deployment",
    "Application",
    "AutoscalingConfig",
    "batch",
    "run",
    "proxy_ports",
    "start",
    "status",
    "status_detail",
    "get_request_id",
    "delete",
    "shutdown",
    "get_app_handle",
    "DeploymentHandle",
    "DeploymentOverloaded",
    "DeploymentResponse",
    "Request",
]
