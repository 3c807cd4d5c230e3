from ray_tpu_torch.autoscaler.autoscaler import (
    AutoscalerConfig,
    SliceAutoscaler,
    SliceAutoscalerConfig,
    StandardAutoscaler,
)
from ray_tpu_torch.autoscaler.instance_manager import (
    CloudProvider,
    FakeCloudProvider,
    Instance,
    InstanceManager,
)
from ray_tpu_torch.autoscaler.node_provider import LocalNodeProvider, NodeProvider

__all__ = [
    "AutoscalerConfig", "StandardAutoscaler", "NodeProvider",
    "LocalNodeProvider", "SliceAutoscaler", "SliceAutoscalerConfig",
    "CloudProvider", "FakeCloudProvider", "Instance", "InstanceManager",
]
