"""ray_tpu_torch.serve — model/application serving over the actor runtime
(the port of ray_tpu.serve).

Reference capability: python/ray/serve (controller, proxy, replicas, pow-2
routing, dynamic batching, autoscaling). The flagship deployment is the
continuous-batched LLM engine (serve.llm) with a paged KV cache on the card;
``ray_actor_options={"num_gpus": 1}`` places its replica on a GPU.

Each proxy serves HTTP and the msgpack-RPC ingress (``ServeRpcClient`` on
its ``rpc_address()``); ``proxy_location="every_node"`` pins one proxy to
each alive node of a cluster. A replica with ``num_gpus=1`` on the cluster
runtime is a worker process of its own that sees its card only.
"""

from ray_tpu_torch.serve.api import (
    delete,
    get_app_handle,
    get_deployment_handle,
    http_address,
    http_addresses,
    run,
    shutdown,
    start,
    status,
)
from ray_tpu_torch.serve.batching import batch
from ray_tpu_torch.serve.deployment import Application, AutoscalingConfig, Deployment, deployment
from ray_tpu_torch.serve.handle import DeploymentHandle, DeploymentResponse
from ray_tpu_torch.serve.multiplex import get_multiplexed_model_id, multiplexed
from ray_tpu_torch.serve.rpc_ingress import ServeRpcClient
from ray_tpu_torch.serve import schema

__all__ = [
    "get_multiplexed_model_id",
    "multiplexed",
    "schema",
    "Application",
    "AutoscalingConfig",
    "Deployment",
    "DeploymentHandle",
    "DeploymentResponse",
    "ServeRpcClient",
    "batch",
    "delete",
    "deployment",
    "get_app_handle",
    "get_deployment_handle",
    "http_address",
    "http_addresses",
    "run",
    "shutdown",
    "start",
    "status",
]
