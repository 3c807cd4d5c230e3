"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu's models (Llama, ViT),
serving, training and RL (GRPO, PPO) paths, its mesh and sharding, and its
task/actor/object runtime (in-process, or a multi-process cluster of GCS,
node agents and worker processes: ``ray_tpu_torch.cluster``) with Train,
Tune, Serve, Data, DAGs (``dag``, compiled onto shared-memory channels),
``workflow`` and ``util``'s shims on it.

Mirrors ``ray_tpu``'s module paths and public names (``ops``, ``models``,
``serve.llm``, ``train``, ``tune``, ``rl``, ``parallel``, ``core``, ``util``
and the top-level ``init``/``remote``/``get``/``put``...) so each function
has an obvious counterpart. The runtime's accelerator resource is ``GPU``
(``num_gpus=``), where the JAX package's is ``TPU``. Hot kernels are
hand-written CUDA C++ for Hopper under ``csrc/``; they are compiled at their
first launch (``_kernels.py``), never on import, so importing the package
needs neither a card nor ``nvcc``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no card present they raise instead of falling back to the CPU.
"""

from ray_tpu_torch._version import __version__
# the runtime's API first: train.trainer declares its worker actor with
# ray_tpu_torch.remote while the package is still importing
from ray_tpu_torch.api import (available_resources, cancel, cluster_resources, free, get,
                               get_actor, get_runtime_context, init, is_initialized, kill,
                               kv_del, kv_get, kv_keys, kv_put, list_named_actors, nodes, put,
                               remote, shutdown, wait)
from ray_tpu_torch.core.actor import ActorClass, ActorHandle, method
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.core.remote_function import RemoteFunction
from ray_tpu_torch.core.streaming import ObjectRefGenerator
from ray_tpu_torch import exceptions
from ray_tpu_torch.profiling import profile

# The train step's names load on first use, through ``train``'s own
# PEP 562 hook: they import torch, which takes seconds, and the cluster's
# daemons (GCS, node agents) and its CPU workers import this package
# without needing it.
from ray_tpu_torch import train


def __getattr__(name):
    if name in train.STEP_NAMES:
        return getattr(train, name)
    raise AttributeError(f"module 'ray_tpu_torch' has no attribute {name!r}")


__all__ = ["AdamW", "AdamWConstant", "AdamWState", "ActorClass", "ActorHandle", "ObjectRef",
           "ObjectRefGenerator", "RemoteFunction", "TrainState", "adamw", "available_resources",
           "cancel", "cluster_resources", "default_optimizer", "exceptions", "free", "get",
           "get_actor", "get_runtime_context", "init", "is_initialized", "kill", "kv_del",
           "kv_get", "kv_keys", "kv_put", "list_named_actors", "make_eval_step",
           "make_train_state_factory", "make_train_step", "method", "nodes", "profile", "put",
           "remote", "shutdown", "train_state_from_jax", "wait"]
