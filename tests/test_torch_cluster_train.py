"""Training and serving through worker processes of the port's cluster.

- ``GpuTrainer(use_torch_distributed=True)`` with two ``TrainWorker``
  processes forms one gloo process group from worker 0's address (the
  multi-process rendezvous; in the in-process runtime it raises). Each
  worker takes the loss and gradients of ``LlamaConfig.tiny`` in fp32 on
  its half of the batch and averages them over the group: the result must
  match the JAX package's loss and gradients on the whole batch, from the
  same weights, at ``tests/test_torch_train.py``'s tolerance (atol 1e-5,
  rtol 1e-4). ``tests/test_train_multiprocess.py`` is the JAX package's
  counterpart (``jax.distributed`` across two worker processes).
- A tiny fp32 ``LLMDeployment`` served through ``serve.run`` from a replica
  in a worker process gives the same greedy tokens as the same deployment
  on the port's in-process runtime, which ``tests/test_torch_serve.py``
  holds against the JAX package's.

One port cluster (2-CPU head) for the module; each test connects its own
driver. The JAX side runs in this process.
"""

import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu.models import llama as jl
from ray_tpu_torch.cluster import Cluster
from ray_tpu_torch.models import llama as tl

JCFG = jl.LlamaConfig.tiny(dtype=jnp.float32, remat=None, attention_impl="reference")
GRAD_ATOL, GRAD_RTOL, LOSS_ATOL = 1e-5, 1e-4, 1e-5


@pytest.fixture(scope="module")
def cluster():
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    c = Cluster(initialize_head=True, head_node_args={"num_cpus": 2})
    try:
        yield c
    finally:
        if ray_tpu_torch.is_initialized():
            ray_tpu_torch.shutdown()
        c.shutdown()


def _flat_jax(tree):
    """JAX pytree leaves in the port's _leaves order (key-sorted)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _flat_jax(tree[k])]
    return [np.asarray(tree)]


def test_two_process_data_parallel_step_matches_jax(cluster, tmp_path):
    from ray_tpu_torch.train import GpuTrainer, RunConfig, ScalingConfig

    jp = jl.llama_init(JCFG, jax.random.key(1))
    tokens = np.random.default_rng(4).integers(0, 256, (4, 32)).astype(np.int32)
    targets = np.roll(tokens, -1, axis=1)
    with jax.default_matmul_precision("highest"):
        jloss, jgrads = jax.value_and_grad(lambda p: jl.llama_loss(
            p, jnp.asarray(tokens), jnp.asarray(targets), JCFG))(jp)
    grads_file = str(tmp_path / "grads.npz")

    # defined here: cloudpickle sends it by value to the worker processes
    def train_fn(config):
        import os
        import sys

        import numpy as np
        import torch
        import torch.distributed as dist

        from ray_tpu_torch.models import llama as tl
        from ray_tpu_torch.train import session
        from ray_tpu_torch.train.step import _leaves

        rank, world = dist.get_rank(), dist.get_world_size()
        cfg = tl.LlamaConfig.tiny(dtype=torch.float32, remat=None)
        params = tl.params_from_jax(config["params"])  # numpy leaves: no JAX here
        rows = config["tokens"].shape[0] // world
        part = slice(rank * rows, (rank + 1) * rows)
        leaves = _leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss = tl.llama_loss(params, torch.from_numpy(config["tokens"][part]).long(),
                             torch.from_numpy(config["targets"][part]).long(), cfg)
        grads = torch.autograd.grad(loss, leaves)
        loss = loss.detach()
        for t in (loss, *grads):
            dist.all_reduce(t)
            t /= world
        if rank == 0:
            np.savez(config["grads_file"], *[g.numpy() for g in grads])
        session.report({"loss": loss.item(), "world": world, "backend": dist.get_backend(),
                        "pid": os.getpid(),
                        "jax_package_loaded": "ray_tpu" in sys.modules or "jax" in sys.modules})

    ray_tpu_torch.init(address=cluster.gcs_address)
    try:
        result = GpuTrainer(
            train_fn,
            # numpy, so the Tune trial's process unpickles it without torch
            train_loop_config={"params": jax.tree.map(np.asarray, jp), "tokens": tokens,
                               "targets": targets, "grads_file": grads_file},
            scaling_config=ScalingConfig(num_workers=2),
            run_config=RunConfig(name="dp", storage_path=str(tmp_path)),
            use_torch_distributed=True,
        ).fit()
    finally:
        ray_tpu_torch.shutdown()
    assert result.error is None, result.error
    m = result.metrics
    assert (m["world"], m["backend"], m["jax_package_loaded"]) == (2, "gloo", False)
    assert m["pid"] != os.getpid()
    assert abs(m["loss"] - float(jloss)) < LOSS_ATOL
    with np.load(grads_file) as f:
        got = [f[f"arr_{i}"] for i in range(len(f.files))]
    want = _flat_jax(jgrads)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=GRAD_ATOL, rtol=GRAD_RTOL)


def test_two_in_process_workers_still_refused():
    """The refusal stays for the in-process runtime, whose workers share a
    process (and so one default process group)."""
    from ray_tpu_torch.train import GpuTrainer, ScalingConfig

    ray_tpu_torch.init(num_cpus=2)
    try:
        with pytest.raises(ValueError, match="in-process runtime"):
            GpuTrainer(lambda: None, scaling_config=ScalingConfig(num_workers=2),
                       use_torch_distributed=True).fit()
    finally:
        ray_tpu_torch.shutdown()


PROMPTS = [[3, 14, 15, 92, 65, 35], [1, 2, 3], list(range(20, 45))]


def _tiny_fp32_deployment():
    """An LLMDeployment on LlamaConfig.tiny in fp32 on the CPU, defined in a
    function so cloudpickle sends it by value to the replica's process."""
    from ray_tpu_torch.serve.llm import LLMDeployment

    class TinyFp32(LLMDeployment):
        def __init__(self, params, **kw):
            import torch

            from ray_tpu_torch.models.llama import LlamaConfig
            from ray_tpu_torch.serve.llm import LLMEngine

            self.engine = LLMEngine(LlamaConfig.tiny(dtype=torch.float32, remat=None), params,
                                    device="cpu", **kw)

        def where(self):
            import os
            import sys

            return os.getpid(), "ray_tpu" in sys.modules

    return TinyFp32


def _serve_tokens(params):
    from ray_tpu_torch import serve

    app = serve.deployment(_tiny_fp32_deployment(), name="llm").bind(
        params=params, num_slots=2, decode_chunk=4, max_seq_len=64)
    handle = serve.run(app, http=False)
    try:
        reqs = [{"tokens": p, "max_tokens": 6, "timeout": 60} for p in PROMPTS]
        one_by_one = [handle.generate.remote(r).result(timeout=60)["tokens"] for r in reqs]
        together = [r.result(timeout=60)["tokens"]
                    for r in [handle.generate.remote(q) for q in reqs]]
        pid, jax_package_loaded = handle.where.remote().result(timeout=60)
    finally:
        serve.shutdown()
    deadline = time.monotonic() + 10
    while (time.monotonic() < deadline
           and any(t.name == "serve-control-loop" for t in threading.enumerate())):
        time.sleep(0.1)
    return one_by_one, together, pid, jax_package_loaded


def test_llm_deployment_on_a_replica_process_matches_in_process(cluster):
    params = tl.params_from_jax(jl.llama_init(JCFG, jax.random.key(1)))
    ray_tpu_torch.init(num_cpus=4)
    try:
        local_tokens, local_together, local_pid, _ = _serve_tokens(params)
    finally:
        ray_tpu_torch.shutdown()
    ray_tpu_torch.init(address=cluster.gcs_address)
    try:
        tokens, together, pid, jax_package_loaded = _serve_tokens(params)
    finally:
        ray_tpu_torch.shutdown()
    assert local_pid == os.getpid() != pid  # the replica is a process of its own
    assert not jax_package_loaded
    assert [len(t) for t in tokens] == [6] * len(PROMPTS)
    assert tokens == local_tokens and together == local_together == tokens
