"""A compiled DAG with a GPU stage and the RPC ingress streaming from a GPU
replica, on the port's cluster runtime on the card.

Marked ``cuda``: every test skips without an NVIDIA card. On a machine with
one (and without JAX, which tests/conftest.py imports):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_dag_gpu.py
"""

import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def gpu_cluster():
    """One node of the port's cluster whose agent counts the card itself."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the cluster's GPU workers run on it")
    import ray_tpu_torch
    from ray_tpu_torch.cluster import Cluster

    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    c = Cluster(initialize_head=True, head_node_args={"num_cpus": 4})
    try:
        ray_tpu_torch.init(address=c.gcs_address)
        yield c
    finally:
        if ray_tpu_torch.is_initialized():
            ray_tpu_torch.shutdown()
        c.shutdown()


def test_compiled_dag_gpu_stage_returns_a_cuda_tensor(gpu_cluster):
    """A CPU stage feeds a num_gpus=1 stage over a shared-memory channel; the
    GPU stage computes on its card and its CUDA tensor lands on the driver's
    card, bit-equal to the same product computed here."""
    import ray_tpu_torch
    from ray_tpu_torch.dag import InputNode

    class Source:
        def make(self, seed):
            g = torch.Generator().manual_seed(seed)
            return torch.randn(64, 64, generator=g).to(torch.bfloat16)

    class Square:
        def run(self, x):
            import os

            x = x.to("cuda")  # it left from the CPU: it lands on the CPU
            y = x @ x
            return {"y": y, "device": str(y.device),
                    "visible": os.environ.get("CUDA_VISIBLE_DEVICES")}

    src = ray_tpu_torch.remote(Source).bind()
    sq = ray_tpu_torch.remote(Square).options(num_gpus=1).bind()
    with InputNode() as seed:
        dag = sq.run.bind(src.make.bind(seed))
    compiled = dag.experimental_compile()
    try:
        outs = [compiled.execute(s).get(timeout=300) for s in (1, 2)]
    finally:
        compiled.teardown()
        for actor in compiled._actors.values():  # the GPU stage holds the card
            ray_tpu_torch.kill(actor)
    for s, out in zip((1, 2), outs):
        x = Source().make(s).cuda()
        assert out["device"].startswith("cuda") and out["visible"] == "0"
        assert out["y"].device.type == "cuda" and out["y"].dtype == torch.bfloat16
        assert torch.equal(out["y"].view(torch.int16), (x @ x).view(torch.int16))


def test_rpc_ingress_streams_from_a_gpu_replica(gpu_cluster):
    """A num_gpus=1 replica streams items computed on its card through the
    proxy's msgpack-RPC ingress, item by item, as lists of ints."""
    from ray_tpu_torch import serve

    class CardCounter:
        def __call__(self, n):
            import torch as t

            x = t.arange(int(n), device="cuda")
            for i in range(int(n)):
                yield {"i": int(x[i].item()), "device": x.device.type}

    try:
        serve.run(serve.deployment(CardCounter, name="counter", stream=True)
                  .options(ray_actor_options={"num_gpus": 1}).bind(),
                  name="counter", http_port=0)
        import ray_tpu_torch

        addr = ray_tpu_torch.get(serve.api._state["proxy"].rpc_address.remote(), timeout=60)
        client = serve.ServeRpcClient(addr)
        try:
            items = list(client.stream("counter", 5, item_timeout=120))
        finally:
            client.close()
        assert items == [{"i": i, "device": "cuda"} for i in range(5)]
    finally:
        serve.shutdown()
