"""The external placement policy (``core/gcs/external_policy.py``: the
GCS batches placement requests to a line-JSON service) on the port's
cluster, held against the JAX package's.

The scenarios of ``tests/test_cluster_external_policy.py``, each run on the
JAX package's cluster and then on the port's. A policy server written for
the JAX package (this one is the reference test's) serves the port
unchanged. The clusters of this file start with
``RAY_TPU_EXTERNAL_SCHEDULER_ADDRESS`` set, so they have a file of their
own: ``tests/test_torch_cluster.py``'s run without a policy."""

import json
import os
import socket
import threading

import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu.cluster import Cluster as JaxCluster
from ray_tpu_torch.cluster import Cluster as PortCluster
from ray_tpu_torch.core.resources import SpreadSchedulingStrategy

PACKAGES = (ray_tpu, ray_tpu_torch)
CLUSTERS = {"ray_tpu": JaxCluster, "ray_tpu_torch": PortCluster}


class _PolicyServer(threading.Thread):
    """Minimal line-JSON external placement policy: pins every request to one
    chosen node and records everything it saw (protocol: gcs/external_policy.py)."""

    def __init__(self):
        super().__init__(daemon=True)
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(4)
        self.port = self.sock.getsockname()[1]
        self.nodes = []
        self.batches = []
        self.pin_node = None
        self.lock = threading.Lock()

    def run(self):
        try:
            conn, _ = self.sock.accept()
        except OSError:
            return
        buf = b""
        while True:
            try:
                data = conn.recv(65536)
            except OSError:
                return
            if not data:
                return
            buf += data
            while b"\n" in buf:
                line, buf = buf.split(b"\n", 1)
                msg = json.loads(line)
                with self.lock:
                    if msg["op"] == "add_node":
                        self.nodes.append(msg["node_id"])
                        if self.pin_node is None:
                            self.pin_node = msg["node_id"]
                    elif msg["op"] == "remove_node":
                        self.nodes = [n for n in self.nodes if n != msg["node_id"]]
                    elif msg["op"] == "schedule":
                        self.batches.append(msg)
                        placements = [self.pin_node for _ in msg["requests"]]
                        conn.sendall((json.dumps(
                            {"batch_id": msg["batch_id"], "placements": placements}
                        ) + "\n").encode())


@pytest.fixture(scope="module")
def setups():
    for P in PACKAGES:
        if P.is_initialized():
            P.shutdown()
    out = {}
    try:
        for P in PACKAGES:
            server = _PolicyServer()
            server.start()
            os.environ["RAY_TPU_EXTERNAL_SCHEDULER_ADDRESS"] = f"127.0.0.1:{server.port}"
            try:
                c = CLUSTERS[P.__name__](initialize_head=True, head_node_args={"num_cpus": 2})
            finally:
                os.environ.pop("RAY_TPU_EXTERNAL_SCHEDULER_ADDRESS", None)
            out[P.__name__] = (c, server)
            P.init(address=c.gcs_address)
        yield out
    finally:
        for P in PACKAGES:
            if P.is_initialized():
                P.shutdown()
        for c, server in out.values():
            c.shutdown()
            server.sock.close()


def _on_both(setups, fn):
    return [fn(P, *setups[P.__name__]) for P in PACKAGES]


def test_external_policy_receives_and_places(setups):
    def fn(P, cluster, server):
        @P.remote
        def where():
            return os.environ["RAY_TPU_NODE_ID"]

        nodes = P.get([where.remote() for _ in range(6)], timeout=60)
        with server.lock:
            saw_nodes, saw_batches, pin = bool(server.nodes), bool(server.batches), server.pin_node
        # the policy pinned every task to the first-registered node and the
        # cluster honored it
        return saw_nodes, saw_batches, set(nodes) == {pin}

    jax_out, port_out = _on_both(setups, fn)
    assert port_out == jax_out == (True, True, True)


def test_external_policy_sees_batched_requests(setups):
    def fn(P, cluster, server):
        @P.remote
        def noop(i):
            return i

        out = sorted(P.get([noop.remote(i) for i in range(10)], timeout=60))
        with server.lock:
            reqs = [len(b["requests"]) for b in server.batches]
            have_nodes = all("nodes" in b for b in server.batches)
        return out, have_nodes, sum(reqs) >= 10

    jax_out, port_out = _on_both(setups, fn)
    assert port_out == jax_out == (list(range(10)), True, True)


def test_spread_task_is_placed_by_the_policy(setups):
    """SPREAD goes through the GCS's batched scheduling, so through the
    policy: its batch carries the request and the task runs where the
    policy says (the port's chip_smoke runs this with num_gpus=1)."""
    cluster, server = setups["ray_tpu_torch"]
    with server.lock:
        before = len(server.batches)

    @ray_tpu_torch.remote
    def where():
        return os.environ["RAY_TPU_NODE_ID"]

    node = ray_tpu_torch.get(
        where.options(scheduling_strategy=SpreadSchedulingStrategy()).remote(), timeout=60)
    with server.lock:
        new = server.batches[before:]
        pin = server.pin_node
    assert node == pin
    assert any(r.get("resources", {}).get("CPU") for b in new for r in b["requests"]), new
