"""Data and object broadcast on the port's cluster runtime held against the
JAX package's: ``tests/test_data_cluster.py`` (a distributed sort of 1e6
rows, and a map over ten times the store budget that completes through
spill and byte-budget backpressure) and ``tests/test_broadcast.py``
(a seeded object pushed to every node by the agents' push tree), plus the
transfer probe of ``ray_tpu_torch.bench``.

Each scenario is written once, as a function of the package, and runs on a
cluster of each package (2 nodes of 2 CPUs, a 48 MB store each, for the
module) with the reference test's own assertions and sizes; the broadcast
counts follow the node count (the reference's cluster has 3 nodes). Each
scenario runs in a thread joined after 120 s, so a hang fails its test
instead of holding the suite.
"""

import importlib
import threading
import time

import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu.cluster import Cluster as JaxCluster
from ray_tpu_torch.cluster import Cluster as PortCluster

PACKAGES = (ray_tpu, ray_tpu_torch)
CLUSTERS = {"ray_tpu": JaxCluster, "ray_tpu_torch": PortCluster}
STORE_MB = 48
LIMIT_S = 120.0


def _mod(P, name):
    return importlib.import_module(f"{P.__name__}.{name}")


def _shutdown_all():
    for P in PACKAGES:
        if P.is_initialized():
            P.shutdown()


@pytest.fixture(scope="module")
def clusters():
    _shutdown_all()
    started = {}
    try:
        for P in PACKAGES:
            c = CLUSTERS[P.__name__](
                initialize_head=True,
                head_node_args={"num_cpus": 2, "object_store_memory": STORE_MB << 20})
            started[P.__name__] = c
            c.add_node(num_cpus=2, object_store_memory=STORE_MB << 20)
            c.wait_for_nodes(2, timeout=60)
            P.init(address=c.gcs_address, log_to_driver=False)
        yield started
    finally:
        _shutdown_all()
        for c in started.values():
            c.shutdown()


def _bounded(fn, *args):
    """``fn(*args)`` on a thread, failing the test after ``LIMIT_S``."""
    box = {}

    def run():
        try:
            box["out"] = fn(*args)
        except BaseException as e:  # noqa: BLE001 - re-raised in the test
            box["err"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(LIMIT_S)
    if t.is_alive():
        pytest.fail(f"{getattr(fn, '__name__', fn)} on {args[0].__name__} "
                    f"did not finish in {LIMIT_S:.0f} s")
    if "err" in box:
        raise box["err"]
    return box["out"]


def _on_clusters(clusters, fn):
    out = [_bounded(fn, P, clusters[P.__name__]) for P in PACKAGES]
    assert out[1] == out[0]
    return out[1]


# ------------------------- before the module's clusters start (own drivers)
def test_broadcast_is_a_noop_in_process():
    """Port only: the in-process runtime has one store, nothing to push."""
    _shutdown_all()
    from ray_tpu_torch.experimental.broadcast import broadcast

    ray_tpu_torch.init(num_cpus=1)
    try:
        assert broadcast(ray_tpu_torch.put(np.ones(4))) == 0
    finally:
        ray_tpu_torch.shutdown()


def test_object_transfer_probe_pulls_raw():
    """``ray_tpu_torch.bench.measure_object_transfer`` on its own two-node
    cluster: the second agent pulls the 16 MB object and says so."""
    from ray_tpu_torch.bench import measure_object_transfer

    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    out = _bounded(lambda _P: measure_object_transfer(), ray_tpu_torch)
    assert out["raw_transfer"] is True and out["bytes"] == 16 << 20
    assert out["pull_mbps"] > 0


# ---------------------------------------------------- tests/test_data_cluster.py
def _sort_1m(P, _cluster):
    n = 1_000_000
    vals = np.random.default_rng(42).permutation(n)
    chunks = np.array_split(vals, 12)  # 12 source blocks spread over the cluster

    def source():
        for c in chunks:
            yield P.put(__import__("pyarrow").table({"v": c.astype(np.int64)}))

    ds = _mod(P, "data.dataset").Dataset(source).sort("v")
    prev_max, total, blocks = -1, 0, 0
    for ref in ds.iter_internal_refs():
        col = P.get(ref, timeout=60).column("v").to_numpy()
        if len(col) == 0:
            continue
        assert np.all(np.diff(col) >= 0), "block not internally sorted"
        assert col[0] >= prev_max, "blocks not globally ordered"
        prev_max = int(col[-1])
        total += len(col)
        blocks += 1
    return total, prev_max, blocks > 1


def test_distributed_sort_1m_rows(clusters):
    assert _on_clusters(clusters, _sort_1m) == (1_000_000, 999_999, True)


def _store_used(P, cluster):
    """Bytes each node's store holds (its agent's node_info)."""
    used = []
    for node in cluster.nodes:
        agent = _mod(P, "core.rpc").SyncRpcClient(node.address)
        try:
            used.append(agent.call("node_info")["store"]["used"])
        finally:
            agent.close()
    return used


def _wait_drained(P, cluster, below=1 << 20, limit_s=60.0):
    """Until every node's store holds less than ``below`` bytes, or
    ``limit_s``: the previous scenario's blocks free after the
    distributed-GC grace window (2 x object_ref_grace_s; the sort's 24 MB
    were gone 2.5 s after it on an idle host), which a loaded host
    stretches, so its end is waited for, not assumed. A few KB may stay
    (2.5 KB did, under load), so drained is less than 1 MB, not empty."""
    deadline = time.monotonic() + limit_s
    while max(_store_used(P, cluster)) >= below and time.monotonic() < deadline:
        time.sleep(0.25)


def _map_10x_store(P, cluster):
    # the sort's blocks free after the GC grace window: wait for the stores to
    # drain so this measures ITS OWN pressure
    _wait_drained(P, cluster)
    block_rows, n_blocks = 1_500_000, 40  # 40 x 12 MB float64 through a 48 MB store

    def source():
        for i in range(n_blocks):
            yield P.put(__import__("pyarrow").table(
                {"x": np.full(block_rows, float(i), dtype=np.float64)}))

    ds = _mod(P, "data.dataset").Dataset(source).map_batches(lambda b: {"x": b["x"] + 1.0})
    seen, firsts = 0, set()
    for ref in ds.iter_internal_refs():
        block = P.get(ref, timeout=60)
        assert block.num_rows == block_rows
        firsts.add(float(block.column("x")[0].as_py()))
        seen += 1
        del block, ref  # drop refs promptly so the store can evict
    return seen, sorted(firsts) == [float(i + 1) for i in range(n_blocks)]


def test_map_10x_store_budget_completes_via_spill(clusters):
    assert _on_clusters(clusters, _map_10x_store) == (40, True)


# ------------------------------------------------------ tests/test_broadcast.py
def _runtime(P):
    return _mod(P, "core.worker").global_worker().runtime


def _others(P):
    rt = _runtime(P)
    return [n["NodeID"] for n in rt.nodes() if n["NodeID"] != rt.node_hex and n["Alive"]]


def _broadcast_all(P, cluster):
    ser = _mod(P, "core.serialization")
    arr = np.arange(300_000, dtype=np.float64)  # ~2.4 MB: chunked path
    ref = P.put(arr)
    pushed = _mod(P, "experimental.broadcast").broadcast(ref)
    assert pushed == len(_others(P))  # every non-driver node received a copy
    size = len(ser.pack(P.get(ref, timeout=60))[0])
    infos = []
    # every agent now holds a sealed local copy (no pulls needed)
    for node in cluster.nodes:
        agent = _mod(P, "core.rpc").SyncRpcClient(node.address)
        try:
            info = agent.call("object_info", object_id=ref.id.hex())
            infos.append(info is not None and info["sealed"] and info["size"] == size)
        finally:
            agent.close()
    return pushed, infos


def test_broadcast_replicates_to_all_nodes(clusters):
    assert _on_clusters(clusters, _broadcast_all) == (1, [True, True])


def _broadcast_subset(P, _cluster):
    ref = P.put(np.ones(50_000))
    return _mod(P, "experimental.broadcast").broadcast(ref, node_ids=_others(P)[:1])


def test_broadcast_to_explicit_subset(clusters):
    assert _on_clusters(clusters, _broadcast_subset) == 1


def _broadcast_noop(P, _cluster):
    broadcast = _mod(P, "experimental.broadcast").broadcast
    ref = P.put(1234)
    # only our own node targeted -> nothing to push; a repeated broadcast is
    # idempotent (receivers short-circuit and are NOT counted again)
    return [broadcast(ref, node_ids=[_runtime(P).node_hex]), broadcast(ref), broadcast(ref)]


def test_broadcast_noop_cases(clusters):
    assert _on_clusters(clusters, _broadcast_noop) == [0, 1, 0]


def _broadcast_empty(P, _cluster):
    # must not raise; empty chunk handshake
    return _mod(P, "experimental.broadcast").broadcast(P.put(b"")) >= 0


def test_broadcast_zero_byte_object(clusters):
    assert _on_clusters(clusters, _broadcast_empty) is True
