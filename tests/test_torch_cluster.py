"""The port's multi-process cluster runtime (``ray_tpu_torch.cluster``: a
GCS, node agents and worker processes) held against the JAX package's
(``ray_tpu.cluster``).

Each scenario of ``tests/test_cluster.py`` and ``tests/test_cluster_sched.py``
is written once, as a function of the package, and runs on the JAX
package's cluster and then on the port's (one 2-CPU head each, for the
module, both drivers connected at once: each package has its own
module-global worker); both must give the same observable result, with the
reference test's own assertions. Added: placement groups, and a
``num_gpus=1`` task on a cluster without a card, which stays pending and
never runs on the CPU. Port-only: a port worker process holds neither
``ray_tpu`` nor ``jax``, and a CUDA-less tensor round-trips through the
shared-memory store. Every wait has a timeout of 60 s at most.
"""

import importlib
import os
import time

import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu.cluster import Cluster as JaxCluster
from ray_tpu_torch.cluster import Cluster as PortCluster

PACKAGES = (ray_tpu, ray_tpu_torch)
CLUSTERS = {"ray_tpu": JaxCluster, "ray_tpu_torch": PortCluster}


def _mod(P, name):
    return importlib.import_module(f"{P.__name__}.{name}")


@pytest.fixture(scope="module")
def clusters():
    for P in PACKAGES:
        if P.is_initialized():
            P.shutdown()
    started = {}
    try:
        for P in PACKAGES:
            started[P.__name__] = CLUSTERS[P.__name__](
                initialize_head=True, head_node_args={"num_cpus": 2})
            P.init(address=started[P.__name__].gcs_address)
        yield started
    finally:
        for P in PACKAGES:
            if P.is_initialized():
                P.shutdown()
        for c in started.values():
            c.shutdown()


@pytest.fixture
def on_both(clusters):
    """``run(fn)`` runs ``fn(P, cluster)`` on ray_tpu's cluster, then on
    ray_tpu_torch's, and returns both results."""
    def run(fn):
        return [fn(P, clusters[P.__name__]) for P in PACKAGES]
    return run


def _same(on_both, fn):
    jax_result, port_result = on_both(fn)
    assert port_result == jax_result
    return port_result


# ------------------------------------------------- tests/test_cluster_sched.py
def _sched_stats(P, cluster):
    client = _mod(P, "core.rpc").SyncRpcClient(cluster.gcs_address)
    try:
        d = client.call("debug_state")
        return d["schedule_calls"], d["schedule_requests"]
    finally:
        client.close()


def test_default_tasks_grant_locally_without_gcs(on_both):
    def fn(P, cluster):
        @P.remote
        def f(i):
            return i + 1

        P.get([f.remote(i) for i in range(5)], timeout=60)  # warm workers
        _, reqs0 = _sched_stats(P, cluster)
        out = P.get([f.remote(i) for i in range(20)], timeout=60)
        _, reqs1 = _sched_stats(P, cluster)
        # fitting default-strategy tasks take the local fast path: strictly
        # fewer control-plane placement requests than tasks
        return out, reqs1 - reqs0 < 20

    assert _same(on_both, fn) == (list(range(1, 21)), True)


def test_oversubscription_spills_back_and_completes(on_both):
    def fn(P, _):
        @P.remote
        def burn(i):
            time.sleep(0.05)
            return i

        # 12 tasks on 2 CPUs: most grants hit "busy" and spill back
        return sorted(P.get([burn.remote(i) for i in range(12)], timeout=60))

    assert _same(on_both, fn) == list(range(12))


def test_spread_strategy_still_uses_gcs(on_both):
    def fn(P, cluster):
        Spread = _mod(P, "core.resources").SpreadSchedulingStrategy

        @P.remote
        def f():
            return 1

        calls0, reqs0 = _sched_stats(P, cluster)
        refs = [f.options(scheduling_strategy=Spread()).remote() for _ in range(12)]
        out = P.get(refs, timeout=60)
        calls1, reqs1 = _sched_stats(P, cluster)
        # SPREAD consults the global scheduler, in batches (fewer RPCs than
        # requests)
        return out, reqs1 - reqs0 >= 12, calls1 - calls0 < reqs1 - reqs0

    assert _same(on_both, fn) == ([1] * 12, True, True)


# ------------------------------------------------------ tests/test_cluster.py
def test_task_roundtrip(on_both):
    def fn(P, _):
        @P.remote
        def mul(a, b):
            return a * b

        return P.get(mul.remote(6, 7), timeout=60)

    assert _same(on_both, fn) == 42


def test_object_put_get(on_both):
    def fn(P, _):
        arr = np.arange(10_000, dtype=np.float32)
        out = P.get(P.put(arr), timeout=30)
        np.testing.assert_array_equal(arr, out)
        return out.dtype.name, out.shape

    _same(on_both, fn)


def test_task_chain_with_deps(on_both):
    def fn(P, _):
        @P.remote
        def inc(x):
            return x + 1

        ref = inc.remote(0)
        for _ in range(4):
            ref = inc.remote(ref)
        return P.get(ref, timeout=60)

    assert _same(on_both, fn) == 5


def test_actor_ordering_and_state(on_both):
    def fn(P, _):
        @P.remote
        class Counter:
            def __init__(self):
                self.v = 0

            def inc(self):
                self.v += 1
                return self.v

        c = Counter.remote()
        out = P.get([c.inc.remote() for _ in range(10)], timeout=60)
        P.kill(c)
        return out

    assert _same(on_both, fn) == list(range(1, 11))


def test_named_actor_across_driver(on_both):
    def fn(P, _):
        @P.remote
        class KV:
            def __init__(self):
                self.d = {}

            def set(self, k, v):
                self.d[k] = v
                return True

            def get(self, k):
                return self.d.get(k)

        KV.options(name="cluster_kv").remote()
        h = P.get_actor("cluster_kv")
        P.get(h.set.remote("a", 1), timeout=30)
        out = P.get(h.get.remote("a"), timeout=30), "cluster_kv" in P.list_named_actors()
        P.kill(h)
        return out

    assert _same(on_both, fn) == (1, True)


def test_task_error_propagation(on_both):
    def fn(P, _):
        @P.remote
        def fail():
            raise KeyError("distributed ka-boom")

        with pytest.raises((KeyError, P.exceptions.TaskError)) as info:
            P.get(fail.remote(), timeout=30)
        return type(info.value).__name__, "ka-boom" in str(info.value)

    assert _same(on_both, fn)[1]


def test_worker_crash_is_reported(on_both):
    def fn(P, _):
        @P.remote(max_retries=0)
        def die():
            import os

            os._exit(13)

        with pytest.raises(P.exceptions.RayTpuError) as info:
            P.get(die.remote(), timeout=60)
        return type(info.value).__name__

    _same(on_both, fn)


def test_actor_kill(on_both):
    def fn(P, _):
        @P.remote
        class Victim:
            def ping(self):
                return "pong"

        v = Victim.remote()
        before = P.get(v.ping.remote(), timeout=30)
        P.kill(v)
        time.sleep(0.5)
        with pytest.raises((P.exceptions.ActorDiedError,
                            P.exceptions.ActorUnavailableError)):
            P.get(v.ping.remote(), timeout=30)
        return before

    assert _same(on_both, fn) == "pong"


def test_wait_cluster(on_both):
    def fn(P, _):
        @P.remote
        def quick(i):
            return i

        refs = [quick.remote(i) for i in range(4)]
        ready, not_ready = P.wait(refs, num_returns=4, timeout=60)
        return len(ready), len(not_ready), sorted(P.get(ready, timeout=30))

    assert _same(on_both, fn) == (4, 0, [0, 1, 2, 3])


def test_kv_cluster(on_both):
    def fn(P, _):
        P.kv_put("cluster_key", b"cluster_value")
        got = P.kv_get("cluster_key")
        P.kv_del("cluster_key")
        return got, P.kv_get("cluster_key")

    assert _same(on_both, fn) == (b"cluster_value", None)


def test_nested_task_submission(on_both):
    def fn(P, _):
        @P.remote
        def inner(x):
            return x * 2

        @P.remote
        def outer(x):
            return P.get(inner.remote(x)) + 1

        return P.get(outer.remote(10), timeout=60)

    assert _same(on_both, fn) == 21


def test_actor_with_ref_arg(on_both):
    def fn(P, _):
        @P.remote
        def produce():
            return 5

        @P.remote
        class Acc:
            def __init__(self):
                self.total = 0

            def add(self, x):
                self.total += x
                return self.total

        a = Acc.remote()
        out = P.get(a.add.remote(produce.remote()), timeout=60)
        P.kill(a)
        return out

    assert _same(on_both, fn) == 5


def test_actor_restart_after_crash(on_both):
    """GCS-driven actor failover: a fresh incarnation after the crash."""
    def fn(P, _):
        @P.remote(max_restarts=1)
        class Phoenix:
            def __init__(self):
                self.calls = 0

            def call(self):
                self.calls += 1
                return self.calls

            def die(self):
                import os

                os._exit(1)

        p = Phoenix.remote()
        first = P.get(p.call.remote(), timeout=60)
        p.die.remote()  # max_task_retries=0: the kill is NOT re-executed on restart
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            try:
                again = P.get(p.call.remote(), timeout=30)
                P.kill(p)
                return first, again
            except (P.exceptions.ActorDiedError, P.exceptions.ActorUnavailableError):
                time.sleep(0.5)
        raise AssertionError("actor never came back")

    assert _same(on_both, fn) == (1, 1)


def test_custom_resources_cluster(on_both):
    def fn(P, cluster):
        node = cluster.add_node(num_cpus=1, resources={"widget": 2})
        try:
            cluster.wait_for_nodes(2, timeout=60)

            @P.remote(num_cpus=0, resources={"widget": 1})
            def use_widget():
                return P.get_runtime_context().get_node_id()

            where = P.get(use_widget.remote(), timeout=60)
            head = next(n for n in P.nodes() if n["Alive"] and "widget" not in n["Resources"])
            return bool(where) and where != head["NodeID"]
        finally:
            cluster.remove_node(node)

    assert _same(on_both, fn) is True


def test_worker_logs_stream_to_driver(on_both, capfd):
    """log_to_driver: a worker's print surfaces on the driver's stderr."""
    def fn(P, _):
        marker = f"HELLO-LOG-STREAM-{P.__name__}"

        @P.remote
        def chatty():
            print(marker, flush=True)
            return 1

        assert P.get(chatty.remote(), timeout=60) == 1
        deadline = time.time() + 15
        seen = ""
        while time.time() < deadline and marker not in seen:
            out, err = capfd.readouterr()
            seen += out + err
            time.sleep(0.3)
        return marker in seen

    assert _same(on_both, fn) is True


# ---------------------------------------------------------------- added
def test_placement_group_bundles(on_both):
    def fn(P, _):
        pgm = _mod(P, "util.placement_group")
        pg = pgm.placement_group([{"CPU": 1}, {"CPU": 1}], strategy="PACK")
        assert pg.wait(timeout_seconds=60)

        @P.remote(num_cpus=1)
        def where():
            return P.get_runtime_context().get_node_id()

        refs = [where.options(placement_group=pg, placement_group_bundle_index=i).remote()
                for i in range(2)]
        nodes = P.get(refs, timeout=60)
        pgm.remove_placement_group(pg)
        return len(set(nodes)), len(nodes)

    assert _same(on_both, fn) == (1, 2)


def test_accelerator_task_without_a_card_stays_pending(on_both):
    """A task that needs the accelerator (num_gpus=1 in the port, num_tpus=1
    in the JAX package) on a cluster without one is never run elsewhere:
    it stays pending past its get's timeout."""
    def fn(P, _):
        opt = "num_gpus" if P is ray_tpu_torch else "num_tpus"

        @P.remote(**{opt: 1})
        def needs_card():
            return "ran"

        ref = needs_card.remote()
        with pytest.raises(P.exceptions.GetTimeoutError):
            P.get(ref, timeout=1)
        ready, _ = P.wait([ref], timeout=0.2)
        return ready

    assert _same(on_both, fn) == []


# -------------------------------------------------------------- port only
def test_port_worker_imports_neither_jax_package_nor_jax(clusters):
    @ray_tpu_torch.remote
    def loaded():
        import sys

        return sorted({m.split(".")[0] for m in sys.modules} & {"ray_tpu", "jax", "torch"})

    assert ray_tpu_torch.get(loaded.remote(), timeout=60) == []


def test_daemons_load_no_torch(clusters):
    """The port's GCS and node agent never import torch (so never touch
    CUDA): the package loads its train step lazily."""
    c = clusters["ray_tpu_torch"]
    for proc in [c._gcs_proc] + [n.proc for n in c.nodes]:
        with open(f"/proc/{proc.pid}/maps") as f:
            libs = {line.split()[-1] for line in f if "libtorch" in line or "libcuda" in line}
        assert not libs, (proc.args, sorted(libs))


def test_tensor_through_the_store(clusters):
    """A bf16 tensor put by the driver reaches a worker through shared
    memory and comes back bit-equal (CPU tensors here: no card)."""
    import torch

    t = torch.randn(256, 128).to(torch.bfloat16)

    @ray_tpu_torch.remote
    def echo(x):
        return x.dtype == torch.bfloat16, x.clone()

    ok, back = ray_tpu_torch.get(echo.remote(ray_tpu_torch.put(t)), timeout=60)
    assert ok and back.dtype == torch.bfloat16
    assert torch.equal(back.view(torch.int16), t.view(torch.int16))


def test_init_connects_through_the_exported_address(clusters, monkeypatch):
    """RAY_TPU_ADDRESS auto-connects init(), as in the JAX package."""
    ray_tpu_torch.shutdown()
    try:
        monkeypatch.setenv("RAY_TPU_ADDRESS", clusters["ray_tpu_torch"].gcs_address)
        info = ray_tpu_torch.init()
        assert info["address"] == clusters["ray_tpu_torch"].gcs_address
        assert not ray_tpu_torch.get_runtime_context()._worker.runtime.is_local
    finally:
        monkeypatch.delenv("RAY_TPU_ADDRESS")
        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init(address=clusters["ray_tpu_torch"].gcs_address)
