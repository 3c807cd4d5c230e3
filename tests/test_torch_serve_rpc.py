"""The port's Serve RPC ingress, per-node proxies and state API
(``ray_tpu_torch.serve.rpc_ingress``, ``serve.proxy``'s msgpack-RPC
listener, ``serve.start(proxy_location="every_node")``,
``ray_tpu_torch.util.state``) held against the JAX package's.

Each scenario is written once, as a function of the package, and runs on
``ray_tpu`` and then on ``ray_tpu_torch`` with the reference test's own
assertions: ``tests/test_serve_ops.py::TestRpcIngress`` on each package's
in-process runtime, and ``::test_rest_deploy_and_rollback_on_cluster``,
``tests/test_serve.py::test_per_node_proxies_cluster`` (here also through
each proxy's RPC ingress, unary and streaming) and
``tests/test_ops_shell.py::test_state_api_lists`` on a real cluster of each
package (2 nodes of 2 CPUs, for the module). The port's apps come from
``tests/torch_serve_app_fixture.py``. Every wait is 60 s at most.
"""

import importlib
import json
import time
import urllib.error
import urllib.request

import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu.cluster import Cluster as JaxCluster
from ray_tpu_torch.cluster import Cluster as PortCluster

PACKAGES = (ray_tpu, ray_tpu_torch)
CLUSTERS = {"ray_tpu": JaxCluster, "ray_tpu_torch": PortCluster}
FIXTURE = {"ray_tpu": "tests.serve_app_fixture", "ray_tpu_torch": "tests.torch_serve_app_fixture"}


def _serve(P):
    return importlib.import_module(P.__name__ + ".serve")


def _fixture(P):
    return importlib.import_module(FIXTURE[P.__name__])


def _shutdown_all():
    for P in PACKAGES:
        if P.is_initialized():
            try:
                _serve(P).shutdown()
            finally:
                P.shutdown()


@pytest.fixture
def on_local():
    """``run(fn)`` runs ``fn(P)`` on each package's fresh in-process runtime
    (serve shut down after each) and returns both results."""
    _shutdown_all()

    def run(fn):
        out = []
        for P in PACKAGES:
            P.init(num_cpus=8)
            try:
                out.append(fn(P))
            finally:
                _serve(P).shutdown()
                P.shutdown()
        return out

    yield run
    _shutdown_all()


@pytest.fixture(scope="module")
def clusters():
    _shutdown_all()
    started = {}
    try:
        for P in PACKAGES:
            c = CLUSTERS[P.__name__](initialize_head=True, head_node_args={"num_cpus": 2})
            started[P.__name__] = c
            c.add_node(num_cpus=2)
            c.wait_for_nodes(2, timeout=60)
            P.init(address=c.gcs_address, log_to_driver=False)
        yield started
    finally:
        _shutdown_all()
        for c in started.values():
            c.shutdown()


@pytest.fixture
def on_clusters(clusters):
    """``run(fn)`` runs ``fn(P, cluster)`` on ray_tpu's cluster, then on
    ray_tpu_torch's (serve shut down after each), and returns both."""
    def run(fn):
        out = []
        for P in PACKAGES:
            try:
                out.append(fn(P, clusters[P.__name__]))
            finally:
                _serve(P).shutdown()
        return out
    return run


def _same(results):
    jax_result, port_result = results
    assert port_result == jax_result
    return port_result


def _raised_name(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the caller compares what was raised
        return type(e).__name__, "no app" in str(e)
    return None


def _rpc_address(P, proxy):
    return P.get(proxy.rpc_address.remote(), timeout=30)


# ---------------------------------------- tests/test_serve_ops.py::TestRpcIngress
def test_rpc_unary_call(on_local):
    def fn(P):
        serve = _serve(P)
        serve.run(_fixture(P).adder_app, name="adder", http_port=0)
        addr = _rpc_address(P, serve.api._state["proxy"])
        client = serve.ServeRpcClient(addr)
        try:
            out = client.call("adder", {"a": 4, "b": 5})
            assert out == {"sum": 9}
            raised = _raised_name(lambda: client.call("ghost", 1))
            assert raised is not None and raised[1]  # match="no app"
            return addr.startswith("127.0.0.1:"), out, raised
        finally:
            client.close()

    assert _same(on_local(fn)) == (True, {"sum": 9}, ("RpcError", True))


def test_rpc_server_streaming(on_local):
    def fn(P):
        serve = _serve(P)
        serve.run(_fixture(P).TokenStreamer.bind(), name="stream", http_port=0)
        client = serve.ServeRpcClient(_rpc_address(P, serve.api._state["proxy"]))
        try:
            items = list(client.stream("stream", "one two three"))
            assert [i["token"] for i in items] == ["one", "two", "three"]
            return items
        finally:
            client.close()

    assert [i["index"] for i in _same(on_local(fn))] == [0, 1, 2]


def test_every_node_needs_a_cluster(on_local):
    """On the in-process runtime there is no GCS to list nodes from: both
    packages refuse ``proxy_location="every_node"`` through the state API."""
    def fn(P):
        try:
            _serve(P).start(http_port=0, proxy_location="every_node")
        except RuntimeError as e:
            return "cluster runtime" in str(e)
        return None

    assert _same(on_local(fn)) is True


# ------------------- tests/test_serve_ops.py::test_rest_deploy_and_rollback_on_cluster
def test_rest_deploy_and_rollback_on_cluster(on_clusters):
    """Dashboard REST -> KV config bus -> controller reconcile (the full
    declarative loop on a real multi-process cluster)."""
    def fn(P, _cluster):
        serve = _serve(P)
        dash = P.kv_get("dashboard:address").decode()  # http://host:port
        req = urllib.request.Request(
            f"{dash}/api/serve/applications",
            data=json.dumps({"applications": [
                {"name": "adder", "import_path": f"{FIXTURE[P.__name__]}:adder_app"}]}).encode(),
            method="PUT")
        codes = []
        # no controller yet -> 409
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=30)
        codes.append(e.value.code)
        # invalid config -> 400 with the field path
        bad = urllib.request.Request(
            f"{dash}/api/serve/applications",
            data=b'{"applications": [{"name": "x"}]}', method="PUT")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(bad, timeout=30)
        codes.append(e.value.code)
        # start serve, then the same PUT is accepted and reconciled
        serve.start(http=False)
        with urllib.request.urlopen(req, timeout=30) as resp:
            codes.append(resp.status)
        handle = serve.get_app_handle("adder")
        deadline = time.monotonic() + 60
        result = None
        while time.monotonic() < deadline:
            try:
                result = handle.remote({"a": 2, "b": 3}).result(timeout=10)
                break
            except Exception:  # noqa: BLE001 - controller still reconciling
                time.sleep(0.5)
        with urllib.request.urlopen(f"{dash}/api/serve/applications", timeout=30) as resp:
            body = json.loads(resp.read())
        serve.delete("adder")
        return codes, result, body["config"]["applications"][0]["name"]

    assert _same(on_clusters(fn)) == ([409, 400, 202], {"sum": 5}, "adder")


# ------------------------------ tests/test_serve.py::test_per_node_proxies_cluster
def test_per_node_proxies_cluster(on_clusters):
    """proxy_location='every_node': one HTTP proxy per node, all serving,
    each with its own RPC ingress (unary and streaming)."""
    def fn(P, _cluster):
        serve = _serve(P)

        @serve.deployment
        def ident(x):
            return x

        serve.run(ident.bind(), name="ident", http=True, http_port=0,
                  proxy_location="every_node")
        serve.run(_fixture(P).TokenStreamer.bind(), name="stream", http=True,
                  http_port=0, proxy_location="every_node")
        addrs = serve.http_addresses()
        assert len(addrs) == 2, addrs
        http = []
        for addr in addrs:
            req = urllib.request.Request(
                f"{addr}/ident", data=json.dumps(7).encode(),
                headers={"Content-Type": "application/json"})
            http.append(json.loads(urllib.request.urlopen(req, timeout=30).read()))
        rpc = []
        for proxy in serve.api._state["proxies"]:
            client = serve.ServeRpcClient(_rpc_address(P, proxy))
            try:
                rpc.append((client.call("ident", 7),
                            [i["token"] for i in client.stream("stream", "a b c")]))
            finally:
                client.close()
        state = importlib.import_module(P.__name__ + ".util.state")
        proxy_nodes = {a.get("node_id") or a.get("NodeID") for a in state.list_actors()
                       if str(a.get("name", "")).startswith("SERVE_PROXY:")
                       and a.get("state", "ALIVE") == "ALIVE"}
        return http, rpc, len(proxy_nodes)

    assert _same(on_clusters(fn)) == ([7, 7], [(7, ["a", "b", "c"])] * 2, 2)


# ----------------------------- tests/test_ops_shell.py::test_state_api_lists
def test_state_api_lists(on_clusters):
    def fn(P, _cluster):
        state = importlib.import_module(P.__name__ + ".util.state")

        @P.remote
        class Sentinel:
            def ping(self):
                return "pong"

        s = Sentinel.options(name="state-sentinel").remote()
        assert P.get(s.ping.remote(), timeout=60) == "pong"
        ref = P.put({"state": "api"})

        nodes = state.list_nodes()
        alive = [n for n in nodes if n["Alive"]]
        actors = state.list_actors()
        objs = state.list_objects()
        tasks = state.list_tasks()
        summary = state.cluster_summary()
        logs = state.list_logs()
        out = {
            "alive": len(alive),
            "cpus": sorted(n["Resources"].get("CPU") for n in alive),
            "sentinel": any(a.get("name") == "state-sentinel" for a in actors),
            "object": any(o["object_id"] == ref.id.hex() for o in objs),
            "tasks": isinstance(tasks, list),
            "summary_nodes": summary["nodes"],
            "summary_cpus": summary["resources_total"].get("CPU"),
            "logs": any(name.endswith(".log") for name in logs),
            "log_bytes": isinstance(state.get_log(logs[0]), bytes),
            "jobs": state.list_jobs(),
        }
        P.kill(s)
        return out

    assert _same(on_clusters(fn)) == {
        "alive": 2, "cpus": [2.0, 2.0], "sentinel": True, "object": True, "tasks": True,
        "summary_nodes": 2, "summary_cpus": 4.0, "logs": True, "log_bytes": True,
        "jobs": []}


def test_state_api_needs_a_cluster():
    """Port only: on the in-process backend the state API refuses, naming
    the cluster runtime it needs."""
    _shutdown_all()
    from ray_tpu_torch.util import state

    ray_tpu_torch.init(num_cpus=2)
    try:
        with pytest.raises(RuntimeError, match="cluster runtime"):
            state.list_nodes()
    finally:
        ray_tpu_torch.shutdown()


def test_slow_replica_constructor_is_not_a_failed_health_check(tmp_path):
    """Port only (fault C7 of the reference): a replica whose constructor
    outlasts a health check's 10 s (a model load on a fresh GPU worker) is
    not declared dead while it starts, so no second replica is started
    beside it. The JAX package's controller starts one after 10 s."""
    _shutdown_all()
    serve = _serve(ray_tpu_torch)
    starts = tmp_path / "starts"

    class SlowStart:
        def __init__(self, path):
            with open(path, "a") as f:
                f.write("x")
            time.sleep(12)

        def __call__(self, x):
            return x

    ray_tpu_torch.init(num_cpus=4)
    try:
        handle = serve.run(serve.deployment(SlowStart, name="slow").bind(str(starts)),
                           name="slow", http=False, timeout=60)
        assert handle.remote(3).result(timeout=30) == 3
        time.sleep(1.5)  # three control-loop ticks after the replica answered
        assert starts.read_text() == "x"
        assert serve.status()["slow"]["running_replicas"] == 1
    finally:
        _shutdown_all()
