"""The port's Serve control plane (``ray_tpu_torch.serve``: controller,
replicas, router, handles, batching, multiplexing, the HTTP proxy, the
declarative config) held against the JAX package's (``ray_tpu.serve``).

Each scenario follows a test of tests/test_serve.py,
tests/test_serve_streaming.py or tests/test_serve_ops.py (keeping that
test's own checks), is written once as a function of the package module,
runs on each package's fresh ``LocalRuntime`` in turn, and must give the
same observable result in both. HTTP runs on port 0. The msgpack-RPC
ingress and the multi-node proxies (``proxy_location="every_node"``, which
needs the cluster runtime) are held in tests/test_torch_serve_rpc.py.

``LLMDeployment`` at ``LlamaConfig.tiny`` in fp32, with the port's weights
converted from the JAX package's (``params_from_jax``), gives greedy tokens
equal to the JAX deployment's through the handle, HTTP and streaming."""

import importlib
import json
import socket
import threading
import time
import urllib.error
import urllib.request
import uuid
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu.models import llama as jl
from ray_tpu_torch.models import llama as tl

PACKAGES = (ray_tpu, ray_tpu_torch)
SCENARIOS = {}
FIXTURE = {"ray_tpu": "tests.serve_app_fixture", "ray_tpu_torch": "tests.torch_serve_app_fixture"}


def scenario(fn):
    SCENARIOS[fn.__name__] = fn
    return fn


def _serve(pkg):
    return importlib.import_module(pkg.__name__ + ".serve")


def _shutdown_all():
    for pkg in PACKAGES:
        if pkg.is_initialized():
            _serve(pkg).shutdown()
            pkg.shutdown()


@pytest.fixture
def on_both():
    """``run(fn)`` runs ``fn(pkg)`` on ray_tpu's runtime, then on
    ray_tpu_torch's, and returns both results; serve and each runtime are
    shut down whatever happens."""
    _shutdown_all()

    def run(fn):
        out = []
        for pkg in PACKAGES:
            pkg.init(num_cpus=8)
            try:
                out.append(fn(pkg))
            finally:
                _serve(pkg).shutdown()
                pkg.shutdown()
        return out

    yield run
    _shutdown_all()


def _until(cond, timeout):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.05)
    return False


def _post_json(addr, path, payload, timeout=60):
    req = urllib.request.Request(f"{addr}{path}", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    return json.loads(urllib.request.urlopen(req, timeout=timeout).read())


class _Echo:
    def __call__(self, payload):
        return {"echo": payload}

    def shout(self, payload):
        return str(payload).upper()


class _WhoAmI:
    def __init__(self):
        self.uid = uuid.uuid4().hex

    def __call__(self, _=None):
        return self.uid


class _Slow:
    def __call__(self, i=None):
        time.sleep(1.0)
        return "done" if i is None else i


# ------------------------------------------------------- tests/test_serve.py
@scenario
def deploy_and_handle(pkg):
    serve = _serve(pkg)
    handle = serve.run(serve.deployment(_Echo, name="Echo").bind(), http=False)
    return [handle.remote({"x": 1}).result(timeout=30),
            handle.shout.remote("abc").result(timeout=30)]


@scenario
def function_deployment(pkg):
    serve = _serve(pkg)

    def double(x):
        return x * 2

    handle = serve.run(serve.deployment(double).bind(), http=False)
    return handle.remote(21).result(timeout=30)


@scenario
def multi_replica_routing(pkg):
    serve = _serve(pkg)
    handle = serve.run(serve.deployment(_WhoAmI, num_replicas=3).bind(), name="whoami",
                       http=False)
    uids = {handle.remote(None).result(timeout=30) for _ in range(20)}
    # pow-2 routing over 3 replicas should reach more than one replica
    return len(uids) >= 2


@scenario
def dynamic_batching(pkg):
    serve = _serve(pkg)

    class Batched:
        @serve.batch(max_batch_size=8, batch_wait_timeout_s=0.2)
        def __call__(self, requests):
            return [len(requests)] * len(requests)

    handle = serve.run(serve.deployment(Batched, max_ongoing_requests=16).bind(),
                       name="batched", http=False)
    responses = [handle.remote(i) for i in range(8)]
    sizes = [r.result(timeout=30) for r in responses]
    return [len(sizes), max(sizes) > 1, all(1 <= s <= 8 for s in sizes)]


@scenario
def status_and_delete(pkg):
    serve = _serve(pkg)
    serve.run(serve.deployment(_Echo, name="Echo").bind(), name="status_app", http=False)
    st = serve.status()["status_app"]
    before = [st["target_replicas"], st["running_replicas"], len(st["replica_stats"])]
    serve.delete("status_app")
    time.sleep(0.5)
    return [before, "status_app" in serve.status()]


@scenario
def http_proxy_e2e(pkg):
    serve = _serve(pkg)
    serve.run(serve.deployment(_Echo, name="Echo").bind(), name="http_echo", http=True,
              http_port=0)
    addr = serve.http_address()
    out = [addr.startswith("http://127.0.0.1:"), serve.http_addresses() == [addr],
           urllib.request.urlopen(f"{addr}/-/healthz", timeout=10).read(),
           json.loads(urllib.request.urlopen(f"{addr}/-/routes", timeout=10).read()),
           _post_json(addr, "/http_echo", {"hello": "gpu"})]
    try:
        urllib.request.urlopen(f"{addr}/nope", timeout=10)
        out.append(None)
    except urllib.error.HTTPError as e:
        out.append(e.code)
    return out


@scenario
def autoscaling_scales_up(pkg):
    serve = _serve(pkg)
    dep = serve.deployment(_Slow, name="Slow", max_ongoing_requests=2, autoscaling_config={
        "min_replicas": 1, "max_replicas": 3, "target_ongoing_requests": 1.0,
        "upscale_delay_s": 0.5, "metrics_interval_s": 0.2})
    handle = serve.run(dep.bind(), name="slow", http=False)
    responses = [handle.remote(None) for _ in range(12)]
    scaled = _until(lambda: serve.status().get("slow", {}).get("running_replicas", 0) >= 2, 30)
    # resolved together: the overloaded ones retry on whatever replicas exist
    with ThreadPoolExecutor(len(responses)) as pool:
        return [scaled, list(pool.map(lambda r: r.result(timeout=60), responses))]


@scenario
def config_change_propagates_fast(pkg):
    serve = _serve(pkg)
    handle = serve.run(serve.deployment(_WhoAmI, num_replicas=1).bind(), name="scaleapp",
                       http=False)
    first = bool(handle.remote(None).result(timeout=30))
    router = importlib.import_module(pkg.__name__ + ".serve.handle")._routers["scaleapp"]
    t0 = time.monotonic()
    serve.run(serve.deployment(_WhoAmI, num_replicas=3).bind(), name="scaleapp", http=False,
              wait_for_ready=False)
    seen = _until(lambda: len(router._replicas) == 3, 10)
    return [first, seen, time.monotonic() - t0 < 5.0]


@scenario
def rolling_scale_down_loses_no_inflight_requests(pkg):
    serve = _serve(pkg)
    dep = serve.deployment(_Slow, name="Slow", num_replicas=3, max_ongoing_requests=4)
    handle = serve.run(dep.bind(), name="drainapp", http=False)
    resps = [handle.remote(i) for i in range(9)]
    time.sleep(0.2)  # let requests land on replicas
    serve.run(dep.options(num_replicas=1).bind(), name="drainapp", http=False,
              wait_for_ready=False)
    return sorted(r.result(timeout=60) for r in resps)


@scenario
def multiplexed_models_lru_and_sticky_routing(pkg):
    serve = _serve(pkg)

    class MuxServer:
        def __init__(self):
            self.loads = []

        @serve.multiplexed(max_num_models_per_replica=2)
        def get_model(self, model_id: str):
            self.loads.append(model_id)
            return {"id": model_id, "scale": len(model_id)}

        def __call__(self, x):
            model = self.get_model(serve.get_multiplexed_model_id())
            return {"model": model["id"], "y": x * model["scale"]}

        def load_count(self, _=None):
            return list(self.loads)

    handle = serve.run(serve.deployment(MuxServer, name="mux", num_replicas=1).bind(),
                       name="mux", http_port=0)
    h_a = handle.options(multiplexed_model_id="aa")
    h_b = handle.options(multiplexed_model_id="bbb")
    loads = handle.options(method_name="load_count")
    out = [h_a.remote(2).result(timeout=60), h_b.remote(2).result(timeout=60),
           h_a.remote(3).result(timeout=60), loads.remote(0).result(timeout=60)]
    handle.options(multiplexed_model_id="cccc").remote(1).result(timeout=60)
    h_a.remote(1).result(timeout=60)
    out.append(loads.remote(0).result(timeout=60))
    h_b.remote(1).result(timeout=60)
    out.append(loads.remote(0).result(timeout=60))
    serve.delete("mux")
    return out


# --------------------------------------------- tests/test_serve_streaming.py
class _SlowStreamer:
    def __init__(self, delay: float = 0.15, n: int = 5):
        self._delay = delay
        self._n = n

    def __call__(self, request=None):
        for i in range(self._n):
            yield {"i": i, "t": time.time()}
            time.sleep(self._delay)


def _http_stream_chunks(host, port, path, body=b""):
    """tests/test_serve_streaming.py's chunked-transfer client: yields
    (chunk_bytes, arrival_time)."""
    s = socket.create_connection((host, port), timeout=30)
    try:
        s.sendall((f"POST {path} HTTP/1.1\r\nHost: {host}\r\n"
                   f"Content-Length: {len(body)}\r\nContent-Type: application/json\r\n"
                   f"Connection: close\r\n\r\n").encode() + body)
        f = s.makefile("rb")
        assert b"200" in f.readline()
        headers = {}
        while True:
            line = f.readline().strip()
            if not line:
                break
            k, _, v = line.partition(b":")
            headers[k.strip().lower()] = v.strip()
        assert headers.get(b"transfer-encoding") == b"chunked", headers
        while True:
            size = int(f.readline().strip(), 16)
            if size == 0:
                break
            data = f.read(size)
            f.read(2)
            yield data, time.time()
    finally:
        s.close()


@scenario
def http_chunks_arrive_before_generation_finishes(pkg):
    serve = _serve(pkg)
    serve.start(http_port=0)
    serve.run(serve.deployment(_SlowStreamer, stream=True).bind(delay=0.15, n=5), name="slow")
    host, port = serve.http_address().replace("http://", "").split(":")
    chunks = list(_http_stream_chunks(host, int(port), "/slow"))
    records = [json.loads(c.decode()) for c, _ in chunks]
    # incremental: the first chunk arrives before the last record was produced
    return [[r["i"] for r in records], chunks[0][1] < records[-1]["t"]]


@scenario
def handle_streaming(pkg):
    serve = _serve(pkg)
    serve.start(http_port=0)

    def counter(request=None):
        for i in range(4):
            yield i * 2

    class Plain:
        def __call__(self, request=None):
            return {"answer": 42}

    h1 = serve.run(serve.deployment(counter, stream=True).bind(), name="counter")
    h2 = serve.run(serve.deployment(Plain).bind(), name="plain")
    return [list(h1.options(stream=True).remote(None)),
            list(h2.options(stream=True).remote(None))]


# ------------------------------------------------- tests/test_serve_ops.py
BAD_CONFIGS = [
    ({}, "applications"),
    ({"applications": []}, "non-empty"),
    ({"applications": [{"import_path": "m:a"}]}, "name"),
    ({"applications": [{"name": "x", "import_path": "noattr"}]}, "import_path"),
    ({"applications": [{"name": "x", "import_path": "m:a", "num_replicas": 0}]},
     "num_replicas"),
    ({"applications": [{"name": "x", "import_path": "m:a"},
                       {"name": "x", "import_path": "m:b"}]}, "duplicate"),
    ({"applications": [{"name": "x", "import_path": "m:a", "bogus": 1}]}, "unknown"),
]


def test_schema_normalizes_like_jax():
    cfg = {"applications": [{"name": "a", "import_path": "m:attr", "num_replicas": 2}]}
    got, want = (_serve(pkg).schema.validate_config(cfg) for pkg in (ray_tpu_torch, ray_tpu))
    assert got == want and got["applications"][0]["num_replicas"] == 2


@pytest.mark.parametrize("bad,msg", BAD_CONFIGS)
def test_schema_rejects_like_jax(bad, msg):
    errors = []
    for pkg in PACKAGES:
        with pytest.raises(ValueError, match=msg) as e:
            _serve(pkg).schema.validate_config(bad)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


@scenario
def apply_deploy_update_remove_rollback(pkg):
    serve, fixture = _serve(pkg), FIXTURE[pkg.__name__]
    schema = serve.schema
    serve.start(http_port=0)
    cfg1 = {"applications": [{"name": "adder", "import_path": f"{fixture}:adder_app"},
                             {"name": "adder100", "import_path": f"{fixture}:build_adder"}]}
    out = [schema.apply_config(cfg1, wait_for_ready=True)]
    h = serve.get_app_handle("adder")
    out += [h.remote({"a": 1, "b": 2}).result(timeout=30),
            serve.get_app_handle("adder100").remote({"a": 1, "b": 2}).result(timeout=30)]
    cfg2 = {"applications": [{"name": "adder",
                              "import_path": f"{fixture}:adder_deployment",
                              "user_config": {"offset": 10}, "num_replicas": 2}]}
    out += [schema.apply_config(cfg2, wait_for_ready=True),
            h.remote({"a": 1, "b": 2}).result(timeout=30),
            _until(lambda: "adder100" not in serve.status(), 30),
            schema.current_config() == schema.validate_config(cfg2)]

    def adder100_back():
        try:
            return (serve.get_app_handle("adder100").remote({"a": 1, "b": 2})
                    .result(timeout=10) == {"sum": 103})
        except Exception:  # noqa: BLE001 - app still coming up
            return False

    schema.rollback()
    out += [_until(adder100_back, 60), h.remote({"a": 1, "b": 2}).result(timeout=30),
            schema.current_config() == schema.validate_config(cfg1)]
    return out


@scenario
def apply_isolates_per_app_errors(pkg):
    serve, fixture = _serve(pkg), FIXTURE[pkg.__name__]
    serve.start(http_port=0)
    status = serve.schema.apply_config({"applications": [
        {"name": "good", "import_path": f"{fixture}:adder_app"},
        {"name": "broken", "import_path": f"{fixture}:nope"}]}, wait_for_ready=True)
    return [status["deployed"], sorted(status["errors"]),
            status["errors"]["broken"].split(":")[0]]


@scenario
def kv_driven_apply(pkg):
    """The controller's control loop applies a config left in the KV store
    (the pending key the REST plane writes) and clears the key."""
    serve, fixture = _serve(pkg), FIXTURE[pkg.__name__]
    schema = serve.schema
    serve.start(http=False)
    cfg = {"applications": [{"name": "adder", "import_path": f"{fixture}:build_adder"}]}
    pkg.kv_put(schema.PENDING_KEY, json.dumps(cfg).encode())

    def answered():
        try:
            return serve.get_app_handle("adder").remote({"a": 2, "b": 3}).result(timeout=10)
        except Exception:  # noqa: BLE001 - controller still reconciling
            return None

    assert _until(lambda: answered() is not None, 60)
    return [answered(), pkg.kv_get(schema.PENDING_KEY), schema.current_config() == cfg,
            json.loads(pkg.kv_get(schema.STATUS_KEY))]


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_same_result_in_both_runtimes(on_both, name):
    jax_result, port_result = on_both(SCENARIOS[name])
    assert port_result == jax_result


# --------------------------------------------------------- LLMDeployment
PROMPTS = [[3, 14, 15, 92, 65, 35], [1, 2, 3], list(range(20, 45))]


@pytest.fixture
def tiny_fp32(monkeypatch):
    """Both packages' ``LlamaConfig.tiny`` in fp32 (the JAX one on its plain
    attention, neither rematerialized), so LLMDeployment(model="tiny") builds
    the fp32 engine; the JAX weights and their conversion."""
    jtiny, ttiny = jl.LlamaConfig.tiny, tl.LlamaConfig.tiny
    monkeypatch.setattr(jl.LlamaConfig, "tiny", classmethod(lambda cls, **kw: jtiny(
        dtype=jnp.float32, remat=None, attention_impl="reference", **kw)))
    monkeypatch.setattr(tl.LlamaConfig, "tiny", classmethod(lambda cls, **kw: ttiny(
        dtype=torch.float32, remat=None, **kw)))
    jparams = jl.llama_init(jl.LlamaConfig.tiny(), jax.random.key(1))
    return {"ray_tpu": {"params": jparams},
            "ray_tpu_torch": {"params": tl.params_from_jax(jparams), "device": "cpu"}}


def _llm_via_serve(pkg, extra):
    serve = _serve(pkg)
    llm = importlib.import_module(pkg.__name__ + ".serve.llm")
    app = serve.deployment(llm.LLMDeployment, name="llm").options(max_ongoing_requests=8).bind(
        model="tiny", num_slots=2, decode_chunk=4, max_seq_len=64, **extra)
    handle = serve.run(app, http=True, http_port=0)
    reqs = [{"tokens": p, "max_tokens": 6, "timeout": 120} for p in PROMPTS]
    one_by_one = [handle.generate.remote(r).result(timeout=120)["tokens"] for r in reqs]
    together = [r.result(timeout=120)["tokens"] for r in [handle.generate.remote(q) for q in reqs]]
    via_http = _post_json(serve.http_address(), "/llm", reqs[0], timeout=120)["tokens"]
    records = list(handle.options(stream=True).remote(dict(reqs[1], stream=True)))
    streamed = [r["token"] for r in records if "token" in r]
    stats = handle.engine_stats.remote().result(timeout=30)
    serve.shutdown()
    alive = _until(lambda: not any(t.name == "llm-engine" and t.is_alive()
                                   for t in threading.enumerate()), 15)
    return {"one_by_one": one_by_one, "together": together, "http": via_http,
            "streamed": streamed, "done": records[-1].get("done"),
            "tokens_generated": stats["tokens_generated"], "engine_stopped": alive}


def test_llm_deployment_via_serve_matches_jax(on_both, tiny_fp32):
    jax_out, port_out = on_both(lambda pkg: _llm_via_serve(pkg, tiny_fp32[pkg.__name__]))
    assert port_out == jax_out
    assert [len(t) for t in port_out["one_by_one"]] == [6] * len(PROMPTS)
    assert port_out["together"] == port_out["one_by_one"]
    assert port_out["http"] == port_out["one_by_one"][0]
    assert port_out["streamed"] == port_out["one_by_one"][1]
    assert port_out["engine_stopped"] and port_out["done"] is True


# -------------------------------------------------------------- port only
def test_every_node_proxies_and_rpc_ingress_are_refused():
    """On the in-process runtime ``proxy_location="every_node"`` is refused
    (no GCS to list nodes from; the cluster cases are in
    tests/test_torch_serve_rpc.py), while the head's one proxy serves HTTP
    and the msgpack-RPC ingress."""
    _shutdown_all()
    serve = _serve(ray_tpu_torch)
    try:
        with pytest.raises(RuntimeError, match="cluster runtime"):
            serve.start(http_port=0, proxy_location="every_node")
        assert not serve.api._state.get("proxies")  # no proxy was started
        serve.shutdown()
        handle = serve.run(serve.deployment(_Echo, name="Echo").bind(), name="e",
                           http_port=0)
        assert handle.remote(1).result(timeout=30) == {"echo": 1}
        proxy = serve.api._state["proxy"]
        addr = ray_tpu_torch.get(proxy.rpc_address.remote(), timeout=30)
        client = serve.ServeRpcClient(addr)
        try:
            assert client.call("e", 1) == {"echo": 1}
        finally:
            client.close()
    finally:
        _shutdown_all()


def test_llm_deployment_without_a_device_needs_the_card(monkeypatch):
    from ray_tpu_torch.serve.llm import LLMDeployment

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LLMDeployment(model="tiny")


def test_gpu_replica_is_infeasible_without_a_card():
    """``ray_actor_options={"num_gpus": 1}`` reserves the runtime's GPU
    resource: with none here, the controller cannot place the replica and
    serve.run times out instead of running it on the CPU."""
    _shutdown_all()
    serve = _serve(ray_tpu_torch)
    ray_tpu_torch.init(num_cpus=8)
    try:
        assert "GPU" not in ray_tpu_torch.cluster_resources()
        dep = serve.deployment(_Echo, name="Echo").options(ray_actor_options={"num_gpus": 1})
        with pytest.raises(TimeoutError, match="not ready"):
            serve.run(dep.bind(), name="gpu_echo", http=False, timeout=2.0)
    finally:
        _shutdown_all()
