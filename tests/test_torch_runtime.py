"""The port's in-process runtime (``ray_tpu_torch``: tasks, actors, objects,
placement groups) held against the JAX package's (``ray_tpu``).

Each scenario is written once, as a function of the package module, runs on
each package's fresh ``LocalRuntime`` in turn, and must give the same
observable result in both: values, exception class names and causes,
ordering, resource and placement-group accounting. The scenarios follow
``tests/test_core_basic.py`` and ``tests/test_core_actors.py`` (each keeps
that test's own assertions), plus streaming generators, ``wait`` with
timeouts, ``cancel``, ``kill``, named actors, ``kv_*`` and placement groups.
Port-only cases cover the ``GPU`` resource and what the port refuses. Tasks
that must stay busy wait on events instead of sleeping, so the file runs in
a few seconds."""

import asyncio
import importlib
import threading
import time

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch

PACKAGES = (ray_tpu, ray_tpu_torch)
SCENARIOS = {}


def scenario(**init_kwargs):
    """Register ``fn(pkg)`` as a parity case; ``init_kwargs`` go to each
    package's ``init`` (default ``num_cpus=8``, as the conftest's fixture)."""
    def register(fn):
        SCENARIOS[fn.__name__] = (fn, {"num_cpus": 8, **init_kwargs})
        return fn
    return register


def _shutdown_all():
    for pkg in PACKAGES:
        if pkg.is_initialized():
            pkg.shutdown()


@pytest.fixture
def on_both():
    """``run(fn, **init_kwargs)`` runs ``fn(pkg)`` on ray_tpu's runtime, then
    on ray_tpu_torch's, and returns both results. Each package keeps its own
    module-global worker; both are shut down whatever happens."""
    _shutdown_all()

    def run(fn, **init_kwargs):
        out = []
        for pkg in PACKAGES:
            pkg.init(**init_kwargs)
            try:
                out.append(fn(pkg))
            finally:
                pkg.shutdown()
        return out

    yield run
    _shutdown_all()


@pytest.fixture
def port():
    _shutdown_all()
    yield ray_tpu_torch
    _shutdown_all()


def _pg(pkg):
    return importlib.import_module(pkg.__name__ + ".util.placement_group")


def _raised(fn):
    """What a caller sees of the exception ``fn`` raises: its class name,
    the names of the framework and builtin classes it is an instance of,
    and its cause's class name and text (tasks' TaskError)."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the exception is the observation
        cause = getattr(e, "cause", None)
        bases = [c.__name__ for c in type(e).__mro__
                 if c.__module__.split(".")[0] in ("builtins", "ray_tpu", "ray_tpu_torch")]
        return {"type": type(e).__name__, "bases": bases,
                "cause": None if cause is None else [type(cause).__name__, str(cause)]}
    return None


def _cpu(res):
    """The accelerator-free part of a resource dict: the JAX package counts
    TPU, the port GPU (neither has one here); memory and the node key vary."""
    return {k: v for k, v in res.items() if k in ("CPU", "widget")}


def _until(cond, timeout=5.0):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.005)
    return True


class _Counter:
    def __init__(self, start=0):
        self.value = start

    def increment(self, by=1):
        self.value += by
        return self.value

    def get_value(self):
        return self.value


# --------------------------------------------------------------- tasks, objects


@scenario()
def put_get(P):
    return P.get(P.put({"a": 1, "b": [1, 2, 3]}))


@scenario()
def put_get_numpy_zero_copy(P):
    arr = np.arange(1000, dtype=np.float32).reshape(10, 100)
    out = P.get(P.put(arr))
    np.testing.assert_array_equal(arr, out)
    return out is arr


@scenario()
def put_objectref_rejected(P):
    return _raised(lambda: P.put(P.put(1)))


@scenario()
def simple_task(P):
    add = P.remote(lambda a, b: a + b)
    return P.get(add.remote(1, 2))


@scenario()
def task_with_kwargs_and_options(P):
    @P.remote(num_cpus=2)
    def f(a, b=10):
        return a * b

    return [P.get(f.remote(3)), P.get(f.options(name="custom").remote(2, b=5))]


@scenario()
def task_multiple_returns(P):
    @P.remote(num_returns=3)
    def three():
        return 1, 2, 3

    return P.get(list(three.remote()))


@scenario()
def task_dependency_chain(P):
    inc = P.remote(lambda x: x + 1)
    ref = inc.remote(0)
    for _ in range(9):
        ref = inc.remote(ref)
    return P.get(ref)


@scenario()
def task_error_propagates(P):
    @P.remote
    def boom():
        raise ValueError("bad")

    return _raised(lambda: P.get(boom.remote()))


@scenario()
def dependent_task_fails_with_parent_error(P):
    @P.remote
    def boom():
        raise KeyError("inner")

    use = P.remote(lambda x: x)
    return _raised(lambda: P.get(use.remote(boom.remote())))


@scenario()
def retry_exceptions(P):
    counter = {"n": 0}

    @P.remote(max_retries=3, retry_exceptions=True)
    def flaky():
        counter["n"] += 1
        if counter["n"] < 3:
            raise RuntimeError("transient")
        return counter["n"]

    return P.get(flaky.remote())


@scenario()
def num_returns_mismatch_errors(P):
    @P.remote(num_returns=2)
    def wrong():
        return 1

    r1, _ = wrong.remote()
    return _raised(lambda: P.get(r1))


@scenario()
def nested_object_refs(P):
    inner = P.put("inner-value")
    unwrap = P.remote(lambda container: P.get(container["ref"]))
    return P.get(unwrap.remote({"ref": inner}))


@scenario()
def get_timeout(P):
    release = threading.Event()

    @P.remote
    def slow():
        release.wait(10)
        return 1

    ref = slow.remote()
    timed_out = _raised(lambda: P.get(ref, timeout=0.1))
    release.set()
    return [timed_out, P.get(ref, timeout=10)]


@scenario()
def wait_with_timeouts(P):
    release = threading.Event()

    @P.remote
    def gated(i, gate):
        if gate:
            release.wait(10)
        return i

    fast, slow = gated.remote(0, False), gated.remote(1, True)
    ready, not_ready = P.wait([fast, slow], num_returns=1, timeout=2)
    assert ready == [fast] and not_ready == [slow]
    none_ready = P.wait([slow], num_returns=1, timeout=0.05)
    release.set()
    late = P.wait([slow], num_returns=1, timeout=10)
    return [len(none_ready[0]), len(none_ready[1]), len(late[0]), P.get(slow)]


@scenario()
def wait_all(P):
    quick = P.remote(lambda i: i)
    refs = [quick.remote(i) for i in range(5)]
    ready, not_ready = P.wait(refs, num_returns=5, timeout=10)
    return [ready == refs, len(not_ready)]


@scenario()
def wait_refuses_bad_arguments(P):
    r = P.put(1)
    return [_raised(lambda: P.wait([r, r])), _raised(lambda: P.wait([r], num_returns=2)),
            _raised(lambda: P.wait(r))]


@scenario()
def cancel_pending_task(P):
    release = threading.Event()

    @P.remote(num_cpus=8)
    def hog():
        release.wait(10)
        return 1

    queued = P.remote(num_cpus=8)(lambda: 2)
    h = hog.remote()
    q = queued.remote()  # blocked: hog holds all CPUs
    P.cancel(q)
    cancelled = _raised(lambda: P.get(q, timeout=5))
    release.set()
    done = P.get(h, timeout=10)
    P.cancel(h)  # a finished task: nothing to cancel
    return [cancelled, done, P.get(h)]


@scenario()
def cancel_then_get_never_hangs(P):
    release = threading.Event()

    @P.remote(num_cpus=8)
    def hog():
        release.wait(10)

    victim = P.remote(num_cpus=1)(lambda: 1)
    h = hog.remote()
    refs = [victim.remote() for _ in range(20)]
    for r in refs:
        P.cancel(r)
    outcomes = [_raised(lambda r=r: P.get(r, timeout=5))["type"] for r in refs]
    release.set()
    P.get(h, timeout=10)
    return outcomes


@scenario()
def resource_accounting(P):
    total = _cpu(P.cluster_resources())
    started, release = threading.Event(), threading.Event()

    @P.remote(num_cpus=4)
    def hold():
        started.set()
        release.wait(10)
        return 1

    ref = hold.remote()
    started.wait(10)
    during = _cpu(P.available_resources())
    release.set()
    P.get(ref)
    restored = _until(lambda: _cpu(P.available_resources()) == total)
    return [total, during, restored]


@scenario(num_cpus=4, resources={"widget": 2})
def custom_resources(P):
    use_widget = P.remote(resources={"widget": 1})(lambda: "ok")
    too_many = P.remote(resources={"widget": 5})(lambda: None)
    return [P.get(use_widget.remote()), _cpu(P.cluster_resources()),
            _raised(too_many.remote)]


@scenario()
def kv_api(P):
    P.kv_put("k1", b"v1")
    P.kv_put("k2", b"v2")
    got = P.kv_get("k1")
    keys = sorted(P.kv_keys("k"))
    P.kv_del("k1")
    return [got, keys, P.kv_get("k1"), P.kv_keys("k")]


@scenario()
def nodes_and_context(P):
    nodes = P.nodes()
    ctx = P.get_runtime_context()
    whoami = P.remote(lambda: P.get_runtime_context().get_task_id())
    tid = P.get(whoami.remote())
    return [len(nodes), nodes[0]["Alive"], ctx.get_node_id() == nodes[0]["NodeID"],
            bool(tid) and tid != ctx.get_task_id(), ctx.namespace]


@scenario()
def profile_spans(P):
    """A span recorded in an actor call lands in the local span log when
    the call ends (a plain task's spans wait for the next actor call: the
    flush after ``_execute_task``'s loop is never reached, in both packages)."""
    prof = importlib.import_module(P.__name__ + ".profiling")

    class Traced:
        def run(self):
            with P.profile("load", extra={"batch": 8}):
                pass
            return P.get_runtime_context().get_task_id()

    tid = P.get(P.remote(Traced).remote().run.remote())
    spans = [s for s in prof.local_spans() if s.get("task_id") == tid]
    return [(s["name"], s["extra"]) for s in spans]


# ------------------------------------------------------------------ streaming


@scenario()
def streaming_task(P):
    @P.remote(num_returns="streaming")
    def gen(n):
        for i in range(n):
            yield i * i

    g = gen.remote(4)
    return [type(g).__name__, [P.get(r) for r in g], g.completed()]


@scenario()
def streaming_task_error_mid_stream(P):
    @P.remote(num_returns="streaming")
    def gen():
        yield 1
        yield 2
        raise ValueError("mid-stream")

    refs = list(gen.remote())
    return [P.get(refs[0]), P.get(refs[1]), _raised(lambda: P.get(refs[2])), len(refs)]


@scenario()
def streaming_actor_methods(P):
    class Producer:
        def items(self, n):
            for i in range(n):
                yield f"item-{i}"

    class AsyncProducer:
        async def items(self, n):
            for i in range(n):
                await asyncio.sleep(0)
                yield i

    a = P.remote(Producer).remote()
    b = P.remote(AsyncProducer).remote()
    sync = [P.get(r) for r in a.items.options(num_returns="streaming").remote(3)]
    agen = [P.get(r) for r in b.items.options(num_returns="streaming").remote(4)]
    return [sync, agen]


@scenario()
def streaming_consumer_closes_early(P):
    produced = []

    @P.remote(num_returns="streaming", _generator_backpressure=1)
    def gen():
        for i in range(100):
            produced.append(i)
            yield i

    g = gen.remote()
    first = P.get(next(g))
    g.close()
    stopped = _until(lambda: len(produced) < 100 and len(produced) == len(set(produced)))
    return [first, stopped, len(produced) < 100]


# ----------------------------------------------------------- placement groups


@scenario()
def placement_group_pack(P):
    pgm = _pg(P)
    pg = pgm.placement_group([{"CPU": 2}, {"CPU": 2}], strategy="PACK", name="pack")
    ready = pg.ready(timeout=5)
    reserved = _cpu(P.available_resources())
    f = P.remote(num_cpus=2, placement_group=pg, placement_group_bundle_index=1)(lambda: "in-bundle")
    out = P.get(f.remote())
    table = [(t["name"], t["strategy"], t["bundles"]) for t in pgm.placement_group_table().values()]
    pgm.remove_placement_group(pg)
    released = _until(lambda: _cpu(P.available_resources()) == {"CPU": 8.0})
    return [ready, pg.bundle_count, pg.strategy, reserved, out, table, released,
            pgm.placement_group_table()]


@scenario()
def placement_group_strict_pack_holds_actor(P):
    pgm = _pg(P)
    pg = pgm.placement_group([{"CPU": 1}, {"CPU": 3}], strategy="STRICT_PACK")
    pg.ready(timeout=5)
    a = P.remote(_Counter).options(num_cpus=3, placement_group=pg,
                                   placement_group_bundle_index=1).remote(5)
    value = P.get(a.increment.remote())
    # bundle 1 is full while the actor lives: a second such actor cannot fit it,
    # and a one-CPU task still fits bundle 0
    small = P.remote(num_cpus=1, placement_group=pg)(lambda: "bundle-0")
    out = P.get(small.remote())
    P.kill(a)
    pgm.remove_placement_group(pg)
    released = _until(lambda: _cpu(P.available_resources()) == {"CPU": 8.0})
    return [value, out, _cpu(P.available_resources()), released]


@scenario()
def placement_group_infeasible_and_invalid(P):
    pgm = _pg(P)
    return [_raised(lambda: pgm.placement_group([{"CPU": 16}], strategy="STRICT_PACK")),
            _raised(lambda: pgm.placement_group([{"CPU": 4}, {"CPU": 8}], strategy="PACK")),
            _raised(lambda: pgm.placement_group([{"CPU": 1}], strategy="NEARBY")),
            _raised(lambda: pgm.placement_group([])),
            _cpu(P.available_resources())]


@scenario()
def pg_bundle_index_out_of_range(P):
    pg = _pg(P).placement_group([{"CPU": 1}, {"CPU": 1}])
    f = P.remote(placement_group=pg, placement_group_bundle_index=5)(lambda: 1)
    err = _raised(f.remote)
    assert err["type"] == "ValueError"
    return err


# --------------------------------------------------------------------- actors


@scenario()
def actor_basic(P):
    c = P.remote(_Counter).remote()
    return [P.get(c.increment.remote()), P.get(c.increment.remote(5)),
            P.get(c.get_value.remote()), repr(c).split("(")[0]]


@scenario()
def actor_init_args(P):
    return P.get(P.remote(_Counter).remote(start=100).get_value.remote())


@scenario()
def actor_ordering(P):
    c = P.remote(_Counter).remote()
    return P.get([c.increment.remote() for _ in range(50)])


@scenario()
def actor_method_error(P):
    class Bad:
        def fail(self):
            raise RuntimeError("method error")

        def ok(self):
            return "fine"

    b = P.remote(Bad).remote()
    return [_raised(lambda: P.get(b.fail.remote())), P.get(b.ok.remote())]


@scenario()
def actor_init_failure(P):
    class Broken:
        def __init__(self):
            raise ValueError("ctor boom")

        def m(self):
            return 1

    b = P.remote(Broken).remote()
    return _raised(lambda: P.get(b.m.remote(), timeout=10))


@scenario()
def kill_actor(P):
    c = P.remote(_Counter).options(name="to_kill").remote()
    first = P.get(c.increment.remote())
    P.kill(c)
    dead = _raised(lambda: P.get(c.increment.remote(), timeout=10))
    return [first, dead, P.list_named_actors(), _raised(lambda: P.kill("not a handle"))]


@scenario()
def named_actor(P):
    P.remote(_Counter).options(name="global_counter").remote(start=7)
    h = P.get_actor("global_counter")
    return [P.get(h.get_value.remote()), P.list_named_actors()]


@scenario()
def named_actor_duplicate_and_missing(P):
    Counter = P.remote(_Counter)
    Counter.options(name="dup").remote()
    dup = _raised(lambda: Counter.options(name="dup").remote())
    missing = _raised(lambda: P.get_actor("does_not_exist"))
    # the rejected actor must not shadow the original
    return [dup, missing, P.get(P.get_actor("dup").increment.remote())]


@scenario()
def actor_handle_passing(P):
    c = P.remote(_Counter).remote()
    bump = P.remote(lambda handle: P.get(handle.increment.remote()))
    return [P.get(bump.remote(c)), P.get(c.get_value.remote())]


@scenario()
def async_actor(P):
    class AsyncWorker:
        async def process(self, x):
            await asyncio.sleep(0.01)
            return x * 2

    a = P.remote(AsyncWorker).options(max_concurrency=4).remote()
    return sorted(P.get([a.process.remote(i) for i in range(8)]))


@scenario()
def async_actor_context_isolation(P):
    class Ctx:
        async def tid(self):
            await asyncio.sleep(0.05)
            return P.get_runtime_context().get_task_id()

    a = P.remote(Ctx).options(max_concurrency=4).remote()
    tids = P.get([a.tid.remote() for _ in range(4)])
    return [len(set(tids)), all(tids)]


@scenario()
def threaded_actor_concurrency(P):
    class Slow:
        def work(self):
            time.sleep(0.3)
            return 1

    a = P.remote(Slow).options(max_concurrency=4).remote()
    start = time.monotonic()
    out = P.get([a.work.remote() for _ in range(4)])
    return [out, time.monotonic() - start < 1.0]


@scenario(num_cpus=4)
def actor_resources_held(P):
    Heavy = P.remote(num_cpus=2)(type("Heavy", (), {"ping": lambda self: "pong"}))
    h = Heavy.remote()
    pong = P.get(h.ping.remote())
    held = _cpu(P.available_resources())
    P.kill(h)
    released = _until(lambda: _cpu(P.available_resources()) == {"CPU": 4.0})
    return [pong, held, released]


@scenario()
def actor_num_returns_option(P):
    class Multi:
        def pair(self):
            return 1, 2

    m = P.remote(Multi).remote()
    return P.get(list(m.pair.options(num_returns=2).remote()))


@scenario()
def actor_call_with_objectref_arg(P):
    produce = P.remote(lambda: 41)
    c = P.remote(_Counter).remote()
    return [P.get(c.increment.remote(produce.remote())), P.get(c.increment.remote(P.put(1)))]


@scenario()
def actor_and_task_called_directly_refused(P):
    f = P.remote(lambda: 1)
    a = P.remote(_Counter).remote()
    return [_raised(f), _raised(P.remote(_Counter)), _raised(a.increment),
            _raised(lambda: P.remote(1, num_cpus=2))]


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_same_result_in_both_runtimes(on_both, name):
    fn, init_kwargs = SCENARIOS[name]
    jax_result, port_result = on_both(fn, **init_kwargs)
    assert port_result == jax_result


# ----------------------------------------------------------------- port only


def test_num_gpus_and_num_tpus_both_map_to_gpu():
    from ray_tpu.core.remote_function import build_resources as jax_build
    from ray_tpu_torch.core.remote_function import build_resources

    assert build_resources({"num_gpus": 1}) == {"CPU": 1.0, "GPU": 1.0}
    assert build_resources({"num_tpus": 2, "num_cpus": 0}) == {"GPU": 2.0}
    assert build_resources({"num_gpus": 1, "num_tpus": 3}) == {"CPU": 1.0, "GPU": 1.0}
    # the JAX package maps both to TPU: the same request under its own name
    assert jax_build({"num_gpus": 1}) == {"CPU": 1.0, "TPU": 1.0}
    for name in ("CPU", "GPU", "TPU"):
        with pytest.raises(ValueError, match="num_cpus/num_gpus"):
            build_resources({"resources": {name: 1}})


def test_gpu_resource_counts_the_cards(port):
    port.init(num_cpus=2)
    n = torch.cuda.device_count()  # 0 on a machine without a card
    assert port.cluster_resources().get("GPU", 0) == n
    assert port.get_runtime_context().get_accelerator_ids() == {"GPU": [str(i) for i in range(n)]}
    port.shutdown()
    port.init(num_cpus=2, num_gpus=2)
    assert port.cluster_resources()["GPU"] == 2.0
    assert port.get_runtime_context().get_accelerator_ids() == {"GPU": ["0", "1"]}


def test_gpu_task_without_a_card_is_infeasible(on_both):
    """A one-accelerator task where there is none raises at submission in
    both packages (the JAX package's TPU, the port's GPU); nothing runs."""
    if torch.cuda.device_count():
        pytest.skip("a CUDA device is present")
    ran = []

    def submit(P):
        f = P.remote(num_gpus=1)(lambda: ran.append(1))
        actor = P.remote(_Counter).options(num_tpus=1)
        return [_raised(f.remote), _raised(actor.remote)]

    jax_result, port_result = on_both(submit, num_cpus=8)
    assert port_result[0]["type"] == "ValueError" and port_result[1]["type"] == "ValueError"
    assert port_result == jax_result and not ran


def _address_with_no_cluster():
    """host:port on this machine with nothing listening there (a cluster
    address is only ever tried on localhost here)."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{s.getsockname()[1]}"


@pytest.fixture
def short_connect():
    """Connection attempts give up after 0.5 s (init's system_config), and
    the override is dropped afterwards."""
    from ray_tpu_torch.core.config import config

    yield {"rpc_connect_timeout_s": 0.5}
    config.reset()


@pytest.mark.parametrize("scheme", ["", "client://"], ids=["host_port", "client"])
def test_non_local_address_raises(port, short_connect, scheme):
    """Any address but None/"local" connects as a driver to a cluster
    (ray_tpu_torch.cluster): with no cluster there, init raises and nothing
    silently runs locally."""
    from ray_tpu_torch.core.rpc import RpcConnectionError

    with pytest.raises(RpcConnectionError, match="cannot connect"):
        port.init(address=scheme + _address_with_no_cluster(), system_config=short_connect)
    assert not port.is_initialized()


def test_address_from_the_environment_raises(port, short_connect, monkeypatch):
    """RAY_TPU_ADDRESS is connected to as init's address, as in the JAX
    package; with no cluster there init raises, and "local" still starts
    the in-process runtime."""
    from ray_tpu_torch.core.rpc import RpcConnectionError

    address = _address_with_no_cluster()
    monkeypatch.setenv("RAY_TPU_ADDRESS", address)
    with pytest.raises(RpcConnectionError, match=address):
        port.init(system_config=short_connect)
    assert not port.is_initialized()
    port.init(address="local", num_cpus=1)
    assert port.is_initialized()


def test_bind_and_compiled_dag_raise(port):
    """``.bind()`` builds DAG nodes (tests/test_torch_dag.py runs them), and
    the compiled-DAG hook runs the stage loop on the actor: a plan it cannot
    read raises in the caller, and the actor goes on serving calls."""
    from ray_tpu_torch.dag import ClassNode, FunctionNode

    port.init(num_cpus=2)
    f = port.remote(lambda x: x)
    Counter = port.remote(_Counter)
    assert isinstance(f.bind(1), FunctionNode)
    assert isinstance(Counter.bind(1), ClassNode)
    assert port.get(f.bind(41).execute()) == 41
    a = Counter.remote()
    with pytest.raises(port.exceptions.TaskError, match="KeyError"):
        port.get(a._submit("__rtpu_channel_loop__", ({},), {}, 1))
    assert port.get(a.increment.remote()) == 1


def test_objects_stay_zero_copy(port):
    """A tensor comes back from put, a task argument and an actor as the
    same tensor on its device (the card's counterpart is in
    tests/test_torch_cuda_kernels.py)."""
    port.init(num_cpus=2)
    t = torch.arange(12, dtype=torch.bfloat16).reshape(3, 4)
    assert port.get(port.put(t)) is t
    ident = port.remote(lambda x: (x, x.data_ptr()))
    back, ptr = port.get(ident.remote(t))
    assert back is t and ptr == t.data_ptr()
    back, ptr = port.get(ident.remote(port.put(t)))
    assert back is t and ptr == t.data_ptr()

    class Holder:
        def __init__(self, x):
            self.x = x

        def ptr(self):
            self.x.add_(1)
            return self.x.data_ptr()

    h = port.remote(Holder).remote(t)
    assert port.get(h.ptr.remote()) == port.get(h.ptr.remote()) == t.data_ptr()
    assert t[0, 0].item() == 2.0  # the actor's in-place updates landed on the caller's tensor


def test_both_runtimes_in_one_process():
    """Each package's runtime is its own: refs of one are unknown to the
    other, and shutting one down leaves the other running."""
    _shutdown_all()
    try:
        ray_tpu.init(num_cpus=2)
        ray_tpu_torch.init(num_cpus=3)
        assert ray_tpu.cluster_resources()["CPU"] == 2.0
        assert ray_tpu_torch.cluster_resources()["CPU"] == 3.0
        r_jax, r_port = ray_tpu.put("jax"), ray_tpu_torch.put("port")
        assert ray_tpu.get(r_jax) == "jax" and ray_tpu_torch.get(r_port) == "port"
        with pytest.raises(TypeError):
            ray_tpu_torch.get(r_jax)
        ray_tpu.shutdown()
        assert not ray_tpu.is_initialized() and ray_tpu_torch.is_initialized()
        f = ray_tpu_torch.remote(lambda: "still up")
        assert ray_tpu_torch.get(f.remote(), timeout=10) == "still up"
    finally:
        _shutdown_all()
