"""The port's DAGs, compiled DAGs, shared-memory channels and workflows
(``ray_tpu_torch.dag``, ``.dag.compiled``, ``.experimental.channel``,
``.workflow``) held against the JAX package's.

Each scenario of ``tests/test_compiled_dag.py`` and
``tests/test_dag_workflow.py`` is written once, as a function of the
package, runs on each package's fresh in-process runtime in turn with the
reference test's own assertions, and both must give the same observable
result. The compiled chain also runs on a real cluster of each package
(2 nodes of 2 CPUs), where the stage loop is the worker process's
``__rtpu_channel_loop__`` hook. Port-only: channel files are named
``rtpt-chan-*``, a CPU tensor (bf16 included) rides a channel bit-equal,
and the default workflow root is ``~/.ray_tpu_torch/workflows``. Every wait
is 60 s at most.
"""

import importlib
import os
import threading
import time

import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu.cluster import Cluster as JaxCluster
from ray_tpu_torch.cluster import Cluster as PortCluster

PACKAGES = (ray_tpu, ray_tpu_torch)
CLUSTERS = {"ray_tpu": JaxCluster, "ray_tpu_torch": PortCluster}


def _mod(P, name):
    return importlib.import_module(f"{P.__name__}.{name}")


def _shutdown_all():
    for P in PACKAGES:
        if P.is_initialized():
            P.shutdown()


@pytest.fixture
def on_both():
    """``run(fn)`` runs ``fn(P)`` on ray_tpu's in-process runtime, then on
    ray_tpu_torch's, and returns both results."""
    _shutdown_all()

    def run(fn):
        out = []
        for P in PACKAGES:
            P.init(num_cpus=8)
            try:
                out.append(fn(P))
            finally:
                P.shutdown()
        return out

    yield run
    _shutdown_all()


def _same(results):
    jax_result, port_result = results
    assert port_result == jax_result
    return port_result


def _raised(fn, *types):
    """The class name and message of what ``fn`` raises (one of ``types``)."""
    with pytest.raises(types or Exception) as e:
        fn()
    return type(e.value).__name__, str(e.value)


class _Adder:
    def __init__(self, inc):
        self.inc = inc
        self.calls = 0

    def add(self, x):
        self.calls += 1
        return x + self.inc

    def get_calls(self):
        return self.calls


class _Doubler:
    def mul(self, x):
        return 2 * x

    def combine(self, a, b):
        return a + b


def _actors(P):
    return P.remote(_Adder), P.remote(_Doubler)


# ------------------------------------------------ tests/test_compiled_dag.py
def test_channel_basic_roundtrip(on_both):
    def fn(P):
        ch_mod = _mod(P, "experimental.channel")
        ch = ch_mod.Channel.create(capacity=1 << 16, num_readers=1)
        r = ch_mod.Channel.open(ch.handle, reader_slot=0)
        version = ch.write({"k": [1, 2, 3]})
        got = r.read()
        ch.close()
        closed = _raised(r.read, ch_mod.ChannelClosed)[0]
        ch.destroy()
        return version, got, closed

    assert _same(on_both(fn)) == (1, {"k": [1, 2, 3]}, "ChannelClosed")


def test_channel_backpressure_depth1(on_both):
    def fn(P):
        Channel = _mod(P, "experimental.channel").Channel
        ch = Channel.create(capacity=1 << 16, num_readers=1)
        r = Channel.open(ch.handle, reader_slot=0)
        ch.write("a")
        # second write must block until the reader acks version 1
        blocked = _raised(lambda: ch.write("b", timeout_s=0.2))[0]
        out = [blocked, r.read(), ch.write("b", timeout_s=5.0), r.read()]
        ch.destroy()
        return out

    assert _same(on_both(fn)) == ["ChannelTimeout", "a", 2, "b"]


def test_channel_rejects_oversized_payload(on_both):
    def fn(P):
        ch_mod = _mod(P, "experimental.channel")
        ch = ch_mod.Channel.create(capacity=1024, num_readers=1)
        out = _raised(lambda: ch.write(b"x" * 4096), ch_mod.ChannelError)
        ch.destroy()
        return out

    name, msg = _same(on_both(fn))
    assert name == "ChannelError" and "exceeds channel capacity" in msg


def test_compiled_linear_chain(on_both):
    def fn(P):
        InputNode = _mod(P, "dag").InputNode
        Adder, _ = _actors(P)
        with InputNode() as inp:
            dag = Adder.bind(10).add.bind(inp)
        compiled = dag.experimental_compile()
        try:
            out = [compiled.execute(1).get(timeout=30), compiled.execute(2).get(timeout=30)]
            # pipelined: submit several before reading
            refs = [compiled.execute(i) for i in [5, 6]]
            out.append([r.get(timeout=30) for r in refs])
            return out
        finally:
            compiled.teardown()

    assert _same(on_both(fn)) == [11, 12, [15, 16]]


def test_compiled_two_stage_pipeline(on_both):
    def fn(P):
        InputNode = _mod(P, "dag").InputNode
        Adder, Doubler = _actors(P)
        with InputNode() as inp:
            mid = Adder.bind(1).add.bind(inp)
            dag = Doubler.bind().mul.bind(mid)
        compiled = dag.experimental_compile()
        try:
            return [compiled.execute(3).get(timeout=30), compiled.execute(10).get(timeout=30)]
        finally:
            compiled.teardown()

    assert _same(on_both(fn)) == [8, 22]  # (3+1)*2, (10+1)*2


def test_compiled_fan_out_multi_output(on_both):
    def fn(P):
        dag_mod = _mod(P, "dag")
        Adder, _ = _actors(P)
        with dag_mod.InputNode() as inp:
            a = Adder.bind(100).add.bind(inp)
            b = Adder.bind(200).add.bind(inp)
            dag = dag_mod.MultiOutputNode([a, b])
        compiled = dag.experimental_compile()
        try:
            return compiled.execute(5).get(timeout=30)
        finally:
            compiled.teardown()

    assert _same(on_both(fn)) == [105, 205]


def test_compiled_diamond(on_both):
    def fn(P):
        InputNode = _mod(P, "dag").InputNode
        Adder, Doubler = _actors(P)
        with InputNode() as inp:
            a = Adder.bind(1).add.bind(inp)
            b = Adder.bind(2).add.bind(inp)
            dag = Doubler.bind().combine.bind(a, b)
        compiled = dag.experimental_compile()
        try:
            return compiled.execute(10).get(timeout=30)
        finally:
            compiled.teardown()

    assert _same(on_both(fn)) == 23  # (x+1) + (x+2)


def test_compiled_stage_error_propagates(on_both):
    def fn(P):
        InputNode = _mod(P, "dag").InputNode

        @P.remote
        class Bad:
            def boom(self, x):
                raise ValueError(f"bad input {x}")

        with InputNode() as inp:
            dag = Bad.bind().boom.bind(inp)
        compiled = dag.experimental_compile()
        try:
            # the DAG survives an error and keeps serving
            return [_raised(lambda: compiled.execute(x).get(timeout=30), RuntimeError)
                    for x in (7, 8)]
        finally:
            compiled.teardown()

    out = _same(on_both(fn))
    assert [name for name, _ in out] == ["RuntimeError", "RuntimeError"]
    assert "bad input 7" in out[0][1] and "bad input 8" in out[1][1]


def test_compiled_rejects_function_nodes(on_both):
    def fn(P):
        InputNode = _mod(P, "dag").InputNode

        @P.remote
        def f(x):
            return x

        with InputNode() as inp:
            dag = f.bind(inp)
        return _raised(dag.experimental_compile, _mod(P, "experimental.channel").ChannelError)

    assert _same(on_both(fn))[0] == "ChannelError"


def _recording_channels(P, monkeypatch):
    """The channels ``P``'s compiled DAGs create from now on (so a test can
    unlink those the JAX package's refused compile leaves behind: fault C6
    in ROADMAP.md)."""
    compiled_mod = _mod(P, "dag.compiled")
    create, made = compiled_mod.Channel.create, []

    def recording_create(*args, **kwargs):
        made.append(create(*args, **kwargs))
        return made[-1]

    monkeypatch.setattr(compiled_mod.Channel, "create", recording_create)
    return made


def test_compiled_requires_input_node(on_both, monkeypatch):
    def fn(P):
        Adder, _ = _actors(P)
        dag = Adder.bind(1).add.bind(41)
        made = _recording_channels(P, monkeypatch)
        try:
            return _raised(dag.experimental_compile, _mod(P, "experimental.channel").ChannelError)
        finally:
            for ch in made:  # the port's refused compile destroyed its own
                if os.path.exists(ch.handle.path):
                    ch.destroy()

    assert _same(on_both(fn))[0] == "ChannelError"


def test_teardown_frees_actor_for_normal_calls(on_both):
    def fn(P):
        InputNode = _mod(P, "dag").InputNode
        Adder, _ = _actors(P)
        with InputNode() as inp:
            actor = Adder.bind(10)
            dag = actor.add.bind(inp)
        compiled = dag.experimental_compile()
        handle = compiled._actors[id(actor)]
        first = compiled.execute(1).get(timeout=30)
        compiled.teardown()
        # loop exited: the actor serves regular calls again
        return first, P.get(handle.get_calls.remote(), timeout=30) >= 1

    assert _same(on_both(fn)) == (11, True)


# ------------------------------------------------ tests/test_dag_workflow.py
def _fns(P):
    @P.remote
    def add(a, b):
        return a + b

    @P.remote
    def double(x):
        return 2 * x

    return add, double


def test_function_dag_basic(on_both):
    def fn(P):
        add, double = _fns(P)
        return P.get(add.bind(double.bind(3), double.bind(4)).execute())

    assert _same(on_both(fn)) == 14


def test_dag_with_input_node(on_both):
    def fn(P):
        add, double = _fns(P)
        with _mod(P, "dag").InputNode() as inp:
            dag = add.bind(double.bind(inp), 1)
        return P.get(dag.execute(5)), P.get(dag.execute(0))

    assert _same(on_both(fn)) == (11, 1)


def test_dag_input_attribute(on_both):
    def fn(P):
        add, _ = _fns(P)
        with _mod(P, "dag").InputNode() as inp:
            dag = add.bind(inp.a, inp.b)
        return P.get(dag.execute(a=3, b=9))

    assert _same(on_both(fn)) == 12


def test_dag_shared_node_executes_once(on_both):
    def fn(P):
        add, _ = _fns(P)

        @P.remote
        class Counter:
            def __init__(self):
                self.n = 0

            def inc(self):
                self.n += 1
                return self.n

        c = Counter.remote()

        @P.remote
        def bump(counter):
            return P.get(counter.inc.remote())

        shared = bump.bind(c)
        return P.get(add.bind(shared, shared).execute())  # one execution of shared

    assert _same(on_both(fn)) == 2  # 1 + 1, not 1 + 2


def test_actor_dag(on_both):
    def fn(P):
        _, double = _fns(P)

        @P.remote
        class Adder:
            def __init__(self, bias):
                self.bias = bias

            def add(self, x):
                return x + self.bias

        return P.get(Adder.bind(10).add.bind(double.bind(4)).execute())

    assert _same(on_both(fn)) == 18


def test_multi_output_node(on_both):
    def fn(P):
        _, double = _fns(P)
        dag = _mod(P, "dag").MultiOutputNode([double.bind(1), double.bind(2), double.bind(3)])
        return P.get(dag.execute())

    assert _same(on_both(fn)) == [2, 4, 6]


# ------------------------------------------------------------------ workflow
@pytest.fixture
def wf_dirs(tmp_path):
    """``dirs(P)``: a fresh workflow storage root for package ``P``."""
    def dirs(P):
        d = tmp_path / P.__name__
        d.mkdir(exist_ok=True)
        return d
    return dirs


def test_workflow_run_and_status(on_both, wf_dirs):
    def fn(P):
        workflow = _mod(P, "workflow")
        workflow.init(str(wf_dirs(P)))
        add, double = _fns(P)
        out = workflow.run(add.bind(double.bind(5), 7), workflow_id="wf1")
        return (out, workflow.get_status("wf1"),
                any(w["workflow_id"] == "wf1" for w in workflow.list_all()))

    assert _same(on_both(fn)) == (17, "SUCCESSFUL", True)


def test_workflow_checkpoints_skip_completed_steps(on_both, wf_dirs):
    def fn(P):
        workflow = _mod(P, "workflow")
        root = wf_dirs(P)
        workflow.init(str(root))
        marker = root / "ran"
        _, double = _fns(P)

        @P.remote
        def effectful():
            with open(marker, "a") as f:
                f.write("x")
            return 21

        dag = double.bind(effectful.bind())
        out = [workflow.run(dag, workflow_id="wf2"), marker.read_text()]
        # re-run same id: effectful's checkpoint short-circuits the step
        out += [workflow.run(dag, workflow_id="wf2"), marker.read_text()]
        return out

    assert _same(on_both(fn)) == [42, "x", 42, "x"]


def test_workflow_resume_after_failure(on_both, wf_dirs):
    def fn(P):
        workflow = _mod(P, "workflow")
        root = wf_dirs(P)
        workflow.init(str(root))
        flag = root / "fail"
        flag.write_text("1")
        counter = root / "count"

        @P.remote
        def stage_a():
            with open(counter, "a") as f:
                f.write("a")
            return 5

        @P.remote
        def stage_b(x, fail_path):
            if os.path.exists(fail_path):
                raise RuntimeError("injected failure")
            return x * 10

        dag = stage_b.bind(stage_a.bind(), str(flag))
        with pytest.raises(Exception):
            workflow.run(dag, workflow_id="wf3")
        out = [workflow.get_status("wf3")]
        flag.unlink()  # clear the failure, then resume WITHOUT the driver dag
        out += [workflow.resume("wf3"), workflow.get_status("wf3"), counter.read_text()]
        return out

    assert _same(on_both(fn)) == ["FAILED", 50, "SUCCESSFUL", "a"]  # stage_a ran once


def test_workflow_resume_replays_input_node_args(on_both, wf_dirs):
    def fn(P):
        workflow = _mod(P, "workflow")
        root = wf_dirs(P)
        workflow.init(str(root))
        flag = root / "fail"
        flag.write_text("1")
        _, double = _fns(P)

        @P.remote
        def maybe_fail(x, fail_path):
            if os.path.exists(fail_path):
                raise RuntimeError("injected failure")
            return x + 100

        with _mod(P, "dag").InputNode() as inp:
            dag = maybe_fail.bind(double.bind(inp), str(flag))
        with pytest.raises(Exception):
            workflow.run(dag, 21, workflow_id="wf-inp")
        flag.unlink()
        return workflow.resume("wf-inp")

    assert _same(on_both(fn)) == 142  # the original arg (21) survives: 21*2 + 100


def test_workflow_actor_method_args_hit_checkpoints(on_both, wf_dirs):
    def fn(P):
        workflow = _mod(P, "workflow")
        root = wf_dirs(P)
        workflow.init(str(root))
        counter = root / "count"

        @P.remote
        def effectful_parent():
            with open(counter, "a") as f:
                f.write("x")
            return 6

        @P.remote
        class Multiplier:
            def __init__(self, k):
                self.k = k

            def mul(self, x):
                return self.k * x

        dag = Multiplier.bind(7).mul.bind(effectful_parent.bind())
        out = [workflow.run(dag, workflow_id="wf-actor"), counter.read_text()]
        # re-run: the actor step re-executes live, but the function parent
        # comes from its checkpoint (exactly-once side effects)
        out += [workflow.run(dag, workflow_id="wf-actor"), counter.read_text()]
        return out

    assert _same(on_both(fn)) == [42, "x", 42, "x"]


def test_kv_event_listener_fires_and_checkpoints(on_both, wf_dirs):
    def fn(P):
        workflow = _mod(P, "workflow")
        workflow.init(str(wf_dirs(P)))

        @P.remote
        def combine(event_bytes, y):
            return event_bytes.decode() + f":{y}"

        ev = workflow.wait_for_event(workflow.KVEventListener, "wf:test:signal", 0.05, 30.0)
        dag = combine.bind(ev, 7)

        def signal():
            time.sleep(0.4)
            P.kv_put("wf:test:signal", b"fired")

        threading.Thread(target=signal, daemon=True).start()
        out = [workflow.run(dag, workflow_id="wf-event")]
        # durability: the event checkpoint means resume never re-waits
        P.kv_del("wf:test:signal")
        out.append(workflow.resume("wf-event"))
        return out

    assert _same(on_both(fn)) == ["fired:7", "fired:7"]


def test_timer_listener(on_both, wf_dirs):
    def fn(P):
        workflow = _mod(P, "workflow")
        workflow.init(str(wf_dirs(P)))

        @P.remote
        def stamp(fire_at):
            return fire_at

        dag = stamp.bind(workflow.wait_for_event(workflow.TimerListener, time.time() + 0.3))
        t0 = time.monotonic()
        workflow.run(dag, workflow_id="wf-timer")
        return time.monotonic() - t0 >= 0.25

    assert _same(on_both(fn)) is True


def test_dynamic_continuation_recursive(on_both, wf_dirs):
    def fn(P):
        workflow = _mod(P, "workflow")
        workflow.init(str(wf_dirs(P)))

        @P.remote
        def fact(n, acc=1):
            if n <= 1:
                return acc
            return workflow.continuation(fact.bind(n - 1, acc * n))

        return workflow.run(fact.bind(5), workflow_id="wf-fact")

    assert _same(on_both(fn)) == 120


def test_continuation_resume_replays_only_tail(on_both, wf_dirs):
    def fn(P):
        workflow = _mod(P, "workflow")
        root = wf_dirs(P)
        workflow.init(str(root))
        flag = root / "boom"
        flag.write_text("1")
        runs = root / "runs"

        @P.remote
        def mid():
            with open(runs, "a") as f:
                f.write("m")
            if os.path.exists(flag):
                raise RuntimeError("injected failure")
            return 41

        @P.remote
        def start():
            return workflow.continuation(mid.bind())

        @P.remote
        def inc(x):
            return x + 1

        dag = inc.bind(start.bind())
        with pytest.raises(Exception):
            workflow.run(dag, workflow_id="wf-cont-resume")
        os.unlink(flag)
        out = [workflow.resume("wf-cont-resume"), runs.read_text()]
        # the completed tail never replays again
        out += [workflow.resume("wf-cont-resume"), runs.read_text()]
        return out

    assert _same(on_both(fn)) == [42, "mm", 42, "mm"]


# --------------------------------------------- the compiled chain on clusters
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
        yield started
    finally:
        _shutdown_all()
        for c in started.values():
            c.shutdown()


def test_compiled_chain_on_cluster(clusters):
    """Two stages in worker processes of the head node (channels are
    node-local), driven from this process: the values, the stage error,
    and normal calls on the actor after ``teardown()``."""
    def fn(P):
        dag_mod = _mod(P, "dag")
        Node = _mod(P, "core.resources").NodeAffinitySchedulingStrategy
        head = P.get_runtime_context().get_node_id()

        class Stage:
            def __init__(self, inc):
                self.inc = inc
                self.calls = 0

            def add(self, x):
                self.calls += 1
                if x < 0:
                    raise ValueError(f"bad input {x}")
                return x + self.inc

            def info(self):
                return self.calls, os.getpid()

        Stage = P.remote(Stage).options(scheduling_strategy=Node(head))
        with dag_mod.InputNode() as inp:
            first = Stage.bind(1)
            dag = Stage.bind(10).add.bind(first.add.bind(inp))
        compiled = dag.experimental_compile()
        try:
            out = [compiled.execute(i).get(timeout=60) for i in range(4)]
            refs = [compiled.execute(i) for i in (5, 6)]
            out.append([r.get(timeout=60) for r in refs])
            out.append(_raised(lambda: compiled.execute(-5).get(timeout=60), RuntimeError)[0])
            out.append(compiled.execute(7).get(timeout=60))
        finally:
            compiled.teardown()
        calls, pid = P.get(compiled._actors[id(first)].info.remote(), timeout=60)
        return out, calls, pid != os.getpid()

    results = []
    for P in PACKAGES:
        P.init(address=clusters[P.__name__].gcs_address, log_to_driver=False)
        try:
            results.append(fn(P))
        finally:
            P.shutdown()
    assert _same(results) == ([11, 12, 13, 14, [16, 17], "RuntimeError", 18], 8, True)


# ---------------------------------------------------------------- port only
def test_channel_files_are_the_ports():
    from ray_tpu_torch.experimental.channel import Channel

    ch = Channel.create(capacity=1024)
    try:
        assert os.path.basename(ch.handle.path).startswith("rtpt-chan-")
        assert os.path.exists(ch.handle.path)
    finally:
        ch.destroy()
    assert not os.path.exists(ch.handle.path)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int64])
def test_cpu_tensor_rides_a_channel_bit_equal(dtype):
    """A CPU tensor travels as one host buffer inside the payload and comes
    back on the CPU, bit-equal, owning its memory; an ObjectRef is refused."""
    from ray_tpu_torch.experimental.channel import Channel, ChannelError

    g = torch.Generator().manual_seed(0)
    t = (torch.randn(3, 65, generator=g) * 100).to(dtype)
    ch = Channel.create(capacity=1 << 16)
    try:
        r = Channel.open(ch.handle, reader_slot=0)
        ch.write({"t": t, "step": 3})
        out = r.read(timeout_s=10)
        assert out["step"] == 3 and out["t"].device.type == "cpu"
        assert out["t"].dtype == dtype and out["t"].shape == t.shape
        assert torch.equal(out["t"].view(torch.uint8), t.view(torch.uint8))
        out["t"].zero_()  # the reader's copy is its own
        assert r.read_bytes is not None and not torch.equal(out["t"], t)
    finally:
        ch.destroy()
    ray_tpu_torch.init(num_cpus=1)
    try:
        ch = Channel.create(capacity=1024)
        with pytest.raises(ChannelError, match="ObjectRef"):
            ch.write([ray_tpu_torch.put(1)])
        ch.destroy()
    finally:
        ray_tpu_torch.shutdown()


def test_default_workflow_root_is_the_ports(monkeypatch, tmp_path):
    from ray_tpu_torch import workflow

    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.setattr(workflow, "_storage_dir", None)
    workflow.init()
    assert workflow._root() == str(tmp_path / ".ray_tpu_torch" / "workflows")
    assert os.path.isdir(workflow._root())


def test_refused_compile_leaves_no_channel_file(port_local, monkeypatch):
    """A graph refused after its channels were made (here: no InputNode)
    unlinks them; the JAX package's copy leaves one 8 MB file in /dev/shm."""
    from ray_tpu_torch.experimental.channel import ChannelError

    made = _recording_channels(ray_tpu_torch, monkeypatch)
    dag = ray_tpu_torch.remote(_Adder).bind(1).add.bind(41)
    with pytest.raises(ChannelError, match="InputNode"):
        dag.experimental_compile()
    assert made and not any(os.path.exists(ch.handle.path) for ch in made)


@pytest.fixture
def port_local():
    _shutdown_all()
    ray_tpu_torch.init(num_cpus=2)
    yield ray_tpu_torch
    _shutdown_all()
