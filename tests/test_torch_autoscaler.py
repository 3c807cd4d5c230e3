"""The port's autoscalers (``ray_tpu_torch.autoscaler``: StandardAutoscaler
over LocalNodeProvider, SliceAutoscaler over InstanceManager and
FakeCloudProvider) held against the JAX package's (``tests/test_autoscaler.py``,
``tests/test_instance_manager.py``).

Each scenario is written once, as a function of the package, and runs on the
JAX package's cluster and then on the port's, with real subprocess nodes;
both must give the same observable result, with the reference tests' own
assertions. The accelerator is each package's own: ``num_gpus`` and ``GPU``
in the port, ``num_tpus`` and ``TPU`` in the JAX package. Added: accelerator
demand scales up an accelerator node. Port-only: a node config without
``num_gpus`` starts its agent under ``CUDA_VISIBLE_DEVICES=""``, so it never
counts (and takes) the machine's cards. Every wait has a timeout of 120 s
at most.
"""

import importlib
import os
import time

import pytest

import ray_tpu
import ray_tpu_torch

PACKAGES = (ray_tpu, ray_tpu_torch)
# the accelerator option, its resource, and the env var a worker reads its
# cards from, in each package
ACCEL = {"ray_tpu": ("num_tpus", "TPU", "TPU_VISIBLE_CHIPS"),
         "ray_tpu_torch": ("num_gpus", "GPU", "CUDA_VISIBLE_DEVICES")}


def _mod(P, name):
    return importlib.import_module(f"{P.__name__}.{name}")


def _wait(cond, timeout=120.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.5)
    return False


# ---------------------------------------------------- tests/test_autoscaler.py
@pytest.fixture(scope="module")
def scaled_clusters():
    for P in PACKAGES:
        if P.is_initialized():
            P.shutdown()
    started = {}
    try:
        for P in PACKAGES:
            auto = _mod(P, "autoscaler")
            c = _mod(P, "cluster").Cluster(initialize_head=True, head_node_args={"num_cpus": 1})
            P.init(address=c.gcs_address)
            provider = auto.LocalNodeProvider(c.gcs_address, session_dir=c.session_dir)
            scaler = auto.StandardAutoscaler(
                c.gcs_address, provider,
                auto.AutoscalerConfig(min_workers=0, max_workers=2,
                                      worker_node_config={"num_cpus": 2},
                                      idle_timeout_s=6.0, update_interval_s=0.5))
            scaler.start()
            started[P.__name__] = (c, provider, scaler)
        yield started
    finally:
        for P in PACKAGES:
            if P.is_initialized():
                P.shutdown()
        for c, provider, scaler in started.values():
            scaler.stop()
            for h in provider.non_terminated_nodes():
                provider.terminate_node(h)
            c.shutdown()


def _on_both(started, fn):
    jax_result, port_result = [fn(P, *started[P.__name__]) for P in PACKAGES]
    assert port_result == jax_result
    return port_result


def test_scales_up_on_unmet_demand_and_down_when_idle(scaled_clusters):
    def fn(P, c, provider, scaler):
        @P.remote(num_cpus=2)
        def big(i):
            time.sleep(0.2)
            return i

        # head has 1 CPU: these can never run without a scale-up
        out = sorted(P.get([big.remote(i) for i in range(3)], timeout=120))
        up = scaler.launched >= 1 and len(provider.non_terminated_nodes()) >= 1
        # idle: workers must come back down after the timeout
        down = _wait(lambda: scaler.terminated >= 1, timeout=60)
        return out, up, down

    assert _on_both(scaled_clusters, fn) == ([0, 1, 2], True, True)


def test_never_exceeds_max_workers(scaled_clusters):
    def fn(P, c, provider, scaler):
        @P.remote(num_cpus=2)
        def burn(i):
            time.sleep(0.3)
            return i

        out = sorted(P.get([burn.remote(i) for i in range(10)], timeout=120))
        return out, len(provider.non_terminated_nodes()) <= 2

    assert _on_both(scaled_clusters, fn) == (list(range(10)), True)


def _accelerator_demand(P):
    """A task that needs one card pends on a CPU head until the autoscaler
    launches a node of one card (a fake count here), runs there, and the
    idle node is terminated after the timeout."""
    opt, res, env_var = ACCEL[P.__name__]
    auto = _mod(P, "autoscaler")
    c = _mod(P, "cluster").Cluster(initialize_head=True, head_node_args={"num_cpus": 1})
    P.init(address=c.gcs_address)
    provider = auto.LocalNodeProvider(c.gcs_address, session_dir=c.session_dir)
    scaler = auto.StandardAutoscaler(
        c.gcs_address, provider,
        auto.AutoscalerConfig(max_workers=1, worker_node_config={"num_cpus": 1, opt: 1},
                              idle_timeout_s=3.0, update_interval_s=0.5))
    scaler.start()
    try:
        @P.remote(**{opt: 1})
        def on_card():
            return os.environ.get(env_var)

        visible = P.get(on_card.remote(), timeout=120)
        nodes = [n for n in P.nodes() if n["Alive"] and n["Resources"].get(res)]
        down = _wait(lambda: scaler.terminated == 1, timeout=60)
        return visible, [n["Resources"][res] for n in nodes], scaler.launched, down
    finally:
        P.shutdown()
        scaler.stop()
        for h in provider.non_terminated_nodes():
            provider.terminate_node(h)
        c.shutdown()


def test_accelerator_demand_scales_up_an_accelerator_node():
    for P in PACKAGES:
        if P.is_initialized():
            P.shutdown()
    jax_result, port_result = [_accelerator_demand(P) for P in PACKAGES]
    assert port_result[1:] == jax_result[1:] == ([1.0], 1, True)
    # the port's GPU worker is shown its card; the JAX package sets no chip
    # list for a fake count
    assert port_result[0] == "0"


# ---------------------------------------------- tests/test_instance_manager.py
def _slice_gang(P):
    """A 16-card gang provisions 4 fake hosts as ONE slice (atomic group),
    and idle scale-down drains the whole group before terminating it."""
    opt, res, env_var = ACCEL[P.__name__]
    auto = _mod(P, "autoscaler")
    im = _mod(P, "autoscaler.instance_manager")
    pgm = _mod(P, "util.placement_group")
    c = _mod(P, "cluster").Cluster(initialize_head=True, head_node_args={"num_cpus": 1})
    P.init(address=c.gcs_address)
    provider = auto.FakeCloudProvider(c.gcs_address, session_dir=c.session_dir,
                                      provision_delay_s=0.3)
    gcs = _mod(P, "core.rpc").SyncRpcClient(c.gcs_address)
    manager = auto.InstanceManager(provider, gcs_call=gcs.call)
    scaler = auto.SliceAutoscaler(
        c.gcs_address, manager,
        auto.SliceAutoscalerConfig(
            max_groups=1,
            group_config={"hosts": 4, "num_cpus": 1, opt: 4, "slice_label": "slice-16"},
            idle_timeout_s=5.0, update_interval_s=0.5))
    scaler.start()
    try:
        # 16-card gang: the head has no cards, so this PENDS and feeds demand
        pg = pgm.placement_group([{"CPU": 1, res: 4}] * 4, strategy="STRICT_PACK")
        ready = pg.wait(timeout_seconds=120)
        launched = scaler.groups_launched
        # the 4 bundles must land on 4 hosts sharing ONE slice label
        info = gcs.call("placement_group_info", pg_id=pg.id.hex())
        labels = {n["NodeID"]: n["Labels"].get("ray_tpu.io/slice") for n in gcs.call("get_nodes")}
        slices = {labels[n] for n in info["placement"]}
        strategy = _mod(P, "core.resources").PlacementGroupSchedulingStrategy

        @P.remote(**{opt: 4}, scheduling_strategy=strategy(placement_group=pg))
        def on_slice():
            return os.environ.get(env_var, "")

        visible = P.get(on_slice.remote(), timeout=120)
        # release the gang: the idle group must DRAIN (all 4 at once) + terminate
        pgm.remove_placement_group(pg)
        gone = _wait(lambda: {i.state for i in provider.instances()} == {im.TERMINATED},
                     timeout=90)
        return (visible, ready, launched, len(set(info["placement"])), len(slices),
                None in slices, gone, scaler.groups_terminated)
    finally:
        P.shutdown()
        scaler.stop()
        for inst in provider.instances():
            provider.terminate(inst)
        gcs.close()
        c.shutdown()


def test_slice_gang_scales_up_then_drains_down():
    for P in PACKAGES:
        if P.is_initialized():
            P.shutdown()
    jax_result, port_result = [_slice_gang(P) for P in PACKAGES]
    assert port_result[1:] == jax_result[1:] == (True, 1, 4, 1, False, True, 1)
    assert jax_result[0] is not None and port_result[0] == "0,1,2,3"


# ------------------------------------------------ fault C9: a pending actor
def _pending_actor(P):
    """A num_gpus=1 (num_tpus=1) actor on a cluster whose head has no card,
    with an autoscaler of one-card nodes: returns (the autoscaler's launches
    after 5 s, whether the GCS lists the actor's shape as unmet demand)."""
    opt, res, _ = ACCEL[P.__name__]
    auto = _mod(P, "autoscaler")
    c = _mod(P, "cluster").Cluster(initialize_head=True, head_node_args={"num_cpus": 1})
    P.init(address=c.gcs_address)
    provider = auto.LocalNodeProvider(c.gcs_address, session_dir=c.session_dir)
    scaler = auto.StandardAutoscaler(
        c.gcs_address, provider,
        auto.AutoscalerConfig(max_workers=1, worker_node_config={"num_cpus": 1, opt: 1},
                              idle_timeout_s=60.0, update_interval_s=0.5))
    gcs = _mod(P, "core.rpc").SyncRpcClient(c.gcs_address)
    try:
        @P.remote(**{opt: 1})
        class OnCard:
            def ping(self):
                return "pong"

        actor = OnCard.remote()
        time.sleep(1.0)
        demand = any(s.get(res) for s in gcs.call("autoscaler_state")["unmet_shapes"])
        scaler.start()
        _wait(lambda: scaler.launched >= 1, timeout=5)
        launched = scaler.launched
        if launched:
            assert P.get(actor.ping.remote(), timeout=120) == "pong"
        P.kill(actor)
        return launched, demand
    finally:
        P.shutdown()
        scaler.stop()
        gcs.close()
        for h in provider.non_terminated_nodes():
            provider.terminate_node(h)
        c.shutdown()


def test_c9_a_pending_actor_scales_up_in_the_port_only():
    """Fault C9 of the JAX package (not fixed there): its GCS feeds a pending
    actor's shape to no autoscaler, so the actor waits until it is declared
    infeasible (about 63 s) and no node is launched. The port's GCS records
    it as unmet demand, as a pending task's: the autoscaler launches a node
    and the actor runs there."""
    for P in PACKAGES:
        if P.is_initialized():
            P.shutdown()
    assert _pending_actor(ray_tpu) == (0, False)
    assert _pending_actor(ray_tpu_torch) == (1, True)


# -------------------------------------------------------------- port only
def _environ(pid):
    with open(f"/proc/{pid}/environ", "rb") as f:
        return dict(kv.split(b"=", 1) for kv in f.read().split(b"\0") if b"=" in kv)


def test_node_without_gpus_sees_no_card(monkeypatch):
    """A node config without num_gpus starts its agent under
    CUDA_VISIBLE_DEVICES="" (the agent would otherwise count the machine's
    cards); one with num_gpus keeps the caller's visibility and is told its
    count."""
    from ray_tpu_torch.autoscaler import LocalNodeProvider
    from ray_tpu_torch.cluster import Cluster

    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    c = Cluster(initialize_head=True, head_node_args={"num_cpus": 1})
    provider = LocalNodeProvider(c.gcs_address, session_dir=c.session_dir)
    try:
        cpu = provider.create_node({"num_cpus": 1})
        gpu = provider.create_node({"num_cpus": 1, "num_gpus": 1})
        cpu_env, gpu_env = (_environ(provider._procs[h].pid) for h in (cpu, gpu))
        assert cpu_env.get(b"CUDA_VISIBLE_DEVICES") == b""
        assert b"CUDA_VISIBLE_DEVICES" not in gpu_env
        client = ray_tpu_torch.core.rpc.SyncRpcClient(c.gcs_address)
        try:
            assert _wait(lambda: len([n for n in client.call("get_nodes") if n["Alive"]]) == 3)
            by_address = {n["NodeManagerAddress"]: n["Resources"]
                          for n in client.call("get_nodes")}
        finally:
            client.close()
        assert "GPU" not in by_address[provider.node_address_of(cpu)]
        assert by_address[provider.node_address_of(gpu)]["GPU"] == 1.0
        assert "--num-gpus" in provider._procs[gpu].args
        assert "--num-gpus" not in provider._procs[cpu].args
    finally:
        for h in provider.non_terminated_nodes():
            provider.terminate_node(h)
        c.shutdown()
