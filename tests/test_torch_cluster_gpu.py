"""The port's GPU resource model on the cluster (``core/accelerators.py``,
the agent's card pools) held against the JAX package's TPU chips
(``tests/test_tpu_resources.py``).

Both clusters run with a fake accelerator count of 4 (the port's
``RAY_TPU_FAKE_GPUS``, the JAX package's ``RAY_TPU_FAKE_TPU_CHIPS``): a
``num_gpus=k`` task of the port must get the same card ids, through
``CUDA_VISIBLE_DEVICES``, that a ``num_tpus=k`` task of the JAX package gets
through ``TPU_VISIBLE_CHIPS``; a CPU worker of the port sees no card
(``CUDA_VISIBLE_DEVICES=""``), where the JAX package's runs on
``JAX_PLATFORMS=cpu``; ``STRICT_PACK`` keeps a gang on one slice in both.
Unit cases cover detection, the labels and visibility under an inherited
``CUDA_VISIBLE_DEVICES``.
"""

import importlib
import os
import socket
import time

import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu.cluster import Cluster as JaxCluster
from ray_tpu.core import accelerators as jax_acc
from ray_tpu_torch.cluster import Cluster as PortCluster
from ray_tpu_torch.core import accelerators as acc

PACKAGES = (ray_tpu, ray_tpu_torch)
CLUSTERS = {"ray_tpu": JaxCluster, "ray_tpu_torch": PortCluster}
# the accelerator option, the resource, and the env var a worker reads its
# chips from, in each package
ACCEL = {"ray_tpu": ("num_tpus", "TPU", jax_acc.TPU_VISIBLE_CHIPS_ENV),
         "ray_tpu_torch": ("num_gpus", "GPU", acc.CUDA_VISIBLE_DEVICES_ENV)}
FAKE_ENV = {jax_acc.FAKE_CHIPS_ENV: "4", acc.FAKE_GPUS_ENV: "4",
            "RAY_TPU_ACCELERATOR_TYPE": "v5e-8", "RAY_TPU_SLICE_NAME": "slice-a"}


# ------------------------------------------------------------ unit: detection
def test_detection_resources_and_labels(monkeypatch):
    """nvidia-smi's cards are counted and named; the host is the slice."""
    monkeypatch.delenv(acc.FAKE_GPUS_ENV, raising=False)
    monkeypatch.delenv(acc.CUDA_VISIBLE_DEVICES_ENV, raising=False)
    monkeypatch.setattr(acc, "_smi_names", lambda: ("NVIDIA H100 80GB HBM3",) * 2)
    monkeypatch.setenv(acc.SLICE_NAME_ENV, "host-a")
    assert acc.detect_num_chips() == 2
    assert acc.node_gpu_resources() == {"GPU": 2.0}
    labels = acc.node_gpu_labels()
    # the JAX package's label keys
    assert (acc.SLICE_LABEL, acc.ACCEL_LABEL) == (jax_acc.SLICE_LABEL, jax_acc.ACCEL_LABEL)
    assert labels == {acc.SLICE_LABEL: "host-a", acc.ACCEL_LABEL: "NVIDIA H100 80GB HBM3"}
    monkeypatch.delenv(acc.SLICE_NAME_ENV)
    assert acc.node_gpu_labels()[acc.SLICE_LABEL] == socket.gethostname()
    monkeypatch.setenv(acc.FAKE_GPUS_ENV, "4")  # fake cards: counted, not named
    assert acc.node_gpu_resources() == {"GPU": 4.0}
    assert acc.ACCEL_LABEL not in acc.node_gpu_labels()


def test_no_card_no_resource(monkeypatch):
    monkeypatch.delenv(acc.FAKE_GPUS_ENV, raising=False)
    monkeypatch.setattr(acc, "_smi_names", lambda: ())
    monkeypatch.setattr(acc.glob, "glob", lambda pattern: [])
    assert acc.detect_num_chips() == 0 and acc.node_gpu_resources() == {}
    monkeypatch.setenv(acc.CUDA_VISIBLE_DEVICES_ENV, "0,1")
    assert acc.detect_num_chips() == 0  # a visibility list names no card


def test_inherited_visibility_restricts_and_maps(monkeypatch):
    """An agent started under CUDA_VISIBLE_DEVICES owns only those cards,
    and hands its workers their physical ids."""
    monkeypatch.delenv(acc.FAKE_GPUS_ENV, raising=False)
    monkeypatch.setattr(acc, "_host_device_ids", lambda: [str(i) for i in range(8)])
    assert acc.detect_num_chips() == 8
    monkeypatch.setenv(acc.CUDA_VISIBLE_DEVICES_ENV, "4,6")
    assert acc.device_ids() == ["4", "6"]
    assert acc.visible_chip_env([1], 2) == {acc.CUDA_VISIBLE_DEVICES_ENV: "6"}
    assert acc.visible_chip_env([0, 1], 2) == {acc.CUDA_VISIBLE_DEVICES_ENV: "4,6"}
    monkeypatch.setenv(acc.CUDA_VISIBLE_DEVICES_ENV, "")
    assert acc.detect_num_chips() == 0
    monkeypatch.setenv(acc.CUDA_VISIBLE_DEVICES_ENV, "3,-1,5")
    assert acc.device_ids() == ["3"]  # CUDA stops at the first invalid entry


def test_any_subset_is_visible(monkeypatch):
    """Where libtpu has bounds recipes for 1, 2 and 4 chips only, any subset
    of cards is one CUDA_VISIBLE_DEVICES list."""
    monkeypatch.setenv(acc.FAKE_GPUS_ENV, "8")
    assert acc.visible_chip_env([2], 8) == {acc.CUDA_VISIBLE_DEVICES_ENV: "2"}
    assert acc.visible_chip_env([0, 3, 5], 8) == {acc.CUDA_VISIBLE_DEVICES_ENV: "0,3,5"}
    assert jax_acc.visible_chip_env([2], 8)[jax_acc.TPU_VISIBLE_CHIPS_ENV] == "2"
    with pytest.raises(ValueError):
        jax_acc.visible_chip_env([0, 3, 5], 8)


# ------------------------------------------------ cluster: cards and slices
@pytest.fixture(scope="module")
def clusters():
    for P in PACKAGES:
        if P.is_initialized():
            P.shutdown()
    saved = {k: os.environ.get(k) for k in FAKE_ENV}
    os.environ.update(FAKE_ENV)
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
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _on_both(clusters, fn):
    return [fn(P, clusters[P.__name__], *ACCEL[P.__name__]) for P in PACKAGES]


def test_accelerator_resources_registered(clusters):
    def fn(P, _, opt, res, env):
        head = P.nodes()[0]
        return head["Resources"].get(res), head["Labels"][acc.SLICE_LABEL]

    jax_out, port_out = _on_both(clusters, fn)
    assert port_out == jax_out == (4.0, "slice-a")
    assert "TPU" not in ray_tpu_torch.cluster_resources()


def test_accelerator_task_gets_visible_chips(clusters):
    def fn(P, _, opt, res, env):
        @P.remote(**{opt: 1})
        def probe():
            return os.environ.get(env)

        return P.get(probe.remote(), timeout=60)

    jax_out, port_out = _on_both(clusters, fn)
    assert port_out is not None and len(port_out.split(",")) == 1
    assert port_out == jax_out  # the same chip id


def test_two_accelerator_tasks_get_distinct_chips(clusters):
    def fn(P, _, opt, res, env):
        @P.remote(**{opt: 2})
        def probe(delay):
            time.sleep(delay)
            return os.environ.get(env)

        a, b = P.get([probe.remote(0.4), probe.remote(0.4)], timeout=60)
        assert a is not None and b is not None
        assert set(a.split(",")).isdisjoint(set(b.split(","))), (a, b)
        return sorted([a, b])

    jax_out, port_out = _on_both(clusters, fn)
    assert port_out == jax_out


def test_accelerator_actor_keeps_its_chip(clusters):
    def fn(P, _, opt, res, env):
        @P.remote(**{opt: 1})
        class Holder:
            def chips(self):
                return os.environ.get(env)

        h = Holder.remote()
        first = P.get(h.chips.remote(), timeout=60)
        again = P.get(h.chips.remote(), timeout=60)
        P.kill(h)
        return first == again and len(first.split(",")) == 1

    assert _on_both(clusters, fn) == [True, True]


def test_cpu_worker_sees_no_card(clusters):
    """The port's CPU workers get CUDA_VISIBLE_DEVICES="" (no card), where
    the JAX package's are forced onto JAX_PLATFORMS=cpu."""
    def fn(P, _, opt, res, env):
        @P.remote
        def probe():
            return os.environ.get(env), os.environ.get("JAX_PLATFORMS")

        return P.get(probe.remote(), timeout=60)

    (jax_env, jax_platform), (port_env, _) = _on_both(clusters, fn)
    assert jax_env is None and jax_platform == "cpu"
    assert port_env == ""


def test_strict_pack_prefers_same_slice(clusters):
    """Two extra nodes share slice-b, one sits on slice-c; a 2-bundle
    STRICT_PACK gang lands on one slice (one interconnect domain), never
    straddling slices."""
    def fn(P, cluster, opt, res, env):
        os.environ["RAY_TPU_SLICE_NAME"] = "slice-b"
        n1 = cluster.add_node(num_cpus=1)
        n2 = cluster.add_node(num_cpus=1)
        os.environ["RAY_TPU_SLICE_NAME"] = "slice-c"
        n3 = cluster.add_node(num_cpus=1)
        os.environ["RAY_TPU_SLICE_NAME"] = "slice-a"
        try:
            cluster.wait_for_nodes(4, timeout=60)
            pgm = importlib.import_module(f"{P.__name__}.util.placement_group")
            pg = pgm.placement_group([{"CPU": 1}, {"CPU": 1}], strategy="STRICT_PACK")
            assert pg.wait(timeout_seconds=30)
            rpc = importlib.import_module(f"{P.__name__}.core.rpc")
            gcs = rpc.SyncRpcClient(cluster.gcs_address)
            try:
                info = gcs.call("placement_group_info", pg_id=pg.id.hex())
                nodes = {n["NodeID"]: n["Labels"].get(acc.SLICE_LABEL)
                         for n in gcs.call("get_nodes")}
            finally:
                gcs.close()
            pgm.remove_placement_group(pg)
            return len({nodes[n] for n in info["placement"]})
        finally:
            for n in (n1, n2, n3):
                cluster.remove_node(n)

    jax_out, port_out = _on_both(clusters, fn)
    assert port_out == jax_out == 1, "STRICT_PACK straddled slices"
