"""The port's cluster launcher (``ray_tpu_torch.autoscaler.launcher``: ``up /
down / exec``) and its ``stack`` / ``memory`` verbs, held against the JAX
package's (``tests/test_launcher.py``).

Each scenario is written once, as a function of the package, and runs on the
JAX package and then on the port; both must give the same observable result,
with the reference test's own assertions. Added: fault C8, ``up`` and
``down`` with a ``gce`` provider against a fake ``gcloud`` on ``PATH`` that
boots each VM by running its startup script here: the port's head listens on
a routable address, the VMs' agents join it there, ``up`` waits until they
have, and ``down`` deletes the group;
the JAX package's ``up`` raises ``AttributeError`` (its GceTpuProvider has no
``create_node``) and its ``down`` deletes nothing (no ``terminate_node``).
Every wait has a timeout of 120 s at most.
"""

import importlib
import ipaddress
import json
import os
import signal
import subprocess
import sys
import textwrap

import pytest

import ray_tpu
import ray_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = (ray_tpu, ray_tpu_torch)


def _mod(P, name):
    return importlib.import_module(f"{P.__name__}.{name}")


def _both(fn):
    jax_result, port_result = [fn(P) for P in PACKAGES]
    assert port_result == jax_result
    return port_result


# ----------------------------------------------------- tests/test_launcher.py
def test_up_exec_down_roundtrip(tmp_path, monkeypatch):
    def fn(P):
        launcher = _mod(P, "autoscaler.launcher")
        monkeypatch.setattr(launcher, "CLUSTERS_DIR", str(tmp_path / P.__name__ / "clusters"))
        cfg_path = tmp_path / f"cluster_{P.__name__}.yaml"
        cfg_path.write_text(
            "cluster_name: ltest\n"
            "provider:\n  type: local\n"
            "head:\n  num_cpus: 2\n"
            "workers:\n  count: 1\n  num_cpus: 1\n"
        )
        cfg = launcher.load_config(str(cfg_path))
        state = launcher.up(cfg)
        try:
            out = [bool(state["gcs_address"]), len(state["pids"]),
                   launcher.load_state("ltest")["cluster_name"]]
            # a second up against live state must refuse
            with pytest.raises(RuntimeError, match="already"):
                launcher.up(cfg)
            # exec: a driver process that connects via RAY_TPU_ADDRESS and
            # runs a task on the cluster
            script = tmp_path / f"driver_{P.__name__}.py"
            script.write_text(textwrap.dedent(f"""
                import os, sys
                sys.path.insert(0, {REPO!r})
                import {P.__name__} as P
                P.init(address=os.environ['RAY_TPU_ADDRESS'], log_to_driver=False)
                @P.remote
                def f(x):
                    return x * 3
                print('EXEC_RESULT', P.get(f.remote(14), timeout=120))
                P.shutdown()
            """))
            proc = launcher.exec_cmd("ltest", [sys.executable, str(script)], capture=True)
            assert proc.returncode == 0, (proc.stdout, proc.stderr)
            out.append("EXEC_RESULT 42" in proc.stdout)
            # both nodes visible
            nodes = launcher.exec_cmd(
                "ltest", [sys.executable, "-c",
                          f"import sys; sys.path.insert(0, {REPO!r})\n"
                          f"import os, json, {P.__name__} as P\n"
                          "P.init(address=os.environ['RAY_TPU_ADDRESS'], log_to_driver=False)\n"
                          "print(json.dumps(len(P.nodes())))"],
                capture=True)
            out.append(json.loads(nodes.stdout.strip().splitlines()[-1]))
        finally:
            launcher.down("ltest")
        return out + [launcher.load_state("ltest")]

    assert _both(fn) == [True, 3, "ltest", True, 2, None]


def test_load_config_validation(tmp_path):
    bad = tmp_path / "bad.yaml"
    bad.write_text("provider: {type: local}\n")
    bad2 = tmp_path / "bad2.yaml"
    bad2.write_text("cluster_name: x\nprovider: {type: venus}\n")

    def fn(P):
        launcher = _mod(P, "autoscaler.launcher")
        out = []
        for path in (bad, bad2):
            with pytest.raises(ValueError) as e:
                launcher.load_config(str(path))
            out.append(str(e.value))
        return out

    first, second = _both(fn)
    assert "cluster_name" in first and "provider" in second


def test_stack_and_memory_cli():
    """``stack`` / ``memory`` through each package's CLI module against a
    live cluster of that package."""
    for P in PACKAGES:
        if P.is_initialized():
            P.shutdown()

    def fn(P):
        c = _mod(P, "cluster").Cluster(initialize_head=True, head_node_args={"num_cpus": 2})
        try:
            P.init(address=c.gcs_address, log_to_driver=False)
            ref = P.put(b"x" * 100_000)
            env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
            out = []
            for verb in ("memory", "stack"):
                r = subprocess.run(
                    [sys.executable, "-m", f"{P.__name__}.scripts.cli", verb,
                     "--address", c.gcs_address],
                    capture_output=True, text=True, timeout=120, env=env)
                assert r.returncode == 0, r.stderr
                out.append(r.stdout)
            memory, stack = out
            return (ref.id.hex()[:48] in memory, "objects" in memory,
                    "=== GCS" in stack and "=== node agent" in stack,
                    # the dump names real framework threads with frames
                    "MainThread" in stack and "File " in stack)
        finally:
            P.shutdown()
            c.shutdown()

    assert _both(fn) == (True, True, True, True)


# ------------------------------------------------------- fault C8: gce up/down
FAKE_GCLOUD = r'''#!{python}
"""A fake gcloud: `compute instances bulk create/list/delete` on a JSON
file; every call is appended to the log. A created VM boots: its startup
script runs here in a process group of its own, which delete kills."""
import json, os, signal, subprocess, sys

args = sys.argv[1:]
state_path = os.environ["FAKE_GCLOUD_STATE"]
with open(state_path + ".log", "a") as f:
    f.write(json.dumps(args) + "\n")
try:
    with open(state_path) as f:
        vms = json.load(f)
except OSError:
    vms = {{}}


def opt(name):
    return args[args.index(name) + 1]


out = []
if args[:4] == ["compute", "instances", "bulk", "create"]:
    label_k, label_v = opt("--labels").split("=", 1)
    script = opt("--metadata").split("=", 1)[1]
    for i in range(int(opt("--count"))):
        name = opt("--name-pattern").replace("#", str(i + 1))
        log = open(state_path + "." + name + ".log", "ab")
        boot = subprocess.Popen(["sh", "-c", script], stdout=log, stderr=subprocess.STDOUT,
                                start_new_session=True)
        with open(state_path + ".pids", "a") as f:
            f.write(str(boot.pid) + "\n")
        vms[name] = {{"name": name, "status": "RUNNING", "labels": {{label_k: label_v}},
                     "machineType": opt("--machine-type"), "pid": boot.pid}}
elif args[:3] == ["compute", "instances", "list"]:
    out = list(vms.values())
elif args[:3] == ["compute", "instances", "delete"]:
    for name in args[3:]:
        if name.startswith("--"):
            break
        vm = vms.pop(name, None)
        if vm:
            try:
                os.killpg(vm["pid"], signal.SIGKILL)
            except ProcessLookupError:
                pass
else:
    sys.stderr.write("fake gcloud: unsupported " + " ".join(args))
    sys.exit(1)
with open(state_path, "w") as f:
    json.dump(vms, f)
print(json.dumps(out))
'''


@pytest.fixture
def fake_gcloud(tmp_path, monkeypatch):
    """A fake gcloud first on PATH, with a ``python`` beside it for the VMs'
    startup scripts; returns (state path, calls()). Every VM it booted is
    killed at the end, deleted or not."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    gcloud = bin_dir / "gcloud"
    gcloud.write_text(FAKE_GCLOUD.format(python=sys.executable))
    gcloud.chmod(0o755)
    python = bin_dir / "python"
    python.write_text(f'#!/bin/sh\nexec "{sys.executable}" "$@"\n')
    python.chmod(0o755)
    state = tmp_path / "cloud.json"
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setenv("FAKE_GCLOUD_STATE", str(state))
    monkeypatch.setenv("PYTHONPATH", REPO)
    # a VM's node has no card here, whatever num_gpus it advertises
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")

    def calls():
        try:
            with open(f"{state}.log") as f:
                return [json.loads(line) for line in f]
        except OSError:
            return []

    yield state, calls
    try:
        with open(f"{state}.pids") as f:
            pids = [int(line) for line in f]
    except OSError:
        pids = []
    for pid in pids:
        try:
            os.killpg(pid, signal.SIGKILL)
        except ProcessLookupError:
            pass


C8_CONFIG = {"cluster_name": "c8", "provider": {"type": "gce", "project": "p", "zone": "z"},
             "head": {"num_cpus": 1}, "workers": {"count": 2, "num_cpus": 1, "num_gpus": 8,
                                                  "machine_type": "a3-highgpu-8g"}}


def test_c8_port_up_and_down_with_gce_request_and_delete_one_group(
        tmp_path, monkeypatch, fake_gcloud):
    from ray_tpu_torch.autoscaler import launcher
    from ray_tpu_torch.core.rpc import SyncRpcClient

    state_path, calls = fake_gcloud
    monkeypatch.setattr(launcher, "CLUSTERS_DIR", str(tmp_path / "clusters"))
    monkeypatch.setattr(launcher, "GCE_POLL_S", 0.2)
    monkeypatch.setattr(launcher, "GCE_UP_TIMEOUT_S", 120.0)
    try:
        head_ip = launcher._head_ip(C8_CONFIG["provider"])
    except RuntimeError as e:
        # a machine with no routable address: up refuses before any VM
        with pytest.raises(RuntimeError, match="provider.head_ip"):
            launcher.up(json.loads(json.dumps(C8_CONFIG)))
        assert "head_ip" in str(e) and calls() == []
        return
    state = launcher.up(json.loads(json.dumps(C8_CONFIG)))
    try:
        group = state["group_id"]
        assert group.startswith("rtpt-") and len(state["pids"]) == 2
        assert state["worker_handles"] == [f"{group}-1", f"{group}-2"]
        creates = [a for a in calls() if a[:4] == ["compute", "instances", "bulk", "create"]]
        assert len(creates) == 1
        create = creates[0]
        assert create[create.index("--count") + 1] == "2"
        assert create[create.index("--machine-type") + 1] == "a3-highgpu-8g"
        assert create[create.index("--labels") + 1] == f"rtpt-group={group}"
        script = create[create.index("--metadata") + 1]
        assert "-m ray_tpu_torch.core.node.agent" in script and "--num-gpus 8" in script
        assert f"--label ray_tpu.io/slice=gpu-{group}" in script
        # the VMs dial the head at a routable address, the one it listens on
        gcs = script.split("--gcs ", 1)[1].split()[0]
        assert gcs == state["gcs_address"] and gcs.rsplit(":", 1)[0] == head_ip
        assert not ipaddress.ip_address(head_ip).is_loopback
        # up returned once both VMs' agents had joined the GCS
        client = SyncRpcClient(state["gcs_address"])
        try:
            slices = [n["Labels"].get("ray_tpu.io/slice") for n in client.call("get_nodes")
                      if n["Alive"]]
        finally:
            client.close()
        assert slices.count(f"gpu-{group}") == 2 and len(slices) == 3
        with open(state_path) as f:
            assert sorted(json.load(f)) == state["worker_handles"]
        # up polled `instances list`, which takes --zones, for the group's label
        lists = [a for a in calls() if a[:3] == ["compute", "instances", "list"]]
        assert lists and all("--zones" in a and "labels.rtpt-group:*" in a for a in lists)
        assert all("--zone" in a for a in calls() if a not in lists)
    finally:
        launcher.down("c8")
    deletes = [a for a in calls() if a[:3] == ["compute", "instances", "delete"]]
    assert len(deletes) == 1 and deletes[0][3:5] == state["worker_handles"]
    with open(state_path) as f:
        assert json.load(f) == {}
    assert launcher.load_state("c8") is None


def test_c8_port_down_logs_a_failed_delete(tmp_path, monkeypatch, fake_gcloud, caplog):
    """A delete that fails is logged with the group's VM names, not
    swallowed."""
    from ray_tpu_torch.autoscaler import launcher

    state_path, calls = fake_gcloud
    monkeypatch.setattr(launcher, "CLUSTERS_DIR", str(tmp_path / "clusters"))
    monkeypatch.setattr(launcher, "GCE_POLL_S", 0.2)
    monkeypatch.setattr(launcher, "GCE_UP_TIMEOUT_S", 120.0)
    try:
        launcher._head_ip(C8_CONFIG["provider"])
    except RuntimeError:
        # a machine with no routable address: up refuses (the test above)
        with pytest.raises(RuntimeError, match="provider.head_ip"):
            launcher.up(json.loads(json.dumps(C8_CONFIG)))
        return
    state = launcher.up(json.loads(json.dumps(C8_CONFIG)))
    # the cloud refuses from now on
    (tmp_path / "bin" / "gcloud").write_text("#!/bin/sh\necho refused >&2\nexit 1\n")
    caplog.set_level("ERROR", logger="ray_tpu_torch")
    launcher.down("c8")
    text = caplog.text
    assert f"gce group {state['group_id']} was not deleted" in text
    assert all(h in text for h in state["worker_handles"])


def test_c8_jax_up_and_down_with_gce_fail_as_recorded(tmp_path, monkeypatch, fake_gcloud):
    """The record of fault C8 in the JAX package (not fixed there): ``up``
    raises AttributeError after starting the head (which its except kills),
    and ``down`` of a gce cluster's state deletes no VM."""
    from ray_tpu.autoscaler import launcher

    _, calls = fake_gcloud
    monkeypatch.setattr(launcher, "CLUSTERS_DIR", str(tmp_path / "clusters"))
    with pytest.raises(AttributeError, match="'GceTpuProvider' object has no attribute "
                                             "'create_node'"):
        launcher.up(json.loads(json.dumps(C8_CONFIG)))
    assert launcher.load_state("c8") is None and calls() == []
    # the state a working up would have saved: down must delete its VM
    os.makedirs(launcher.CLUSTERS_DIR)
    with open(os.path.join(launcher.CLUSTERS_DIR, "c8.json"), "w") as f:
        json.dump({"cluster_name": "c8", "gcs_address": "127.0.0.1:1", "session_dir": "",
                   "provider": C8_CONFIG["provider"], "pids": [],
                   "worker_handles": ["rtpu-00000000"]}, f)
    launcher.down("c8")  # swallows the AttributeError of terminate_node
    assert calls() == [] and launcher.load_state("c8") is None
