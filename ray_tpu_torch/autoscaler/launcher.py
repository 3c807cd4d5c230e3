"""Cluster launcher: ``up / down / exec / attach`` against a cluster YAML
(own copy of the JAX package's, with GPU cards).

Reference capability: python/ray/autoscaler/_private/commands.py (`ray
up/down/attach/exec` driving NodeProvider plugins). Redesign for this
runtime: the head (GCS + head agent) starts as detached local processes;
worker nodes come from the YAML's provider — "local" spawns agent
subprocesses on this machine (the CI/test path, the FakeMultiNodeProvider
analogue), "gce" requests the workers as ONE group of GPU VMs from
GceGpuProvider (autoscaler/gce.py) and waits until every VM's node agent
has joined the GCS. For gce the head listens on this machine's routable
address (``provider.head_ip``, else its first non-loopback IPv4 address),
the one the VMs' agents are given. Cluster state (addresses + pids +
provider handles + the gce group id) persists under
~/.ray_tpu_torch/clusters/<name>.json so down/exec/attach work from any
later shell; the session dir (logs, ready files) is
``$TMPDIR/ray_tpu_torch/cluster-*``, removed by ``down``.

YAML shape:

```yaml
cluster_name: demo
provider:
  type: local            # or: gce (project/zone/machine_type/head_ip fields)
head:
  num_cpus: 4
workers:
  count: 2
  num_cpus: 2
  num_gpus: 1            # 0 or absent: the node sees no card
```
"""

from __future__ import annotations

import fcntl
import json
import os
import shutil
import signal
import socket
import struct
import subprocess
import sys
import tempfile
import time
import uuid
from typing import Any, Dict, List, Optional

from ray_tpu_torch.autoscaler.node_provider import node_gpu_env, node_gpus
from ray_tpu_torch.utils.logging import get_logger

logger = get_logger("autoscaler.launcher")

CLUSTERS_DIR = os.path.expanduser("~/.ray_tpu_torch/clusters")
# how long `up` waits for a gce group's nodes to join, and how often it polls
GCE_UP_TIMEOUT_S, GCE_POLL_S = 900.0, 5.0
# the provider keys that are the launcher's, not GceGpuProvider's
_LAUNCHER_KEYS = ("type", "head_ip")
_SIOCGIFADDR = 0x8915
# the directory that holds the ray_tpu_torch package: the daemons import it
# whatever the caller's working directory
PKG_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _state_path(name: str) -> str:
    return os.path.join(CLUSTERS_DIR, f"{name}.json")


def load_state(name: str) -> Optional[Dict[str, Any]]:
    try:
        with open(_state_path(name)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _save_state(name: str, state: Dict[str, Any]) -> None:
    os.makedirs(CLUSTERS_DIR, exist_ok=True)
    with open(_state_path(name), "w") as f:
        json.dump(state, f, indent=2)


def load_config(path: str) -> Dict[str, Any]:
    import yaml

    with open(path) as f:
        cfg = yaml.safe_load(f)
    if not isinstance(cfg, dict) or not cfg.get("cluster_name"):
        raise ValueError("cluster YAML needs a 'cluster_name'")
    provider = cfg.get("provider") or {"type": "local"}
    if provider.get("type") not in ("local", "gce"):
        raise ValueError(f"unknown provider type {provider.get('type')!r}")
    cfg["provider"] = provider
    cfg.setdefault("head", {})
    cfg.setdefault("workers", {"count": 0})
    return cfg


def _wait_ready(path: str, proc: subprocess.Popen, what: str,
                timeout: float = 60.0) -> str:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if os.path.exists(path):
            content = open(path).read().strip()
            if content:
                return content
        if proc.poll() is not None:
            raise RuntimeError(f"{what} exited with {proc.returncode}")
        time.sleep(0.05)
    raise TimeoutError(f"{what} not ready in {timeout}s")


def _start_agent(gcs_address: str, session_dir: str, node_cfg: Dict[str, Any],
                 head: bool = False, host: str = "127.0.0.1") -> int:
    ready = os.path.join(session_dir, f"agent-{uuid.uuid4().hex[:6]}.ready")
    log = open(os.path.join(session_dir,
                            f"agent-{'head' if head else uuid.uuid4().hex[:6]}.log"),
               "ab")
    cmd = [sys.executable, "-m", "ray_tpu_torch.core.node.agent",
           "--gcs", gcs_address, "--session-dir", session_dir,
           "--ready-file", ready, "--host", host]
    if node_cfg.get("num_cpus") is not None:
        cmd += ["--num-cpus", str(node_cfg["num_cpus"])]
    if node_gpus(node_cfg):
        cmd += ["--num-gpus", str(node_gpus(node_cfg))]
    for k, v in (node_cfg.get("resources") or {}).items():
        cmd += ["--resource", f"{k}={v}"]
    for k, v in (node_cfg.get("labels") or {}).items():
        cmd += ["--label", f"{k}={v}"]
    if head:
        cmd += ["--head"]
    env = dict(_env(session_dir), **node_gpu_env(node_cfg))
    proc = subprocess.Popen(cmd, env=env, stdout=log,
                            stderr=subprocess.STDOUT, start_new_session=True)
    _wait_ready(ready, proc, "node agent")
    return proc.pid


def _env(session_dir: str) -> Dict[str, str]:
    env = dict(os.environ, RAY_TPU_SESSION_DIR=session_dir)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (PKG_ROOT, env.get("PYTHONPATH", "")) if p)
    return env


def _gce_provider(gcs_address: str, provider_cfg: Dict[str, Any]):
    from ray_tpu_torch.autoscaler.gce import GceGpuProvider

    return GceGpuProvider(gcs_address=gcs_address, **{
        k: v for k, v in provider_cfg.items() if k not in _LAUNCHER_KEYS})


def _head_ip(provider_cfg: Dict[str, Any]) -> str:
    """The address the VMs reach the head at: ``provider.head_ip``, else the
    first non-loopback IPv4 address of this machine's interfaces."""
    if provider_cfg.get("head_ip"):
        return str(provider_cfg["head_ip"])
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        for _, name in socket.if_nameindex():
            try:
                packed = fcntl.ioctl(s.fileno(), _SIOCGIFADDR,
                                     struct.pack("256s", name[:15].encode()))
            except OSError:  # no IPv4 address on this interface
                continue
            ip = socket.inet_ntoa(packed[20:24])
            if not ip.startswith("127."):
                return ip
    raise RuntimeError("no routable IPv4 address on this machine for the gce "
                       "workers to reach the head; set provider.head_ip")


def _wait_group_joined(provider, group_id: str, gcs_address: str,
                       slice_label: str, hosts: int) -> None:
    """Poll the provider and the GCS until every VM of the group is RUNNING
    and ``hosts`` alive nodes carry the group's slice label; raise on a
    FAILED or TERMINATED VM, or after GCE_UP_TIMEOUT_S."""
    from ray_tpu_torch.autoscaler.instance_manager import FAILED, RUNNING, TERMINATED
    from ray_tpu_torch.core.accelerators import SLICE_LABEL
    from ray_tpu_torch.core.rpc import SyncRpcClient

    deadline = time.monotonic() + GCE_UP_TIMEOUT_S
    gcs = SyncRpcClient(gcs_address)
    try:
        while True:
            provider.poll()
            states = {i.instance_id: i.state for i in provider.instances()
                      if i.group_id == group_id}
            if any(s in (FAILED, TERMINATED) for s in states.values()):
                raise RuntimeError(f"gce group {group_id} failed to start: {states}")
            joined = sum(1 for n in gcs.call("get_nodes")
                         if n["Alive"] and n["Labels"].get(SLICE_LABEL) == slice_label)
            if states and all(s == RUNNING for s in states.values()) and joined >= hosts:
                return
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"gce group {group_id}: {joined} of {hosts} nodes joined in "
                    f"{GCE_UP_TIMEOUT_S}s; VMs {states}")
            time.sleep(GCE_POLL_S)
    finally:
        gcs.close()


def up(config: Dict[str, Any]) -> Dict[str, Any]:
    """Bring the cluster up; idempotent-ish (a live state file is an error —
    run down first). Returns the saved state. A gce cluster's workers are one
    group of VMs, requested at once and waited for until each VM runs and its
    node agent has joined."""
    name = config["cluster_name"]
    if load_state(name):
        raise RuntimeError(
            f"cluster '{name}' already has state; run `down` first")
    session_dir = os.path.join(tempfile.gettempdir(), "ray_tpu_torch",
                               f"cluster-{name}-{uuid.uuid4().hex[:6]}")
    os.makedirs(session_dir, exist_ok=True)
    provider_cfg = config["provider"]
    gce = provider_cfg["type"] == "gce"
    # local: every node is on this machine; gce: the VMs dial the head
    host = _head_ip(provider_cfg) if gce else "127.0.0.1"
    pids: List[int] = []
    worker_handles: List[str] = []
    group_id: Optional[str] = None
    provider = None
    try:
        # head: GCS + head agent as detached process groups
        ready = os.path.join(session_dir, "gcs.ready")
        gcs_log = open(os.path.join(session_dir, "gcs.log"), "ab")
        gcs = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch.core.gcs.server", "--ready-file", ready,
             "--host", host],
            env=_env(session_dir),
            stdout=gcs_log, stderr=subprocess.STDOUT, start_new_session=True)
        pids.append(gcs.pid)
        gcs_address = _wait_ready(ready, gcs, "GCS")
        pids.append(_start_agent(gcs_address, session_dir,
                                 config.get("head") or {}, head=True, host=host))
        workers = config.get("workers") or {}
        if not gce:
            for _ in range(int(workers.get("count", 0))):
                pid = _start_agent(gcs_address, session_dir, workers)
                pids.append(pid)
                worker_handles.append(f"pid:{pid}")
        elif int(workers.get("count", 0)):
            # gce: one group of GPU VMs whose agents join over the network
            from ray_tpu_torch.autoscaler.gce import group_slice_label

            provider = _gce_provider(gcs_address, provider_cfg)
            group_cfg = {k: v for k, v in workers.items() if k != "count"}
            hosts = int(workers["count"])
            members = provider.request_group(dict(group_cfg, hosts=hosts))
            group_id = members[0].group_id
            worker_handles = [i.instance_id for i in members]
            _wait_group_joined(provider, group_id, gcs_address,
                               group_slice_label(group_cfg, group_id), hosts)
    except BaseException:
        # a half-launched cluster with no state file would orphan detached
        # process groups (and VMs) that `down` can never find — end what we
        # started
        if group_id is not None and not provider.delete_group(group_id):
            logger.error("gce group %s was not deleted; its VMs %s may still run",
                         group_id, worker_handles)
        _kill(pids)
        shutil.rmtree(session_dir, ignore_errors=True)
        raise
    state = {
        "cluster_name": name,
        "gcs_address": gcs_address,
        "session_dir": session_dir,
        "provider": provider_cfg,
        "pids": pids,
        "worker_handles": worker_handles,
        "group_id": group_id,
        "created_at": time.time(),
    }
    _save_state(name, state)
    return state


def down(name: str) -> None:
    state = load_state(name)
    if not state:
        raise RuntimeError(f"no state for cluster '{name}'")
    if state["provider"]["type"] == "gce" and state.get("group_id"):
        # one delete for the whole group; a failed one is logged with the VM
        # names (the provider's pending-delete retry needs a poll loop, which
        # `down` does not run)
        group_id = state["group_id"]
        try:
            provider = _gce_provider(state["gcs_address"], state["provider"])
            deleted = provider.delete_group(group_id, state["worker_handles"])
        except Exception:  # noqa: BLE001 - go on with the local teardown
            logger.exception("deleting gce group %s failed", group_id)
            deleted = False
        if not deleted:
            logger.error("gce group %s was not deleted; its VMs %s may still run",
                         group_id, state["worker_handles"])
    _kill(state.get("pids", []))
    if state.get("session_dir"):
        shutil.rmtree(state["session_dir"], ignore_errors=True)
    try:
        os.unlink(_state_path(name))
    except OSError:
        pass


def _kill(pids: List[int]) -> None:
    for pid in reversed(pids):
        try:
            os.killpg(os.getpgid(pid), signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass


def exec_cmd(name: str, command: List[str],
             capture: bool = False) -> subprocess.CompletedProcess:
    """Run a command against the cluster (RAY_TPU_ADDRESS injected). With a
    local provider this runs on this machine — which IS every node's
    machine; remote-provider exec would ride SSH and is not wired here."""
    state = load_state(name)
    if not state:
        raise RuntimeError(f"no state for cluster '{name}'")
    env = dict(os.environ, RAY_TPU_ADDRESS=state["gcs_address"],
               RAY_TPU_SESSION_DIR=state["session_dir"])
    return subprocess.run(command, env=env, capture_output=capture, text=True)


def attach(name: str) -> int:
    """Interactive shell with the cluster's environment exported."""
    state = load_state(name)
    if not state:
        raise RuntimeError(f"no state for cluster '{name}'")
    shell = os.environ.get("SHELL", "/bin/sh")
    print(f"attached to '{name}' (RAY_TPU_ADDRESS={state['gcs_address']}); "
          "exit the shell to detach")
    return subprocess.call(
        [shell], env=dict(os.environ, RAY_TPU_ADDRESS=state["gcs_address"]))


def list_clusters() -> List[Dict[str, Any]]:
    out = []
    if os.path.isdir(CLUSTERS_DIR):
        for fname in sorted(os.listdir(CLUSTERS_DIR)):
            if fname.endswith(".json"):
                st = load_state(fname[:-5])
                if st:
                    out.append(st)
    return out
