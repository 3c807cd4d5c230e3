"""Instance manager: explicit cloud-instance lifecycle for the autoscaler
(own copy of the JAX package's, with GPU cards).

Reference capability: python/ray/autoscaler/v2/instance_manager/ (instance
states REQUESTED -> ALLOCATED -> RAY_RUNNING -> RAY_STOPPING -> TERMINATED,
reconciler.py) + _private/fake_multi_node/node_provider.py:236 (subprocess
fake cloud for e2e tests). Instances belong to SLICE GROUPS — a group
request is ``hosts`` machines that must provision atomically and join the
cluster under one slice label (the JAX package's TPU queued-resources
semantics, kept for GPU hosts: the whole group becomes ready or nothing
does).
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ray_tpu_torch.autoscaler.node_provider import node_gpu_env, node_gpus
from ray_tpu_torch.utils.logging import get_logger

logger = get_logger("autoscaler.instances")

# lifecycle states (reference: instance_manager/common.py InstanceStatus)
REQUESTED = "REQUESTED"
STARTING = "STARTING"
RUNNING = "RUNNING"
DRAINING = "DRAINING"
TERMINATED = "TERMINATED"
FAILED = "FAILED"


@dataclass
class Instance:
    instance_id: str
    group_id: str           # slice group (one host groups are their own group)
    state: str = REQUESTED
    node_config: Dict[str, Any] = field(default_factory=dict)
    address: str = ""       # node agent RPC address once RUNNING
    created_at: float = field(default_factory=time.monotonic)
    state_since: float = field(default_factory=time.monotonic)
    error: str = ""

    def transition(self, state: str) -> None:
        logger.info("instance %s: %s -> %s", self.instance_id, self.state, state)
        self.state = state
        self.state_since = time.monotonic()


class CloudProvider:
    """Async cloud control plane: request/poll/terminate. Implementations:
    FakeCloudProvider (subprocess nodes, CI) and GceGpuProvider (GPU VMs
    via gcloud)."""

    def request_group(self, group_config: Dict[str, Any]) -> List[Instance]:
        """Ask for one group (1 host, or a whole slice). Returns REQUESTED
        instances immediately; provisioning is asynchronous."""
        raise NotImplementedError

    def poll(self) -> None:
        """Advance async state (REQUESTED->STARTING->RUNNING / FAILED)."""
        raise NotImplementedError

    def terminate(self, instance: Instance) -> None:
        raise NotImplementedError

    def instances(self) -> List[Instance]:
        raise NotImplementedError


class FakeCloudProvider(CloudProvider):
    """Simulated cloud with real subprocess node agents: instances move
    REQUESTED -> STARTING (provision_delay_s) -> RUNNING (agent process up,
    registered at the GCS). A slice group's hosts move together: the group
    becomes RUNNING only when EVERY host's agent is up (atomic slice
    semantics); one host failing fails the whole group."""

    def __init__(self, gcs_address: str, session_dir: Optional[str] = None,
                 provision_delay_s: float = 0.5):
        self.gcs_address = gcs_address
        self.session_dir = session_dir or tempfile.mkdtemp(prefix="ray_tpu_torch_fakecloud_")
        self.provision_delay_s = provision_delay_s
        self._instances: Dict[str, Instance] = {}
        self._procs: Dict[str, subprocess.Popen] = {}
        self._lock = threading.Lock()

    # ------------------------------------------------------------- requests
    def request_group(self, group_config: Dict[str, Any]) -> List[Instance]:
        hosts = int(group_config.get("hosts", 1))
        group_id = f"grp-{uuid.uuid4().hex[:8]}"
        out = []
        with self._lock:
            for _ in range(hosts):
                inst = Instance(
                    instance_id=f"i-{uuid.uuid4().hex[:8]}",
                    group_id=group_id,
                    node_config=dict(group_config),
                )
                self._instances[inst.instance_id] = inst
                out.append(inst)
        logger.info("requested group %s: %d host(s)", group_id, hosts)
        return out

    # ---------------------------------------------------------------- poll
    def poll(self) -> None:
        now = time.monotonic()
        with self._lock:
            insts = list(self._instances.values())
        for inst in insts:
            if inst.state == REQUESTED and now - inst.state_since >= self.provision_delay_s:
                try:
                    self._launch(inst)
                    inst.transition(STARTING)
                except Exception as e:  # noqa: BLE001
                    inst.error = str(e)
                    inst.transition(FAILED)
                    self._fail_group(inst.group_id)
            elif inst.state == STARTING:
                ready = os.path.join(self.session_dir, f"{inst.instance_id}.ready")
                proc = self._procs.get(inst.instance_id)
                if proc is not None and proc.poll() is not None:
                    inst.error = f"agent exited with {proc.returncode}"
                    inst.transition(FAILED)
                    self._fail_group(inst.group_id)
                elif os.path.exists(ready):
                    address = open(ready).read().strip()
                    if address:
                        inst.address = address
                        inst.transition(RUNNING)

    def _fail_group(self, group_id: str) -> None:
        """Slice atomicity: one failed host dooms its whole group."""
        for other in self._instances.values():
            if other.group_id == group_id and other.state not in (FAILED, TERMINATED):
                self.terminate(other)

    def _launch(self, inst: Instance) -> None:
        cfg = inst.node_config
        ready = os.path.join(self.session_dir, f"{inst.instance_id}.ready")
        log = open(os.path.join(self.session_dir, f"{inst.instance_id}.log"), "ab")
        cmd = [
            sys.executable, "-m", "ray_tpu_torch.core.node.agent",
            "--gcs", self.gcs_address,
            "--session-dir", self.session_dir,
            "--ready-file", ready,
            "--num-cpus", str(int(cfg.get("num_cpus", 1))),
        ]
        if node_gpus(cfg):
            cmd += ["--num-gpus", str(node_gpus(cfg))]
        labels = dict(cfg.get("labels") or {})
        if cfg.get("slice_label"):
            # every host of the group shares ONE slice label (STRICT_PACK
            # treats it as one domain)
            labels["ray_tpu.io/slice"] = f"{cfg['slice_label']}-{inst.group_id}"
        for k, v in labels.items():
            cmd += ["--label", f"{k}={v}"]
        for k, v in (cfg.get("resources") or {}).items():
            cmd += ["--resource", f"{k}={v}"]
        env = dict(os.environ)
        pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (pkg_root, env.get("PYTHONPATH", "")) if p)
        env.update(node_gpu_env(cfg))
        self._procs[inst.instance_id] = subprocess.Popen(
            cmd, env=env, stdout=log, stderr=subprocess.STDOUT,
            start_new_session=True,
        )

    # ----------------------------------------------------------- terminate
    def terminate(self, instance: Instance) -> None:
        if instance.state == TERMINATED:
            return
        proc = self._procs.pop(instance.instance_id, None)
        if proc is not None:
            import signal

            try:
                os.killpg(os.getpgid(proc.pid), signal.SIGKILL)
            except Exception:  # noqa: BLE001
                try:
                    proc.kill()
                except Exception:  # noqa: BLE001
                    pass
        instance.transition(TERMINATED)

    def instances(self) -> List[Instance]:
        with self._lock:
            return list(self._instances.values())


class InstanceManager:
    """Reconciles instance state against group targets and drains before
    terminating (reference: v2 reconciler + RAY_STOPPING draining)."""

    def __init__(self, provider: CloudProvider, gcs_call=None):
        self.provider = provider
        self._gcs_call = gcs_call  # fn(method, **kw) for drain_node

    # views
    def running(self) -> List[Instance]:
        return [i for i in self.provider.instances() if i.state == RUNNING]

    def active_groups(self) -> Dict[str, List[Instance]]:
        """group_id -> instances, excluding terminated/failed groups."""
        groups: Dict[str, List[Instance]] = {}
        for i in self.provider.instances():
            if i.state in (TERMINATED, FAILED):
                continue
            groups.setdefault(i.group_id, []).append(i)
        return groups

    def request_group(self, group_config: Dict[str, Any]) -> List[Instance]:
        return self.provider.request_group(group_config)

    def poll(self) -> None:
        self.provider.poll()

    def drain_and_terminate_group(self, group_id: str,
                                  node_ids_by_address: Dict[str, str]) -> None:
        """Slice scale-down: drain every host at the GCS (placements stop
        instantly), then terminate the whole group."""
        members = [i for i in self.provider.instances()
                   if i.group_id == group_id and i.state not in (TERMINATED, FAILED)]
        for inst in members:
            inst.transition(DRAINING)
            node_id = node_ids_by_address.get(inst.address)
            if node_id and self._gcs_call is not None:
                try:
                    self._gcs_call("drain_node", node_id=node_id)
                except Exception:  # noqa: BLE001
                    pass
        for inst in members:
            self.provider.terminate(inst)
