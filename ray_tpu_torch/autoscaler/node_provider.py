"""Node providers: how the autoscaler actually obtains/terminates machines
(own copy of the JAX package's, with GPU cards).

Reference capability: python/ray/autoscaler/node_provider.py (NodeProvider
interface) + _private/fake_multi_node/node_provider.py:236 (subprocess nodes
for e2e autoscaler tests). Cloud/TPU-pod providers implement the same three
methods against their control planes (GKE, queued resources, etc.).
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time
import uuid
from typing import Any, Dict, List, Optional


def node_gpus(node_config: Dict[str, Any]) -> int:
    """A node config's cards: ``num_gpus`` (0 when absent)."""
    return int(node_config.get("num_gpus") or 0)


def node_gpu_env(node_config: Dict[str, Any]) -> Dict[str, str]:
    """The env a launched agent needs: a node config without cards gets
    ``CUDA_VISIBLE_DEVICES=""`` (the rule for a CPU worker, applied to a whole
    node). The agent counts the machine's cards when it is given none, and a
    CPU node would otherwise advertise, and take, a GPU node's card."""
    return {} if node_gpus(node_config) else {"CUDA_VISIBLE_DEVICES": ""}


class NodeProvider:
    def create_node(self, node_config: Dict[str, Any]) -> str:
        """Launch one node; returns an opaque node handle id."""
        raise NotImplementedError

    def terminate_node(self, handle: str) -> None:
        raise NotImplementedError

    def non_terminated_nodes(self) -> List[str]:
        raise NotImplementedError

    def node_address_of(self, handle: str) -> Optional[str]:
        """Agent RPC address of a launched node, when known (lets the
        autoscaler drain the node at the GCS before terminating)."""
        return None


class LocalNodeProvider(NodeProvider):
    """Subprocess node agents on this machine (the fake_multi_node analogue):
    real processes, real RPC — the autoscaler e2e path without a cloud."""

    def __init__(self, gcs_address: str, session_dir: Optional[str] = None):
        self.gcs_address = gcs_address
        self.session_dir = session_dir or tempfile.mkdtemp(prefix="ray_tpu_torch_autoscale_")
        self._procs: Dict[str, subprocess.Popen] = {}
        self._addresses: Dict[str, str] = {}

    def create_node(self, node_config: Dict[str, Any]) -> str:
        handle = f"local-{uuid.uuid4().hex[:8]}"
        ready = os.path.join(self.session_dir, f"{handle}.ready")
        log = open(os.path.join(self.session_dir, f"{handle}.log"), "ab")
        cmd = [
            sys.executable, "-m", "ray_tpu_torch.core.node.agent",
            "--gcs", self.gcs_address,
            "--session-dir", self.session_dir,
            "--ready-file", ready,
            "--num-cpus", str(int(node_config.get("num_cpus", 1))),
        ]
        num_gpus = node_gpus(node_config)
        if num_gpus:
            cmd += ["--num-gpus", str(num_gpus)]
        for k, v in (node_config.get("resources") or {}).items():
            cmd += ["--resource", f"{k}={v}"]
        for k, v in (node_config.get("labels") or {}).items():
            cmd += ["--label", f"{k}={v}"]
        env = dict(os.environ)
        # the agent module must be importable regardless of the caller's cwd
        pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (pkg_root, env.get("PYTHONPATH", "")) if p)
        env.update(node_gpu_env(node_config))
        proc = subprocess.Popen(cmd, env=env, stdout=log,
                                stderr=subprocess.STDOUT, start_new_session=True)
        deadline = time.monotonic() + 40
        address = ""
        while time.monotonic() < deadline:
            if os.path.exists(ready):
                address = open(ready).read().strip()
                if address:
                    break
            if proc.poll() is not None:
                raise RuntimeError(f"node {handle} exited with {proc.returncode}")
            time.sleep(0.05)
        self._procs[handle] = proc
        self._addresses[handle] = address
        return handle

    def node_address_of(self, handle: str) -> Optional[str]:
        return self._addresses.get(handle)

    def terminate_node(self, handle: str) -> None:
        proc = self._procs.pop(handle, None)
        if proc is not None:
            import signal

            try:
                os.killpg(os.getpgid(proc.pid), signal.SIGKILL)
            except Exception:  # noqa: BLE001
                proc.kill()
            # reap it, then drop its shm arena: a SIGKILLed agent cannot
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                return
            from ray_tpu_torch.core.shm_store import sweep_dead_arenas

            sweep_dead_arenas()

    def non_terminated_nodes(self) -> List[str]:
        return [h for h, p in self._procs.items() if p.poll() is None]
