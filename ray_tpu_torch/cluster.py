"""Multi-process cluster harness on one machine.

Reference capability: python/ray/cluster_utils.py:135 (Cluster, add_node:201)
— the single most load-bearing test utility in the reference (SURVEY §4):
real GCS + node-agent processes on one box simulate multi-node clusters for
integration and failure testing (kill nodes/workers, watch recovery).
Own copy of ray_tpu.cluster: it spawns the port's GCS
(``ray_tpu_torch.core.gcs.server``) and node agents
(``ray_tpu_torch.core.node.agent``), and a node's accelerator count is
``num_gpus`` (alias ``num_tpus``; ``None``: the agent counts the cards it
sees).
"""

from __future__ import annotations

import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time
import uuid
from typing import Any, Dict, List, Optional

from ray_tpu_torch.core.shm_store import SHM_PREFIX
from ray_tpu_torch.utils.logging import get_logger

logger = get_logger("cluster")


class NodeHandle:
    def __init__(self, proc: subprocess.Popen, address: str, node_id: Optional[str] = None):
        self.proc = proc
        self.address = address
        self.node_id = node_id

    def kill(self) -> None:
        """Hard-kill the node agent AND its worker children (same process
        group via start_new_session; a bare agent SIGKILL would orphan the
        workers until their agent-watchdog notices)."""
        try:
            os.killpg(os.getpgid(self.proc.pid), signal.SIGKILL)
        except Exception:
            try:
                self.proc.send_signal(signal.SIGKILL)
            except Exception:
                pass


class Cluster:
    """Spins up a GCS + N node agents as real subprocesses."""

    def __init__(self, initialize_head: bool = True, head_node_args: Optional[Dict] = None,
                 gcs_persist: bool = False):
        # reclaim shm arenas orphaned by a SIGKILLed previous cluster (their
        # agents never ran cleanup()); scoped to dead owners only, so live
        # concurrent clusters on this box are untouched
        try:
            from ray_tpu_torch.core.shm_store import sweep_dead_arenas

            sweep_dead_arenas()
        except Exception:  # noqa: BLE001 - janitor must not block startup
            pass
        self.session_dir = tempfile.mkdtemp(prefix="ray_tpu_torch_cluster_")
        self._gcs_proc: Optional[subprocess.Popen] = None
        self.gcs_address: Optional[str] = None
        self._gcs_persist_dir = (os.path.join(self.session_dir, "gcs_state")
                                 if gcs_persist else None)
        self.nodes: List[NodeHandle] = []
        self._start_gcs()
        if initialize_head:
            self.add_node(is_head=True, **(head_node_args or {}))

    # ------------------------------------------------------------- processes
    def _env(self) -> Dict[str, str]:
        env = dict(os.environ)
        env["RAY_TPU_SESSION_DIR"] = self.session_dir
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in [os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        env.get("PYTHONPATH", "")] if p
        )
        return env

    def _wait_ready_file(self, path: str, proc: subprocess.Popen, what: str,
                         timeout: float = 30.0) -> str:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if os.path.exists(path):
                content = open(path).read().strip()
                if content:
                    return content
            if proc.poll() is not None:
                raise RuntimeError(
                    f"{what} exited with {proc.returncode}; "
                    f"logs in {self.session_dir}"
                )
            time.sleep(0.02)
        raise TimeoutError(f"{what} did not become ready in {timeout}s")

    def _start_gcs(self, port: int = 0) -> None:
        ready = os.path.join(self.session_dir, f"gcs-{uuid.uuid4().hex[:6]}.ready")
        log = open(os.path.join(self.session_dir, "gcs.log"), "ab")
        cmd = [sys.executable, "-m", "ray_tpu_torch.core.gcs.server",
               "--ready-file", ready, "--port", str(port)]
        if self._gcs_persist_dir:
            cmd += ["--persist-dir", self._gcs_persist_dir]
        self._gcs_proc = subprocess.Popen(
            cmd, env=self._env(), stdout=log, stderr=subprocess.STDOUT,
            start_new_session=True,
        )
        self.gcs_address = self._wait_ready_file(ready, self._gcs_proc, "GCS")
        logger.info("GCS at %s (session %s)", self.gcs_address, self.session_dir)

    def kill_gcs(self) -> None:
        """SIGKILL the GCS process (fault-tolerance testing)."""
        if self._gcs_proc is not None:
            try:
                os.killpg(os.getpgid(self._gcs_proc.pid), signal.SIGKILL)
            except Exception:
                self._gcs_proc.kill()
            self._gcs_proc.wait()

    def restart_gcs(self) -> None:
        """Restart the GCS on the SAME address (requires gcs_persist=True to
        resume state). Agents reconnect via their heartbeat loops."""
        port = int(self.gcs_address.rsplit(":", 1)[1])
        self.kill_gcs()
        time.sleep(0.2)
        self._start_gcs(port=port)

    def add_node(
        self,
        num_cpus: int = 4,
        num_gpus: int = 0,
        resources: Optional[Dict[str, float]] = None,
        labels: Optional[Dict[str, str]] = None,
        is_head: bool = False,
        object_store_memory: int = 0,
        num_tpus: int = 0,
    ) -> NodeHandle:
        """Start one node agent. ``num_gpus`` (alias ``num_tpus``, the JAX
        package's name) of 0 lets the agent count the cards it sees, as the
        JAX package's agent counts its chips."""
        ready = os.path.join(self.session_dir, f"agent-{uuid.uuid4().hex[:6]}.ready")
        log = open(os.path.join(self.session_dir, f"agent-{len(self.nodes)}.log"), "ab")
        cmd = [
            sys.executable, "-m", "ray_tpu_torch.core.node.agent",
            "--gcs", self.gcs_address,
            "--num-cpus", str(num_cpus),
            "--session-dir", self.session_dir,
            "--ready-file", ready,
        ]
        if num_gpus or num_tpus:
            cmd += ["--num-gpus", str(num_gpus or num_tpus)]
        if object_store_memory:
            cmd += ["--object-store-memory", str(object_store_memory)]
        for k, v in (resources or {}).items():
            cmd += ["--resource", f"{k}={v}"]
        if is_head:
            cmd.append("--head")
        for k, v in (labels or {}).items():
            cmd += ["--label", f"{k}={v}"]
        proc = subprocess.Popen(cmd, env=self._env(), stdout=log, stderr=subprocess.STDOUT,
                                start_new_session=True)
        address = self._wait_ready_file(ready, proc, "node agent")
        handle = NodeHandle(proc, address)
        self.nodes.append(handle)
        return handle

    def remove_node(self, node: NodeHandle) -> None:
        node.kill()
        if node in self.nodes:
            self.nodes.remove(node)

    def wait_for_nodes(self, count: Optional[int] = None, timeout: float = 30.0) -> None:
        from ray_tpu_torch.core.rpc import SyncRpcClient

        expected = count if count is not None else len(self.nodes)
        client = SyncRpcClient(self.gcs_address)
        try:
            deadline = time.monotonic() + timeout
            while time.monotonic() < deadline:
                alive = [n for n in client.call("get_nodes") if n["Alive"]]
                if len(alive) >= expected:
                    return
                time.sleep(0.05)
            raise TimeoutError(f"only {len(alive)} of {expected} nodes alive")
        finally:
            client.close()

    def shutdown(self) -> None:
        # collect THIS cluster's node ids BEFORE killing the GCS: the shm
        # sweep below must only touch files keyed by our own nodes — a
        # blanket rtpt-* sweep deletes the arenas of OTHER live clusters on
        # the box (observed: concurrent test runs corrupting each other)
        prefixes = set()
        try:
            from ray_tpu_torch.core.rpc import SyncRpcClient

            gcs = SyncRpcClient(self.gcs_address)
            try:
                prefixes = {n["NodeID"][:8]
                            for n in gcs.call("get_nodes", timeout=2.0)}
            finally:
                gcs.close()
        except Exception:  # noqa: BLE001 - GCS already dead: leak, don't nuke
            pass
        for node in self.nodes:
            node.kill()
        if self._gcs_proc is not None:
            try:
                os.killpg(os.getpgid(self._gcs_proc.pid), signal.SIGKILL)
            except Exception:
                try:
                    self._gcs_proc.kill()
                except Exception:
                    pass
        time.sleep(0.1)
        shutil.rmtree(self.session_dir, ignore_errors=True)
        # best-effort shm cleanup, scoped to our node-id prefixes
        try:
            for name in os.listdir("/dev/shm"):
                if name.startswith(SHM_PREFIX) and any(p in name for p in prefixes):
                    try:
                        os.unlink(os.path.join("/dev/shm", name))
                    except OSError:
                        pass
        except OSError:
            pass

    def __enter__(self) -> "Cluster":
        return self

    def __exit__(self, *exc_info) -> None:
        self.shutdown()
