"""StandardAutoscaler: demand-driven elastic node pool (own copy of the JAX
package's, with GPU cards: ``num_gpus`` in a node config, ``"GPU"`` demand).

Reference capability: python/ray/autoscaler/_private/autoscaler.py
(StandardAutoscaler: update loop reading LoadMetrics, launching via a
NodeProvider, terminating idle nodes) + the v2 instance-manager split.
Redesign: the demand signal is the GCS's own unmet-placement ledger
(rpc_autoscaler_state) — no separate metrics pipeline to run — and the loop
is a plain thread the operator owns (CLI/head process), provider-agnostic.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, List, Optional

from ray_tpu_torch.core.rpc import SyncRpcClient
from ray_tpu_torch.autoscaler.node_provider import NodeProvider, node_gpus
from ray_tpu_torch.utils.logging import get_logger

logger = get_logger("autoscaler")


@dataclasses.dataclass
class AutoscalerConfig:
    min_workers: int = 0
    max_workers: int = 4
    # what one launched worker provides (node_config for the provider)
    worker_node_config: Dict[str, Any] = dataclasses.field(
        default_factory=lambda: {"num_cpus": 1})
    idle_timeout_s: float = 60.0
    update_interval_s: float = 1.0
    # launch at most this many nodes per update tick (upscaling_speed-lite)
    max_launches_per_tick: int = 2


class StandardAutoscaler:
    def __init__(self, gcs_address: str, provider: NodeProvider,
                 config: Optional[AutoscalerConfig] = None):
        self.gcs = SyncRpcClient(gcs_address)
        self.provider = provider
        self.config = config or AutoscalerConfig()
        self._idle_since: Dict[str, float] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.launched = 0
        self.terminated = 0

    # ------------------------------------------------------------- lifecycle
    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="autoscaler")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
        self.gcs.close()

    def _loop(self) -> None:
        while not self._stop.wait(self.config.update_interval_s):
            try:
                self.update()
            except Exception:  # noqa: BLE001 - the loop must survive hiccups
                logger.exception("autoscaler update failed")

    # ----------------------------------------------------------------- logic
    def update(self) -> None:
        state = self.gcs.call("autoscaler_state", window_s=10.0)
        self._maybe_scale_up(state)
        self._maybe_scale_down(state)

    def _maybe_scale_up(self, state: Dict[str, Any]) -> None:
        shapes: List[Dict[str, float]] = state["unmet_shapes"]
        workers = self.provider.non_terminated_nodes()
        if not shapes and len(workers) >= self.config.min_workers:
            return
        capacity = dict(self.config.worker_node_config.get("resources") or {})
        capacity["CPU"] = float(self.config.worker_node_config.get("num_cpus", 1))
        if node_gpus(self.config.worker_node_config):
            capacity["GPU"] = float(node_gpus(self.config.worker_node_config))

        def fits(shape: Dict[str, float]) -> bool:
            return all(capacity.get(k, 0.0) >= v for k, v in shape.items())

        # bin-pack-lite: how many workers would absorb the unmet shapes
        needed = 0
        room: Dict[str, float] = {}
        for shape in shapes:
            if not shape or not fits(shape):
                continue  # a worker of this type can never satisfy it
            if not all(room.get(k, 0.0) >= v for k, v in shape.items()):
                needed += 1
                room = dict(capacity)
            for k, v in shape.items():
                room[k] = room.get(k, 0.0) - v
        needed = max(needed, self.config.min_workers - len(workers))
        budget = self.config.max_workers - len(workers)
        to_launch = min(needed, budget, self.config.max_launches_per_tick)
        for _ in range(max(0, to_launch)):
            handle = self.provider.create_node(self.config.worker_node_config)
            self.launched += 1
            logger.info("scaled up: launched %s (%d workers)", handle,
                        len(self.provider.non_terminated_nodes()))

    def _maybe_scale_down(self, state: Dict[str, Any]) -> None:
        if state["unmet_shapes"]:
            self._idle_since.clear()
            return
        now = time.monotonic()
        # idle = full availability (nothing leased), NOTHING dispatching
        # (queued work holds no resources yet but must block scale-down), on
        # a non-head alive node
        idle_nodes = {
            n for n, info in state["nodes"].items()
            if info["alive"] and not info["is_head"]
            and not info.get("load", {}).get("dispatching")
            and all(
                abs(info["available"].get(k, 0.0) - v) < 1e-9
                for k, v in info["total"].items()
            )
        }
        for n in list(self._idle_since):
            if n not in idle_nodes:
                del self._idle_since[n]
        workers = self.provider.non_terminated_nodes()
        for n in idle_nodes:
            self._idle_since.setdefault(n, now)
        if len(workers) <= self.config.min_workers:
            return
        # terminate the LONGEST-idle provider node past the timeout. Mapping
        # GCS node ids to provider handles is provider-specific; the local
        # provider launches one agent per handle, so we retire handles while
        # any node has been idle past the deadline (conservative: one/tick).
        expired = [n for n, t in self._idle_since.items()
                   if now - t > self.config.idle_timeout_s]
        if not expired or not workers:
            return
        # terminate the handle whose agent address matches THE idle node —
        # never an arbitrary worker (which could be mid-task)
        addr_to_handle = {
            self.provider.node_address_of(h): h for h in workers
        }
        for node_id in expired:
            addr = state["nodes"].get(node_id, {}).get("address")
            handle = addr_to_handle.get(addr)
            if handle is None:
                self._idle_since.pop(node_id, None)  # not ours to manage
                continue
            # drain at the GCS FIRST (placements stop instantly) so in-flight
            # scheduling doesn't target a node that's about to vanish; the
            # health checker would otherwise lag by seconds
            try:
                self.gcs.call("drain_node", node_id=node_id)
            except Exception:  # noqa: BLE001
                pass
            self.provider.terminate_node(handle)
            self.terminated += 1
            self._idle_since.pop(node_id, None)
            logger.info("scaled down: terminated %s / node %s (idle > %.0fs)",
                        handle, node_id[:8], self.config.idle_timeout_s)
            break  # at most one per tick (conservative)


@dataclasses.dataclass
class SliceAutoscalerConfig:
    """Slice-gang autoscaling: capacity is added/removed in whole SLICES
    (reference: v2 instance manager node groups; TPU queued resources). A
    GPU group is ``hosts`` machines of ``num_gpus`` cards each that join
    under one slice label (``ray_tpu.io/slice``, the JAX package's key)."""

    max_groups: int = 2
    # one group = `hosts` machines that join as one slice
    group_config: Dict[str, Any] = dataclasses.field(
        default_factory=lambda: {
            "hosts": 2, "num_cpus": 1, "num_gpus": 8, "slice_label": "h100-16",
        })
    idle_timeout_s: float = 30.0
    update_interval_s: float = 0.5


class SliceAutoscaler:
    """Demand-driven SLICE scaling over an InstanceManager: unmet GPU demand
    requests whole slice groups (hosts provision atomically via the cloud
    provider); a fully-idle group past the timeout drains every host first,
    then terminates as a unit."""

    def __init__(self, gcs_address: str, manager, config: Optional[SliceAutoscalerConfig] = None):
        from ray_tpu_torch.autoscaler.instance_manager import RUNNING

        self._RUNNING = RUNNING
        self.gcs = SyncRpcClient(gcs_address)
        self.manager = manager
        self.config = config or SliceAutoscalerConfig()
        self._group_idle_since: Dict[str, float] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.groups_launched = 0
        self.groups_terminated = 0

    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="slice-autoscaler")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
        self.gcs.close()

    def _loop(self) -> None:
        while not self._stop.wait(self.config.update_interval_s):
            try:
                self.update()
            except Exception:  # noqa: BLE001
                logger.exception("slice autoscaler update failed")

    def update(self) -> None:
        self.manager.poll()
        state = self.gcs.call("autoscaler_state", window_s=10.0)
        self._maybe_scale_up(state)
        self._maybe_scale_down(state)

    def _chips_per_group(self) -> float:
        cfg = self.config.group_config
        return float(cfg.get("hosts", 1)) * float(node_gpus(cfg))

    def _maybe_scale_up(self, state: Dict[str, Any]) -> None:
        unmet_chips = sum(s.get("GPU", 0.0) for s in state["unmet_shapes"])
        if unmet_chips <= 0:
            return
        per_group = self._chips_per_group()
        if per_group <= 0:
            return
        needed = -(-int(unmet_chips) // int(per_group))  # ceil
        active = len(self.manager.active_groups())
        to_launch = min(needed, self.config.max_groups - active)
        for _ in range(max(0, to_launch)):
            self.manager.request_group(self.config.group_config)
            self.groups_launched += 1
            logger.info("slice scale-up: requested group (%d active)",
                        len(self.manager.active_groups()))

    def _maybe_scale_down(self, state: Dict[str, Any]) -> None:
        if state["unmet_shapes"]:
            self._group_idle_since.clear()
            return
        nodes = state["nodes"]
        by_address = {info["address"]: (nid, info) for nid, info in nodes.items()}
        now = time.monotonic()
        node_ids_by_address = {a: nid for a, (nid, _) in by_address.items()}
        idle_groups = []
        for group_id, members in self.manager.active_groups().items():
            running = [i for i in members if i.state == self._RUNNING]
            if len(running) < len(members) or not members:
                continue  # still provisioning: not a scale-down candidate
            def _idle(inst) -> bool:
                rec = by_address.get(inst.address)
                if rec is None:
                    return False
                _, info = rec
                return (info["alive"] and not info.get("load", {}).get("dispatching")
                        and all(abs(info["available"].get(k, 0.0) - v) < 1e-9
                                for k, v in info["total"].items()))
            if all(_idle(i) for i in running):
                idle_groups.append(group_id)
        for g in list(self._group_idle_since):
            if g not in idle_groups:
                del self._group_idle_since[g]
        for g in idle_groups:
            self._group_idle_since.setdefault(g, now)
        expired = [g for g, t in self._group_idle_since.items()
                   if now - t > self.config.idle_timeout_s]
        if expired:
            g = expired[0]  # one group per tick (conservative)
            self.manager.drain_and_terminate_group(g, node_ids_by_address)
            self.groups_terminated += 1
            self._group_idle_since.pop(g, None)
            logger.info("slice scale-down: terminated group %s", g)
