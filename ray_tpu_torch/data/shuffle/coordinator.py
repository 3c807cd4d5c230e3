"""Driver-side shuffle coordination: partition table, spill-aware reduce
admission, and per-shuffle stats.

The coordinator is shared by one ``ShuffleMapOp``/``ShuffleReduceOp`` pair.
Map tasks deposit their per-reducer partition refs here as they complete
(in any order — the table is keyed by block index, so downstream
determinism never depends on completion order); the reduce op asks
``admit()`` before dispatching reduce ``j``.

Spill-aware admission: the bytes of every ADMITTED-but-unfinished reduce's
partition set are tracked against ``admission_budget`` (a fraction of the
Data memory budget). A shuffle whose working set exceeds aggregate arena
memory simply defers reduce admission — un-admitted partition blocks stay
at rest in the object store, which spills them under pressure and restores
them when the reduce task's pull arrives — instead of OOMing the arena.
One reduce is always admissible (a budget must throttle, never wedge)."""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

from ray_tpu_torch.core.object_ref import ObjectRef


class ShuffleCoordinator:
    def __init__(self, name: str, n_out: int,
                 admission_budget: Optional[int] = None):
        from ray_tpu_torch.core.config import config

        self.name = name
        self.n_out = n_out
        if admission_budget is None:
            admission_budget = int(config.object_store_memory_bytes
                                   * config.data_memory_fraction
                                   * config.shuffle_admission_memory_fraction)
        self.admission_budget = max(1, admission_budget)
        # block index -> [partition ref per reducer], parallel sizes table
        self._parts: Dict[int, List[ObjectRef]] = {}
        self._sizes: Dict[int, List[Optional[int]]] = {}
        self.expected_maps: Optional[int] = None
        # ---- admission accounting
        self._admitted: set = set()
        self._reduced: set = set()
        self._inflight_bytes = 0
        self._stall_started: Optional[float] = None
        # ---- per-shuffle stats (surfaced through Dataset.stats())
        self.stats: Dict[str, Any] = {
            "maps": 0, "reduces": 0, "partitions": n_out,
            "exchange_bytes": 0, "admission_stall_s": 0.0,
            "admission_deferrals": 0, "spill_bytes": 0, "stripe_pulls": 0,
            # columnar exchange decode accounting: bytes of Arrow columns
            # reconstructed as zero-copy views over exchange payloads vs
            # bytes that took the copy/decode fallback (pyobj et al).
            # Cluster-wide worker counters + this driver process; local
            # mode records 0 (LocalRuntime never serializes blocks).
            "zero_copy_bytes": 0, "copied_bytes": 0,
        }
        self._baseline_metrics: Optional[Dict[str, int]] = None

    # ----------------------------------------------------------- partition table
    def add_map_output(self, block_idx: int, refs: List[ObjectRef],
                       sizes: List[Optional[int]]) -> None:
        self._parts[block_idx] = list(refs)
        self._sizes[block_idx] = list(sizes)
        self.stats["maps"] += 1
        self.stats["exchange_bytes"] += sum(s or 0 for s in sizes)

    @property
    def num_maps(self) -> int:
        return len(self._parts)

    def maps_complete(self) -> bool:
        return (self.expected_maps is not None
                and len(self._parts) >= self.expected_maps)

    def partition_refs(self, j: int) -> List[ObjectRef]:
        """Partition ``j`` of every map output, in BLOCK INDEX order — reduce
        input order must not depend on map completion order (seeded
        random_shuffle and order-preserving repartition rely on it)."""
        return [self._parts[i][j] for i in sorted(self._parts)]

    def partition_bytes(self, j: int) -> int:
        total = 0
        for i, sizes in self._sizes.items():
            s = sizes[j]
            if s is None:
                # unknown (sizes probe failed): assume the map's mean
                known = [x for x in sizes if x is not None]
                s = (sum(known) // len(known)) if known else 1 << 20
            total += s
        return total

    # ------------------------------------------------------------ reduce admission
    def admit(self, j: int) -> bool:
        """May reduce ``j`` dispatch now? Admits when nothing is in flight
        (liveness) or its partition set fits the remaining budget. Tracks
        stall time while a reduce is deferred."""
        if j in self._admitted:
            return True
        need = self.partition_bytes(j)
        if self._inflight_bytes > 0 and \
                self._inflight_bytes + need > self.admission_budget:
            if self._stall_started is None:
                self._stall_started = time.perf_counter()
                self.stats["admission_deferrals"] += 1
            return False
        if self._stall_started is not None:
            self.stats["admission_stall_s"] += \
                time.perf_counter() - self._stall_started
            self._stall_started = None
        self._admitted.add(j)
        self._inflight_bytes += need
        return True

    def mark_reduced(self, j: int) -> None:
        """Reduce ``j`` finished: release its admission bytes and drop the
        partition refs (the refs' only remaining holders) so distributed GC
        reclaims the intermediate blocks while the shuffle is still running."""
        if j in self._reduced:
            return
        self._reduced.add(j)
        self.stats["reduces"] += 1
        if j in self._admitted:
            self._inflight_bytes = max(
                0, self._inflight_bytes - self.partition_bytes(j))
        for i in self._parts:
            self._parts[i][j] = None

    def finished(self) -> bool:
        return self.maps_complete() and len(self._reduced) >= (
            self.n_out if self.num_maps else 0)

    # ------------------------------------------------------------------- metrics
    @staticmethod
    def _cluster_metrics() -> Dict[str, int]:
        """Best-effort cluster-wide spill/stripe counters (zeros when the
        runtime has no agents — local mode — or any RPC fails)."""
        out = {"spill_bytes": 0, "stripe_pulls": 0,
               "zero_copy_bytes": 0, "copied_bytes": 0}
        # the driver process decodes too (direct-data-plane gets of partition
        # blocks land here): fold its own counters into the cluster total
        from ray_tpu_torch.core import serialization

        snap = serialization.arrow_decode_snapshot()
        out["zero_copy_bytes"] += snap["zero_copy_bytes"]
        out["copied_bytes"] += snap["copied_bytes"]
        try:
            from ray_tpu_torch import api as _api

            runtime = _api.global_worker().runtime
            gcs = getattr(runtime, "gcs", None)
            if gcs is None:
                return out
            for info in gcs.call("get_nodes", timeout=5.0):
                if not info.get("Alive"):
                    continue
                try:
                    client = runtime._agent_client(info["NodeManagerAddress"])
                    ninfo = client.call("node_info", timeout=5.0)
                    usage = ninfo["store"]
                    out["spill_bytes"] += int(usage.get("spilled_bytes", 0))
                    decode = ninfo.get("decode") or {}
                    out["zero_copy_bytes"] += int(decode.get("zero_copy_bytes", 0))
                    out["copied_bytes"] += int(decode.get("copied_bytes", 0))
                    tstats = client.call("transfer_stats", timeout=5.0)
                    out["stripe_pulls"] += int(tstats.get("stripe_pulls", 0))
                except Exception:  # noqa: BLE001 - dead node mid-scan
                    continue
        except Exception:  # noqa: BLE001 - stats must never fail a shuffle
            pass
        return out

    def sample_baseline(self) -> None:
        self._baseline_metrics = self._cluster_metrics()

    def finalize_metrics(self) -> None:
        if self._baseline_metrics is None:
            return
        now = self._cluster_metrics()
        base = self._baseline_metrics
        self.stats["spill_bytes"] = max(
            0, now["spill_bytes"] - base["spill_bytes"])
        self.stats["stripe_pulls"] = max(
            0, now["stripe_pulls"] - base["stripe_pulls"])
        self.stats["zero_copy_bytes"] = max(
            0, now["zero_copy_bytes"] - base["zero_copy_bytes"])
        self.stats["copied_bytes"] = max(
            0, now["copied_bytes"] - base["copied_bytes"])
        self._baseline_metrics = None
