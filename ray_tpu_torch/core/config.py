"""Typed, env-overridable configuration registry (own copy of
ray_tpu.core.config).

Equivalent capability to the reference's RAY_CONFIG system
(reference: src/ray/common/ray_config_def.h — env override via
``RAY_<name>``, per-run override via ``init(_system_config=...)``). Here:

- defaults declared once in ``_DEFINITIONS``
- env override: ``RAY_TPU_<NAME>`` (bools: 0/1/true/false), the JAX
  package's names, so one environment configures both
- programmatic override: ``config.apply_overrides({...})`` (called by
  ``ray_tpu_torch.init(system_config=...)``).

Only the entries the in-process runtime and Data read are defined; the
cluster runtime's (object plane, leases, GCS recovery) come with that
slice.
"""

from __future__ import annotations

import json
import os
import threading
from dataclasses import dataclass
from typing import Any, Dict, Optional

_ENV_PREFIX = "RAY_TPU_"


@dataclass
class _ConfigEntry:
    name: str
    default: Any
    type: type
    doc: str = ""


def _parse(raw: str, typ: type) -> Any:
    if typ is bool:
        return raw.strip().lower() in ("1", "true", "yes", "on")
    if typ is dict or typ is list:
        return json.loads(raw)
    return typ(raw)


class Config:
    """Process-wide config. Thread-safe; values resolve as
    override > environment > default."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._entries: Dict[str, _ConfigEntry] = {}
        self._overrides: Dict[str, Any] = {}
        for name, default, typ, doc in _DEFINITIONS:
            self._entries[name] = _ConfigEntry(name, default, typ, doc)

    def get(self, name: str) -> Any:
        entry = self._entries[name]
        with self._lock:
            if name in self._overrides:
                return self._overrides[name]
        raw = os.environ.get(_ENV_PREFIX + name.upper())
        if raw is not None:
            try:
                return _parse(raw, entry.type)
            except (ValueError, json.JSONDecodeError):
                pass
        return entry.default

    def __getattr__(self, name: str) -> Any:
        if name.startswith("_"):
            raise AttributeError(name)
        try:
            return self.get(name)
        except KeyError:
            raise AttributeError(name) from None

    def apply_overrides(self, overrides: Optional[Dict[str, Any]]) -> None:
        if not overrides:
            return
        unknown = [k for k in overrides if k not in self._entries]
        if unknown:
            raise ValueError(f"Unknown config keys: {unknown}. Known: {sorted(self._entries)}")
        with self._lock:
            self._overrides.update(overrides)

    def snapshot(self) -> Dict[str, Any]:
        """Resolved view of every entry (for distribution to other nodes)."""
        return {name: self.get(name) for name in self._entries}

    def reset(self) -> None:
        with self._lock:
            self._overrides.clear()


# (name, default, type, doc)
_DEFINITIONS = [
    ("object_store_memory_bytes", 2 * 1024**3, int,
     "Shared-memory object store arena size per node."),
    ("generator_backpressure_items", 16, int,
     "Streaming generators: max items produced ahead of the consumer before "
     "the producer blocks (0 = unlimited). Per-task override via "
     "_generator_backpressure option."),
    ("task_max_retries_default", 3, int,
     "Default retries for tasks that die due to worker/node failure."),
    # --- data (the in-process Data executor and iter_torch_batches) ---
    ("device_prefetch_depth", 2, int, "Host->device double-buffering depth for data loading."),
    # --- data ---
    ("data_memory_fraction", 0.25, float,
     "Fraction of the object-store budget the streaming Data executor may "
     "hold in flight across all operators (the ResourceManager's global "
     "memory budget; reference: execution/resource_manager.py)."),
    ("data_default_op_concurrency", 4, int,
     "Default in-flight task cap per physical Data operator "
     "(ConcurrencyCapBackpressurePolicy; override per-op via "
     "map_batches(concurrency=...))."),
    ("data_max_queued_blocks", 4, int,
     "Max un-consumed output blocks per physical Data operator (its output "
     "queue + the downstream input queue) before the downstream-capacity "
     "backpressure policy stops its dispatches."),
    # --- data: streaming distributed shuffle ---
    ("streaming_shuffle_enabled", True, bool,
     "Streaming shuffle subsystem for sort/groupby/repartition/"
     "random_shuffle: map-side partitioner tasks run as each upstream block "
     "lands (no driver barrier), reduce tasks are admitted under a "
     "spill-aware memory budget. Escape hatch: env RTPU_STREAMING_SHUFFLE=0 "
     "restores the AllToAllOp barrier exchange for A/B."),
    ("shuffle_default_partitions", 8, int,
     "Reducer count for a shuffle whose stage doesn't pin one when the "
     "upstream block count is unknown (iterator sources, unions)."),
    ("shuffle_admission_memory_fraction", 0.5, float,
     "Fraction of the Data memory budget the in-flight reduce partition "
     "sets of one shuffle may occupy. Beyond it, reduce admission DEFERS "
     "(map partition blocks stay at rest in the store, spilling under "
     "pressure) instead of pulling the whole exchange into memory — how a "
     "shuffle larger than aggregate arena memory completes."),
    # --- data: columnar zero-copy exchange ---
    ("columnar_exchange_enabled", True, bool,
     "Columnar exchange path for shuffle blocks: pyarrow Tables serialize "
     "as Arrow IPC stream bytes carried out-of-band (pickle-5 buffers), so "
     "readers reconstruct columns as views over the payload — in a worker "
     "resolving pinned task args, views over the shm arena itself — and "
     "the shuffle kernels partition/merge via vectorized column ops "
     "(single argsort scatter, map-side pre-sort + reduce-side k-way "
     "merge) instead of n-scan takes and full re-sorts. Escape hatch: env "
     "RTPU_COLUMNAR_EXCHANGE=0 restores the cloudpickle block path and "
     "the row-object kernels wholesale for A/B."),
]


config = Config()


def streaming_shuffle_enabled() -> bool:
    """Streaming shuffle subsystem on/off. The RTPU_STREAMING_SHUFFLE env
    var is the operator escape hatch (tools/bench_shuffle.py --no-streaming
    sets it) and wins over the config entry so one process tree can be
    flipped wholesale for A/B against the AllToAllOp barrier exchange."""
    raw = os.environ.get("RTPU_STREAMING_SHUFFLE")
    if raw is not None:
        return raw.strip().lower() not in ("0", "false", "no", "off")
    return config.streaming_shuffle_enabled


def columnar_exchange_enabled() -> bool:
    """Columnar zero-copy exchange on/off. The RTPU_COLUMNAR_EXCHANGE env
    var is the operator escape hatch (tools/bench_shuffle.py --columnar=off
    sets it) and wins over the config entry so one process tree can be
    flipped wholesale for A/B against the cloudpickle block path. Shuffle
    specs capture this at DRIVER construction time (the decision bakes into
    the spec closures shipped to workers), so a mid-run env flip in the
    driver never splits one exchange across kernel variants."""
    raw = os.environ.get("RTPU_COLUMNAR_EXCHANGE")
    if raw is not None:
        return raw.strip().lower() not in ("0", "false", "no", "off")
    return config.columnar_exchange_enabled
