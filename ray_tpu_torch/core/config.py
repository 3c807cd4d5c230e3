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

Only the entries the in-process runtime reads are defined; the cluster
runtime's (object plane, leases, GCS recovery, Data) come with that slice.
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
]


config = Config()
