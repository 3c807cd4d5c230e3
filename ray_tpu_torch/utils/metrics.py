"""Metrics registry: counters/gauges/histograms with tags, Prometheus text
exposition (reference capability: src/ray/stats/metric.h + metric_defs.cc and
python/ray/util/metrics.py → per-node metrics agent → Prometheus scrape).

Single-process registry (own copy of ray_tpu.utils.metrics); the node
agent aggregates worker snapshots and can serve ``/metrics`` over HTTP when
``metrics_export_port`` is set.
"""

from __future__ import annotations

import bisect
import threading
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Tuple

TagKey = Tuple[Tuple[str, str], ...]


def _tags_key(tags: Optional[Dict[str, str]]) -> TagKey:
    return tuple(sorted((tags or {}).items()))


class Metric:
    def __init__(self, name: str, description: str = "", tag_keys: Iterable[str] = ()):
        self.name = name
        self.description = description
        self.tag_keys = tuple(tag_keys)
        self._lock = threading.Lock()
        registry.register(self)


class Counter(Metric):
    KIND = "counter"

    def __init__(self, name: str, description: str = "", tag_keys: Iterable[str] = ()):
        super().__init__(name, description, tag_keys)
        self._values: Dict[TagKey, float] = defaultdict(float)

    def inc(self, value: float = 1.0, tags: Optional[Dict[str, str]] = None) -> None:
        with self._lock:
            self._values[_tags_key(tags)] += value

    def get(self, tags: Optional[Dict[str, str]] = None) -> float:
        with self._lock:
            return self._values.get(_tags_key(tags), 0.0)

    def samples(self) -> List[Tuple[TagKey, float]]:
        with self._lock:
            return list(self._values.items())


class Gauge(Metric):
    KIND = "gauge"

    def __init__(self, name: str, description: str = "", tag_keys: Iterable[str] = ()):
        super().__init__(name, description, tag_keys)
        self._values: Dict[TagKey, float] = {}

    def set(self, value: float, tags: Optional[Dict[str, str]] = None) -> None:
        with self._lock:
            self._values[_tags_key(tags)] = value

    def get(self, tags: Optional[Dict[str, str]] = None) -> float:
        with self._lock:
            return self._values.get(_tags_key(tags), 0.0)

    def samples(self) -> List[Tuple[TagKey, float]]:
        with self._lock:
            return list(self._values.items())


class Histogram(Metric):
    KIND = "histogram"
    DEFAULT_BOUNDARIES = [0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1, 5, 10, 60, 300]

    def __init__(
        self,
        name: str,
        description: str = "",
        boundaries: Optional[List[float]] = None,
        tag_keys: Iterable[str] = (),
    ):
        super().__init__(name, description, tag_keys)
        self.boundaries = sorted(boundaries or self.DEFAULT_BOUNDARIES)
        self._counts: Dict[TagKey, List[int]] = {}
        self._sums: Dict[TagKey, float] = defaultdict(float)
        self._totals: Dict[TagKey, int] = defaultdict(int)

    def observe(self, value: float, tags: Optional[Dict[str, str]] = None) -> None:
        key = _tags_key(tags)
        idx = bisect.bisect_left(self.boundaries, value)
        with self._lock:
            if key not in self._counts:
                self._counts[key] = [0] * (len(self.boundaries) + 1)
            self._counts[key][idx] += 1
            self._sums[key] += value
            self._totals[key] += 1

    def summary(self, tags: Optional[Dict[str, str]] = None) -> Dict[str, float]:
        key = _tags_key(tags)
        with self._lock:
            total = self._totals.get(key, 0)
            return {
                "count": total,
                "sum": self._sums.get(key, 0.0),
                "mean": (self._sums.get(key, 0.0) / total) if total else 0.0,
            }


class MetricsRegistry:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[str, Metric] = {}

    def register(self, metric: Metric) -> None:
        with self._lock:
            existing = self._metrics.get(metric.name)
            if existing is not None and type(existing) is not type(metric):
                raise ValueError(f"Metric {metric.name} already registered with a different kind")
            self._metrics[metric.name] = metric

    def get(self, name: str) -> Optional[Metric]:
        with self._lock:
            return self._metrics.get(name)

    def clear(self) -> None:
        with self._lock:
            self._metrics.clear()

    def prometheus_text(self, extra_labels: Optional[Dict[str, str]] = None) -> str:
        """Render every metric in Prometheus text exposition format.
        ``extra_labels`` (e.g. {"node": id}) are injected into every sample so
        multi-node aggregation keeps per-node series distinct."""
        base: TagKey = _tags_key(extra_labels)
        lines: List[str] = []
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            lines.append(f"# HELP {m.name} {m.description}")
            if isinstance(m, (Counter, Gauge)):
                lines.append(f"# TYPE {m.name} {m.KIND}")
                for tags, value in m.samples():
                    lines.append(f"{m.name}{_fmt_tags(base + tags)} {value}")
            elif isinstance(m, Histogram):
                lines.append(f"# TYPE {m.name} histogram")
                with m._lock:
                    for tags, counts in m._counts.items():
                        cum = 0
                        for boundary, c in zip(m.boundaries, counts):
                            cum += c
                            lines.append(
                                f'{m.name}_bucket{_fmt_tags(base + tags, ("le", str(boundary)))} {cum}'
                            )
                        cum += counts[-1]
                        lines.append(f'{m.name}_bucket{_fmt_tags(base + tags, ("le", "+Inf"))} {cum}')
                        lines.append(f"{m.name}_sum{_fmt_tags(base + tags)} {m._sums[tags]}")
                        lines.append(f"{m.name}_count{_fmt_tags(base + tags)} {m._totals[tags]}")
        return "\n".join(lines) + "\n"


def _fmt_tags(tags: TagKey, extra: Optional[Tuple[str, str]] = None) -> str:
    items = list(tags)
    if extra:
        items.append(extra)
    if not items:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in items)
    return "{" + inner + "}"


registry = MetricsRegistry()
