"""The traced window of a ``--trace 1`` run: ``torch.profiler`` over the
device's activity and the CUDA runtime calls, reduced to what the per-layer readers and the result line
need. Timestamps are the profiler's (nanoseconds on the host's clock, device
activity mapped onto it), so a host interval taken with ``time.time_ns`` can
be laid over the device's."""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Dict, List, Optional, Tuple

TOP = 10
PROFILER_OWN = ("Activity Buffer", "ProfilerStep", "[memory]")  # the profiler's own host events


@dataclasses.dataclass
class Trace:
    t0_ns: int  # the traced window, host clock
    t1_ns: int
    busy_s: float  # seconds in which some operation ran on the device
    kernel_s: Dict[str, float]  # device seconds by operation name
    kernel_n: Dict[str, int]  # launches by operation name
    device_ops: List[Tuple[str, float]]  # the TOP operations by device seconds
    idle_gaps: List[Tuple[str, float]]  # the TOP longest gaps, named by the host's op

    @property
    def window_s(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e9

    def seconds(self, *parts: str) -> float:
        """Device seconds of the operations whose name holds any of ``parts``."""
        return sum(s for n, s in self.kernel_s.items() if any(p in n for p in parts))

    def launches(self, *parts: str) -> int:
        return sum(c for n, c in self.kernel_n.items() if any(p in n for p in parts))


class Tracer:
    """``start()`` ... ``stop()`` around the traced window, ``summary()``
    once the run has closed; ``stop`` synchronises the device first, so the
    window holds all it launched."""

    def __init__(self, device):
        self.device = device
        self._prof = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        # on the card, device activity and the CUDA runtime calls only: recording
        # every host op as well slowed a decode tick by a third
        acts = [ProfilerActivity.CUDA if self.device.type == "cuda" else ProfilerActivity.CPU]
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.t0_ns = time.time_ns()

    def stop(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.t1_ns = time.time_ns()
        self._prof.__exit__(None, None, None)

    def summary(self) -> Trace:
        """The reduction, after the run has closed (it takes host time)."""
        events = self._prof.profiler.kineto_results.events()
        self._prof = None
        return reduce(events, self.t0_ns, self.t1_ns, self.device.type)


def _is_device(ev, device_type: str) -> bool:
    return str(ev.device_type()).split(".")[-1].lower() == device_type


def reduce(events, t0_ns: int, t1_ns: int, device_type: str = "cuda") -> Trace:
    dev, host = [], []
    for ev in events:
        a = max(int(ev.start_ns()), t0_ns)
        b = min(int(ev.start_ns()) + int(ev.duration_ns()), t1_ns)
        if b <= a:
            continue
        if device_type != "cpu" and _is_device(ev, device_type):
            dev.append((a, b, ev.name()))
        elif _is_device(ev, "cpu") and not ev.name().startswith(PROFILER_OWN):
            host.append((a, b, ev.name()))
    kernel_s: Dict[str, float] = collections.defaultdict(float)
    kernel_n: Dict[str, int] = collections.Counter()
    for a, b, name in dev:
        kernel_s[name] += (b - a) / 1e9
        kernel_n[name] += 1
    merged: List[List[int]] = []
    for a, b, _ in sorted(dev):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged) / 1e9
    edges = [t0_ns] + [x for iv in merged for x in iv] + [t1_ns]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    named = [(_host_op(host, a, b), (b - a) / 1e9) for a, b in gaps[:TOP]]
    top = sorted(kernel_s.items(), key=lambda kv: -kv[1])[:TOP]
    return Trace(t0_ns=t0_ns, t1_ns=t1_ns, busy_s=busy, kernel_s=dict(kernel_s),
                 kernel_n=dict(kernel_n), device_ops=[[n, s] for n, s in top],
                 idle_gaps=[[n, s] for n, s in named])


def _host_op(host, a: int, b: int) -> str:
    """What the host was doing in a device gap: the host op covering most of
    it, the shortest on a tie; ``python`` where no op ran."""
    best: Optional[Tuple[int, int, str]] = None
    for ha, hb, name in host:
        cover = min(hb, b) - max(ha, a)
        if cover <= 0:
            continue
        key = (cover, -(hb - ha), name)
        if best is None or key > best:
            best = key
    return f"host: {best[2]}" if best else "host: python"
