"""Distributed tracing: spans with cross-process trace propagation.

Reference capability: python/ray/util/tracing/tracing_helper.py:34-165
(`ray.init(_tracing_startup_hook=...)` injecting OpenTelemetry wrappers
around remote calls). Redesign without an opentelemetry dependency (not in
the image): the framework emits plain span dicts

    {"trace_id", "span_id", "parent_id", "name", "start_s", "end_s",
     "attrs": {...}}

to a pluggable EXPORTER — the OpenTelemetry hook point: pass an exporter
that forwards to your otel SDK (span dicts map 1:1 onto otel spans), or use
the default JSONL file exporter.

Propagation: ``enable_tracing()`` patches task submission to stamp the
current trace context into each task's spec (``__trace_ctx__`` in
runtime_env); workers (always listening — near-zero cost when the spec
carries no context) restore it around execution, so nested submits chain
parent ids across processes.

    tracing.enable_tracing()                      # or exporter=fn
    with tracing.trace_span("pipeline"):
        ray_tpu_torch.get(step.remote(x))               # child span in the worker
    tracing.flush()
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import os
import threading
import time
import uuid
from typing import Any, Callable, Dict, List, Optional

_ctx: "contextvars.ContextVar[Optional[Dict[str, str]]]" = contextvars.ContextVar(
    "ray_tpu_trace_ctx", default=None
)

_lock = threading.Lock()
_buffer: List[Dict[str, Any]] = []
_exporter: Optional[Callable[[List[Dict[str, Any]]], None]] = None
_enabled = False
_patched = False


def jsonl_exporter(path: Optional[str] = None) -> Callable:
    path = path or os.path.join(
        os.environ.get("RAY_TPU_SESSION_DIR", "/tmp"),
        f"trace-{os.getpid()}.jsonl")

    def export(spans: List[Dict[str, Any]]) -> None:
        with open(path, "a") as f:
            for s in spans:
                f.write(json.dumps(s) + "\n")

    export.path = path  # type: ignore[attr-defined]
    return export


def enable_tracing(exporter: Optional[Callable] = None) -> None:
    """Turn on span recording + trace propagation in THIS process (driver
    or worker). ``exporter`` receives batches of span dicts at flush()."""
    global _enabled, _exporter
    _exporter = exporter or jsonl_exporter()
    _enabled = True
    _patch_submission()


def set_exporter(exporter: Callable) -> None:
    """Install an exporter WITHOUT enabling tracing. Workers use this: spans
    are then recorded only for tasks whose spec carries a __trace_ctx__
    (i.e. the DRIVER opted in), so untraced clusters pay nothing."""
    global _exporter
    _exporter = exporter
    _patch_submission()  # nested submits must still forward inherited ctx


def is_enabled() -> bool:
    return _enabled


def current_trace_context() -> Optional[Dict[str, str]]:
    return _ctx.get()


def set_trace_context(ctx: Optional[Dict[str, str]]) -> None:
    _ctx.set(ctx)


def _record(span: Dict[str, Any]) -> None:
    with _lock:
        _buffer.append(span)


def flush() -> int:
    """Export buffered spans; returns the count."""
    with _lock:
        spans, _buffer[:] = list(_buffer), []
    if spans and _exporter is not None:
        _exporter(spans)
    return len(spans)


@contextlib.contextmanager
def trace_span(name: str, attrs: Optional[Dict[str, Any]] = None,
               force_record: bool = False):
    """Record one span; nested spans (and remote calls made inside) chain
    off it. Works whether or not enable_tracing ran (no-op buffer-less when
    disabled, unless force_record — the worker path for driver-initiated
    traces)."""
    parent = _ctx.get()
    span = {
        "trace_id": parent["trace_id"] if parent else uuid.uuid4().hex,
        "span_id": uuid.uuid4().hex[:16],
        "parent_id": parent["span_id"] if parent else None,
        "name": name,
        "start_s": time.time(),
        "attrs": dict(attrs or {}),
    }
    token = _ctx.set({"trace_id": span["trace_id"], "span_id": span["span_id"]})
    try:
        yield span
    finally:
        _ctx.reset(token)
        span["end_s"] = time.time()
        if _enabled or force_record:
            _record(span)


def _patch_submission() -> None:
    """Stamp the current trace context into outgoing task specs (once).
    __trace_ctx__ rides runtime_env's internal ("__"-prefixed) key space,
    which _prepare_runtime_env forwards verbatim to the worker's spec."""
    global _patched
    if _patched:
        return
    _patched = True
    from ray_tpu_torch.core import remote_function as rf

    original = rf.RemoteFunction.remote

    def traced_remote(self, *args, **kwargs):
        ctx = _ctx.get()
        if ctx is not None:
            renv = dict(self._options.get("runtime_env") or {})
            renv["__trace_ctx__"] = ctx
            return original(self.options(runtime_env=renv), *args, **kwargs)
        return original(self, *args, **kwargs)

    rf.RemoteFunction.remote = traced_remote


def restore_from_spec(spec: Dict[str, Any]) -> Optional[Dict[str, str]]:
    """Worker-side: pull the submitter's trace context out of a task spec
    (returns it; caller sets/uses via task_execution_span)."""
    renv = spec.get("runtime_env") or {}
    ctx = renv.get("__trace_ctx__")
    if isinstance(ctx, dict) and "trace_id" in ctx and "span_id" in ctx:
        return {"trace_id": str(ctx["trace_id"]),
                "span_id": str(ctx["span_id"])}
    return None


@contextlib.contextmanager
def task_execution_span(spec: Dict[str, Any]):
    """Wrap a task execution: restores the submitter's context (if any) and
    records an execute span under it. Cheap no-op when the spec carries no
    context and tracing is off — so untraced clusters record nothing and
    pay no per-task flush RPC."""
    ctx = restore_from_spec(spec)
    if ctx is None and not _enabled:
        yield None
        return
    token = _ctx.set(ctx) if ctx is not None else None
    try:
        with trace_span(f"task:{spec.get('name', '?')}",
                        {"task_id": spec.get("task_id", "")},
                        force_record=ctx is not None) as span:
            yield span
    finally:
        if token is not None:
            _ctx.reset(token)
