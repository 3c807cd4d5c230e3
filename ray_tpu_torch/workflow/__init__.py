"""Durable workflows: checkpointed DAG execution with resume (own copy of
ray_tpu.workflow; the default storage is ~/.ray_tpu_torch/workflows, so
neither package resumes the other's workflows).

Reference capability: python/ray/workflow/ (api.py run/resume_async/
list_all/get_output, workflow_executor.py, workflow_storage.py — durable
step results + metadata under a storage prefix, exactly-once step semantics
via idempotent checkpoint commits). Redesign: a workflow is a ray_tpu_torch.dag
graph; each node gets a deterministic step id (graph position + function
name); the executor walks the graph, skipping any step whose checkpoint
exists in storage and persisting each fresh result before it is consumed.
Crash + resume(workflow_id) therefore replays only incomplete steps.

Storage layout (under <storage>/<workflow_id>/):
    meta.pkl            pickled DAG + status
    steps/<step_id>.pkl pickled step result (checkpoint)
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, List, Optional

import cloudpickle

import ray_tpu_torch
from ray_tpu_torch.dag import DAGNode
from ray_tpu_torch.utils.logging import get_logger

logger = get_logger("workflow")

_storage_dir: Optional[str] = None


def init(storage: Optional[str] = None) -> None:
    """Set the durable storage root (default: ~/.ray_tpu_torch/workflows)."""
    global _storage_dir
    _storage_dir = storage or os.path.expanduser("~/.ray_tpu_torch/workflows")
    os.makedirs(_storage_dir, exist_ok=True)


def _root() -> str:
    if _storage_dir is None:
        init()
    return _storage_dir  # type: ignore[return-value]


def _wf_dir(workflow_id: str) -> str:
    return os.path.join(_root(), workflow_id)


def _atomic_write(path: str, data: bytes) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)  # atomic commit: a crash never leaves a torn file


# --------------------------------------------------------------------------- #
# Events (reference: python/ray/workflow/event_listener.py — workflows that
# block on external signals, durably: once the event step's checkpoint is
# committed, resume() never waits again) and dynamic continuations
# (reference: workflow.continuation — a step may RETURN a new sub-DAG which
# runs in its place, checkpointed under the same step).
# --------------------------------------------------------------------------- #
class EventListener:
    """Subclass and implement poll_for_event (blocking; return the event
    payload). Instantiated INSIDE the event step's task."""

    def poll_for_event(self, *args, **kwargs) -> Any:
        raise NotImplementedError


class KVEventListener(EventListener):
    """Built-in listener: waits for a cluster-KV key to appear (external
    systems signal by ray_tpu_torch.kv_put). Returns the key's bytes."""

    def poll_for_event(self, key: str, poll_interval_s: float = 0.2,
                       timeout_s: Optional[float] = None):
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        while True:
            value = ray_tpu_torch.kv_get(key)
            if value is not None:
                return value
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"no event on KV key {key!r} in {timeout_s}s")
            time.sleep(poll_interval_s)


class TimerListener(EventListener):
    """Fires at an absolute unix timestamp (durable sleep)."""

    def poll_for_event(self, fire_at: float):
        while True:
            now = time.time()
            if now >= fire_at:
                return fire_at
            time.sleep(min(1.0, fire_at - now))


def _poll_event_task(payload: bytes):
    listener_cls, args, kwargs = cloudpickle.loads(payload)
    return listener_cls().poll_for_event(*args, **kwargs)


def wait_for_event(listener_cls, *args, **kwargs) -> DAGNode:
    """A DAG node that blocks until the listener fires. As a FunctionNode it
    checkpoints like any step: the event is consumed EXACTLY ONCE across
    crash/resume (reference: event_listener.py + checkpointed event step)."""
    if not (isinstance(listener_cls, type) and issubclass(listener_cls, EventListener)):
        raise TypeError("wait_for_event needs an EventListener subclass")
    fn = ray_tpu_torch.remote(_poll_event_task)
    fn._name = f"event_{listener_cls.__name__}"
    return fn.bind(cloudpickle.dumps((listener_cls, args, kwargs)))


class Continuation:
    __slots__ = ("dag",)

    def __init__(self, dag: DAGNode):
        self.dag = dag


def continuation(dag: DAGNode) -> Continuation:
    """Return this from a workflow step to continue INTO a dynamically-built
    sub-DAG: the sub-DAG runs in the step's place and its result becomes the
    step's checkpointed value. Sub-steps checkpoint individually, so a crash
    mid-continuation replays only the incomplete tail. Requirement (same as
    the reference): the parent step must rebuild the same sub-DAG shape on
    re-execution."""
    if not isinstance(dag, DAGNode):
        raise TypeError("continuation() takes a DAG node")
    return Continuation(dag)


def _step_id(node: DAGNode, order: Dict[int, int]) -> str:
    name = type(node).__name__
    fn = getattr(node, "_fn", None)
    if fn is not None:
        name = getattr(fn, "_name", None) or getattr(
            getattr(fn, "_function", None), "__name__", name
        )
    return f"{order[id(node)]:04d}_{name}"


class WorkflowExecution:
    def __init__(self, workflow_id: str, dag: DAGNode):
        self.workflow_id = workflow_id
        self.dag = dag
        self.dir = _wf_dir(workflow_id)
        self.steps_dir = os.path.join(self.dir, "steps")
        os.makedirs(self.steps_dir, exist_ok=True)
        # deterministic step ids: depth-first order over the (stable) graph
        self._order = {id(n): i for i, n in enumerate(dag.walk())}
        self._inputs: Optional[tuple] = None  # (args, kwargs) of this run

    # ------------------------------------------------------------- metadata
    def _write_meta(self, status: str, error: str = "") -> None:
        _atomic_write(os.path.join(self.dir, "meta.pkl"), cloudpickle.dumps({
            "workflow_id": self.workflow_id,
            "status": status,
            "error": error,
            "dag": self.dag,
            # original run() (args, kwargs): replayed by resume() so
            # InputNode steps see the same inputs on every attempt
            "inputs": self._inputs,
            "updated_at": time.time(),
        }))

    # ------------------------------------------------------------ execution
    def _ckpt_path(self, step_id: str) -> str:
        return os.path.join(self.steps_dir, f"{step_id}.pkl")

    def _load_ckpt(self, step_id: str):
        path = self._ckpt_path(step_id)
        if not os.path.exists(path):
            return None
        with open(path, "rb") as f:
            return cloudpickle.loads(f.read())

    def run(self, *args, **kwargs) -> Any:
        self._inputs = (args, kwargs)
        self._write_meta("RUNNING")
        try:
            result = self._run_node(self.dag, args, kwargs)
            self._write_meta("SUCCESSFUL")
            return result
        except BaseException as e:
            self._write_meta("FAILED", error=repr(e))
            raise

    def _run_node(self, node: DAGNode, args: tuple, kwargs: dict) -> Any:
        """Execute with per-FunctionNode checkpointing: completed steps are
        fed back as literal values, so only incomplete subgraphs re-run."""
        from ray_tpu_torch.dag import (
            ClassMethodNode, ClassNode, FunctionNode, MultiOutputNode,
        )
        from ray_tpu_torch.dag import _ExecutionContext

        ctx = _ExecutionContext(args, kwargs)
        memo_values: Dict[int, Any] = {}

        def resolve(n: DAGNode):
            if id(n) in memo_values:
                return memo_values[id(n)]
            if isinstance(n, FunctionNode):
                sid = _step_id(n, self._order)
                ckpt = self._load_ckpt(sid)
                if ckpt is not None:
                    value = ckpt["value"]
                else:
                    r_args = tuple(resolve(a) if isinstance(a, DAGNode) else a
                                   for a in n._args)
                    r_kwargs = {k: resolve(v) if isinstance(v, DAGNode) else v
                                for k, v in n._kwargs.items()}
                    ref = n._fn.remote(*r_args, **r_kwargs)
                    value = ray_tpu_torch.get(ref)
                    # dynamic continuation: the step returned a sub-DAG to
                    # run in its place; its nodes get fresh deterministic
                    # ids and checkpoint individually, and the FINAL value
                    # lands under THIS step's checkpoint
                    while isinstance(value, Continuation):
                        base = (max(self._order.values()) + 1
                                if self._order else 0)
                        for j, sub in enumerate(value.dag.walk()):
                            if id(sub) not in self._order:
                                self._order[id(sub)] = base + j
                        value = resolve(value.dag)
                    # checkpoint BEFORE the value is consumed downstream:
                    # a crash after this line never re-runs the step
                    _atomic_write(self._ckpt_path(sid),
                                  cloudpickle.dumps({"value": value}))
                memo_values[id(n)] = value
                return value
            if isinstance(n, MultiOutputNode):
                value = [resolve(o) for o in n._outputs]
                memo_values[id(n)] = value
                return value
            if isinstance(n, (ClassNode, ClassMethodNode)):
                # actor steps are not durable (reference: workflows support
                # virtual actors separately); execute live each run. But their
                # DAG-node arguments MUST resolve through this checkpoint-
                # aware path first — seeding ctx.memo so the live _resolve
                # below picks up checkpointed values instead of re-running
                # function parents (duplicate side effects on resume).
                for child in n.walk():
                    if child is n or isinstance(child, (ClassNode, ClassMethodNode)):
                        continue  # actor chain stays live; resolved below
                    if child not in ctx.memo:
                        ctx.memo[child] = resolve(child)
                value = ray_tpu_torch.get(n._resolve(ctx)) if isinstance(
                    n, ClassMethodNode) else n._resolve(ctx)
                memo_values[id(n)] = value
                return value
            value = n._resolve(ctx)
            memo_values[id(n)] = value
            return value

        return resolve(self.dag)


# -------------------------------------------------------------------- api
def run(dag: DAGNode, *args, workflow_id: Optional[str] = None, **kwargs) -> Any:
    """Execute a DAG durably; returns the final value (reference:
    workflow.run). Steps checkpoint as they complete; re-running the same
    workflow_id resumes instead of restarting."""
    workflow_id = workflow_id or f"wf-{int(time.time() * 1000):x}"
    return WorkflowExecution(workflow_id, dag).run(*args, **kwargs)


def resume(workflow_id: str) -> Any:
    """Resume an interrupted workflow from its last checkpoints (reference:
    workflow.resume). The DAG is loaded from durable metadata, so the
    original driver script is not needed."""
    meta_path = os.path.join(_wf_dir(workflow_id), "meta.pkl")
    if not os.path.exists(meta_path):
        raise ValueError(f"no workflow '{workflow_id}' in {_root()}")
    with open(meta_path, "rb") as f:
        meta = cloudpickle.loads(f.read())
    dag = meta["dag"]
    inputs = meta.get("inputs")
    if inputs is None:
        from ray_tpu_torch.dag import InputNode

        if any(isinstance(n, InputNode) for n in dag.walk()):
            raise ValueError(
                f"workflow '{workflow_id}' has an InputNode but no recorded "
                "run() inputs (written by an older version?); cannot resume "
                "without the original arguments"
            )
        inputs = ((), {})
    args, kwargs = inputs
    return WorkflowExecution(workflow_id, dag).run(*args, **kwargs)


def get_status(workflow_id: str) -> Optional[str]:
    meta_path = os.path.join(_wf_dir(workflow_id), "meta.pkl")
    if not os.path.exists(meta_path):
        return None
    with open(meta_path, "rb") as f:
        return cloudpickle.loads(f.read())["status"]


def list_all() -> List[Dict[str, Any]]:
    out = []
    root = _root()
    for wid in sorted(os.listdir(root)):
        meta_path = os.path.join(root, wid, "meta.pkl")
        if not os.path.exists(meta_path):
            continue
        with open(meta_path, "rb") as f:
            meta = cloudpickle.loads(f.read())
        out.append({"workflow_id": wid, "status": meta["status"],
                    "updated_at": meta["updated_at"]})
    return out


def delete(workflow_id: str) -> None:
    import shutil

    shutil.rmtree(_wf_dir(workflow_id), ignore_errors=True)
