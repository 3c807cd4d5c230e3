"""Compiled DAGs: channel-wired persistent actor loops (the aDAG analogue;
own copy of ray_tpu.dag.compiled).

Reference capability: python/ray/dag/compiled_dag_node.py:664 (CompiledDAG —
`experimental_compile()` pre-provisions per-actor execution loops connected
by mutable-object channels so steady-state execution does ZERO control-plane
RPCs per call; `execute:2118`). Redesign: stages are ClassMethodNodes bound
to long-lived actors; each stage runs `__rtpu_channel_loop__` (a worker-side
hook) that blocks on its input channels, runs the bound method, and writes
the result channel — the data plane is ray_tpu_torch.experimental.channel (native
seqlock shm), the control plane is used only at compile and teardown.

Card note: within one program, pipeline stages compose with
`parallel.pipeline` (point-to-point sends over the mesh). Compiled DAGs are
the HOST-LEVEL pipeline: chaining programs that live in different
processes (e.g. a CPU data maker feeding a `num_gpus=1` learner), the role
torch-tensor NCCL channels play in the reference. A tensor rides a channel
as one host buffer and lands on `cuda` in a reader that sees a card; the
stage loop runs on a thread of the actor's process, which shares that
process's CUDA context and built kernels.

Supported graph shape (v1, mirrors the reference's constraints): InputNode
(+ attribute projections) feeding ClassMethodNodes on distinct actors,
arbitrary depth/fan-out, optional MultiOutputNode root. Each actor may own
at most one stage (an actor's loop is dedicated, like the reference's
per-actor compiled loop).
"""

from __future__ import annotations

import threading
import uuid
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.dag import (
    ClassMethodNode, ClassNode, DAGNode, InputAttributeNode, InputNode,
    MultiOutputNode,
)
from ray_tpu_torch.experimental.channel import Channel, ChannelClosed, ChannelError
from ray_tpu_torch.utils.logging import get_logger

logger = get_logger("dag.compiled")


class _StageError:
    """Error marker flowing through channels (poisons downstream stages)."""

    def __init__(self, stage: str, err: BaseException):
        self.stage = stage
        self.error = err

    def raise_(self):
        raise RuntimeError(
            f"compiled DAG stage '{self.stage}' failed: {self.error!r}"
        ) from self.error


def channel_loop(instance, plan: Dict[str, Any]) -> str:
    """Worker-side stage loop (dispatched by the __rtpu_channel_loop__ hook
    in worker_main). Reads every input channel, applies the bound method,
    writes the output channel; exits when an upstream channel closes."""
    method = getattr(instance, plan["method"])
    out = Channel.open(plan["out"], reader_slot=None) if plan.get("out") else None
    # out channel: this stage is the WRITER; reader_slot None (we never read)
    ins: List[Tuple[str, Any, Optional[Any], Optional[int]]] = []
    # each arg spec: ("const", value) | ("chan", Channel, key)
    opened: Dict[str, Channel] = {}

    def open_chan(handle, slot):
        c = opened.get(handle.path)
        if c is None:
            c = Channel.open(handle, reader_slot=slot)
            opened[handle.path] = c
        return c

    arg_specs = []
    for spec in plan["args"]:
        if spec[0] == "const":
            arg_specs.append(("const", spec[1], None))
        else:  # ("chan", handle, slot, key)
            arg_specs.append(("chan", open_chan(spec[1], spec[2]), spec[3]))
    if not opened:
        # no channel inputs: nothing can tick this stage (validated at
        # compile time; defensive here)
        if out is not None:
            out.close()
        return "done"
    try:
        while True:
            # read one version from every distinct input channel
            try:
                values = {path: c.read(timeout_s=plan.get("timeout_s", 3600.0))
                          for path, c in opened.items()}
            except ChannelClosed:
                break
            poison = next((v for v in values.values()
                           if isinstance(v, _StageError)), None)
            if poison is not None:
                if out is not None:
                    out.write(poison)
                continue
            args = []
            for kind, v, key in arg_specs:
                if kind == "const":
                    args.append(v)
                else:
                    val = values[v.handle.path]
                    args.append(val[key] if key is not None else val)
            try:
                result = method(*args)
            except BaseException as e:  # noqa: BLE001 - poison downstream
                result = _StageError(plan["label"], e)
            if out is not None:
                out.write(result)
    finally:
        if out is not None:
            out.close()
    return "done"


class CompiledDAGRef:
    """Future for one execute() call (version-indexed channel read)."""

    def __init__(self, dag: "CompiledDAG", version: int):
        self._dag = dag
        self._version = version

    def get(self, timeout: Optional[float] = None):
        return self._dag._get_output(self._version, timeout)


class CompiledDAG:
    def __init__(self, root: DAGNode, max_buffer_bytes: int = 8 << 20,
                 timeout_s: float = 3600.0):
        self._root = root
        self._cap = max_buffer_bytes
        self._timeout_s = timeout_s
        self._lock = threading.Lock()
        self._submitted = 0
        self._results: Dict[int, Any] = {}  # version -> output (buffered)
        self._next_to_read = 1
        self._torn_down = False
        self._all_channels: List[Channel] = []
        try:
            self._build()
        except BaseException:
            # a graph refused after some channels were made: unlink them (the
            # JAX package's copy leaves its 8 MB /dev/shm files behind), which
            # also ends any stage loop already started on them
            self._torn_down = True
            for ch in self._all_channels:
                ch.destroy()
            raise

    # ------------------------------------------------------------- planning
    def _build(self) -> None:
        import ray_tpu_torch

        nodes = self._root.walk()
        outputs = (self._root._outputs if isinstance(self._root, MultiOutputNode)
                   else [self._root])
        stages = [n for n in nodes if isinstance(n, ClassMethodNode)]
        if not stages:
            raise ChannelError("experimental_compile needs >=1 actor method node")
        for n in nodes:
            if not isinstance(n, (ClassMethodNode, ClassNode, InputNode,
                                  InputAttributeNode, MultiOutputNode)):
                raise ChannelError(
                    f"unsupported node in compiled DAG: {type(n).__name__} "
                    "(function nodes run per-call; bind them to an actor)")
        for o in outputs:
            if not isinstance(o, ClassMethodNode):
                raise ChannelError("compiled DAG outputs must be actor methods")

        # one actor per ClassNode (created once, with constant args)
        self._actors: Dict[int, Any] = {}
        owners: Dict[int, ClassMethodNode] = {}
        for s in stages:
            cn = s._class_node
            if id(cn) in owners:
                raise ChannelError(
                    "one actor cannot own two stages of a compiled DAG "
                    "(its loop is dedicated)")
            owners[id(cn)] = s
            if id(cn) not in self._actors:
                if any(isinstance(a, DAGNode) for a in cn._args) or any(
                        isinstance(v, DAGNode) for v in cn._kwargs.values()):
                    raise ChannelError(
                        "actor constructor args must be constants in a "
                        "compiled DAG")
                self._actors[id(cn)] = cn._cls.remote(*cn._args, **cn._kwargs)

        # channels: stage -> consumers; input -> consumers
        def producers_of(n: ClassMethodNode) -> List[Tuple[Any, Optional[Any]]]:
            """For each positional arg: ("const", v) or (producer, key)."""
            specs = []
            for a in n._args:
                if isinstance(a, ClassMethodNode):
                    specs.append((a, None))
                elif isinstance(a, InputAttributeNode):
                    specs.append((a._parent, a._key))
                elif isinstance(a, InputNode):
                    specs.append((a, None))
                elif isinstance(a, DAGNode):
                    raise ChannelError(
                        f"unsupported arg node {type(a).__name__}")
                else:
                    specs.append(("const", a))
            if n._kwargs:
                raise ChannelError("kwargs not supported in compiled DAGs (v1)")
            return specs

        consumers: Dict[int, List[ClassMethodNode]] = {}
        plans: Dict[int, Dict[str, Any]] = {}
        for s in stages:
            for spec in producers_of(s):
                if spec[0] != "const" and not isinstance(spec[0], tuple):
                    prod = spec[0]
                    consumers.setdefault(id(prod), [])
                    if s not in consumers[id(prod)]:
                        consumers[id(prod)].append(s)

        # driver reads every output stage
        out_readers: Dict[int, int] = {}
        for o in outputs:
            consumers.setdefault(id(o), [])

        self._chans: Dict[int, Channel] = {}   # producer node id -> channel
        self._all_channels = []
        for pid, cons in consumers.items():
            n_readers = len(cons) + (1 if any(id(o) == pid for o in outputs) else 0)
            ch = Channel.create(capacity=self._cap, num_readers=max(1, n_readers),
                                name=f"rtpt-cdag-{uuid.uuid4().hex[:12]}")
            self._chans[pid] = ch
            self._all_channels.append(ch)
            if any(id(o) == pid for o in outputs):
                out_readers[pid] = len(cons)  # driver takes the LAST slot

        # reader slot assignment per (producer, consumer)
        slot_of: Dict[Tuple[int, int], int] = {}
        for pid, cons in consumers.items():
            for i, c in enumerate(cons):
                slot_of[(pid, id(c))] = i

        # input channel: the InputNode's "producer" is the driver
        self._input_nodes = [n for n in nodes if isinstance(n, InputNode)]
        if not self._input_nodes:
            raise ChannelError(
                "a compiled DAG requires an InputNode (stages are driven by "
                "versions arriving on channels; without one nothing ticks)")
        inp = self._input_nodes[0]
        self._input_chan = self._chans.get(id(inp))
        if self._input_chan is None:
            raise ChannelError("InputNode present but unused")

        # stage plans + loop dispatch
        self._loop_refs = []
        for s in stages:
            args_spec = []
            for spec in producers_of(s):
                if spec[0] == "const":
                    args_spec.append(("const", spec[1]))
                else:
                    prod, key = spec
                    ch = self._chans[id(prod)]
                    args_spec.append(
                        ("chan", ch.handle, slot_of[(id(prod), id(s))], key))
            if not any(a[0] == "chan" for a in args_spec):
                raise ChannelError(
                    f"stage '{s._method}' has no channel inputs; every stage "
                    "must consume the InputNode or an upstream stage")
            plan = {
                "method": s._method,
                "label": f"{type(s).__name__}:{s._method}",
                "args": args_spec,
                "out": self._chans[id(s)].handle if id(s) in self._chans else None,
                "timeout_s": self._timeout_s,
            }
            from ray_tpu_torch.core.actor import ActorMethod

            actor = self._actors[id(s._class_node)]
            # dunder names are blocked on ActorHandle.__getattr__; the
            # worker-side dispatch hook recognizes this one specially
            ref = ActorMethod(actor, "__rtpu_channel_loop__").remote(plan)
            self._loop_refs.append(ref)

        # driver-side output readers (the last slot of each output channel)
        self._out_readers: List[Channel] = []
        for o in outputs:
            ch = self._chans[id(o)]
            self._out_readers.append(
                Channel.open(ch.handle, reader_slot=out_readers[id(o)]))
        self._multi = isinstance(self._root, MultiOutputNode)

    # ------------------------------------------------------------ execution
    def execute(self, *args, **kwargs) -> CompiledDAGRef:
        if self._torn_down:
            raise ChannelError("compiled DAG torn down")
        with self._lock:
            # in-flight cap: channels buffer depth 1 each, so submitting more
            # than the pipeline can hold without a get() would deadlock the
            # driver inside write_acquire (reference: CompiledDAG bounds
            # max in-flight executions the same way)
            in_flight = self._submitted - (self._next_to_read - 1)
            if in_flight >= len(self._all_channels) + 1:
                raise ChannelError(
                    f"{in_flight} executions in flight fill the pipeline "
                    f"(depth {len(self._all_channels) + 1}); call .get() on "
                    "earlier refs before submitting more")
            if self._input_chan is not None:
                if len(args) == 1 and not kwargs:
                    payload = args[0]
                elif kwargs and not args:
                    payload = dict(kwargs)
                else:
                    payload = args
                self._input_chan.write(payload, timeout_s=self._timeout_s)
            self._submitted += 1
            return CompiledDAGRef(self, self._submitted)

    def _get_output(self, version: int, timeout: Optional[float]):
        with self._lock:
            while version not in self._results:
                if version < self._next_to_read:
                    raise ChannelError(f"version {version} already consumed")
                outs = [r.read(timeout_s=timeout if timeout is not None
                               else self._timeout_s)
                        for r in self._out_readers]
                self._results[self._next_to_read] = outs
                self._next_to_read += 1
            outs = self._results.pop(version)
        for o in outs:
            if isinstance(o, _StageError):
                o.raise_()
        return outs if self._multi else outs[0]

    # ------------------------------------------------------------- teardown
    def teardown(self) -> None:
        if self._torn_down:
            return
        self._torn_down = True
        if self._input_chan is not None:
            self._input_chan.close()  # cascades: every stage loop drains+exits
        import ray_tpu_torch

        try:
            ray_tpu_torch.get(self._loop_refs, timeout=30)
        except Exception:  # noqa: BLE001 - best effort drain
            logger.warning("compiled-loop drain failed", exc_info=True)
        for ch in self._all_channels:
            ch.destroy()

    def __del__(self):
        try:
            self.teardown()
        except Exception:  # noqa: BLE001
            pass


def experimental_compile(node: DAGNode, max_buffer_bytes: int = 8 << 20,
                         timeout_s: float = 3600.0) -> CompiledDAG:
    return CompiledDAG(node, max_buffer_bytes=max_buffer_bytes,
                       timeout_s=timeout_s)
