"""Classic lazy DAG API: bind() builds a graph, execute() runs it (own copy
of ray_tpu.dag).

Reference capability: python/ray/dag/dag_node.py (DAGNode base + execute),
function_node.py, class_node.py, input_node.py, output_node.py. Redesign:
a small, explicit node tree over the existing task/actor API — bind is pure
graph construction (no submission); execute walks the graph once, submits
each task with its parents' ObjectRefs as arguments (so the data plane
chains refs, never materializing intermediates at the driver), and returns
the root's ObjectRef.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "DAGNode", "FunctionNode", "InputNode", "InputAttributeNode",
    "ClassNode", "ClassMethodNode", "MultiOutputNode",
]


class DAGNode:
    """Base graph node. Subclasses implement _execute_impl(resolver)."""

    def execute(self, *args, **kwargs):
        """Run the DAG rooted at this node; returns ObjectRef(s) of this
        node's result (a list for MultiOutputNode). ``args`` feed any
        InputNode in the graph."""
        ctx = _ExecutionContext(args, kwargs)
        return self._resolve(ctx)

    def _resolve(self, ctx: "_ExecutionContext"):
        if self in ctx.memo:
            return ctx.memo[self]
        out = self._execute_impl(ctx)
        ctx.memo[self] = out
        return out

    def _execute_impl(self, ctx: "_ExecutionContext"):
        raise NotImplementedError

    def experimental_compile(self, max_buffer_bytes: int = 8 << 20,
                             timeout_s: float = 3600.0):
        """Compile this DAG into channel-wired persistent actor loops
        (reference: compiled_dag_node.py:664). Steady-state execution does
        zero control-plane RPCs per call."""
        from ray_tpu_torch.dag.compiled import experimental_compile

        return experimental_compile(self, max_buffer_bytes=max_buffer_bytes,
                                    timeout_s=timeout_s)

    # graph introspection (reference: DAGNode._get_all_child_nodes)
    def _children(self) -> List["DAGNode"]:
        return []

    def walk(self) -> List["DAGNode"]:
        """All nodes reachable from this root (depth-first, deduped)."""
        seen: List[DAGNode] = []

        def visit(n: DAGNode) -> None:
            if any(n is s for s in seen):
                return
            for c in n._children():
                visit(c)
            seen.append(n)

        visit(self)
        return seen


class _ExecutionContext:
    def __init__(self, args: tuple, kwargs: dict):
        self.args = args
        self.kwargs = kwargs
        self.memo: Dict[DAGNode, Any] = {}


def _resolve_args(ctx, args, kwargs) -> Tuple[tuple, dict]:
    def r(v):
        return v._resolve(ctx) if isinstance(v, DAGNode) else v

    return tuple(r(a) for a in args), {k: r(v) for k, v in kwargs.items()}


def _collect_children(args, kwargs) -> List[DAGNode]:
    out = [a for a in args if isinstance(a, DAGNode)]
    out += [v for v in kwargs.values() if isinstance(v, DAGNode)]
    return out


class InputNode(DAGNode):
    """Placeholder for execute()-time arguments (reference: input_node.py).
    Usable as a context manager for parity with the reference syntax:

        with InputNode() as inp:
            dag = f.bind(inp)
        dag.execute(5)
    """

    def __enter__(self) -> "InputNode":
        return self

    def __exit__(self, *exc) -> None:
        return None

    def __getattr__(self, key: str) -> "InputAttributeNode":
        if key.startswith("_"):
            raise AttributeError(key)
        return InputAttributeNode(self, key)

    def __getitem__(self, key) -> "InputAttributeNode":
        return InputAttributeNode(self, key)

    def _execute_impl(self, ctx: _ExecutionContext):
        if len(ctx.args) == 1 and not ctx.kwargs:
            return ctx.args[0]
        if not ctx.args and ctx.kwargs:
            return dict(ctx.kwargs)
        return ctx.args


class InputAttributeNode(DAGNode):
    """inp.key / inp[idx]: one field of the execute() input."""

    def __init__(self, parent: InputNode, key):
        self._parent = parent
        self._key = key

    def _children(self) -> List[DAGNode]:
        return [self._parent]

    def _execute_impl(self, ctx: _ExecutionContext):
        base = self._parent._resolve(ctx)
        if isinstance(self._key, str) and isinstance(base, dict):
            return base[self._key]
        if isinstance(self._key, int):
            return base[self._key]
        return getattr(base, self._key)


class FunctionNode(DAGNode):
    """fn.bind(*args): a task invocation node (reference: function_node.py)."""

    def __init__(self, remote_fn, args: tuple, kwargs: dict):
        self._fn = remote_fn
        self._args = args
        self._kwargs = kwargs

    def _children(self) -> List[DAGNode]:
        return _collect_children(self._args, self._kwargs)

    def _execute_impl(self, ctx: _ExecutionContext):
        args, kwargs = _resolve_args(ctx, self._args, self._kwargs)
        return self._fn.remote(*args, **kwargs)

    def __repr__(self) -> str:
        return f"FunctionNode({getattr(self._fn, '_name', '?')})"


class ClassNode(DAGNode):
    """Actor.bind(*args): an actor-creation node; method calls on it create
    ClassMethodNodes (reference: class_node.py)."""

    def __init__(self, actor_cls, args: tuple, kwargs: dict):
        self._cls = actor_cls
        self._args = args
        self._kwargs = kwargs

    def _children(self) -> List[DAGNode]:
        return _collect_children(self._args, self._kwargs)

    def __getattr__(self, name: str) -> "_ClassMethodBinder":
        if name.startswith("_"):
            raise AttributeError(name)
        return _ClassMethodBinder(self, name)

    def _execute_impl(self, ctx: _ExecutionContext):
        args, kwargs = _resolve_args(ctx, self._args, self._kwargs)
        return self._cls.remote(*args, **kwargs)


class _ClassMethodBinder:
    def __init__(self, class_node: ClassNode, method: str):
        self._node = class_node
        self._method = method

    def bind(self, *args, **kwargs) -> "ClassMethodNode":
        return ClassMethodNode(self._node, self._method, args, kwargs)


class ClassMethodNode(DAGNode):
    def __init__(self, class_node: ClassNode, method: str, args: tuple, kwargs: dict):
        self._class_node = class_node
        self._method = method
        self._args = args
        self._kwargs = kwargs

    def _children(self) -> List[DAGNode]:
        return [self._class_node] + _collect_children(self._args, self._kwargs)

    def _execute_impl(self, ctx: _ExecutionContext):
        actor = self._class_node._resolve(ctx)
        args, kwargs = _resolve_args(ctx, self._args, self._kwargs)
        return getattr(actor, self._method).remote(*args, **kwargs)


class MultiOutputNode(DAGNode):
    """Bundle several leaves as the DAG output (reference: output_node.py)."""

    def __init__(self, outputs: List[DAGNode]):
        self._outputs = list(outputs)

    def _children(self) -> List[DAGNode]:
        return list(self._outputs)

    def _execute_impl(self, ctx: _ExecutionContext):
        return [o._resolve(ctx) for o in self._outputs]
