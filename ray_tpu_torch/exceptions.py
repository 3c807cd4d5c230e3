"""Exception hierarchy for ray_tpu_torch (own copy of ray_tpu.exceptions:
the same classes under the same names).

Mirrors the capability surface of the reference's exception set
(reference: python/ray/exceptions.py): errors raised inside remote
tasks/actors are captured and re-raised at the ``get()`` site wrapped in
the corresponding error type.
"""

from __future__ import annotations

import traceback
from typing import Optional


class RayTpuError(Exception):
    """Base class for all framework errors."""


class TaskError(RayTpuError):
    """A task raised an exception during execution.

    Re-raised at every ``get()`` of the task's return refs (and propagated
    through dependent tasks, like the reference's RayTaskError cause chain).
    """

    def __init__(
        self,
        function_name: str = "<unknown>",
        traceback_str: str = "",
        cause: Optional[BaseException] = None,
        pid: int = 0,
        node_id: str = "",
    ):
        self.function_name = function_name
        self.traceback_str = traceback_str
        self.cause = cause
        self.pid = pid
        self.node_id = node_id
        super().__init__(self._format())

    def _format(self) -> str:
        msg = f"Task '{self.function_name}' failed (pid={self.pid}, node={self.node_id[:8] if self.node_id else '?'})"
        if self.traceback_str:
            msg += "\n" + self.traceback_str
        return msg

    @classmethod
    def from_exception(cls, exc: BaseException, function_name: str, pid: int = 0, node_id: str = "") -> "TaskError":
        tb = "".join(traceback.format_exception(type(exc), exc, exc.__traceback__))
        return cls(function_name=function_name, traceback_str=tb, cause=exc, pid=pid, node_id=node_id)

    def as_instanceof_cause(self) -> BaseException:
        """Return an exception that is also an instance of the cause's type,
        so ``except UserError`` works at the get() site."""
        if self.cause is None:
            return self
        cause_cls = type(self.cause)
        if cause_cls is TaskError or issubclass(TaskError, cause_cls):
            return self
        try:
            derived = type(
                "TaskError_" + cause_cls.__name__,
                (TaskError, cause_cls),
                {"__init__": lambda s: None},
            )()
            derived.__dict__.update(self.__dict__)
            derived.args = (self._format(),)
            return derived
        except TypeError:
            return self


class ActorError(RayTpuError):
    """Base for actor-related failures."""


class ActorDiedError(ActorError):
    """The actor died before or while executing the submitted method."""

    def __init__(self, actor_id: str = "", reason: str = "actor died"):
        self.actor_id = actor_id
        self.reason = reason
        super().__init__(f"Actor {actor_id[:8]} died: {reason}")


class ActorUnavailableError(ActorError):
    """The actor is temporarily unreachable (e.g. restarting)."""


class ObjectLostError(RayTpuError):
    """An object's value was lost from the object store and could not be
    reconstructed from lineage."""

    def __init__(self, object_id: str = "", message: str = ""):
        self.object_id = object_id
        super().__init__(message or f"Object {object_id[:8]} was lost and could not be reconstructed")


class ObjectFetchTimeoutError(RayTpuError):
    """Fetching an object from a remote node timed out."""


class OwnerDiedError(ObjectLostError):
    """The owner (the worker that created the ObjectRef) died, so the
    object's metadata and lineage are gone."""

    def __init__(self, object_id: str = ""):
        ObjectLostError.__init__(
            self, object_id, f"Owner of object {object_id[:8]} died; object cannot be recovered"
        )


class ObjectReconstructionFailedError(ObjectLostError):
    """Lineage reconstruction was attempted but failed (e.g. max retries
    exhausted or lineage evicted)."""


class GetTimeoutError(RayTpuError, TimeoutError):
    """``get()`` timed out before the object was available."""


class TaskCancelledError(RayTpuError):
    """The task was cancelled before or during execution."""

    def __init__(self, task_id: str = ""):
        self.task_id = task_id
        super().__init__(f"Task {task_id[:8] if task_id else ''} was cancelled")


class WorkerCrashedError(RayTpuError):
    """The worker process executing the task died unexpectedly (segfault,
    OOM-kill, node failure)."""


class NodeDiedError(RayTpuError):
    """A cluster node died."""


class RuntimeEnvSetupError(RayTpuError):
    """Setting up the runtime environment for a task/actor failed."""


class PendingCallsLimitExceededError(RayTpuError):
    """The actor's pending-call queue limit (max_pending_calls) was reached."""


class OutOfMemoryError(RayTpuError):
    """The object store or worker heap ran out of memory."""


class ObjectStoreFullError(OutOfMemoryError):
    """The shared-memory object store is full and eviction could not make room."""


class CrossLanguageError(RayTpuError):
    """Error crossing a language boundary."""


class PlacementGroupError(RayTpuError):
    """Placement-group related failure (infeasible bundle, removed group...)."""
