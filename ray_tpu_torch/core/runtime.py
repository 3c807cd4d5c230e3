"""CoreRuntime: the backend interface behind the public API (own copy of
ray_tpu.core.runtime).

Two implementations, as in the JAX package:

- ``LocalRuntime`` (core/local_runtime.py): in-process — threads for tasks,
  dedicated threads/event-loops for actors, a zero-copy in-process object
  table. CUDA tensors passed between tasks stay on the device, the same
  tensor with the same storage. This is also the test backend.
- ``ClusterRuntime`` (core/cluster_runtime.py): multi-process/multi-node —
  control service (GCS-equivalent), per-node agents with worker pools (a
  GPU worker sees its cards only), a shared-memory object plane (a CUDA
  tensor travels as host bytes), lease-based task submission.

The public API (ray_tpu_torch/api.py) only ever talks to this interface.
"""

from __future__ import annotations

import abc
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ray_tpu_torch.core.ids import ActorID, ObjectID, PlacementGroupID
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.core.task_spec import TaskSpec


class CoreRuntime(abc.ABC):
    is_local: bool = True

    # --- objects -----------------------------------------------------------
    @abc.abstractmethod
    def put(self, value: Any) -> ObjectRef: ...

    @abc.abstractmethod
    def get(self, refs: Sequence[ObjectRef], timeout: Optional[float]) -> List[Any]: ...

    @abc.abstractmethod
    def wait(
        self,
        refs: Sequence[ObjectRef],
        num_returns: int,
        timeout: Optional[float],
        fetch_local: bool,
    ) -> Tuple[List[ObjectRef], List[ObjectRef]]: ...

    @abc.abstractmethod
    def free(self, refs: Sequence[ObjectRef]) -> None: ...

    def object_sizes(self, refs: Sequence[ObjectRef]) -> List[Optional[int]]:
        """Best-effort stored size per ref (None = unknown). Used by the Data
        executor's byte-budget backpressure; not part of the public API."""
        return [None] * len(refs)

    def release(self, oid: ObjectID) -> None:
        """Refcount reached zero in this process."""

    # --- tasks -------------------------------------------------------------
    @abc.abstractmethod
    def submit_task(self, spec: TaskSpec, func: Any, args: tuple, kwargs: dict) -> List[ObjectRef]: ...

    # --- streaming generators (num_returns="streaming") --------------------
    def stream_next(self, task_hex: str, index: int, timeout: Optional[float]) -> Tuple[str, Any]:
        """Block until stream item ``index`` exists or the stream ended.
        Returns ("item", oid_hex) or ("end", total). Asking for index i
        acknowledges consumption of items < i (backpressure watermark)."""
        raise NotImplementedError

    def stream_close(self, task_hex: str) -> None:
        """Consumer abandoned the stream: unblock/stop the producer."""
        raise NotImplementedError

    @abc.abstractmethod
    def cancel(self, ref: ObjectRef, force: bool, recursive: bool) -> None: ...

    # --- actors ------------------------------------------------------------
    @abc.abstractmethod
    def create_actor(self, spec: TaskSpec, cls: Any, args: tuple, kwargs: dict) -> ActorID: ...

    @abc.abstractmethod
    def submit_actor_task(
        self, actor_id: ActorID, spec: TaskSpec, args: tuple, kwargs: dict
    ) -> List[ObjectRef]: ...

    @abc.abstractmethod
    def kill_actor(self, actor_id: ActorID, no_restart: bool) -> None: ...

    def get_named_actor(self, name: str, namespace: Optional[str]) -> ActorID:
        raise ValueError(f"Failed to look up actor '{name}'")

    def list_named_actors(self, all_namespaces: bool = False, namespace: str = "default") -> List[str]:
        return []

    # --- placement groups ---------------------------------------------------
    @abc.abstractmethod
    def create_placement_group(
        self, bundles: List[Dict[str, float]], strategy: str, name: str
    ) -> PlacementGroupID: ...

    @abc.abstractmethod
    def remove_placement_group(self, pg_id: PlacementGroupID) -> None: ...

    @abc.abstractmethod
    def placement_group_ready(self, pg_id: PlacementGroupID, timeout: Optional[float]) -> bool: ...

    # --- cluster info ------------------------------------------------------
    @abc.abstractmethod
    def nodes(self) -> List[Dict[str, Any]]: ...

    @abc.abstractmethod
    def cluster_resources(self) -> Dict[str, float]: ...

    @abc.abstractmethod
    def available_resources(self) -> Dict[str, float]: ...

    @abc.abstractmethod
    def shutdown(self) -> None: ...

    # --- kv / misc ---------------------------------------------------------
    def kv_put(self, key: str, value: bytes) -> None:
        raise NotImplementedError

    def kv_get(self, key: str) -> Optional[bytes]:
        raise NotImplementedError

    def kv_del(self, key: str) -> None:
        raise NotImplementedError

    def kv_keys(self, prefix: str = "") -> List[str]:
        raise NotImplementedError
