"""Per-worker training session: report/checkpoint plumbing (own copy of
ray_tpu.train.session).

Reference capability: python/ray/train/_internal/session.py (_TrainSession:
ray.train.report:667 metrics+checkpoint queue between the user's training
thread and the worker actor; get_checkpoint:754). The user training function
runs on a thread inside the TrainWorker actor; ``report()`` hands
(metrics, checkpoint) to the actor, which the trainer collects in lockstep
rounds.
"""

from __future__ import annotations

import os
import queue
import shutil
import threading
import uuid
from dataclasses import dataclass
from typing import Any, Dict, Optional


class Checkpoint:
    """A directory of files on shared/local storage (reference:
    train/_checkpoint.py — pyarrow-fs backed; local fs tier here)."""

    def __init__(self, path: str):
        self.path = path

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(os.path.abspath(path))

    def to_directory(self, dest: Optional[str] = None) -> str:
        if dest is None:
            return self.path
        os.makedirs(dest, exist_ok=True)
        shutil.copytree(self.path, dest, dirs_exist_ok=True)
        return dest

    def as_directory(self):
        import contextlib

        @contextlib.contextmanager
        def ctx():
            yield self.path

        return ctx()

    def __repr__(self) -> str:
        return f"Checkpoint({self.path})"


@dataclass
class TrainContext:
    world_rank: int
    world_size: int
    local_rank: int
    local_world_size: int
    node_rank: int
    experiment_name: str
    storage_path: str
    trial_dir: str


class SessionStopped(BaseException):
    """Raised inside the training thread when the controller stops the
    session (BaseException so user ``except Exception`` blocks can't swallow
    it; the stack unwinds through the trainable, releasing gangs/PGs)."""


class _Session:
    def __init__(self, ctx: TrainContext, latest_checkpoint: Optional[Checkpoint],
                 dataset_shards: Optional[Dict[str, Any]] = None):
        self.ctx = ctx
        self.latest_checkpoint = latest_checkpoint
        self.dataset_shards = dataset_shards or {}
        self.result_queue: "queue.Queue[Dict[str, Any]]" = queue.Queue()
        self.continue_event = threading.Event()
        self.finished = False
        self.stop_requested = False
        self.error: Optional[BaseException] = None

    def report(self, metrics: Dict[str, Any], checkpoint: Optional[Checkpoint] = None) -> None:
        persisted: Optional[str] = None
        if checkpoint is not None:
            # persist into the run's storage under a unique dir (all ranks may
            # report; rank subdir avoids clobbering — trainer keeps rank-0)
            step_dir = os.path.join(
                self.ctx.trial_dir,
                f"checkpoint_{metrics.get('step', metrics.get('epoch', uuid.uuid4().hex[:6]))}"
                f"_rank{self.ctx.world_rank}",
            )
            if os.path.abspath(checkpoint.path) != os.path.abspath(step_dir):
                os.makedirs(os.path.dirname(step_dir), exist_ok=True)
                shutil.copytree(checkpoint.path, step_dir, dirs_exist_ok=True)
            persisted = step_dir
        self.result_queue.put({"metrics": dict(metrics), "checkpoint": persisted, "done": False})
        # lockstep with the trainer's collection round
        self.continue_event.wait()
        self.continue_event.clear()
        if self.stop_requested:
            raise SessionStopped()

    def get_checkpoint(self) -> Optional[Checkpoint]:
        return self.latest_checkpoint


# Sessions are keyed by the TRAINING THREAD (not process-global): in local
# mode several TrainWorker actors share one process, each running its user fn
# on its own thread, and report() must resolve to the caller's own session.
_sessions: Dict[int, _Session] = {}
_session_lock = threading.Lock()


def _bind_session_to_current_thread(s: _Session) -> None:
    with _session_lock:
        _sessions[threading.get_ident()] = s


def _unbind_current_thread() -> None:
    with _session_lock:
        _sessions.pop(threading.get_ident(), None)


def _get_session() -> Optional[_Session]:
    with _session_lock:
        return _sessions.get(threading.get_ident())


# ---------------------------------------------------------------- public api
def report(metrics: Dict[str, Any], checkpoint: Optional[Checkpoint] = None) -> None:
    s = _get_session()
    if s is None:
        raise RuntimeError("ray_tpu_torch.train.report() called outside a training session")
    s.report(metrics, checkpoint)


def get_checkpoint() -> Optional[Checkpoint]:
    s = _get_session()
    return s.get_checkpoint() if s else None


def get_context() -> TrainContext:
    s = _get_session()
    if s is None:
        raise RuntimeError("no active training session")
    return s.ctx


def world_rank() -> int:
    return get_context().world_rank


def world_size() -> int:
    return get_context().world_size


def get_dataset_shard(name: str = "train"):
    """This worker's shard of a dataset passed via GpuTrainer(datasets={...})
    (reference: ray.train.get_dataset_shard over streaming_split)."""
    s = _get_session()
    if s is None:
        raise RuntimeError("no active training session")
    shard = s.dataset_shards.get(name)
    if shard is None:
        raise KeyError(
            f"no dataset named {name!r}; available: {sorted(s.dataset_shards)}"
        )
    return shard
