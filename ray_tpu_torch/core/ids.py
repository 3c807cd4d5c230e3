"""Binary entity IDs with embedded lineage.

Design follows the reference's ID scheme (reference: src/ray/common/id.h,
id_def.h) — fixed-width binary IDs where ObjectIDs embed the creating TaskID
plus a return-index, and TaskIDs embed the JobID — but sized for this runtime:

- JobID:            4 bytes (counter)
- NodeID:          16 bytes (random)
- WorkerID:        16 bytes (random)
- ActorID:         12 bytes = 8 random + 4 job
- TaskID:          20 bytes = 8 unique + 12 actor-or-padding (job-embedded)
- ObjectID:        24 bytes = 20 task + 4 big-endian return/put index
- PlacementGroupID 12 bytes = 8 random + 4 job

The embedding is what makes ownership and lineage reconstruction cheap: given
an ObjectID you can recover the TaskID that creates it (``ObjectID.task_id()``)
without any metadata lookup, exactly the property the reference relies on for
lineage re-execution.
"""

from __future__ import annotations

import os
import struct
import threading
from typing import ClassVar, Type, TypeVar

T = TypeVar("T", bound="BaseID")

_pid_rand_lock = threading.Lock()


def _random_bytes(n: int) -> bytes:
    return os.urandom(n)


class BaseID:
    SIZE: ClassVar[int] = 16
    __slots__ = ("_bytes", "_hash")

    def __init__(self, id_bytes: bytes):
        if len(id_bytes) != self.SIZE:
            raise ValueError(
                f"{type(self).__name__} requires {self.SIZE} bytes, got {len(id_bytes)}"
            )
        self._bytes = bytes(id_bytes)
        self._hash = hash((type(self).__name__, self._bytes))

    @classmethod
    def from_random(cls: Type[T]) -> T:
        return cls(_random_bytes(cls.SIZE))

    @classmethod
    def from_hex(cls: Type[T], hex_str: str) -> T:
        return cls(bytes.fromhex(hex_str))

    @classmethod
    def nil(cls: Type[T]) -> T:
        return cls(b"\xff" * cls.SIZE)

    def is_nil(self) -> bool:
        return self._bytes == b"\xff" * self.SIZE

    def binary(self) -> bytes:
        return self._bytes

    def hex(self) -> str:
        return self._bytes.hex()

    def __hash__(self) -> int:
        return self._hash

    def __eq__(self, other: object) -> bool:
        return type(other) is type(self) and other._bytes == self._bytes  # type: ignore[attr-defined]

    def __lt__(self, other: "BaseID") -> bool:
        return self._bytes < other._bytes

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.hex()})"

    def __reduce__(self):
        return (type(self), (self._bytes,))


class JobID(BaseID):
    SIZE = 4

    @classmethod
    def from_int(cls, value: int) -> "JobID":
        return cls(struct.pack(">I", value))

    def int_value(self) -> int:
        return struct.unpack(">I", self._bytes)[0]


class NodeID(BaseID):
    SIZE = 16


class WorkerID(BaseID):
    SIZE = 16


class ClusterID(BaseID):
    SIZE = 16


class ActorID(BaseID):
    SIZE = 12
    UNIQUE_BYTES = 8

    @classmethod
    def of(cls, job_id: JobID) -> "ActorID":
        return cls(_random_bytes(cls.UNIQUE_BYTES) + job_id.binary())

    def job_id(self) -> JobID:
        return JobID(self._bytes[self.UNIQUE_BYTES :])


class PlacementGroupID(BaseID):
    SIZE = 12
    UNIQUE_BYTES = 8

    @classmethod
    def of(cls, job_id: JobID) -> "PlacementGroupID":
        return cls(_random_bytes(cls.UNIQUE_BYTES) + job_id.binary())

    def job_id(self) -> JobID:
        return JobID(self._bytes[self.UNIQUE_BYTES :])


class TaskID(BaseID):
    SIZE = 20
    UNIQUE_BYTES = 8

    @classmethod
    def for_normal_task(cls, job_id: JobID) -> "TaskID":
        # Pad the actor slot with the job id so job_id() works uniformly.
        pad = b"\x00" * (ActorID.UNIQUE_BYTES)
        return cls(_random_bytes(cls.UNIQUE_BYTES) + pad + job_id.binary())

    @classmethod
    def for_actor_task(cls, actor_id: ActorID) -> "TaskID":
        return cls(_random_bytes(cls.UNIQUE_BYTES) + actor_id.binary())

    @classmethod
    def for_actor_creation(cls, actor_id: ActorID) -> "TaskID":
        # Deterministic: the creation task of an actor is unique, so use a
        # fixed unique part (zeros) + the actor id.
        return cls(b"\x00" * cls.UNIQUE_BYTES + actor_id.binary())

    @classmethod
    def for_driver(cls, job_id: JobID) -> "TaskID":
        return cls(b"\xfe" * cls.UNIQUE_BYTES + b"\x00" * ActorID.UNIQUE_BYTES + job_id.binary())

    def actor_id(self) -> ActorID:
        return ActorID(self._bytes[self.UNIQUE_BYTES :])

    def job_id(self) -> JobID:
        return JobID(self._bytes[self.SIZE - JobID.SIZE :])


class ObjectID(BaseID):
    SIZE = 24
    INDEX_BYTES = 4

    @classmethod
    def for_task_return(cls, task_id: TaskID, index: int) -> "ObjectID":
        """Return values use indices 1..N (index 0 is reserved)."""
        return cls(task_id.binary() + struct.pack(">I", index))

    @classmethod
    def for_put(cls, task_id: TaskID, put_index: int) -> "ObjectID":
        """Puts use the high bit of the index to distinguish from returns."""
        return cls(task_id.binary() + struct.pack(">I", put_index | 0x80000000))

    def task_id(self) -> TaskID:
        return TaskID(self._bytes[: TaskID.SIZE])

    def job_id(self) -> JobID:
        return self.task_id().job_id()

    def index(self) -> int:
        return struct.unpack(">I", self._bytes[TaskID.SIZE :])[0] & 0x7FFFFFFF

    def is_put(self) -> bool:
        return bool(struct.unpack(">I", self._bytes[TaskID.SIZE :])[0] & 0x80000000)


# Backwards-friendly aliases mirroring the public reference naming.
ObjectRefID = ObjectID
