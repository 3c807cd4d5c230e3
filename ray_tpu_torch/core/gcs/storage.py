"""Pluggable GCS metadata persistence backends.

Reference capability: src/ray/gcs/store_client/ (in_memory_store_client.h,
redis_store_client.cc — pluggable metadata persistence behind one
interface, selected by configuration, giving the GCS fault tolerance).
Redesign: the GCS snapshots its full state dict; backends own WHERE that
durable copy lives. Selection by URI (``gcs_storage`` config /
``persist_dir`` argument):

    /some/dir  or  file:///some/dir   atomic-rename msgpack snapshot file
    sqlite:///some/path.db            WAL-mode sqlite with fsync'd commits

sqlite buys crash-consistency on every commit (the file backend's rename
is atomic but the interval between snapshots is the loss window for both;
sqlite also keeps the previous generation on partial writes) and is the
natural seam for a future networked store.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, Optional

from ray_tpu_torch.utils.logging import get_logger

logger = get_logger("gcs.storage")


class GcsStorageBackend:
    """save()/load() a full GCS state dict; implementations must be
    crash-safe (a torn write can never corrupt the last good copy) and
    thread-safe (stop()'s final on-loop save can race an in-flight
    executor save from the persist loop)."""

    @staticmethod
    def _encode(state: Dict[str, Any]) -> bytes:
        import msgpack

        return msgpack.packb(state, use_bin_type=True)

    @staticmethod
    def _decode(blob: bytes) -> Dict[str, Any]:
        import msgpack

        return msgpack.unpackb(blob, raw=False, strict_map_key=False)

    def save(self, state: Dict[str, Any]) -> None:
        raise NotImplementedError

    def load(self) -> Optional[Dict[str, Any]]:
        raise NotImplementedError

    def close(self) -> None:
        pass


class FileSnapshotBackend(GcsStorageBackend):
    """Atomic-rename msgpack snapshot (the original persist_dir behavior)."""

    def __init__(self, directory: str):
        self.directory = directory

    def _path(self) -> str:
        return os.path.join(self.directory, "gcs_snapshot.msgpack")

    def save(self, state: Dict[str, Any]) -> None:
        os.makedirs(self.directory, exist_ok=True)
        path = self._path()
        # unique tmp per writer: a final on-loop write may race an in-flight
        # executor write; sharing one tmp name would interleave and publish
        # a torn file
        tmp = f"{path}.{os.getpid()}.{id(state):x}.tmp"
        with open(tmp, "wb") as f:
            f.write(self._encode(state))
        # keep the previous generation: rename is atomic but the published
        # file can still end up unreadable (disk-full truncation, fs bugs,
        # a crash between the rename and a later page flush); load() falls
        # back to .prev so a SIGKILL'd GCS restarts from the last-but-one
        # snapshot instead of fresh
        if os.path.exists(path):
            try:
                os.replace(path, f"{path}.prev")
            except OSError:
                pass
        os.replace(tmp, path)  # atomic: readers never see a torn snapshot

    def load(self) -> Optional[Dict[str, Any]]:
        path = self._path()
        for candidate in (path, f"{path}.prev"):
            if not os.path.exists(candidate):
                continue
            try:
                with open(candidate, "rb") as f:
                    return self._decode(f.read())
            except Exception:  # noqa: BLE001 - corrupt generation: try older
                logger.exception("unreadable snapshot %s; trying previous",
                                 candidate)
        return None


class SqliteBackend(GcsStorageBackend):
    """WAL-mode sqlite: one row holding the latest msgpack state blob,
    committed transactionally (a crash mid-save leaves the previous
    generation intact and fsync'd)."""

    def __init__(self, path: str):
        import sqlite3

        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path
        # one connection shared across the event-loop and executor threads:
        # transaction state is per-connection, so all access is serialized
        # by this lock (interleaved `with db:` blocks would cross-commit)
        self._lock = threading.Lock()
        self._db = sqlite3.connect(path, check_same_thread=False)
        self._db.execute("PRAGMA journal_mode=WAL")
        self._db.execute("PRAGMA synchronous=FULL")
        self._db.execute(
            "CREATE TABLE IF NOT EXISTS gcs_state ("
            " id INTEGER PRIMARY KEY CHECK (id = 1),"
            " data BLOB NOT NULL,"
            " updated_at REAL NOT NULL)"
        )
        self._db.commit()

    def save(self, state: Dict[str, Any]) -> None:
        blob = self._encode(state)
        with self._lock, self._db:  # transactional: all-or-nothing
            self._db.execute(
                "INSERT INTO gcs_state (id, data, updated_at) VALUES (1, ?, ?)"
                " ON CONFLICT(id) DO UPDATE SET data=excluded.data,"
                " updated_at=excluded.updated_at",
                (blob, time.time()),
            )

    def load(self) -> Optional[Dict[str, Any]]:
        with self._lock:
            row = self._db.execute(
                "SELECT data FROM gcs_state WHERE id = 1").fetchone()
        if row is None:
            return None
        return self._decode(row[0])

    def close(self) -> None:
        with self._lock:
            try:
                self._db.close()
            except Exception:  # noqa: BLE001
                pass


def storage_backend_from_uri(uri: str) -> GcsStorageBackend:
    """Resolve a persistence URI/path to a backend. Plain paths and
    file:// URIs keep the original snapshot-file behavior."""
    if uri.startswith("sqlite://"):
        return SqliteBackend(uri[len("sqlite://"):])
    if uri.startswith("file://"):
        return FileSnapshotBackend(uri[len("file://"):])
    return FileSnapshotBackend(uri)
