"""Shared-memory object store (plasma-equivalent).

Reference capability: src/ray/object_manager/plasma/ — shared-memory
immutable objects with zero-copy reads, eviction under pressure, and
spill-to-disk. Two backends:

- "arena" (default when the native lib builds): ONE mmap'd shm arena per
  node managed by the C++ boundary-tag allocator in ray_tpu_torch/_native/arena.cc
  (the plasma_allocator.cc / dlmalloc.cc equivalent). Objects are carved out
  of the arena at 64-byte-aligned offsets the agent hands out over RPC;
  every process maps the arena ONCE, so reads/writes are pointer arithmetic
  instead of per-object open+mmap+close syscalls. A 64-byte in-arena header
  (object id + size) is validated on every read so a slot recycled between
  the metadata RPC and the read surfaces as "object missing", never as
  another object's bytes.
- "segments": one POSIX shm segment per object (kernel allocator) — the
  pure-Python fallback when no C++ toolchain is available.

In both backends the node agent owns the index (sizes, pins, LRU order) and
enforces the per-node budget with LRU eviction of unpinned sealed objects,
spilling them to ``<spill_dir>`` first when enabled (restore-on-get).
"""

from __future__ import annotations

import mmap
import os
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.core.config import config
from ray_tpu_torch.core.ids import ObjectID
from ray_tpu_torch.exceptions import ObjectStoreFullError
from ray_tpu_torch.utils.logging import get_logger

logger = get_logger("shm_store")

_SHM_DIR = "/dev/shm"
# The port's own prefix for every file it makes in /dev/shm (segments,
# arenas and their pidfiles, the agents' locality probes). The JAX package
# uses "rtpu-": with distinct prefixes a live cluster of each package on
# one machine never attaches to, sweeps or counts the other's files.
SHM_PREFIX = "rtpt-"


def segment_name(oid: ObjectID, node_suffix: str) -> str:
    # FULL 48-hex id: a truncated prefix would collide for every put of the
    # same task (ObjectID = TaskID ++ index, the index is at the END).
    return f"{SHM_PREFIX}{node_suffix[:8]}-{oid.hex()}"


def arena_path(node_suffix: str) -> str:
    return os.path.join(_SHM_DIR, f"{SHM_PREFIX}arena-{node_suffix[:8]}")


def _arena_pid_path(path: str) -> str:
    return path + ".pid"


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True  # another user's live process
    except OSError:
        return True  # unknowable: never sweep what might be alive
    return True


def write_arena_pidfile(path: str, pid: Optional[int] = None) -> None:
    """Record the owning process of an arena file. Written BEFORE the arena
    is created so a concurrent sweeper always sees a live owner."""
    try:
        with open(_arena_pid_path(path), "w") as f:
            f.write(str(pid if pid is not None else os.getpid()))
    except OSError:
        pass  # /dev/shm unwritable: the arena create will fail loudly anyway


def arena_owner_alive(path: str) -> bool:
    """True unless the pidfile names a provably-dead process. A missing or
    corrupt pidfile counts as DEAD: every arena creator in this codebase
    writes the pidfile first, so an arena without one is a pre-pidfile
    orphan (or lost its owner before finishing startup)."""
    try:
        pid = int(open(_arena_pid_path(path)).read().strip())
    except (OSError, ValueError):
        return False
    return _pid_alive(pid)


def sweep_dead_arenas() -> List[str]:
    """Reclaim arenas whose owner process is gone (reference capability:
    raylet startup cleanup of stale plasma sockets/segments). A SIGKILLed
    agent cannot run ShmObjectStore.cleanup(), so its multi-GB arena file
    would pin /dev/shm forever; every agent/cluster startup calls this to
    reclaim them. Returns the arena paths removed."""
    import glob as _glob

    removed: List[str] = []
    for path in _glob.glob(os.path.join(_SHM_DIR, SHM_PREFIX + "arena-*")):
        if path.endswith(".pid"):
            continue
        if arena_owner_alive(path):
            continue
        for p in (path, _arena_pid_path(path)):
            try:
                os.unlink(p)
            except OSError:
                pass
        removed.append(path)
        logger.info("swept orphaned shm arena %s", path)
    # pidfiles whose arena vanished (crash between unlinks): drop them too
    for pidfile in _glob.glob(os.path.join(_SHM_DIR, SHM_PREFIX + "arena-*.pid")):
        if not os.path.exists(pidfile[: -len(".pid")]):
            try:
                os.unlink(pidfile)
            except OSError:
                pass
    return removed


def find_orphan_arenas() -> List[str]:
    """Arenas (not pidfiles) whose owner is dead — the post-suite CI check."""
    import glob as _glob

    return [
        path for path in _glob.glob(os.path.join(_SHM_DIR, SHM_PREFIX + "arena-*"))
        if not path.endswith(".pid") and not arena_owner_alive(path)
    ]


# process-wide cache of attached arenas (one mmap per process per node)
_arena_cache: Dict[str, Any] = {}
_arena_lock = threading.Lock()


def attach_arena(node_suffix: str):
    """Worker-side: map this node's arena once and cache it. The cache is
    inode-validated — if the arena file was unlinked+recreated (store
    restart in the same process, e.g. tests), the stale mapping is dropped
    and re-attached."""
    from ray_tpu_torch import _native

    path = arena_path(node_suffix)
    with _arena_lock:
        cached = _arena_cache.get(path)
        ino = os.stat(path).st_ino  # raises FileNotFoundError if gone
        if cached is not None and cached[1] == ino:
            return cached[0]
        # NOTE: a replaced stale arena is deliberately NOT munmap'd — ctypes
        # from_address views cannot be tracked, so unmapping could turn a
        # straggling reader's access into SIGSEGV. The old mapping leaks
        # until process exit (rare: same-process store recreate).
        a = _native.Arena(path)
        _arena_cache[path] = (a, ino)
        return a


def _oid24(oid: ObjectID) -> bytes:
    b = oid.binary()
    return b[:24] if len(b) >= 24 else b.ljust(24, b"\0")


class ShmSegment:
    """POSIX shm segment via direct /dev/shm open+mmap.

    Deliberately NOT multiprocessing.shared_memory: that class registers
    every segment with the resource_tracker daemon over a pipe, and under
    load the tracker process starves, its pipe fills, and the register()
    write BLOCKS the caller — observed freezing the node agent's event loop
    for 12+ s (heartbeats missed, node declared dead). It also unlinks
    segments when the registering process exits (bpo-38119), fighting the
    store's explicit ownership. Segment lifetime here is owned by the node
    agent's delete/cleanup."""

    __slots__ = ("name", "size", "_mm", "buf")

    def __init__(self, name: str, create: bool, size: int = 0):
        path = os.path.join(_SHM_DIR, name)
        flags = os.O_RDWR | ((os.O_CREAT | os.O_EXCL) if create else 0)
        fd = os.open(path, flags, 0o600)
        try:
            if create:
                os.ftruncate(fd, max(size, 1))
            else:
                size = os.fstat(fd).st_size
            self._mm = mmap.mmap(fd, max(size, 1))
        finally:
            os.close(fd)
        self.name = name
        self.size = size
        self.buf: memoryview = memoryview(self._mm)

    def close(self) -> None:
        try:
            self.buf.release()
            self._mm.close()
        except (BufferError, ValueError):
            # numpy views may still alias the map; the OS reclaims at exit
            pass

    @staticmethod
    def unlink(name: str) -> None:
        os.unlink(os.path.join(_SHM_DIR, name))


class ShmWriter:
    """Created by workers to write an object directly into shared memory.

    ``offset`` (from the agent's create_object reply) selects the arena
    backend: the write lands at that offset of the node's single arena
    mapping. offset=None falls back to a per-object segment."""

    def __init__(self, oid: ObjectID, size: int, node_suffix: str,
                 offset: Optional[int] = None):
        self.oid = oid
        self.size = size
        self.offset = offset
        if offset is not None:
            self._arena = attach_arena(node_suffix)
            self._shm = None
            if not self._arena.validate(_oid24(oid), offset, size):
                # the reservation vanished (aborted/evicted) before we wrote
                raise FileNotFoundError(
                    f"arena slot for {oid.hex()[:16]} no longer reserved")
            return
        name = segment_name(oid, node_suffix)
        try:
            self._shm = ShmSegment(name, create=True, size=size)
        except FileExistsError:
            # a retried create (dropped RPC response) already made the
            # segment; attach and (re)write the identical bytes
            self._shm = ShmSegment(name, create=False)

    @property
    def buffer(self) -> memoryview:
        if self._shm is None:
            return self._arena.slice(self.offset, self.size)
        return self._shm.buf[: self.size]

    def seal(self) -> None:
        if self._shm is not None:
            self._shm.close()
            return
        if not self._arena.validate(_oid24(self.oid), self.offset, self.size):
            # the reservation was aborted (and possibly recycled) while we
            # were writing: fail loudly so the caller re-creates, instead of
            # a silent write into memory that no reader will attribute to us
            raise FileNotFoundError(
                f"arena slot for {self.oid.hex()[:16]} aborted mid-write")


class ShmReader:
    def __init__(self, oid: ObjectID, size: int, node_suffix: str,
                 offset: Optional[int] = None):
        self.oid = oid
        self.size = size
        self.offset = offset
        if offset is not None:
            self._arena = attach_arena(node_suffix)
            self._shm = None
            if not self._arena.validate(_oid24(oid), offset, size):
                # slot evicted+recycled between the metadata RPC and this
                # read: surface as missing, never as someone else's bytes
                raise FileNotFoundError(
                    f"arena slot for {oid.hex()[:16]} was evicted")
            return
        self._shm = ShmSegment(segment_name(oid, node_suffix), create=False)

    @property
    def buffer(self) -> memoryview:
        if self._shm is None:
            return self._arena.slice(self.offset, self.size)
        return self._shm.buf[: self.size]

    def revalidate(self) -> bool:
        """True if the slot still belongs to this object (arena backend);
        always True for per-object segments (an mmap cannot be recycled)."""
        return self._shm is not None or self._arena.validate(
            _oid24(self.oid), self.offset, self.size
        )

    def read_bytes(self) -> bytes:
        """Copy out the payload with a post-copy header re-validation: if the
        slot was evicted+recycled DURING the copy (free() scrubs the header,
        the next alloc overwrites it under the store lock), the stale copy is
        detected and surfaced as missing — never returned as data."""
        data = bytes(self.buffer)
        if not self.revalidate():
            raise FileNotFoundError(
                f"arena slot for {self.oid.hex()[:16]} recycled mid-read")
        return data

    def close(self) -> None:
        if self._shm is None:
            return  # the arena mapping is process-wide; nothing per-object
        try:
            self._shm.close()
        except Exception:
            pass


@dataclass
class _Entry:
    size: int
    sealed: bool = False
    pinned: int = 0
    spilled_path: Optional[str] = None
    offset: Optional[int] = None  # arena backend: payload offset
    created_at: float = field(default_factory=time.time)


class ShmObjectStore:
    """Node-agent-side index + lifecycle manager for the shm segments."""

    def __init__(self, node_suffix: str, capacity_bytes: Optional[int] = None,
                 spill_dir: Optional[str] = None, backend: Optional[str] = None):
        self.node_suffix = node_suffix
        self.capacity = capacity_bytes or config.object_store_memory_bytes
        self.spill_dir = spill_dir
        self._lock = threading.Lock()
        self._restore_lock = threading.Lock()
        self._entries: "OrderedDict[ObjectID, _Entry]" = OrderedDict()
        self._used = 0
        # lifetime spill counters (observability: shuffle stats, node_info)
        self._spilled_bytes = 0
        self._spill_count = 0
        self._restored_bytes = 0
        # aborted reservations may have a zombie writer still holding the
        # offset (crashed-execution recovery): their arena blocks are
        # quarantined for a grace period before re-entering circulation so a
        # late write lands in dead memory, not in another object's bytes
        self._quarantine: List[Tuple[float, int, int]] = []  # (expiry, offset, size)
        backend = backend or config.object_store_backend
        self._arena = None
        if backend in ("auto", "arena"):
            # agent startup doubles as the node's arena janitor: reclaim any
            # arena whose owner died without running cleanup() (SIGKILLed
            # cluster) before creating our own
            try:
                sweep_dead_arenas()
            except OSError:
                pass
            try:
                from ray_tpu_torch import _native

                if _native.available():
                    # pidfile BEFORE the arena: a concurrent sweeper must
                    # always observe a live owner for a nascent arena
                    write_arena_pidfile(arena_path(node_suffix))
                    self._arena = _native.Arena(
                        arena_path(node_suffix), capacity=self.capacity,
                        create=True,
                    )
            except Exception:  # noqa: BLE001 - toolchain/shm issues
                if backend == "arena":
                    raise
                logger.warning("native arena unavailable; using per-object "
                               "segments", exc_info=True)
        self.backend = "arena" if self._arena is not None else "segments"

    # ---- write path -------------------------------------------------------
    def reserve(self, oid: ObjectID, size: int) -> Optional[int]:
        """Returns the arena payload offset (None for the segments backend)."""
        with self._lock:
            if oid in self._entries:
                raise FileExistsError(f"object {oid.hex()[:16]} already exists")
            self._ensure_capacity(size)
            offset = None
            if self._arena is not None:
                offset = self._alloc_locked(oid, size)
            self._entries[oid] = _Entry(size=size, offset=offset)
            self._used += size
            return offset

    def _quarantine_locked(self, offset: int, size: int) -> None:
        """Must hold lock. Scrub the header NOW (stale readers/writers fail
        validation from this instant) but keep the block allocated — and its
        bytes charged against the budget — until the grace period passes: a
        zombie writer's late bytes land in dead memory, never in a recycled
        object. Monotonic clock: a wall-clock step must not shorten the
        grace window."""
        self._arena.slice(offset - 64, 64)[:] = b"\x00" * 64
        self._quarantine.append(
            (time.monotonic() + config.arena_abort_quarantine_s, offset, size))

    def _sweep_quarantine_locked(self) -> None:
        now = time.monotonic()
        keep = []
        for expiry, off, size in self._quarantine:
            if expiry <= now:
                self._arena.free(off)
                self._used -= size
            else:
                keep.append((expiry, off, size))
        self._quarantine = keep

    def _reclaim_quarantine_locked(self) -> bool:
        """Pressure-driven early reclaim of ONE quarantined block (oldest
        first). The grace window is defense-in-depth against a crashed
        writer's late bytes; under memory pressure, dropping it early beats
        evicting LIVE sealed objects while dead bytes sit idle (a churny
        delete+put workload near capacity would otherwise thrash or raise
        ObjectStoreFullError). The header was scrubbed at quarantine time,
        so readers can never validate into the recycled block."""
        if not self._quarantine:
            return False
        _expiry, off, size = self._quarantine.pop(0)
        self._arena.free(off)
        self._used -= size
        return True

    def _alloc_locked(self, oid: ObjectID, size: int) -> int:
        """Arena alloc with fragmentation-driven eviction. Must hold lock.
        _ensure_capacity already freed BUDGET; a fragmented arena can still
        fail the actual allocation, in which case we evict more LRU victims
        until a contiguous block fits."""
        self._sweep_quarantine_locked()
        key = _oid24(oid)
        attempts = 0
        while True:
            off = self._arena.alloc(key, size)
            if off >= 0:
                return off
            if attempts >= config.object_store_full_retries or \
                    not (self._reclaim_quarantine_locked()
                         or self._evict_one_locked()):
                raise ObjectStoreFullError(
                    f"arena fragmented: need {size} contiguous, largest free "
                    f"{self._arena.largest_free()} "
                    f"({self._arena.num_free_blocks()} free blocks)"
                )
            attempts += 1

    def seal(self, oid: ObjectID) -> None:
        with self._lock:
            e = self._entries.get(oid)
            if e is not None:
                e.sealed = True
                self._entries.move_to_end(oid)

    def abort(self, oid: ObjectID) -> None:
        with self._lock:
            e = self._entries.pop(oid, None)
            if e is not None and e.spilled_path is None:
                if e.offset is not None:
                    # budget stays charged until the sweep frees the block:
                    # _used and real arena occupancy must not diverge
                    self._quarantine_locked(e.offset, e.size)
                    e.offset = None
                else:
                    self._used -= e.size
                    self._unlink(oid)
        if e is not None and e.spilled_path:
            try:
                os.unlink(e.spilled_path)
            except OSError:
                pass

    # ---- read path --------------------------------------------------------
    def contains(self, oid: ObjectID) -> bool:
        with self._lock:
            e = self._entries.get(oid)
            return e is not None and e.sealed

    def info(self, oid: ObjectID) -> Optional[Tuple[int, bool]]:
        with self._lock:
            e = self._entries.get(oid)
            return (e.size, e.sealed) if e else None

    def sealed_items(self) -> List[Tuple[ObjectID, int]]:
        """(oid, size) of every sealed object — the agent's re-registration
        source of truth after a GCS restart."""
        with self._lock:
            return [(oid, e.size) for oid, e in self._entries.items()
                    if e.sealed]

    def offset(self, oid: ObjectID) -> Optional[int]:
        """Arena payload offset for a local (non-spilled) object, else None."""
        with self._lock:
            e = self._entries.get(oid)
            return e.offset if e is not None and e.spilled_path is None else None

    def touch(self, oid: ObjectID) -> None:
        with self._lock:
            if oid in self._entries:
                self._entries.move_to_end(oid)

    def ensure_local(self, oid: ObjectID) -> Optional[int]:
        """Restore from spill if needed; returns size or None if unknown."""
        with self._lock:
            e = self._entries.get(oid)
            if e is None:
                return None
            if e.spilled_path is None:
                self._entries.move_to_end(oid)
                return e.size
        return self._restore(oid)

    # ---- lifecycle --------------------------------------------------------
    def pin(self, oid: ObjectID) -> None:
        with self._lock:
            e = self._entries.get(oid)
            if e is not None:
                e.pinned += 1

    def unpin(self, oid: ObjectID) -> None:
        with self._lock:
            e = self._entries.get(oid)
            if e is not None and e.pinned > 0:
                e.pinned -= 1

    def delete(self, oid: ObjectID) -> None:
        with self._lock:
            e = self._entries.pop(oid, None)
            if e is None:
                return
            if e.spilled_path is None:
                self._used -= e.size
                self._free_storage_locked(oid, e)
            spilled = e.spilled_path
        if spilled:
            try:
                os.unlink(spilled)
            except OSError:
                pass

    def usage(self) -> Dict[str, float]:
        with self._lock:
            out = {
                "capacity": self.capacity,
                "used": self._used,
                "objects": len(self._entries),
                "backend": self.backend,
                "spilled_bytes": self._spilled_bytes,
                "spill_count": self._spill_count,
                "restored_bytes": self._restored_bytes,
            }
            if self._arena is not None:
                out["arena_used"] = self._arena.used()
                out["arena_largest_free"] = self._arena.largest_free()
                out["arena_free_blocks"] = self._arena.num_free_blocks()
            return out

    def debug_entries(self, limit: int = 200) -> List[Dict[str, Any]]:
        """Per-entry state for debugging store pressure."""
        with self._lock:
            out = []
            for oid, e in self._entries.items():
                out.append({
                    "id": oid.hex()[:16], "size": e.size, "sealed": e.sealed,
                    "pinned": e.pinned, "spilled": e.spilled_path is not None,
                })
                if len(out) >= limit:
                    break
            return out

    # ---- internal ---------------------------------------------------------
    def _free_storage_locked(self, oid: ObjectID, e: _Entry) -> None:
        """Release the bytes behind a local entry. Must hold lock."""
        if e.offset is not None:
            self._arena.free(e.offset)
            e.offset = None
        else:
            self._unlink(oid)

    def _evict_one_locked(self) -> bool:
        """Spill (or drop) ONE LRU unpinned sealed object. Must hold lock."""
        spill_enabled = (self.spill_dir is not None
                         and config.object_spilling_enabled)
        for oid, e in self._entries.items():
            if e.sealed and e.pinned == 0 and e.spilled_path is None:
                if spill_enabled:
                    self._spill_locked(oid, e)
                else:
                    self._entries.pop(oid)
                    self._used -= e.size
                    self._free_storage_locked(oid, e)
                return True
        return False

    def _ensure_capacity(self, size: int) -> None:
        """Must hold lock. Evict (spill) LRU unpinned sealed objects."""
        if self._arena is not None and self._quarantine:
            self._sweep_quarantine_locked()
        if size > self.capacity:
            raise ObjectStoreFullError(
                f"object of {size} bytes exceeds store capacity {self.capacity}"
            )
        attempts = 0
        while self._used + size > self.capacity and attempts < config.object_store_full_retries:
            # dead (quarantined) bytes go before live sealed objects
            if not self._reclaim_quarantine_locked() and not self._evict_one_locked():
                break
            attempts += 1
        if self._used + size > self.capacity:
            raise ObjectStoreFullError(
                f"object store full: need {size}, used {self._used}/{self.capacity} "
                f"and nothing evictable (all pinned or unsealed)"
            )

    def _spill_locked(self, oid: ObjectID, e: _Entry) -> None:
        os.makedirs(self.spill_dir, exist_ok=True)
        path = os.path.join(self.spill_dir, oid.hex())
        try:
            reader = ShmReader(oid, e.size, self.node_suffix, offset=e.offset)
        except FileNotFoundError:
            self._entries.pop(oid, None)
            self._used -= e.size
            if e.offset is not None:
                self._arena.free(e.offset)
                e.offset = None
            return
        try:
            with open(path, "wb") as f:
                f.write(reader.buffer)
        finally:
            reader.close()
        self._free_storage_locked(oid, e)
        e.spilled_path = path
        self._used -= e.size
        self._spilled_bytes += e.size
        self._spill_count += 1
        logger.debug("spilled %s (%d bytes)", oid.hex()[:16], e.size)

    def _restore(self, oid: ObjectID) -> Optional[int]:
        # _restore_lock serializes concurrent restores of the same (or any)
        # spilled object; the re-check under _lock makes the loser a no-op
        # instead of a FileExistsError on the segment create.
        with self._restore_lock:
            with self._lock:
                e = self._entries.get(oid)
                if e is None or e.spilled_path is None:
                    return e.size if e else None
                path = e.spilled_path
                size = e.size
                self._ensure_capacity(size)
                # reserve the headroom BEFORE dropping the lock: a concurrent
                # reserve() must not claim the same bytes (mirror of
                # reserve()'s reserve-then-write pattern)
                self._used += size
                offset = None
                if self._arena is not None:
                    try:
                        offset = self._alloc_locked(oid, size)
                    except ObjectStoreFullError:
                        self._used -= size
                        raise
            try:
                data = open(path, "rb").read()
                writer = ShmWriter(oid, len(data), self.node_suffix,
                                   offset=offset)
                writer.buffer[:] = data
                writer.seal()
            except Exception:
                with self._lock:
                    self._used -= size
                    if offset is not None:
                        self._arena.free(offset)
                raise
            deleted = False
            with self._lock:
                e = self._entries.get(oid)
                if e is not None:
                    e.spilled_path = None
                    e.offset = offset
                    self._restored_bytes += size
                    self._entries.move_to_end(oid)
                else:
                    self._used -= size  # deleted while restoring
                    deleted = True
            if deleted:
                # delete() ran before our storage existed: release what we
                # just wrote or it leaks until the store shuts down
                if offset is not None:
                    with self._lock:
                        self._arena.free(offset)
                else:
                    self._unlink(oid)
            try:
                os.unlink(path)
            except OSError:
                pass
            return size

    def _unlink(self, oid: ObjectID) -> None:
        try:
            ShmSegment.unlink(segment_name(oid, self.node_suffix))
        except FileNotFoundError:
            pass
        except Exception:  # noqa: BLE001
            logger.debug("unlink failed for %s", oid.hex()[:16])

    def cleanup(self) -> None:
        with self._lock:
            ids = list(self._entries)
            self._entries.clear()
            self._used = 0
            arena, self._arena = self._arena, None
        if arena is not None:
            arena.close()
            try:
                arena.unlink()
            except OSError:
                pass
            try:
                os.unlink(_arena_pid_path(arena_path(self.node_suffix)))
            except OSError:
                pass
            return
        for oid in ids:
            self._unlink(oid)
