"""Mutable-object channels: zero-RPC shared-memory pipes between processes
(own copy of ray_tpu.experimental.channel).

Reference capability: python/ray/experimental/channel/shared_memory_channel.py
+ src/ray/core_worker/experimental_mutable_object_manager.h:48 (versioned
WriteAcquire/ReadAcquire over mutable plasma buffers) — the data plane of
compiled DAGs. Redesign: a channel is one shm file holding a 128-byte
control block (C++11 atomics driven by ray_tpu_torch/_native/channel.cc — the
seqlock protocol Python cannot express) plus a payload region. A writer
publishes versioned values; up to 8 readers consume them with per-reader
ack counters, giving the reference's depth-1 lossless queue: write N+1
blocks until every reader acked N.

A pure-Python fallback (struct-packed control words, polling) keeps the
API alive without the native toolchain; aligned 8-byte stores are atomic
on every platform the port runs on (x86-64, aarch64), so the fallback is
safe if slower.

A ``torch.Tensor`` rides a channel as one host buffer inside the payload
(``core/serialization.py``'s reducer) and lands on ``cuda`` when the
reader's process sees a card, as through the object store. Channel files
are ``/dev/shm/rtpt-chan-*`` (the JAX package's ``rtpu-chan-*``).

Channels are NODE-LOCAL (same shm namespace). Cross-node pipelines go
through ``RemoteChannelRelay`` (a tiny actor that forwards versions over
the existing RPC plane) — the analogue of the reference raylet's
HandlePushMutableObject cross-node push.
"""

from __future__ import annotations

import ctypes
import mmap
import os
import struct
import time
import uuid
from dataclasses import dataclass
from typing import Any, List, Optional

from ray_tpu_torch.core import serialization
from ray_tpu_torch.utils.logging import get_logger

logger = get_logger("channel")

_HDR = 128
# control-block layout (must match channel.cc): seq@0, len@8, acks[8]@16,
# closed@80 — all u64 little-endian
_OFF_SEQ, _OFF_LEN, _OFF_ACKS, _OFF_CLOSED = 0, 8, 16, 80


class ChannelError(RuntimeError):
    pass


class ChannelClosed(ChannelError):
    pass


class ChannelTimeout(ChannelError, TimeoutError):
    pass


@dataclass
class ChannelHandle:
    """Serializable address of a channel (pass to actors as a task arg)."""

    path: str
    capacity: int
    num_readers: int
    node_id: str = ""


def _native_lib():
    try:
        from ray_tpu_torch import _native

        return _native.lib() if _native.available() else None
    except Exception:  # noqa: BLE001
        return None


class _PyOps:
    """Fallback seqlock ops over the mapped control block (struct-based)."""

    @staticmethod
    def _get(mm, off):
        return struct.unpack_from("<Q", mm, off)[0]

    @staticmethod
    def _set(mm, off, v):
        struct.pack_into("<Q", mm, off, v)

    @classmethod
    def init(cls, mm):
        mm[:_HDR] = b"\x00" * _HDR

    @classmethod
    def write_acquire(cls, mm, wait_readers, timeout_ms):
        deadline = time.monotonic() + timeout_ms / 1000.0
        seq = cls._get(mm, _OFF_SEQ)
        current = seq // 2
        if wait_readers > 0 and current > 0:
            while True:
                if all(cls._get(mm, _OFF_ACKS + 8 * r) >= current
                       for r in range(min(wait_readers, 8))):
                    break
                if cls._get(mm, _OFF_CLOSED):
                    return -2
                if time.monotonic() > deadline:
                    return -1
                time.sleep(0.00005)
        if cls._get(mm, _OFF_CLOSED):
            return -2
        cls._set(mm, _OFF_SEQ, seq + 1)
        return current + 1

    @classmethod
    def write_release(cls, mm, length):
        cls._set(mm, _OFF_LEN, length)
        cls._set(mm, _OFF_SEQ, cls._get(mm, _OFF_SEQ) + 1)

    @classmethod
    def read_acquire(cls, mm, last_version, timeout_ms):
        deadline = time.monotonic() + timeout_ms / 1000.0
        while True:
            seq = cls._get(mm, _OFF_SEQ)
            if seq % 2 == 0 and seq // 2 > last_version:
                return seq // 2, cls._get(mm, _OFF_LEN)
            if cls._get(mm, _OFF_CLOSED):
                return -2, 0
            if time.monotonic() > deadline:
                return -1, 0
            time.sleep(0.00005)

    @classmethod
    def read_validate(cls, mm, version):
        seq = cls._get(mm, _OFF_SEQ)
        return seq % 2 == 0 and seq // 2 == version

    @classmethod
    def read_ack(cls, mm, slot, version):
        cls._set(mm, _OFF_ACKS + 8 * slot, version)

    @classmethod
    def close(cls, mm):
        cls._set(mm, _OFF_CLOSED, 1)

    @classmethod
    def is_closed(cls, mm):
        return bool(cls._get(mm, _OFF_CLOSED))


class Channel:
    """Single-writer, N-reader versioned shm channel.

    Create on the writer side with ``Channel.create(...)``; ship
    ``chan.handle`` to readers; each reader opens ``Channel.open(handle,
    reader_slot=i)``.
    """

    def __init__(self, handle: ChannelHandle, create: bool,
                 reader_slot: Optional[int] = None):
        self.handle = handle
        self.reader_slot = reader_slot
        self._last_read = 0
        flags = os.O_RDWR | (os.O_CREAT | os.O_EXCL if create else 0)
        fd = os.open(handle.path, flags, 0o600)
        try:
            if create:
                os.ftruncate(fd, _HDR + handle.capacity)
            self._mm = mmap.mmap(fd, _HDR + handle.capacity)
        finally:
            os.close(fd)
        self._lib = _native_lib()
        if self._lib is not None:
            self._cbuf = ctypes.c_char.from_buffer(self._mm)
            self._base = ctypes.addressof(self._cbuf)
        if create:
            if self._lib is not None:
                self._lib.rtpu_chan_init(self._base)
            else:
                _PyOps.init(self._mm)

    # ------------------------------------------------------------- factory
    @classmethod
    def create(cls, capacity: int = 8 << 20, num_readers: int = 1,
               name: Optional[str] = None) -> "Channel":
        if not 1 <= num_readers <= 8:
            raise ValueError("num_readers must be in [1, 8]")
        path = os.path.join(
            "/dev/shm", name or f"rtpt-chan-{uuid.uuid4().hex[:16]}")
        node_id = ""
        try:
            from ray_tpu_torch.core.worker import global_worker

            w = global_worker()
            node_id = getattr(getattr(w, "runtime", None), "node_hex", "") or ""
        except Exception:  # noqa: BLE001 - outside a runtime
            pass
        h = ChannelHandle(path=path, capacity=capacity,
                          num_readers=num_readers, node_id=node_id)
        return cls(h, create=True)

    @classmethod
    def open(cls, handle: ChannelHandle, reader_slot: int = 0) -> "Channel":
        if not os.path.exists(handle.path):
            raise ChannelError(
                f"channel {handle.path} not on this node"
                + (f" (created on node {handle.node_id[:8]}; use "
                   f"RemoteChannelRelay for cross-node pipelines)"
                   if handle.node_id else "")
            )
        return cls(handle, create=False, reader_slot=reader_slot)

    # -------------------------------------------------------------- writer
    def write(self, value: Any, timeout_s: float = 30.0) -> int:
        """Publish a new version (blocks until all readers acked the
        previous one — depth-1 lossless queue). Returns the version."""
        payload, refs = serialization.pack(value)
        if refs:
            raise ChannelError(
                "ObjectRefs cannot ride a mutable channel (no ownership "
                "transfer); pass plain data or use task args"
            )
        return self.write_bytes(bytes(payload), timeout_s)

    def write_bytes(self, payload: bytes, timeout_s: float = 30.0) -> int:
        if len(payload) > self.handle.capacity:
            raise ChannelError(
                f"payload {len(payload)}B exceeds channel capacity "
                f"{self.handle.capacity}B"
            )
        if self._lib is not None:
            v = self._lib.rtpu_chan_write_acquire(
                self._base, self.handle.num_readers, int(timeout_s * 1000))
        else:
            v = _PyOps.write_acquire(self._mm, self.handle.num_readers,
                                     int(timeout_s * 1000))
        if v == -2:
            raise ChannelClosed("channel closed")
        if v == -1:
            raise ChannelTimeout(
                f"write_acquire: readers did not consume within {timeout_s}s")
        self._mm[_HDR:_HDR + len(payload)] = payload
        if self._lib is not None:
            self._lib.rtpu_chan_write_release(self._base, len(payload))
        else:
            _PyOps.write_release(self._mm, len(payload))
        return int(v)

    # -------------------------------------------------------------- reader
    def read(self, timeout_s: float = 30.0) -> Any:
        version, data = self.read_bytes(timeout_s)
        return serialization.unpack(data, zero_copy=False)

    def read_bytes(self, timeout_s: float = 30.0) -> tuple:
        """Block for the next version after the last one this reader saw.
        Returns (version, bytes). Raises ChannelClosed at end-of-stream."""
        deadline = time.monotonic() + timeout_s
        while True:
            remaining_ms = max(1, int((deadline - time.monotonic()) * 1000))
            if self._lib is not None:
                ln = ctypes.c_uint64()
                v = self._lib.rtpu_chan_read_acquire(
                    self._base, self._last_read, ctypes.byref(ln), remaining_ms)
                length = ln.value
            else:
                v, length = _PyOps.read_acquire(self._mm, self._last_read,
                                                remaining_ms)
            if v == -2:
                raise ChannelClosed("channel closed by writer")
            if v == -1:
                raise ChannelTimeout(f"no new version within {timeout_s}s")
            data = bytes(self._mm[_HDR:_HDR + length])
            ok = (self._lib.rtpu_chan_read_validate(self._base, v)
                  if self._lib is not None
                  else _PyOps.read_validate(self._mm, v))
            if not ok:
                continue  # torn read: writer raced us; retry
            self._last_read = int(v)
            if self.reader_slot is not None:
                if self._lib is not None:
                    self._lib.rtpu_chan_read_ack(self._base, self.reader_slot, v)
                else:
                    _PyOps.read_ack(self._mm, self.reader_slot, int(v))
            return int(v), data

    # ------------------------------------------------------------ lifecycle
    def close(self) -> None:
        """Writer hang-up: readers drain and then see ChannelClosed."""
        try:
            if self._lib is not None:
                self._lib.rtpu_chan_close(self._base)
            else:
                _PyOps.close(self._mm)
        except (ValueError, OSError):
            pass

    def is_closed(self) -> bool:
        if self._lib is not None:
            return bool(self._lib.rtpu_chan_is_closed(self._base))
        return _PyOps.is_closed(self._mm)

    def destroy(self) -> None:
        """Close + release the mapping + unlink the file (creator side)."""
        self.close()
        try:
            if self._lib is not None:
                del self._cbuf  # release the buffer export so mmap can close
            self._mm.close()
        except (BufferError, ValueError):
            pass
        try:
            os.unlink(self.handle.path)
        except OSError:
            pass

    def __reduce__(self):
        raise TypeError(
            "pass chan.handle (ChannelHandle) to other processes, then "
            "Channel.open(handle, reader_slot=...)"
        )
