"""ctypes bindings for the native runtime components (own copy of
ray_tpu._native).

The native layer implements the pieces that stay native in the reference —
the object-store arena allocator (plasma_allocator.cc / dlmalloc.cc) and
the mutable-object channel atomics (experimental_mutable_object_manager.h)
— behind a C ABI, bound with plain ctypes.

The library is built with ``g++`` at first use into ``build/native/`` at
the root of the checkout (listed in ``.gitignore``), never next to the
sources. Its file name carries a hash of the sources and flags, so an
edited source builds a new library and a stale one is never loaded; it is
written under a private name and moved into place with ``os.replace``, so
agents that start together and build at once never load half a file. If
the toolchain is missing the package degrades as the JAX package's does:
``available()`` returns False and pure-Python fallbacks take over
(per-object shm segments; RPC-based channels).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRCS = [os.path.join(_DIR, f) for f in ("arena.cc", "channel.cc")]
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build", "native")
CXX_FLAGS = ["-std=c++17", "-O2", "-fPIC", "-Wall", "-Wextra", "-shared", "-pthread"]

_lib: Optional[ctypes.CDLL] = None
_build_lock = threading.Lock()
_build_failed = False


def library_path() -> str:
    """Where the library built from the current sources lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for src in _SRCS:
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"librtpu_native-{h.hexdigest()[:16]}.so")


def _try_build(force: bool = False) -> bool:
    so = library_path()
    if not force and os.path.exists(so):
        return True
    tmp = f"{so}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        os.makedirs(BUILD_DIR, exist_ok=True)
        out = subprocess.run(
            [os.environ.get("CXX", "g++"), *CXX_FLAGS, *_SRCS, "-o", tmp],
            capture_output=True, text=True, timeout=120,
        )
        if out.returncode != 0 or not os.path.exists(tmp):
            return False
        os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
        return True
    except Exception:  # noqa: BLE001 - missing g++, unwritable build dir etc.
        return False
    finally:
        try:
            os.unlink(tmp)
        except OSError:
            pass


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    if _lib is not None:
        return _lib
    if _build_failed:
        return None
    with _build_lock:
        if _lib is not None:
            return _lib
        if not _try_build():
            _build_failed = True
            return None
        try:
            lib = ctypes.CDLL(library_path())
        except OSError:
            # a stale/foreign-arch .so (e.g. copied checkout): rebuild from
            # source once before giving up on the native backend
            if not _try_build(force=True):
                _build_failed = True
                return None
            try:
                lib = ctypes.CDLL(library_path())
            except OSError:
                _build_failed = True
                return None
        c = ctypes
        # arena
        lib.rtpu_arena_create.argtypes = [c.c_char_p, c.c_uint64]
        lib.rtpu_arena_create.restype = c.c_int64
        lib.rtpu_arena_attach.argtypes = [c.c_char_p]
        lib.rtpu_arena_attach.restype = c.c_int64
        lib.rtpu_arena_base.argtypes = [c.c_int64]
        lib.rtpu_arena_base.restype = c.c_void_p
        lib.rtpu_arena_capacity.argtypes = [c.c_int64]
        lib.rtpu_arena_capacity.restype = c.c_uint64
        lib.rtpu_arena_alloc.argtypes = [c.c_int64, c.c_char_p, c.c_uint64]
        lib.rtpu_arena_alloc.restype = c.c_int64
        lib.rtpu_arena_free.argtypes = [c.c_int64, c.c_uint64]
        lib.rtpu_arena_free.restype = c.c_int
        lib.rtpu_arena_validate.argtypes = [c.c_int64, c.c_char_p, c.c_uint64,
                                            c.c_uint64]
        lib.rtpu_arena_validate.restype = c.c_int
        lib.rtpu_arena_used.argtypes = [c.c_int64]
        lib.rtpu_arena_used.restype = c.c_uint64
        lib.rtpu_arena_num_free_blocks.argtypes = [c.c_int64]
        lib.rtpu_arena_num_free_blocks.restype = c.c_uint64
        lib.rtpu_arena_largest_free.argtypes = [c.c_int64]
        lib.rtpu_arena_largest_free.restype = c.c_uint64
        lib.rtpu_arena_close.argtypes = [c.c_int64]
        lib.rtpu_arena_close.restype = None
        lib.rtpu_arena_unlink.argtypes = [c.c_char_p]
        lib.rtpu_arena_unlink.restype = c.c_int
        # channel
        lib.rtpu_chan_header_size.argtypes = []
        lib.rtpu_chan_header_size.restype = c.c_uint64
        lib.rtpu_chan_init.argtypes = [c.c_void_p]
        lib.rtpu_chan_init.restype = None
        lib.rtpu_chan_write_acquire.argtypes = [c.c_void_p, c.c_int, c.c_uint64]
        lib.rtpu_chan_write_acquire.restype = c.c_int64
        lib.rtpu_chan_write_release.argtypes = [c.c_void_p, c.c_uint64]
        lib.rtpu_chan_write_release.restype = None
        lib.rtpu_chan_read_acquire.argtypes = [c.c_void_p, c.c_uint64,
                                               c.POINTER(c.c_uint64), c.c_uint64]
        lib.rtpu_chan_read_acquire.restype = c.c_int64
        lib.rtpu_chan_read_validate.argtypes = [c.c_void_p, c.c_uint64]
        lib.rtpu_chan_read_validate.restype = c.c_int
        lib.rtpu_chan_read_ack.argtypes = [c.c_void_p, c.c_int, c.c_uint64]
        lib.rtpu_chan_read_ack.restype = None
        lib.rtpu_chan_close.argtypes = [c.c_void_p]
        lib.rtpu_chan_close.restype = None
        lib.rtpu_chan_is_closed.argtypes = [c.c_void_p]
        lib.rtpu_chan_is_closed.restype = c.c_int
        lib.rtpu_chan_version.argtypes = [c.c_void_p]
        lib.rtpu_chan_version.restype = c.c_uint64
        _lib = lib
        return _lib


def available() -> bool:
    """True if the native library is (or can be) loaded."""
    return _load() is not None


def lib() -> ctypes.CDLL:
    l = _load()
    if l is None:
        raise RuntimeError(
            "the native library is unavailable (no g++?); use the "
            "pure-Python fallbacks"
        )
    return l


class Arena:
    """Owner-side (allocating) or attached (read/write) view of one arena."""

    def __init__(self, path: str, capacity: Optional[int] = None,
                 create: bool = False):
        self._lib = lib()
        self.path = path
        if create:
            assert capacity is not None
            self._h = self._lib.rtpu_arena_create(path.encode(), capacity)
        else:
            self._h = self._lib.rtpu_arena_attach(path.encode())
        if self._h < 0:
            raise OSError(f"arena {'create' if create else 'attach'} failed: {path}")
        self.owner = create
        self.capacity = self._lib.rtpu_arena_capacity(self._h)
        base = self._lib.rtpu_arena_base(self._h)
        # one zero-copy view over the whole arena; object views are slices
        self._buf = (ctypes.c_char * self.capacity).from_address(base)
        self.view: memoryview = memoryview(self._buf).cast("B")

    # ---- owner ops --------------------------------------------------------
    def alloc(self, oid24: bytes, size: int) -> int:
        """Returns the payload offset, or -1 if no block fits."""
        return self._lib.rtpu_arena_alloc(self._h, oid24, size)

    def free(self, offset: int) -> bool:
        return self._lib.rtpu_arena_free(self._h, offset) == 0

    def used(self) -> int:
        return self._lib.rtpu_arena_used(self._h)

    def largest_free(self) -> int:
        return self._lib.rtpu_arena_largest_free(self._h)

    def num_free_blocks(self) -> int:
        return self._lib.rtpu_arena_num_free_blocks(self._h)

    # ---- shared ops -------------------------------------------------------
    def validate(self, oid24: bytes, offset: int, size: int) -> bool:
        return self._lib.rtpu_arena_validate(self._h, oid24, offset, size) == 1

    def slice(self, offset: int, size: int) -> memoryview:
        return self.view[offset : offset + size]

    def close(self) -> None:
        if self._h >= 0:
            try:
                self.view.release()
            except BufferError:
                # live views still alias the mapping: munmap would turn their
                # next access into SIGSEGV. Leak the mapping instead (the OS
                # reclaims at process exit) — mirror of ShmSegment.close.
                self._h = -1
                return
            self._lib.rtpu_arena_close(self._h)
            self._h = -1

    def unlink(self) -> None:
        self._lib.rtpu_arena_unlink(self.path.encode())
