"""The port's native arena allocator and arena-backed object store
(``ray_tpu_torch._native``, ``ray_tpu_torch.core.shm_store``) held against
the JAX package's (``ray_tpu._native``, ``ray_tpu.core.shm_store``).

Each scenario of ``tests/test_native_store.py`` runs on each package in
turn with that test's own assertions; the allocator cases also require the
two packages to hand out the same offsets for the same calls. Port-only
cases: the library is built from the repo's sources into ``build/native/``
under a name that hashes them, and the port's ``/dev/shm`` files carry
their own prefix, which the JAX package's janitor never touches.
"""

import ctypes
import importlib
import mmap
import multiprocessing as mp
import os
import uuid

import pytest

import ray_tpu_torch

PACKAGES = ("ray_tpu", "ray_tpu_torch")


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


@pytest.fixture(params=PACKAGES)
def pkg(request):
    native = _mod(request.param, "_native")
    if not native.available():
        pytest.fail(f"{request.param}._native did not build (g++ missing?)")
    return request.param


def _arena(pkg, path):
    return _mod(pkg, "_native").Arena(str(path), capacity=1 << 20, create=True)


@pytest.fixture
def arena(pkg, tmp_path):
    # arenas work on any filesystem; tmp keeps /dev/shm clean under pytest
    a = _arena(pkg, tmp_path / "arena")
    yield a
    a.close()
    try:
        a.unlink()
    except OSError:
        pass


def _oid(i: int) -> bytes:
    return bytes([i]) * 24


# ------------------------------------------------------------- allocator
class TestAllocator:
    def test_alloc_is_aligned_and_validates(self, arena):
        off = arena.alloc(_oid(1), 1000)
        assert off > 0 and off % 64 == 0
        assert arena.validate(_oid(1), off, 1000)
        assert not arena.validate(_oid(2), off, 1000)   # wrong id
        assert not arena.validate(_oid(1), off, 999)    # wrong size

    def test_free_scrubs_header_and_coalesces(self, arena):
        offs = [arena.alloc(_oid(i), 10_000) for i in range(1, 6)]
        assert all(o > 0 for o in offs)
        for o in offs:
            assert arena.free(o)
        assert arena.used() == 0
        assert arena.num_free_blocks() == 1  # fully coalesced
        assert not arena.validate(_oid(1), offs[0], 10_000)  # scrubbed

    def test_first_fit_reuses_freed_hole(self, arena):
        a = arena.alloc(_oid(1), 10_000)
        b = arena.alloc(_oid(2), 10_000)
        assert a > 0 and b > 0
        arena.free(a)
        c = arena.alloc(_oid(3), 5_000)
        assert c == a  # the freed hole is first-fit reused

    def test_exhaustion_returns_minus_one(self, arena):
        assert arena.alloc(_oid(1), (1 << 20)) == -1  # header doesn't fit
        ok = arena.alloc(_oid(1), (1 << 20) - 64)
        assert ok > 0
        assert arena.alloc(_oid(2), 64) == -1

    def test_fragmentation_probe(self, arena):
        offs = [arena.alloc(_oid(i), 100_000) for i in range(1, 9)]
        arena.free(offs[1])
        arena.free(offs[3])
        # two ~100k holes + the arena tail: three disjoint free blocks
        assert arena.num_free_blocks() == 3
        assert arena.largest_free() >= 100_000
        # a 200k allocation cannot fit either hole -> must land in the tail
        tail = arena.alloc(_oid(9), 200_000)
        assert tail > offs[7]

    def test_double_free_rejected(self, arena):
        off = arena.alloc(_oid(1), 128)
        assert arena.free(off)
        assert not arena.free(off)
        assert not arena.free(12345)  # never-allocated offset

    def test_attach_sees_writes(self, pkg, arena, tmp_path):
        off = arena.alloc(_oid(7), 256)
        arena.slice(off, 256)[:] = b"z" * 256
        other = _mod(pkg, "_native").Arena(str(tmp_path / "arena"))
        try:
            assert bytes(other.slice(off, 256)) == b"z" * 256
            assert other.validate(_oid(7), off, 256)
        finally:
            other.close()


def test_allocators_hand_out_the_same_offsets(tmp_path):
    """One sequence of allocations and frees gives the same offsets, usage
    and free-block counts in both packages' arenas."""
    seen = []
    for pkg in PACKAGES:
        a = _arena(pkg, tmp_path / f"arena-{pkg}")
        try:
            offs = [a.alloc(_oid(i), 1000 * i + 7) for i in range(1, 12)]
            for o in offs[1::3]:
                a.free(o)
            offs += [a.alloc(_oid(40 + i), 500 * i) for i in range(1, 6)]
            seen.append((offs, a.used(), a.num_free_blocks(), a.largest_free()))
        finally:
            a.close()
            a.unlink()
    assert seen[0] == seen[1]


# ----------------------------------------------------------- arena store
class TestArenaStore:
    @pytest.fixture
    def store(self, pkg, tmp_path):
        s = _mod(pkg, "core.shm_store").ShmObjectStore(
            # a fresh suffix per store: xdist workers share /dev/shm
            uuid.uuid4().hex[:8], capacity_bytes=1 << 20,
            spill_dir=str(tmp_path / "spill"), backend="arena",
        )
        assert s.backend == "arena"
        yield s
        s.cleanup()

    def _write(self, pkg, store, oid, data: bytes) -> int:
        off = store.reserve(oid, len(data))
        assert off is not None and off > 0
        w = _mod(pkg, "core.shm_store").ShmWriter(oid, len(data), store.node_suffix, offset=off)
        w.buffer[:] = data
        w.seal()
        store.seal(oid)
        return off

    def test_write_read_roundtrip(self, pkg, store):
        oid = _mod(pkg, "core.ids").ObjectID.from_random()
        off = self._write(pkg, store, oid, b"hello arena" * 100)
        r = _mod(pkg, "core.shm_store").ShmReader(oid, 1100, store.node_suffix, offset=off)
        assert bytes(r.buffer) == b"hello arena" * 100
        assert store.offset(oid) == off

    def test_evicted_slot_fails_validation(self, pkg, store):
        """A reader holding a stale offset must see 'missing', never another
        object's bytes (the in-arena header check)."""
        ObjectID = _mod(pkg, "core.ids").ObjectID
        oid = ObjectID.from_random()
        off = self._write(pkg, store, oid, b"a" * 600_000)
        # force eviction by filling the store past capacity
        self._write(pkg, store, ObjectID.from_random(), b"b" * 600_000)
        assert store.offset(oid) is None  # spilled (or dropped) under pressure
        with pytest.raises(FileNotFoundError):
            _mod(pkg, "core.shm_store").ShmReader(oid, 600_000, store.node_suffix, offset=off)

    def test_spill_and_restore_reallocates(self, pkg, store):
        ObjectID = _mod(pkg, "core.ids").ObjectID
        oid = ObjectID.from_random()
        payload = os.urandom(600_000)
        self._write(pkg, store, oid, payload)
        self._write(pkg, store, ObjectID.from_random(), b"x" * 600_000)  # evicts oid
        assert store.offset(oid) is None
        size = store.ensure_local(oid)  # restore from disk
        assert size == len(payload)
        off = store.offset(oid)
        assert off is not None
        r = _mod(pkg, "core.shm_store").ShmReader(oid, size, store.node_suffix, offset=off)
        assert bytes(r.buffer) == payload

    def test_delete_frees_arena_space(self, pkg, store):
        oid = _mod(pkg, "core.ids").ObjectID.from_random()
        self._write(pkg, store, oid, b"d" * 10_000)
        assert store.usage()["arena_used"] > 0
        store.delete(oid)
        assert store.usage()["arena_used"] == 0

    def test_usage_reports_backend(self, store):
        u = store.usage()
        assert u["backend"] == "arena"
        assert "arena_largest_free" in u

    def test_abort_quarantines_block_until_grace(self, pkg, store, monkeypatch):
        """An aborted reservation's block must not re-enter circulation
        until the grace period passes (zombie-writer protection)."""
        config = _mod(pkg, "core.config").config
        ObjectID = _mod(pkg, "core.ids").ObjectID
        monkeypatch.setattr(config, "arena_abort_quarantine_s", 60.0)
        oid = ObjectID.from_random()
        off = store.reserve(oid, 1000)
        w = _mod(pkg, "core.shm_store").ShmWriter(oid, 1000, store.node_suffix, offset=off)
        store.abort(oid)
        # the zombie writer fails its seal (header scrubbed at abort) ...
        w.buffer[:] = b"z" * 1000
        with pytest.raises(FileNotFoundError):
            w.seal()
        # ... and a new reservation does NOT land on the quarantined block
        assert store.reserve(ObjectID.from_random(), 1000) != off
        # once the grace period expires, the block is reusable again
        monkeypatch.setattr(config, "arena_abort_quarantine_s", 0.0)
        store._quarantine = [(0.0, off, 1000)]
        assert store.reserve(ObjectID.from_random(), 1000) == off

    def test_read_bytes_detects_mid_copy_eviction(self, pkg, store):
        oid = _mod(pkg, "core.ids").ObjectID.from_random()
        self._write(pkg, store, oid, b"r" * 1000)
        r = _mod(pkg, "core.shm_store").ShmReader(oid, 1000, store.node_suffix,
                                                  offset=store.offset(oid))
        assert r.read_bytes() == b"r" * 1000  # normal path revalidates clean
        store.delete(oid)  # slot freed (header scrubbed) while reader exists
        with pytest.raises(FileNotFoundError):
            r.read_bytes()


# ---------------------------------------------------------------- channel
def _chan_writer(pkg, path, size):
    import ctypes
    import mmap as mmap_mod

    L2 = importlib.import_module(f"{pkg}._native").lib()
    fd = os.open(path, os.O_RDWR)
    m = mmap_mod.mmap(fd, size)
    os.close(fd)
    b = ctypes.addressof(ctypes.c_char.from_buffer(m))
    h = L2.rtpu_chan_header_size()
    for i in range(5):
        v = L2.rtpu_chan_write_acquire(b, 1, 10_000)
        assert v == i + 1
        payload = f"msg-{i}".encode()
        memoryview(m)[h:h + len(payload)] = payload
        L2.rtpu_chan_write_release(b, len(payload))
    L2.rtpu_chan_close(b)


class TestChannel:
    """Seqlock mutable-object channel (channel.cc, built into the same
    library): cross-process versioned acquire/release."""

    @pytest.fixture
    def chan(self, pkg, tmp_path):
        L = _mod(pkg, "_native").lib()
        path = str(tmp_path / "chan")
        size = 4096
        fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o600)
        os.ftruncate(fd, size)
        mm = mmap.mmap(fd, size)
        os.close(fd)
        base = ctypes.addressof(ctypes.c_char.from_buffer(mm))
        L.rtpu_chan_init(base)
        yield L, mm, base, path, size
        del base
        try:
            mm.close()
        except BufferError:
            pass

    def test_write_read_versions(self, chan):
        L, mm, base, _, _ = chan
        hdr = L.rtpu_chan_header_size()
        assert L.rtpu_chan_version(base) == 0
        assert L.rtpu_chan_write_acquire(base, 0, 1000) == 1
        memoryview(mm)[hdr:hdr + 3] = b"abc"
        L.rtpu_chan_write_release(base, 3)
        ln = ctypes.c_uint64()
        assert L.rtpu_chan_read_acquire(base, 0, ctypes.byref(ln), 1000) == 1
        assert ln.value == 3
        assert bytes(memoryview(mm)[hdr:hdr + 3]) == b"abc"
        assert L.rtpu_chan_read_validate(base, 1) == 1

    def test_read_blocks_until_new_version_and_times_out(self, chan):
        L, _, base, _, _ = chan
        ln = ctypes.c_uint64()
        assert L.rtpu_chan_read_acquire(base, 0, ctypes.byref(ln), 50) == -1

    def test_lossless_mode_cross_process(self, pkg, chan):
        """Writer in a spawned process; depth-1 queue: every version
        delivered."""
        L, mm, base, path, size = chan
        hdr = L.rtpu_chan_header_size()
        p = mp.get_context("spawn").Process(target=_chan_writer, args=(pkg, path, size))
        p.start()
        got, last = [], 0
        while True:
            ln = ctypes.c_uint64()
            v = L.rtpu_chan_read_acquire(base, last, ctypes.byref(ln), 15_000)
            if v == -2:
                break
            assert v > 0
            got.append(bytes(memoryview(mm)[hdr:hdr + ln.value]))
            assert L.rtpu_chan_read_validate(base, v)
            L.rtpu_chan_read_ack(base, 0, v)
            last = v
        p.join(timeout=30)
        assert not p.is_alive() and p.exitcode == 0
        assert got == [f"msg-{i}".encode() for i in range(5)]

    def test_close_unblocks_readers(self, chan):
        L, _, base, _, _ = chan
        L.rtpu_chan_close(base)
        ln = ctypes.c_uint64()
        assert L.rtpu_chan_read_acquire(base, 0, ctypes.byref(ln), 5000) == -2
        assert L.rtpu_chan_is_closed(base)


# -------------------------------------------------------------- port only
def test_library_is_built_into_build_native_from_hashed_sources():
    from ray_tpu_torch import _native

    path = _native.library_path()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(ray_tpu_torch.__file__)))
    assert os.path.dirname(path) == os.path.join(repo, "build", "native")
    assert os.path.basename(path).startswith("librtpu_native-")
    assert _native.available() and os.path.exists(path)
    # nothing is built next to the sources
    assert not [f for f in os.listdir(os.path.dirname(_native.__file__)) if f.endswith(".so")]


def test_port_shm_files_have_their_own_prefix():
    """A dead owner's arena of the port is swept by the port's janitor and
    never by the JAX package's, whose files start with another prefix."""
    from ray_tpu.core import shm_store as jax_store
    from ray_tpu_torch.core import shm_store as port_store

    suffix = uuid.uuid4().hex[:8]
    path = port_store.arena_path(suffix)
    assert os.path.basename(path).startswith(port_store.SHM_PREFIX)
    assert not os.path.basename(path).startswith("rtpu-")
    assert os.path.basename(jax_store.arena_path(suffix)).startswith("rtpu-")
    ctx = mp.get_context("spawn")
    dead = ctx.Process(target=int)
    dead.start()
    dead.join(timeout=30)
    with open(path, "wb") as f:
        f.write(b"\0" * 4096)
    port_store.write_arena_pidfile(path, pid=dead.pid)
    try:
        assert path not in jax_store.sweep_dead_arenas()
        assert os.path.exists(path)
        assert path in port_store.sweep_dead_arenas()
        assert not os.path.exists(path) and not os.path.exists(path + ".pid")
    finally:
        for p in (path, path + ".pid"):
            if os.path.exists(p):
                os.unlink(p)
