"""Agent transfer plane: zero-copy pipelined object-byte movement.

Reference capability: src/ray/object_manager/ (object_manager.h:117 —
PullManager/PushManager with 64MB chunks over dedicated transfer streams).
This module owns the agent side of the raw-frame data plane (rpc.py RAW
frames):

- ``TransferManager.pull``: a real PullManager — windowed pipelined chunk
  requests (``transfer_window_chunks`` in flight per source instead of one
  serial await-per-chunk), STRIPED across every GCS-known holder
  (work-stealing: each source's fetchers pop chunk ranges off one shared
  queue, so a fast source naturally carries more), mid-object FAILOVER that
  resumes from the chunks already landed instead of restarting, and a
  global in-flight-bytes budget shared by every transfer on the node.
- ``TransferManager.open_ingest``: the receive side for pushes and
  streaming driver puts — ONE cached ShmWriter per in-flight ingest keyed
  by object id (not one per chunk), chunk payloads received socket->arena
  with no intermediate buffer, sealed + GCS-registered when all bytes land.
- per-transfer stats (bytes/s, stripe sources, stalls, retries, failovers,
  resumes) served through ``rpc_transfer_stats`` and the agent's metrics.
"""

from __future__ import annotations

import asyncio
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.core.config import config
from ray_tpu_torch.core.ids import ObjectID
from ray_tpu_torch.core.rpc import RpcConnectionError, RpcError, spawn
from ray_tpu_torch.core.shm_store import ShmWriter
from ray_tpu_torch.utils.logging import get_logger

logger = get_logger("transfer")


def stripe_enabled() -> bool:
    return config.pull_stripe_enabled


def attempt_timeout(attempt: int) -> float:
    """Per-attempt deadline for one chunk transfer: short first (a chaos/
    network-dropped frame costs seconds, not transfer_chunk_timeout_s),
    doubling per retry so a legitimately slow link still gets the full
    window before the chunk fails over."""
    base = max(2.0, 2 * config.rpc_retry_attempt_timeout_s)
    return float(min(config.transfer_chunk_timeout_s,
                     base * (2 ** max(0, attempt))))


class _ByteBudget:
    """Global in-flight transfer byte budget (backpressure): chunk requests
    wait here instead of over-committing memory/network. A single request
    larger than the cap is still admitted when nothing else is in flight."""

    def __init__(self, cap: int):
        self.cap = max(1, int(cap))
        self.used = 0
        self._cond = asyncio.Condition()

    async def acquire(self, n: int) -> bool:
        """Returns True if the acquire had to WAIT (a stall)."""
        stalled = False
        async with self._cond:
            while self.used > 0 and self.used + n > self.cap:
                stalled = True
                await self._cond.wait()
            self.used += n
        return stalled

    async def release(self, n: int) -> None:
        async with self._cond:
            self.used -= n
            self._cond.notify_all()


class _Ingest:
    """One in-flight chunked ingest (push/stream-put receive side): the
    ShmWriter is created ONCE and cached for the whole transfer."""

    __slots__ = ("writer", "total", "done", "is_error", "owner", "contained",
                 "last_active")

    def __init__(self, writer: ShmWriter, total: int):
        self.writer = writer
        self.total = total
        self.done: Dict[int, int] = {}  # offset -> bytes landed there
        self.is_error = False
        self.owner = ""
        self.contained: Optional[List[str]] = None
        self.last_active = time.monotonic()

    def received(self) -> int:
        return sum(self.done.values())


class _PullState:
    """Resumable progress of one in-flight (or interrupted) pull."""

    __slots__ = ("size", "writer", "work", "done_bytes", "fetched_bytes",
                 "meta", "failed_sources", "sources_used", "started",
                 "last_active", "resumed")

    def __init__(self, size: int, writer: ShmWriter, work: "deque"):
        self.size = size
        self.writer = writer
        self.work = work                 # deque[(offset, length)] still needed
        self.done_bytes = 0
        self.fetched_bytes = 0           # includes re-fetched tails
        self.meta: Optional[Dict[str, Any]] = None
        self.failed_sources: set = set()
        self.sources_used: set = set()
        self.started = time.monotonic()
        self.last_active = time.monotonic()
        self.resumed = False


class _RegistrationBatcher:
    """Coalesces GCS registrations of pulled/ingested objects into batched
    ``register_objects`` RPCs (one per ``transfer_register_batch_ms``
    window). A shuffle reduce landing its N-block partition set registers
    the whole set in one control frame instead of N round trips. Callers
    still await completion — semantics match the per-object RPC exactly,
    only the framing is shared."""

    def __init__(self, agent) -> None:
        self.agent = agent
        self._pending: List[Dict[str, Any]] = []
        self._waiters: List[asyncio.Future] = []
        self._wake: Optional[asyncio.Event] = None
        self._drainer: Optional[asyncio.Task] = None
        self.batches_sent = 0

    async def register(self, **reg: Any) -> None:
        fut = asyncio.get_event_loop().create_future()
        self._pending.append(reg)
        self._waiters.append(fut)
        # ONE persistent drainer per agent, started lazily and never exited:
        # a spawn-per-batch flusher has an orphan window (a registration
        # landing while the previous batch's GCS call is in flight would
        # wait for a flush nobody schedules, wedging its pull forever)
        if self._wake is None:
            self._wake = asyncio.Event()
        if self._drainer is None or self._drainer.done():
            self._drainer = spawn(self._drain_loop())
        self._wake.set()
        await fut

    async def _drain_loop(self) -> None:
        while True:
            await self._wake.wait()
            self._wake.clear()
            await asyncio.sleep(
                max(0.0, config.transfer_register_batch_ms / 1000.0))
            pending, waiters = self._pending, self._waiters
            self._pending, self._waiters = [], []
            if not pending:
                continue
            self.batches_sent += 1
            parked_until: Optional[float] = None
            while True:
                try:
                    await self.agent.gcs.call("register_objects", regs=pending)
                    for fut in waiters:
                        if not fut.done():
                            fut.set_result(True)
                    break
                except (RpcConnectionError, TimeoutError) as e:
                    # GCS restarted mid-drain: PARK the batch and re-send
                    # against the new incarnation instead of failing every
                    # waiter's pull/ingest (register_objects is idempotent,
                    # so an ambiguous timeout re-send is harmless)
                    from ray_tpu_torch.core.config import gcs_recovery_enabled

                    if not gcs_recovery_enabled():
                        self._fail_waiters(waiters, e)
                        break
                    now = time.monotonic()
                    if parked_until is None:
                        parked_until = now + config.recovery_park_timeout_s
                        logger.warning(
                            "transfer registration batch parked across GCS "
                            "outage (%d objects)", len(pending))
                    if now >= parked_until:
                        self._fail_waiters(waiters, e)
                        break
                    await asyncio.sleep(0.2)
                except BaseException as e:  # noqa: BLE001 - fan the failure out
                    self._fail_waiters(waiters, e)
                    break

    @staticmethod
    def _fail_waiters(waiters: List[asyncio.Future], e: BaseException) -> None:
        for fut in waiters:
            if not fut.done():
                fut.set_exception(e)


class TransferManager:
    def __init__(self, agent) -> None:
        self.agent = agent
        self.budget = _ByteBudget(config.transfer_inflight_max_bytes)
        self._ingests: Dict[str, _Ingest] = {}
        self._progress: Dict[str, _PullState] = {}
        self._registrar = _RegistrationBatcher(agent)
        self.stats: Dict[str, Any] = {
            "pulls": 0, "pull_bytes": 0, "pull_failovers": 0,
            "pull_retries": 0, "pull_resumes": 0, "stripe_pulls": 0,
            "stalls": 0, "ingests": 0, "ingest_bytes": 0,
            "chunks_out": 0, "bytes_out": 0,
            "last_pull": {},
        }

    # ------------------------------------------------------------ pull side
    async def pull(self, oid: ObjectID, size: int, locations: List[str],
                   owner_hint: str = "") -> Optional[Dict[str, Any]]:
        """Materialize the object locally by striped, windowed chunk pulls.
        Returns the piggybacked metadata dict ({} if none) on success, None
        on failure (progress is KEPT for a later resume). Callers serialize
        per object via the agent's pull lock."""
        agent = self.agent
        object_id = oid.hex()
        self._sweep_stale()
        st = self._progress.get(object_id)
        if st is not None and st.size != size:
            self._drop_progress(object_id, abort=True)
            st = None
        if st is None:
            state = agent._reserve_idempotent(oid, size)
            if state == "sealed":
                return {}
            arena_off = agent.store.offset(oid)
            try:
                writer = ShmWriter(oid, size, agent.hex, offset=arena_off)
            except FileNotFoundError:
                agent.store.abort(oid)
                return None
            chunk = max(64 * 1024, int(config.fetch_chunk_bytes))
            work = deque((off, min(chunk, size - off), 0)
                         for off in range(0, size, chunk))
            if not work:
                work.append((0, 0, 0))  # zero-size: one empty chunk (meta)
            st = _PullState(size, writer, work)
            self._progress[object_id] = st
        else:
            st.resumed = True
            st.failed_sources.clear()  # a new attempt may retry old sources
            self.stats["pull_resumes"] += 1
        ok = await self._run_pull(object_id, st, locations)
        if not ok:
            st.last_active = time.monotonic()
            return None  # progress retained: the next attempt resumes
        try:
            st.writer.seal()
            agent.store.seal(oid)
        except FileNotFoundError:
            self._drop_progress(object_id, abort=True)
            return None
        meta = st.meta or {}
        owner = meta.get("owner") or owner_hint or ""
        contained = meta.get("contained") or None
        if meta.get("is_error"):
            agent.error_objects.add(object_id)
        agent._remember_meta(object_id, owner, contained)
        # the meta rode the first chunk reply, so the pull costs exactly its
        # data frames — no post-transfer object_info round trip; the
        # registration itself coalesces with sibling pulls into one batched
        # RPC (partition-set pulls register as a set)
        await self._registrar.register(
            object_id=object_id, size=size,
            node_id=agent.hex, owner=owner, contained=contained,
        )
        dt = max(1e-9, time.monotonic() - st.started)
        self.stats["pulls"] += 1
        self.stats["pull_bytes"] += size
        if len(st.sources_used) > 1:
            self.stats["stripe_pulls"] += 1
        self.stats["last_pull"] = {
            "object": object_id[:16], "bytes": size,
            "seconds": round(dt, 4), "mbps": round(size / dt / 1e6, 2),
            "sources": sorted(s[:8] for s in st.sources_used),
            "resumed": st.resumed,
            "refetched_bytes": max(0, st.fetched_bytes - size),
        }
        self._drop_progress(object_id, abort=False)
        return meta

    async def _run_pull(self, object_id: str, st: _PullState,
                        locations: List[str]) -> bool:
        """Rounds of striped fetching until the work queue drains or no
        sources remain. Each round fans ``transfer_window_chunks`` fetchers
        out per source, all popping the shared queue."""
        agent = self.agent
        sources = [n for n in locations
                   if n != agent.hex and n not in st.failed_sources]
        for _round in range(max(3, config.object_transfer_retries)):
            if not st.work and not self._missing(st):
                return True
            if not sources:
                sources = await self._refresh_sources(object_id, st)
                if not sources:
                    return False
            if not stripe_enabled():
                active = sources[:1]
            else:
                active = sources[:max(1, int(config.transfer_max_sources))]
            window = max(1, int(config.transfer_window_chunks))
            before = st.done_bytes
            await asyncio.gather(*(
                self._source_worker(object_id, st, node, window)
                for node in active
            ))
            sources = [n for n in sources if n not in st.failed_sources]
            if not st.work and not self._missing(st):
                return True
            if st.done_bytes == before and not sources:
                # zero progress and every source burned: refresh or give up
                sources = await self._refresh_sources(object_id, st)
                if not sources:
                    return False
        return not st.work and not self._missing(st)

    @staticmethod
    def _missing(st: _PullState) -> bool:
        return st.done_bytes < st.size

    async def _refresh_sources(self, object_id: str,
                               st: _PullState) -> List[str]:
        """Mid-pull holder refresh from the GCS (failover beyond the holder
        list the pull started with — e.g. a broadcast landed new replicas)."""
        try:
            rec = await self.agent.gcs.call("lookup_object",
                                            object_id=object_id, timeout=10.0)
        except (RpcError, RpcConnectionError, TimeoutError, OSError):
            return []
        if not rec or not rec.get("locations"):
            return []
        return [n for n in rec["locations"]
                if n != self.agent.hex and n not in st.failed_sources]

    async def _source_worker(self, object_id: str, st: _PullState,
                             node_id: str, window: int) -> None:
        client = await self.agent._transfer_peer(node_id)
        if client is None:
            st.failed_sources.add(node_id)
            return
        dead = [False]  # shared flag: first fetcher failure stops siblings
        await asyncio.gather(*(
            self._fetcher(object_id, st, node_id, client, dead)
            for _ in range(window)
        ))

    async def _fetcher(self, object_id: str, st: _PullState, node_id: str,
                       client, dead: List[bool]) -> None:
        while st.work and not dead[0]:
            off, ln, attempts = st.work.popleft()
            want_meta = st.meta is None
            if await self.budget.acquire(ln):
                self.stats["stalls"] += 1
            try:
                res = await client.call_raw(
                    "read_chunk_raw",
                    self._make_sink(st, off, ln),
                    timeout=attempt_timeout(attempts),
                    object_id=object_id, offset=off, length=ln,
                    want_meta=want_meta,
                )
            except TimeoutError:
                # likely a dropped frame, not a dead source: re-request with
                # a doubled window (any source may pick it up) before giving
                # up on this source
                self.stats["pull_retries"] += 1
                st.work.append((off, ln, attempts + 1))
                if attempts + 1 >= 3 and not dead[0]:
                    dead[0] = True
                    st.failed_sources.add(node_id)
                    self.stats["pull_failovers"] += 1
                    logger.warning(
                        "pull of %s: source %s timed out repeatedly; "
                        "failing over with %d/%d bytes landed",
                        object_id[:16], node_id[:8], st.done_bytes, st.size)
                    return
                continue
            except (RpcError, RpcConnectionError, OSError) as e:
                # this source is out (died, or evicted the object): hand the
                # chunk back and fail over — chunks already landed are NEVER
                # re-fetched
                st.work.appendleft((off, ln, 0))
                if not dead[0]:
                    dead[0] = True
                    st.failed_sources.add(node_id)
                    self.stats["pull_failovers"] += 1
                    logger.warning("pull of %s: source %s failed mid-object "
                                   "(%s); failing over with %d/%d bytes "
                                   "landed", object_id[:16], node_id[:8], e,
                                   st.done_bytes, st.size)
                return
            finally:
                await self.budget.release(ln)
            got = int(res.get("nbytes", 0))
            meta = res.get("meta") or {}
            if st.meta is None and meta.get("has_meta"):
                st.meta = meta
            st.sources_used.add(node_id)
            st.done_bytes += got
            st.fetched_bytes += got
            st.last_active = time.monotonic()
            if got < ln:
                # short chunk (chaos truncation / bounded sender): resume
                # from the exact received offset, possibly on another source
                self.stats["pull_retries"] += 1
                st.work.append((off + got, ln - got, 0))

    def _make_sink(self, st: _PullState, off: int, ln: int):
        writer = st.writer

        def sink(meta, nbytes: int) -> Optional[memoryview]:
            if nbytes == 0 or nbytes > ln:
                return None  # empty or protocol violation: drain
            try:
                return writer.buffer[off:off + nbytes]
            except FileNotFoundError:
                return None  # reservation aborted under us: discard

        return sink

    def _drop_progress(self, object_id: str, abort: bool) -> None:
        st = self._progress.pop(object_id, None)
        if st is not None and abort:
            try:
                self.agent.store.abort(ObjectID.from_hex(object_id))
            except Exception:  # noqa: BLE001
                pass

    # ---------------------------------------------------------- ingest side
    async def open_ingest(self, payload_len: int = 0, object_id: str = "",
                          total_size: int = 0, offset: int = 0,
                          is_error: bool = False, owner: str = "",
                          contained: Optional[List[str]] = None) -> Tuple:
        """Raw-frame ingest handler (rpc.register_raw contract): returns
        (sink, finish). The ShmWriter is cached per in-flight object — the
        old path built a fresh writer (attach + validate) for EVERY chunk."""
        agent = self.agent
        oid = ObjectID.from_hex(object_id)
        self._sweep_stale()
        if agent.store.contains(oid):
            return None, self._finish_const({"ok": True, "existing": "sealed"})
        ing = self._ingests.get(object_id)
        if ing is None:
            state = agent._reserve_idempotent(oid, total_size)
            if state == "sealed":
                return None, self._finish_const(
                    {"ok": True, "existing": "sealed"})
            arena_off = agent.store.offset(oid)
            if arena_off is None and agent.store.backend == "arena":
                raise KeyError(f"arena slot for {object_id[:16]} lost mid-push")
            writer = ShmWriter(oid, total_size, agent.hex, offset=arena_off)
            ing = _Ingest(writer, total_size)
            if offset > 0:
                if state == "reserved":
                    # continuation of an ingest whose cached state was lost
                    # (agent restart in-place / sweep) onto a surviving
                    # reservation: the pusher streams in order, so bytes
                    # before `offset` already landed
                    ing.done[0] = offset
                else:
                    # fresh reservation mid-stream: earlier bytes are GONE —
                    # fail loudly, never seal a hole-y object
                    agent.store.abort(oid)
                    raise KeyError(
                        f"ingest state for {object_id[:16]} vanished mid-push")
            self._ingests[object_id] = ing
            self.stats["ingests"] += 1
        if ing.total != total_size:
            raise KeyError(f"size mismatch mid-push for {object_id[:16]}")
        if is_error:
            ing.is_error = True
        if owner:
            ing.owner = owner
        if contained:
            ing.contained = list(contained)
        ing.last_active = time.monotonic()
        sink = ing.writer.buffer[offset:offset + payload_len] \
            if payload_len else None

        async def finish(nbytes: int) -> Dict[str, Any]:
            ing.done[offset] = max(ing.done.get(offset, 0), int(nbytes))
            ing.last_active = time.monotonic()
            self.stats["ingest_bytes"] += int(nbytes)
            if ing.received() >= ing.total:
                return await self._seal_ingest(object_id, ing)
            return {"ok": True}

        return sink, finish

    @staticmethod
    def _finish_const(result: Dict[str, Any]):
        async def finish(_nbytes: int) -> Dict[str, Any]:
            return result

        return finish

    async def _seal_ingest(self, object_id: str, ing: _Ingest) -> Dict[str, Any]:
        agent = self.agent
        oid = ObjectID.from_hex(object_id)
        ing.writer.seal()
        agent.store.seal(oid)
        self._ingests.pop(object_id, None)
        if ing.is_error:
            agent.error_objects.add(object_id)
        agent._remember_meta(object_id, ing.owner, ing.contained)
        await self._registrar.register(
            object_id=object_id, size=ing.total,
            node_id=agent.hex, owner=ing.owner,
            contained=ing.contained or None,
        )
        return {"ok": True, "complete": True}

    # ------------------------------------------------------------- plumbing
    def _sweep_stale(self) -> None:
        """Abort ingests/pull progress idle past the deadline (dead pusher /
        abandoned pull): their reservations would otherwise pin arena bytes
        forever."""
        idle = max(1.0, config.transfer_ingest_idle_s)
        now = time.monotonic()
        for object_id, ing in list(self._ingests.items()):
            if now - ing.last_active > idle:
                self._ingests.pop(object_id, None)
                try:
                    self.agent.store.abort(ObjectID.from_hex(object_id))
                except Exception:  # noqa: BLE001
                    pass
                logger.warning("swept stale ingest of %s (%d/%d bytes)",
                               object_id[:16], ing.received(), ing.total)
        for object_id, st in list(self._progress.items()):
            if now - st.last_active > idle:
                self._drop_progress(object_id, abort=True)
                logger.warning("swept stale pull progress of %s",
                               object_id[:16])

    def snapshot(self) -> Dict[str, Any]:
        out = dict(self.stats)
        out["inflight_bytes"] = self.budget.used
        out["open_ingests"] = len(self._ingests)
        out["partial_pulls"] = len(self._progress)
        out["register_batches"] = self._registrar.batches_sent
        return out
