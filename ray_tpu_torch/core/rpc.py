"""Asyncio RPC layer: length-prefixed msgpack frames over TCP.

Reference capability: src/ray/rpc/ (templated gRPC server/client with call
manager, deadlines, retries) + rpc_chaos.{h,cc} fault injection. Design:

- frame = [u32 little-endian length][msgpack map]
- request:  {"i": id, "m": method, "p": params}
- response: {"i": id, "r": result} | {"i": id, "e": [type, message]}
- push:     {"c": channel, "d": data}   (server -> client pubsub)
- chaos: ``config.rpc_chaos_failure_prob`` drops requests/responses randomly
  (seeded) to exercise retry paths, like the reference's RpcFailure.

Binary values pass through msgpack natively (use_bin_type). Handlers are
``async def handler(**params) -> result``.

RAW frames (the object-byte transfer plane; reference: ObjectManager
multi-stream chunked transfer, object_manager.h:117): a frame whose length
word has the top bit set carries a small msgpack header plus an opaque
payload that never touches msgpack —

- raw frame = [u32 (RAW_FLAG | length)][u16 header_len][msgpack header][payload]
- raw request:  header {"i": id, "m": method, "p": params}; the server routes
  to a handler registered with ``register_raw`` which supplies a writable
  memoryview BEFORE the payload is read, so bytes go socket -> arena slot
  with no intermediate buffer; the reply is a normal msgpack response.
- raw response: a normal handler returns ``RawResult(meta, payload)`` and the
  payload memoryview is written straight from the arena mapping; the client
  issued the call with ``call_raw(method, sink, ...)`` and the sink provides
  the destination buffer the read loop copies the payload into.
- chaos also covers raw frames: requests/responses drop (payload drained to
  keep the stream framed) and responses may be TRUNCATED (frame stays
  consistent, fewer payload bytes than asked) to exercise resume paths.
"""

from __future__ import annotations

import asyncio
import itertools
import random
import struct
import threading
from typing import Any, Awaitable, Callable, Dict, List, Optional, Tuple

import msgpack

from ray_tpu_torch.core.config import config
from ray_tpu_torch.utils.logging import get_logger

logger = get_logger("rpc")

MAX_FRAME = 1 << 31

# Top bit of the length word marks a raw binary frame (header + payload);
# plain frame lengths are capped well below it by rpc_max_message_bytes.
RAW_FLAG = 0x80000000

# Sentinel: "use the configured default deadline". Pass timeout=None for an
# INFINITE deadline (long-running task pushes, blocking gets).
DEFAULT_TIMEOUT = object()


class RawResult:
    """Returned by a handler to answer with a RAW frame: ``payload`` (any
    bytes-like, typically an arena memoryview) is written to the socket
    without msgpack encoding; ``meta`` is the small msgpack header the
    client's sink sees. ``release`` (if set) runs after the frame is written
    — unpin/close whatever kept the payload memory valid."""

    __slots__ = ("meta", "payload", "release")

    def __init__(self, meta: Dict[str, Any], payload, release=None):
        self.meta = meta
        self.payload = payload
        self.release = release


class RpcError(Exception):
    def __init__(self, remote_type: str, message: str):
        self.remote_type = remote_type
        super().__init__(f"{remote_type}: {message}")


class RpcConnectionError(ConnectionError):
    pass


def _pack(obj: Any) -> bytes:
    body = msgpack.packb(obj, use_bin_type=True)
    return struct.pack("<I", len(body)) + body


async def _read_frame(reader: asyncio.StreamReader) -> Any:
    header = await reader.readexactly(4)
    (length,) = struct.unpack("<I", header)
    if length > config.rpc_max_message_bytes:
        raise ValueError(f"frame of {length} bytes exceeds limit")
    body = await reader.readexactly(length)
    return msgpack.unpackb(body, raw=False, strict_map_key=False)


async def _read_raw_header(
    reader: asyncio.StreamReader, length: int
) -> Tuple[Dict[str, Any], int]:
    """After a RAW length word: parse the msgpack header, return it plus the
    number of payload bytes that FOLLOW on the stream (not yet consumed)."""
    (hlen,) = struct.unpack("<H", await reader.readexactly(2))
    header = msgpack.unpackb(await reader.readexactly(hlen), raw=False,
                             strict_map_key=False)
    return header, length - 2 - hlen


async def _read_into(reader: asyncio.StreamReader, view: memoryview,
                     n: int) -> None:
    """Read exactly n bytes from the stream directly into ``view`` (the
    caller-provided destination — an arena slot slice) with no intermediate
    whole-payload buffer."""
    pos = 0
    while pos < n:
        data = await reader.read(n - pos)
        if not data:
            raise asyncio.IncompleteReadError(b"", n - pos)
        view[pos:pos + len(data)] = data
        pos += len(data)


async def _drain_payload(reader: asyncio.StreamReader, n: int) -> None:
    """Consume and discard n payload bytes (unroutable/chaos-dropped raw
    frame): the stream must stay framed."""
    while n > 0:
        data = await reader.read(min(n, 1 << 18))
        if not data:
            raise asyncio.IncompleteReadError(b"", n)
        n -= len(data)


def _pack_raw(header: Dict[str, Any], payload_len: int) -> bytes:
    body = msgpack.packb(header, use_bin_type=True)
    return struct.pack("<IH", RAW_FLAG | (2 + len(body) + payload_len),
                       len(body)) + body


class _Chaos:
    """Seeded fault injector. Beyond request/response drops it also covers
    the pipelined control-plane frames: pushed completion events
    (``should_drop_push``, consulted by RpcServer.publish) and inline result
    payloads (``should_drop_inline``, consulted by the GCS before attaching
    a payload to a sealed event) — so retry/fallback coverage tracks the
    pipelined protocol instead of silently shrinking to the lockstep one."""

    def __init__(self, enabled: bool = True) -> None:
        prob = config.rpc_chaos_failure_prob if enabled else 0.0
        self.prob = prob
        self.rng = random.Random(config.rpc_chaos_seed or None) if prob > 0 else None

    def should_drop(self) -> bool:
        return self.rng is not None and self.rng.random() < self.prob

    # distinct names so call sites read as what they inject; same process
    # (one seeded stream) so runs stay reproducible
    should_drop_push = should_drop
    should_drop_inline = should_drop
    # raw transfer plane: dropped raw requests/responses and TRUNCATED raw
    # payloads (frame consistent, fewer bytes than asked) exercise the pull
    # manager's re-request/failover/resume paths
    should_drop_raw = should_drop
    should_truncate_raw = should_drop


# Methods a client may transparently re-send after a (possibly chaos-induced)
# timeout. Every entry is idempotent on the server: reads, set-semantics
# ref-count updates, re-registrations, and the deduplicated task submit. Calls
# with data-plane side effects that are NOT safely repeatable (run_actor_task
# mutating actor state, dispatch/run_task long-running executions) stay out.
async def loop_lag_watchdog(name: str, period: float = 0.5) -> None:
    """Logs when the event loop stalls (a sleep overshoots badly): stalls
    starve heartbeats and get healthy nodes marked dead. With
    RAY_TPU_STALL_DUMP set, arms faulthandler to dump all thread stacks
    mid-stall (the dump fires only if the loop fails to re-arm in time)."""
    import faulthandler
    import os
    import time

    dump_file = None
    dump_path = os.environ.get("RAY_TPU_STALL_DUMP")
    if dump_path:
        dump_file = open(f"{dump_path}.{name}.{os.getpid()}", "w")  # noqa: SIM115
    while True:
        if dump_file is not None:
            faulthandler.dump_traceback_later(3.0, repeat=False, file=dump_file)
        t0 = time.monotonic()
        await asyncio.sleep(period)
        lag = time.monotonic() - t0 - period
        if lag > 1.0:
            logger.warning("%s event loop stalled %.2fs", name, lag)


_BACKGROUND_TASKS: set = set()


def spawn(coro) -> "asyncio.Task":
    """ensure_future with a STRONG reference held until completion.

    The event loop only weakly references tasks: a fire-and-forget
    ``ensure_future`` result that nobody retains can be garbage-collected
    MID-EXECUTION (observed under a 50k-task load: _submit_with_retries and
    RPC dispatch tasks vanishing, wedging the scheduler with free resources
    and losing RPC replies). Every fire-and-forget in this codebase must go
    through here."""
    t = asyncio.ensure_future(coro)
    _BACKGROUND_TASKS.add(t)
    t.add_done_callback(_BACKGROUND_TASKS.discard)
    return t


RETRY_SAFE_METHODS = frozenset({
    "ping", "get_nodes", "heartbeat", "register_node", "cluster_resources",
    "available_resources", "node_info", "debug_state",
    "next_job_id",  # retry burns an id from the sequence — gaps are fine
    "kv_put", "kv_get", "kv_del", "kv_keys",
    "schedule", "lookup_object", "register_object", "register_objects",
    "pin_tasks",
    "object_info", "object_sizes", "read_chunk", "free_object_everywhere",
    "delete_local_object", "transfer_stats",
    # idempotent ensure/wait/push surface: a dropped frame must cost one
    # attempt window, not the caller's whole deadline (broadcast under 5%
    # chaos burned 125s on one lost ensure_local request, r5)
    "ensure_local", "ensure_local_batch", "wait_objects",
    "wait_object_located", "wait_objects_located", "receive_chunk",
    "push_object",
    # publish_worker_logs: seq-deduplicated at the GCS (exactly-once)
    "publish_worker_logs",
    "add_object_refs", "remove_object_refs", "pin_task", "unpin_tasks",
    "drop_holder",
    "holder_heartbeat", "get_lineage",
    "get_actor", "get_actor_spec", "get_named_actor", "list_named_actors",
    "list_actors", "actor_started", "placement_group_info",
    # create_actor dedupes by driver-supplied actor_id at the GCS (an
    # already-registered id returns True without re-scheduling), so a
    # re-send after an ambiguous timeout or a GCS restart is harmless
    "create_actor",
    "placement_group_table", "reserve_bundle", "return_bundle",
    # create dedupes by pg_id at the GCS (first attempt wins); remove's
    # second attempt no-ops on the already-popped record
    "create_placement_group", "remove_placement_group",
    "create_object", "seal_object", "abort_object", "store_error", "put_object",
    "stream_put", "stream_end", "stream_next", "stream_wait", "stream_close",
    "stream_state",
    "submit_task", "worker_ready", "worker_blocked", "worker_unblocked",
    # submit_task_batch: per-task deduplicated at the agent (same as
    # submit_task), so re-sending a whole batch re-accepts nothing
    "submit_task_batch",
    "__subscribe__",
})


class RpcServer:
    """Serves handler coroutines; also supports pushing to subscribed clients.

    ``chaos=False`` exempts this server from fault injection — used by worker
    processes, whose task/actor-call handlers are not idempotent (the chaos
    tier targets the control plane: GCS + node agents, like the reference's
    rpc_chaos on GCS RPCs)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0, chaos: bool = True):
        self._chaos_enabled = chaos
        self.host = host
        self.port = port
        self._handlers: Dict[str, Callable[..., Awaitable[Any]]] = {}
        # raw ingest handlers: name -> async fn(payload_len=..., **params)
        # returning (sink_view_or_None, finish) — see register_raw
        self._raw_handlers: Dict[str, Callable[..., Awaitable[Any]]] = {}
        self._server: Optional[asyncio.AbstractServer] = None
        # channel -> set of writer
        self._subscribers: Dict[str, set] = {}
        # per-connection write locks: a slow/stalled subscriber must only
        # block its own socket, never other connections' replies
        self._writer_locks: Dict[asyncio.StreamWriter, asyncio.Lock] = {}
        self._chaos = None

    def handler(self, name: str):
        def deco(fn):
            self._handlers[name] = fn
            return fn

        return deco

    def register(self, name: str, fn: Callable[..., Awaitable[Any]]) -> None:
        self._handlers[name] = fn

    def register_raw(self, name: str, open_fn: Callable[..., Awaitable[Any]]) -> None:
        """Register an inbound-raw-frame handler. ``open_fn(payload_len=N,
        **params)`` runs BEFORE the payload is read and returns
        ``(sink, finish)``: ``sink`` is a writable memoryview of >= N bytes
        the payload is received into directly (None = drain/discard), and
        ``await finish(nbytes)`` runs after the payload landed, returning
        the msgpack reply value."""
        self._raw_handlers[name] = open_fn

    def register_object(self, obj: Any, prefix: str = "") -> None:
        """Every ``async def rpc_*`` method becomes a handler."""
        for attr in dir(obj):
            if attr.startswith("rpc_"):
                self._handlers[prefix + attr[4:]] = getattr(obj, attr)

    async def start(self) -> Tuple[str, int]:
        self._chaos = _Chaos(self._chaos_enabled)
        self._server = await asyncio.start_server(self._on_client, self.host, self.port)
        sock = self._server.sockets[0]
        self.host, self.port = sock.getsockname()[:2]
        return self.host, self.port

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            # Actively close live client connections: since 3.12 wait_closed()
            # waits for every handler coroutine, so a connected client that
            # never disconnects would hang a graceful stop forever.
            for w in list(self._writer_locks):
                try:
                    w.close()
                except Exception:  # noqa: BLE001
                    pass
            try:
                await asyncio.wait_for(self._server.wait_closed(), timeout=2.0)
            except (asyncio.TimeoutError, TimeoutError):
                pass

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    async def _on_client(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        self._writer_locks[writer] = asyncio.Lock()
        try:
            while True:
                head = await reader.readexactly(4)
                (word,) = struct.unpack("<I", head)
                if word & RAW_FLAG:
                    # raw frames are consumed INLINE: the payload bytes
                    # follow on this stream and must land in their sink (or
                    # be drained) before the next frame can be parsed
                    await self._handle_raw(word & ~RAW_FLAG, reader, writer)
                    continue
                if word > config.rpc_max_message_bytes:
                    raise ValueError(f"frame of {word} bytes exceeds limit")
                body = await reader.readexactly(word)
                msg = msgpack.unpackb(body, raw=False, strict_map_key=False)
                spawn(self._dispatch(msg, writer))
        except (asyncio.IncompleteReadError, ConnectionResetError, BrokenPipeError):
            pass
        except Exception:
            logger.exception("rpc server: connection handler error")
        finally:
            for subs in self._subscribers.values():
                subs.discard(writer)
            self._writer_locks.pop(writer, None)
            try:
                writer.close()
            except Exception:
                pass

    async def _handle_raw(self, length: int, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter) -> None:
        """One inbound raw frame: parse header, obtain the sink from the
        registered handler, receive the payload straight into it, then run
        the handler's finish step off-loop (reply rides a normal msgpack
        response frame)."""
        header, payload_len = await _read_raw_header(reader, length)
        req_id = header.get("i")
        method = header.get("m", "")
        if self._chaos.should_drop_raw():
            logger.warning("rpc chaos: dropping raw request %s", method)
            await _drain_payload(reader, payload_len)
            return
        fn = self._raw_handlers.get(method)
        if fn is None:
            await _drain_payload(reader, payload_len)
            await self._reply(writer, {"i": req_id,
                                       "e": ["KeyError", f"no raw handler {method!r}"]})
            return
        try:
            sink, finish = await fn(payload_len=payload_len,
                                    **(header.get("p") or {}))
        except Exception as e:  # noqa: BLE001 - serialize handler errors
            await _drain_payload(reader, payload_len)
            await self._reply(writer, {"i": req_id,
                                       "e": [type(e).__name__, str(e)]})
            return
        if sink is None or len(sink) < payload_len:
            # no sink (discard) or an undersized one (malformed offset/len):
            # drain so the stream stays framed either way
            await _drain_payload(reader, payload_len)
            if sink is not None:
                await self._reply(writer, {"i": req_id,
                                           "e": ["ValueError",
                                                 "payload exceeds sink"]})
                return
        else:
            await _read_into(reader, sink, payload_len)
        spawn(self._finish_raw(req_id, finish, payload_len, writer))

    async def _finish_raw(self, req_id, finish, nbytes: int,
                          writer: asyncio.StreamWriter) -> None:
        try:
            result = await finish(nbytes)
            resp = {"i": req_id, "r": result}
        except Exception as e:  # noqa: BLE001
            resp = {"i": req_id, "e": [type(e).__name__, str(e)]}
        if self._chaos.should_drop_raw():
            logger.warning("rpc chaos: dropping raw-ingest response")
            return
        await self._reply(writer, resp)

    async def _dispatch(self, msg: Dict, writer: asyncio.StreamWriter) -> None:
        req_id = msg.get("i")
        method = msg.get("m", "")
        if self._chaos.should_drop():
            logger.warning("rpc chaos: dropping request %s", method)
            return
        if method == "__subscribe__":
            channel = msg["p"]["channel"]
            self._subscribers.setdefault(channel, set()).add(writer)
            await self._reply(writer, {"i": req_id, "r": True})
            return
        if method == "__unsubscribe__":
            channel = msg["p"]["channel"]
            subs = self._subscribers.get(channel)
            if subs is not None:
                subs.discard(writer)
                if not subs:
                    del self._subscribers[channel]
            await self._reply(writer, {"i": req_id, "r": True})
            return
        fn = self._handlers.get(method)
        if fn is None:
            await self._reply(writer, {"i": req_id, "e": ["KeyError", f"no handler {method!r}"]})
            return
        try:
            result = await fn(**(msg.get("p") or {}))
            if isinstance(result, RawResult):
                await self._reply_raw(writer, req_id, result)
                return
            resp = {"i": req_id, "r": result}
        except Exception as e:  # noqa: BLE001 - serialize handler errors to caller
            resp = {"i": req_id, "e": [type(e).__name__, str(e)]}
        if self._chaos.should_drop():
            logger.warning("rpc chaos: dropping response for %s", method)
            return
        await self._reply(writer, resp)

    async def _reply_raw(self, writer: asyncio.StreamWriter, req_id,
                         result: RawResult) -> None:
        """Answer with a raw frame: payload memoryview written straight to
        the transport — no msgpack encode, no bytes() copy. Chaos may drop
        the whole response (caller re-requests the chunk) or truncate the
        payload (frame stays consistent; caller re-requests the tail)."""
        payload = memoryview(result.payload)
        try:
            if self._chaos.should_drop_raw():
                logger.warning("rpc chaos: dropping raw response")
                return
            if len(payload) > 0 and self._chaos.should_truncate_raw():
                logger.warning("rpc chaos: truncating raw response payload")
                payload = payload[: max(1, len(payload) // 2)]
            frame = _pack_raw({"i": req_id, "r": result.meta}, len(payload))
            lock = self._writer_locks.get(writer)
            if lock is None:
                return
            async with lock:
                try:
                    writer.write(frame)
                    if len(payload):
                        writer.write(payload)
                    await writer.drain()
                except (ConnectionResetError, BrokenPipeError):
                    pass
        finally:
            if result.release is not None:
                try:
                    result.release()
                except Exception:  # noqa: BLE001
                    logger.exception("raw-result release failed")

    async def _reply(self, writer: asyncio.StreamWriter, obj: Any) -> None:
        lock = self._writer_locks.get(writer)
        if lock is None:
            return
        async with lock:
            try:
                writer.write(_pack(obj))
                await writer.drain()
            except (ConnectionResetError, BrokenPipeError):
                pass

    def chaos_drop_inline(self) -> bool:
        """Fault injection for inline payloads riding pushed completions:
        True = the caller should strip the payload (the completion itself
        still arrives), exercising the receiver's fallback-read path."""
        return self._chaos is not None and self._chaos.should_drop_inline()

    async def publish(self, channel: str, data: Any) -> None:
        if self._chaos is not None and self._chaos.should_drop_push():
            logger.warning("rpc chaos: dropping push on %s", channel)
            return
        dead = []
        frame = _pack({"c": channel, "d": data})
        for w in list(self._subscribers.get(channel, set())):
            lock = self._writer_locks.get(w)
            if lock is None:
                dead.append(w)
                continue
            async with lock:
                try:
                    # no drain(): a stalled subscriber buffers in its socket
                    # instead of backpressuring the publisher
                    w.write(frame)
                except Exception:  # noqa: BLE001
                    dead.append(w)
        for w in dead:
            self._subscribers.get(channel, set()).discard(w)


class RpcClient:
    """Async client with optional subscription callbacks."""

    def __init__(self, address: str):
        host, port = address.rsplit(":", 1)
        self.host, self.port = host, int(port)
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._pending: Dict[int, asyncio.Future] = {}
        # req_id -> sink callable for in-flight call_raw requests: the read
        # loop hands the raw payload straight into the buffer it returns
        self._raw_sinks: Dict[int, Callable[[Any, int], Optional[memoryview]]] = {}
        self._ids = itertools.count(1)
        self._read_task: Optional[asyncio.Task] = None
        self._sub_callbacks: Dict[str, Callable[[Any], None]] = {}
        # sync callables fired after every successful _reconnect (channels
        # already re-subscribed): the hook point for catch-up work a push
        # channel silently missed during the outage (e.g. sealed events)
        self._reconnect_hooks: List[Callable[[], None]] = []
        self._send_lock: Optional[asyncio.Lock] = None
        self._reconnect_lock: Optional[asyncio.Lock] = None
        self._conn_gen = 0
        self._closed = False
        self._user_closed = False

    async def connect(self, timeout: Optional[float] = None) -> "RpcClient":
        timeout = timeout or config.rpc_connect_timeout_s
        deadline = asyncio.get_event_loop().time() + timeout
        last_err: Optional[Exception] = None
        while asyncio.get_event_loop().time() < deadline:
            try:
                self._reader, self._writer = await asyncio.open_connection(self.host, self.port)
                break
            except OSError as e:
                last_err = e
                await asyncio.sleep(0.05)
        else:
            raise RpcConnectionError(f"cannot connect to {self.host}:{self.port}: {last_err}")
        self._send_lock = asyncio.Lock()
        self._read_task = spawn(self._read_loop())
        return self

    async def _read_loop(self) -> None:
        gen = self._conn_gen
        reader = self._reader
        try:
            while True:
                head = await reader.readexactly(4)
                (word,) = struct.unpack("<I", head)
                if word & RAW_FLAG:
                    await self._on_raw_response(reader, word & ~RAW_FLAG)
                    continue
                if word > config.rpc_max_message_bytes:
                    raise ValueError(f"frame of {word} bytes exceeds limit")
                body = await reader.readexactly(word)
                msg = msgpack.unpackb(body, raw=False, strict_map_key=False)
                if "c" in msg:  # pubsub push
                    cb = self._sub_callbacks.get(msg["c"])
                    if cb is not None:
                        try:
                            cb(msg["d"])
                        except Exception:
                            logger.exception("subscriber callback error")
                    continue
                fut = self._pending.pop(msg.get("i"), None)
                if fut is None or fut.done():
                    continue
                if "e" in msg:
                    fut.set_exception(RpcError(*msg["e"]))
                else:
                    fut.set_result(msg.get("r"))
        except (asyncio.IncompleteReadError, ConnectionResetError, BrokenPipeError, asyncio.CancelledError):
            pass
        finally:
            # A stale read loop (superseded by _reconnect) must not clobber
            # the live connection's state or fail its in-flight futures.
            if gen == self._conn_gen:
                self._closed = True
                for fut in self._pending.values():
                    if not fut.done():
                        fut.set_exception(RpcConnectionError("connection lost"))
                        fut.exception()  # caller may have timed out: mark retrieved
                self._pending.clear()
                self._raw_sinks.clear()

    async def _on_raw_response(self, reader: asyncio.StreamReader,
                               length: int) -> None:
        """A raw response frame: route the payload into the caller-provided
        sink buffer (registered by call_raw) with no intermediate copy; a
        late/unclaimed payload is drained."""
        header, payload_len = await _read_raw_header(reader, length)
        req_id = header.get("i")
        sink = self._raw_sinks.pop(req_id, None)
        fut = self._pending.pop(req_id, None)
        view: Optional[memoryview] = None
        if sink is not None and fut is not None and not fut.done():
            try:
                view = sink(header.get("r"), payload_len)
            except Exception:  # noqa: BLE001 - sink failure = discard
                logger.exception("raw sink failed")
                view = None
        if view is not None and len(view) < payload_len:
            view = None  # undersized sink: discard rather than desync
        if view is None or payload_len == 0:
            await _drain_payload(reader, payload_len)
            if view is None:
                payload_len = 0  # nothing landed in the caller's buffer
        else:
            await _read_into(reader, view, payload_len)
        if fut is not None and not fut.done():
            if "e" in header:
                fut.set_exception(RpcError(*header["e"]))
            else:
                fut.set_result({"meta": header.get("r"), "nbytes": payload_len})

    async def call_raw(self, method: str, sink, timeout: Optional[float] = None,
                       **params) -> Dict[str, Any]:
        """Request whose RESPONSE is a raw frame. ``sink(meta, nbytes)`` is
        invoked by the read loop when the response header arrives and must
        return a writable memoryview of >= nbytes (or None to discard); the
        payload is received directly into it. Returns {"meta", "nbytes"}.
        No transparent retry — transfer callers own re-request/failover."""
        if self._closed:
            raise RpcConnectionError("client closed")
        req_id = next(self._ids)
        fut: asyncio.Future = asyncio.get_event_loop().create_future()
        self._pending[req_id] = fut
        self._raw_sinks[req_id] = sink
        try:
            async with self._send_lock:
                self._writer.write(_pack({"i": req_id, "m": method, "p": params}))
                await self._writer.drain()
        except (ConnectionError, OSError) as e:
            self._pending.pop(req_id, None)
            self._raw_sinks.pop(req_id, None)
            raise RpcConnectionError(f"send failed: {e}") from None
        try:
            if timeout is None:
                return await fut
            return await asyncio.wait_for(fut, timeout)
        except asyncio.TimeoutError:
            self._pending.pop(req_id, None)
            raise TimeoutError(f"rpc {method} timed out after {timeout}s") from None
        finally:
            self._raw_sinks.pop(req_id, None)

    async def call_raw_send(self, method: str, payload,
                            timeout: Optional[float] = None, **params) -> Any:
        """Raw REQUEST: ``payload`` (bytes-like / memoryview, e.g. an arena
        slice) rides after the small msgpack header with no msgpack encode
        and no bytes() copy; the reply is a normal msgpack response."""
        if self._closed:
            raise RpcConnectionError("client closed")
        view = memoryview(payload)
        req_id = next(self._ids)
        fut: asyncio.Future = asyncio.get_event_loop().create_future()
        self._pending[req_id] = fut
        try:
            async with self._send_lock:
                self._writer.write(
                    _pack_raw({"i": req_id, "m": method, "p": params}, len(view)))
                if len(view):
                    self._writer.write(view)
                await self._writer.drain()
        except (ConnectionError, OSError) as e:
            self._pending.pop(req_id, None)
            raise RpcConnectionError(f"send failed: {e}") from None
        try:
            if timeout is None:
                return await fut
            return await asyncio.wait_for(fut, timeout)
        except asyncio.TimeoutError:
            self._pending.pop(req_id, None)
            raise TimeoutError(f"rpc {method} timed out after {timeout}s") from None

    async def call(self, method: str, timeout: Any = DEFAULT_TIMEOUT, **params) -> Any:
        if timeout is DEFAULT_TIMEOUT:
            timeout = config.rpc_call_timeout_s
        if timeout is not None and method in RETRY_SAFE_METHODS:
            # at-least-once within the deadline: a dropped request/response
            # (chaos, transient network) is re-sent with a short per-attempt
            # timeout instead of burning the whole deadline on one try
            deadline = asyncio.get_event_loop().time() + timeout
            # per-attempt window doubles each retry so a legitimately-slow
            # call (big read_chunk, spill restore, busy scheduler) still gets
            # a long attempt before the overall deadline, while fast drops
            # are re-sent quickly
            attempt_timeout = max(0.2, config.rpc_retry_attempt_timeout_s)
            while True:
                remaining = deadline - asyncio.get_event_loop().time()
                if remaining <= 0:
                    raise TimeoutError(f"rpc {method} timed out after {timeout}s")
                try:
                    return await self._call_once(
                        method, min(attempt_timeout, remaining), params
                    )
                except TimeoutError:
                    attempt_timeout *= 2
                    continue
                except RpcConnectionError:
                    # server restarted (e.g. persistent GCS failover):
                    # retry-safe methods survive by reconnecting in place
                    if self._user_closed:
                        raise
                    await asyncio.sleep(min(0.2, remaining))
                    try:
                        await self._reconnect()
                    except RpcConnectionError:
                        continue
                    continue
        return await self._call_once(method, timeout, params)

    async def _reconnect(self) -> None:
        if self._reconnect_lock is None:
            self._reconnect_lock = asyncio.Lock()
        gen = self._conn_gen
        async with self._reconnect_lock:
            if self._user_closed:
                # close() landed while we waited: never resurrect a client the
                # application has shut down
                raise RpcConnectionError("client closed")
            if self._conn_gen != gen and not self._closed:
                return  # a racing caller already reconnected; reuse its link
            try:
                reader, writer = await asyncio.open_connection(self.host, self.port)
            except OSError as e:
                raise RpcConnectionError(
                    f"reconnect to {self.host}:{self.port}: {e}"
                ) from None
            if self._read_task is not None:
                self._read_task.cancel()
            # In-flight futures belong to the dead connection: fail them (the
            # retry loop re-sends) instead of dropping them to hang forever.
            for fut in self._pending.values():
                if not fut.done():
                    fut.set_exception(RpcConnectionError("connection lost"))
                    fut.exception()  # caller may have timed out: mark retrieved
            self._pending.clear()
            self._raw_sinks.clear()
            self._reader, self._writer = reader, writer
            self._closed = False
            self._conn_gen += 1
            self._send_lock = asyncio.Lock()
            self._read_task = spawn(self._read_loop())
            for channel in list(self._sub_callbacks):
                try:
                    await self._call_once("__subscribe__", 2.0, {"channel": channel})
                except (TimeoutError, RpcConnectionError):
                    pass
            for hook in list(self._reconnect_hooks):
                try:
                    hook()
                except Exception:  # noqa: BLE001 - catch-up must not kill reconnect
                    logger.exception("reconnect hook failed")

    def add_reconnect_hook(self, hook: Callable[[], None]) -> None:
        self._reconnect_hooks.append(hook)

    async def _call_once(self, method: str, timeout: Optional[float], params: Dict) -> Any:
        if self._closed:
            raise RpcConnectionError("client closed")
        req_id = next(self._ids)
        fut: asyncio.Future = asyncio.get_event_loop().create_future()
        self._pending[req_id] = fut
        try:
            async with self._send_lock:
                self._writer.write(_pack({"i": req_id, "m": method, "p": params}))
                await self._writer.drain()
        except (ConnectionError, OSError) as e:
            # a half-open connection surfaces here as a raw OS error; translate
            # so the retry-safe path reconnects instead of leaking it upward
            self._pending.pop(req_id, None)
            raise RpcConnectionError(f"send failed: {e}") from None
        try:
            if timeout is None:
                return await fut  # infinite deadline (connection loss still errors)
            return await asyncio.wait_for(fut, timeout)
        except asyncio.TimeoutError:
            self._pending.pop(req_id, None)
            raise TimeoutError(f"rpc {method} timed out after {timeout}s") from None

    async def subscribe(self, channel: str, callback: Callable[[Any], None]) -> None:
        self._sub_callbacks[channel] = callback
        await self.call("__subscribe__", channel=channel)

    async def unsubscribe(self, channel: str) -> None:
        """Drop a subscription on both ends (per-call channels — e.g. serve
        RPC streams — would otherwise accumulate forever)."""
        self._sub_callbacks.pop(channel, None)
        try:
            await self.call("__unsubscribe__", channel=channel, timeout=5.0)
        except (TimeoutError, RpcConnectionError, RpcError):
            pass  # server-side set is also swept on disconnect

    async def close(self) -> None:
        self._closed = True
        self._user_closed = True
        # Fail in-flight calls HERE, synchronously: close() must never
        # return while a caller could still be parked on a pending future —
        # the read task's finally also does this, but its cancellation only
        # runs when the loop next schedules it, and SyncRpcClient.close()
        # stops the loop right after this coroutine (a stranded future
        # blocked interpreter exit via the futures atexit join, r5).
        for fut in self._pending.values():
            if not fut.done():
                fut.set_exception(RpcConnectionError("client closed"))
                fut.exception()  # caller may never retrieve: mark consumed
        self._pending.clear()
        self._raw_sinks.clear()
        if self._read_task is not None:
            self._read_task.cancel()
            try:
                await self._read_task
            except BaseException:  # noqa: BLE001 - incl. CancelledError
                pass
        if self._writer is not None:
            try:
                self._writer.close()
            except Exception:
                pass


class SyncRpcClient:
    """Thread-safe synchronous facade: owns a background event loop thread.
    Used by driver/worker processes whose user code is synchronous."""

    def __init__(self, address: str):
        self.address = address
        self._stopped = False
        self._loop = asyncio.new_event_loop()
        self._thread = threading.Thread(target=self._loop.run_forever, daemon=True, name="rpc-client")
        self._thread.start()
        self._client = RpcClient(address)
        self._run(self._client.connect())

    def _run(self, coro, timeout: Optional[float] = None):
        if self._stopped or not self._thread.is_alive():
            # a submit to a stopped loop would hang forever (the coroutine
            # never runs); teardown-path callers (e.g. generator __del__ at
            # interpreter exit) must get an error instead
            coro.close()
            raise RpcConnectionError("client closed")
        fut = asyncio.run_coroutine_threadsafe(coro, self._loop)
        return fut.result(timeout)

    def call(self, method: str, timeout: Any = DEFAULT_TIMEOUT, **params) -> Any:
        return self._run(self._client.call(method, timeout=timeout, **params))

    def call_async(self, method: str, timeout: Any = DEFAULT_TIMEOUT, **params):
        """Pipelined call: returns a concurrent.futures.Future immediately.
        Lets a caller keep many requests in flight instead of paying one
        round trip per call (reference: the core worker submits task leases
        asynchronously and only the grpc completion queue waits)."""
        if self._stopped or not self._thread.is_alive():
            raise RpcConnectionError("client closed")
        return asyncio.run_coroutine_threadsafe(
            self._client.call(method, timeout=timeout, **params), self._loop
        )

    def call_raw(self, method: str, sink, timeout: Optional[float] = None,
                 **params) -> Dict[str, Any]:
        """Raw-response call; ``sink`` runs on the client loop thread."""
        return self._run(self._client.call_raw(method, sink, timeout=timeout,
                                               **params))

    def call_raw_send(self, method: str, payload,
                      timeout: Optional[float] = None, **params) -> Any:
        return self._run(self._client.call_raw_send(method, payload,
                                                    timeout=timeout, **params))

    def call_raw_send_async(self, method: str, payload,
                            timeout: Optional[float] = None, **params):
        """Pipelined raw send: returns a concurrent.futures.Future so a
        caller can keep a window of chunk uploads in flight (streaming
        put)."""
        if self._stopped or not self._thread.is_alive():
            raise RpcConnectionError("client closed")
        return asyncio.run_coroutine_threadsafe(
            self._client.call_raw_send(method, payload, timeout=timeout,
                                       **params), self._loop
        )

    def call_raw_async(self, method: str, sink,
                       timeout: Optional[float] = None, **params):
        if self._stopped or not self._thread.is_alive():
            raise RpcConnectionError("client closed")
        return asyncio.run_coroutine_threadsafe(
            self._client.call_raw(method, sink, timeout=timeout, **params),
            self._loop
        )

    def subscribe(self, channel: str, callback: Callable[[Any], None]) -> None:
        self._run(self._client.subscribe(channel, callback))

    def add_reconnect_hook(self, hook: Callable[[], None]) -> None:
        """``hook()`` runs on the client loop thread after every successful
        transparent reconnect (subscriptions already restored) — keep it
        non-blocking; spawn a thread for real catch-up work."""
        self._client.add_reconnect_hook(hook)

    def unsubscribe(self, channel: str) -> None:
        self._run(self._client.unsubscribe(channel))

    def close(self) -> None:
        try:
            self._run(self._client.close(), timeout=2)
        except Exception:
            pass
        self._stopped = True
        self._loop.call_soon_threadsafe(self._loop.stop)
