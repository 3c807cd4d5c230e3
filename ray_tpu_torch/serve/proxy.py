"""HTTP proxy: the ingress data plane (own copy of ray_tpu.serve.proxy).

Reference capability: serve/_private/proxy.py (ProxyActor:446, HTTP entry
:542 — route-prefix matching, request forwarding to replicas via the
replica scheduler, draining). Here: a minimal asyncio HTTP/1.1 server run by
a proxy actor (stdlib only — no starlette in the image); bodies are decoded
by content-type (json -> dict, text -> str, else bytes) and handed to the
deployment's __call__ through the pow-2 router.
"""

from __future__ import annotations

import asyncio
import json
import threading
from typing import Any, Dict, Optional, Tuple

from ray_tpu_torch.utils.logging import get_logger

logger = get_logger("serve.proxy")

_STREAM_DONE = object()
_STREAM_ERR = object()


def _encode_stream_item(item: Any) -> bytes:
    if isinstance(item, bytes):
        return item
    if isinstance(item, str):
        return item.encode()
    try:
        return json.dumps(item).encode() + b"\n"  # ndjson record per item
    except TypeError:
        return (str(item) + "\n").encode()


class ProxyActor:
    """One per serve instance (head node). Routes /app_name/... -> app.

    Two ingress planes on one event loop:
    - HTTP/1.1 (curl-able, json/ndjson) — the reference's uvicorn analogue;
    - native msgpack-RPC (``rpc_address()``) with push-channel streaming —
      the reference's gRPC ingress analogue (serve/_private/grpc_util.py)
      re-based on this framework's own wire protocol; clients use
      serve.rpc_ingress.ServeRpcClient.
    """

    def __init__(self, controller, host: str = "127.0.0.1", port: int = 8000):
        self._controller = controller
        self._host = host
        self._port = port
        self._rpc = None
        self._rpc_addr: Optional[str] = None
        self._routes: Dict[str, Any] = {}  # app -> Router (lazy)
        self._stream_flags: Dict[str, Tuple[bool, float]] = {}  # app -> (stream, ts)
        self._ready = threading.Event()
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._http_server: Optional[asyncio.AbstractServer] = None
        self._stopping = False
        self._thread = threading.Thread(target=self._serve, daemon=True,
                                        name="serve-http-proxy")
        self._thread.start()
        self._ready.wait(timeout=30)

    def address(self) -> str:
        return f"http://{self._host}:{self._port}"

    def rpc_address(self) -> Optional[str]:
        """host:port of the msgpack-RPC ingress listener."""
        return self._rpc_addr

    def check_health(self) -> bool:
        return self._ready.is_set()

    def stop(self) -> bool:
        """Close both listeners and stop the server loop. Needed explicitly:
        in the local runtime actors are THREADS, so killing the actor alone
        would leave the HTTP port bound for the life of the process."""
        self._stopping = True
        loop = self._loop
        if loop is None or not loop.is_running():
            return True

        async def _close() -> None:
            # close the SOCKETS, not just the loop: a stopped loop keeps its
            # transports (and the bound ports) alive in this process
            if self._http_server is not None:
                self._http_server.close()
            if self._rpc is not None:
                try:
                    await self._rpc.stop()
                except Exception:  # noqa: BLE001
                    pass
            loop.stop()

        asyncio.run_coroutine_threadsafe(_close(), loop)
        self._thread.join(timeout=5.0)
        return True

    # ------------------------------------------------------------- http core
    def _serve(self) -> None:
        self._loop = asyncio.new_event_loop()
        asyncio.set_event_loop(self._loop)

        async def start():
            from ray_tpu_torch.core.rpc import RpcServer

            server = await asyncio.start_server(self._on_conn, self._host, self._port)
            self._http_server = server
            self._port = server.sockets[0].getsockname()[1]
            # RPC ingress rides the same loop; chaos-exempt (data plane)
            self._rpc = RpcServer(self._host, 0, chaos=False)
            self._rpc.register("serve_call", self._serve_call)
            self._rpc.register("serve_stream", self._serve_stream)
            host, rpc_port = await self._rpc.start()
            self._rpc_addr = f"{host}:{rpc_port}"
            self._ready.set()
            async with server:
                await server.serve_forever()

        try:
            self._loop.run_until_complete(start())
        except RuntimeError:
            if not self._stopping:  # deliberate stop() is not a death
                logger.exception("proxy server died")
        except Exception:  # noqa: BLE001
            logger.exception("proxy server died")

    # -------------------------------------------------------- rpc ingress
    async def _serve_call(self, app: str, payload: Any = None,
                          app_method: str = "__call__") -> Any:
        """Unary RPC ingress: payload -> deployment -> msgpack-able result."""
        loop = asyncio.get_event_loop()
        router = await loop.run_in_executor(None, self._router_for, app)
        if router is None:
            raise KeyError(f"no app '{app}'")
        call_args = (payload,) if payload is not None else ()
        return await loop.run_in_executor(
            None, lambda: router.call(app_method, call_args, {}))

    async def _serve_stream(self, app: str, channel: str,
                            payload: Any = None,
                            app_method: str = "__call__") -> bool:
        """Streaming RPC ingress: the CLIENT subscribes to ``channel`` first,
        then calls this; items are pushed as {"item": x}, terminated by
        {"end": true} or {"error": msg}. (The reference's gRPC server-streaming
        analogue over the native push-pubsub plane.)"""
        loop = asyncio.get_event_loop()
        router = await loop.run_in_executor(None, self._router_for, app)
        if router is None:
            raise KeyError(f"no app '{app}'")
        call_args = (payload,) if payload is not None else ()

        def publish(data: Dict[str, Any], timeout: float = 30.0) -> None:
            asyncio.run_coroutine_threadsafe(
                self._rpc.publish(channel, data), loop
            ).result(timeout)

        def pull() -> None:
            try:
                stream = router.call_streaming(app_method, call_args, {})
                try:
                    for item in stream:
                        publish({"item": item})
                    publish({"end": True})
                finally:
                    stream.close()
            except BaseException as e:  # noqa: BLE001 - surfaced in-band
                try:
                    publish({"error": f"{type(e).__name__}: {e}"})
                except Exception:  # noqa: BLE001
                    pass

        threading.Thread(target=pull, daemon=True,
                         name="proxy-rpc-stream").start()
        return True

    async def _on_conn(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        try:
            while True:
                req = await self._read_request(reader)
                if req is None:
                    break
                method, path, headers, body = req
                status, payload, ctype = await self._handle(method, path, headers, body)
                keep = headers.get("connection", "").lower() != "close"
                if status == b"STREAM":
                    # payload is an async item queue: chunked transfer so the
                    # client sees items the moment the replica yields them
                    # (reference: proxy.py:542 streaming response path)
                    await self._write_chunked(writer, payload, ctype, keep)
                    if not keep:
                        break
                    continue
                writer.write(
                    b"HTTP/1.1 " + status + b"\r\n"
                    b"Content-Type: " + ctype + b"\r\n"
                    b"Content-Length: " + str(len(payload)).encode() + b"\r\n"
                    + (b"Connection: keep-alive\r\n" if keep else b"Connection: close\r\n")
                    + b"\r\n" + payload
                )
                await writer.drain()
                if not keep:
                    break
        except (asyncio.IncompleteReadError, ConnectionResetError, BrokenPipeError):
            pass
        except Exception:  # noqa: BLE001
            logger.exception("proxy connection error")
        finally:
            try:
                writer.close()
            except Exception:  # noqa: BLE001
                pass

    async def _read_request(self, reader) -> Optional[Tuple[str, str, Dict[str, str], bytes]]:
        line = await reader.readline()
        if not line:
            return None
        parts = line.decode("latin1").strip().split(" ")
        if len(parts) < 2:
            return None
        method, path = parts[0], parts[1]
        headers: Dict[str, str] = {}
        while True:
            h = await reader.readline()
            h = h.decode("latin1").strip()
            if not h:
                break
            if ":" in h:
                k, v = h.split(":", 1)
                headers[k.strip().lower()] = v.strip()
        length = int(headers.get("content-length", 0) or 0)
        body = await reader.readexactly(length) if length else b""
        return method, path, headers, body

    async def _handle(self, method: str, path: str, headers: Dict[str, str],
                      body: bytes) -> Tuple[bytes, bytes, bytes]:
        loop = asyncio.get_event_loop()
        path = path.split("?", 1)[0]
        if path in ("/-/healthz", "/-/routes"):
            if path == "/-/healthz":
                return b"200 OK", b"ok", b"text/plain"
            import ray_tpu_torch

            # controller calls block: keep them off the event-loop thread
            apps = await loop.run_in_executor(
                None,
                lambda: ray_tpu_torch.get(self._controller.list_apps.remote(), timeout=10),
            )
            return b"200 OK", json.dumps({f"/{a}": a for a in apps}).encode(), b"application/json"
        segs = [s for s in path.split("/") if s]
        if not segs:
            return b"404 Not Found", b"no application in path", b"text/plain"
        app = segs[0]
        router = await loop.run_in_executor(None, self._router_for, app)
        if router is None:
            return b"404 Not Found", f"no app '{app}'".encode(), b"text/plain"
        # decode body by content type
        ctype = headers.get("content-type", "")
        arg: Any
        if "json" in ctype and body:
            try:
                arg = json.loads(body)
            except json.JSONDecodeError:
                return b"400 Bad Request", b"invalid json", b"text/plain"
        elif body:
            arg = body.decode() if "text" in ctype else body
        else:
            arg = None
        call_args = (arg,) if arg is not None else ()
        # controller round-trip inside: keep it off the event-loop thread
        app_streams = await loop.run_in_executor(None, self._app_streams, app)
        if app_streams:
            # hand the connection an asyncio item queue fed by a dedicated
            # puller thread (one per stream — the writer itself never parks a
            # shared executor thread between tokens). The writer owns a
            # `closed` event: on client disconnect the puller stops and
            # closes the value stream — running the router's and replica's
            # finally blocks so ongoing-request accounting and the producer's
            # backpressure gate are released, never leaked. A semaphore
            # bounds unconsumed items so a slow client can't buffer a whole
            # LLM response in proxy memory.
            q: "asyncio.Queue" = asyncio.Queue()
            window = threading.Semaphore(64)
            closed = threading.Event()

            def put(item) -> None:
                loop.call_soon_threadsafe(q.put_nowait, item)

            def pull() -> None:
                stream = router.call_streaming("__call__", call_args, {})
                try:
                    for item in stream:
                        while not window.acquire(timeout=0.5):
                            if closed.is_set():
                                return
                        if closed.is_set():
                            return
                        put(item)
                    put(_STREAM_DONE)
                except BaseException as e:  # noqa: BLE001
                    try:
                        put((_STREAM_ERR, e))
                    except Exception:  # noqa: BLE001
                        pass  # proxy loop already gone
                finally:
                    stream.close()

            threading.Thread(target=pull, daemon=True, name="proxy-stream-pull").start()
            return b"STREAM", (q, window, closed), b"application/x-ndjson"
        try:
            result = await loop.run_in_executor(
                # Router.call is actor-handle dispatch, not the RPC plane
                # rtpulint: disable=rpc-drift
                None, lambda: router.call("__call__", call_args, {})
            )
        except Exception as e:  # noqa: BLE001 - surface as 500
            return b"500 Internal Server Error", str(e).encode(), b"text/plain"
        if isinstance(result, bytes):
            return b"200 OK", result, b"application/octet-stream"
        if isinstance(result, str):
            return b"200 OK", result.encode(), b"text/plain"
        try:
            return b"200 OK", json.dumps(result).encode(), b"application/json"
        except TypeError:
            return b"200 OK", str(result).encode(), b"text/plain"

    def _router_for(self, app: str):
        import ray_tpu_torch
        from ray_tpu_torch.serve.router import Router

        r = self._routes.get(app)
        if r is None:
            apps = ray_tpu_torch.get(self._controller.list_apps.remote(), timeout=10)
            if app not in apps:
                return None
            r = Router(self._controller, app)
            self._routes[app] = r
        return r

    def _app_streams(self, app: str) -> bool:
        import time as _time

        cached = self._stream_flags.get(app)
        now = _time.monotonic()
        if cached is not None and now - cached[1] < 2.0:
            return cached[0]
        import ray_tpu_torch

        try:
            meta = ray_tpu_torch.get(self._controller.get_app_meta.remote(app), timeout=10)
        except Exception:  # noqa: BLE001
            return cached[0] if cached else False
        streams = bool(meta and meta.get("stream"))
        # short TTL: a redeploy that flips `stream` takes effect within 2 s
        self._stream_flags[app] = (streams, now)
        return streams

    async def _write_chunked(self, writer: asyncio.StreamWriter, payload,
                             ctype: bytes, keep: bool) -> None:
        """Chunked-transfer response: one HTTP chunk per stream item, flushed
        immediately — tokens reach the client before generation finishes.
        On client disconnect the puller is stopped and its stream closed so
        no thread or replica ongoing-slot leaks."""
        q, window, closed = payload
        try:
            writer.write(
                b"HTTP/1.1 200 OK\r\n"
                b"Content-Type: " + ctype + b"\r\n"
                b"Transfer-Encoding: chunked\r\n"
                + (b"Connection: keep-alive\r\n" if keep else b"Connection: close\r\n")
                + b"\r\n"
            )
            await writer.drain()
            while True:
                item = await q.get()
                if item is _STREAM_DONE:
                    break
                window.release()
                if isinstance(item, tuple) and len(item) == 2 and item[0] is _STREAM_ERR:
                    # mid-stream failure: terminate the chunk stream with an
                    # in-band error record (headers are already sent)
                    data = json.dumps({"error": str(item[1])}).encode() + b"\n"
                    writer.write(hex(len(data))[2:].encode() + b"\r\n" + data + b"\r\n")
                    break
                data = _encode_stream_item(item)
                writer.write(hex(len(data))[2:].encode() + b"\r\n" + data + b"\r\n")
                await writer.drain()
            writer.write(b"0\r\n\r\n")
            await writer.drain()
        finally:
            closed.set()  # puller sees it within its 0.5s acquire window
