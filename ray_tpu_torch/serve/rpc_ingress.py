"""Native-RPC serve ingress client (own copy of ray_tpu.serve.rpc_ingress).

Reference capability: serve's gRPC ingress client surface
(serve/_private/grpc_util.py + generated stubs) — here a thin client for
the proxy's msgpack-RPC listener (ProxyActor.rpc_address()):

    client = ServeRpcClient(proxy_rpc_address)
    out = client.call("myapp", {"x": 1})          # unary
    for tok in client.stream("chat", "prompt"):    # server streaming
        ...

Payloads/results must be msgpack-able (None/bool/int/float/str/bytes/list/
dict) — the same cross-language type universe as the C++ client; richer
types belong on the Python handle API.
"""

from __future__ import annotations

import queue
import uuid
from typing import Any, Iterator, Optional

from ray_tpu_torch.core.rpc import SyncRpcClient


class ServeRpcClient:
    def __init__(self, address: str):
        self._client = SyncRpcClient(address)

    def call(self, app: str, payload: Any = None, *,
             method: str = "__call__", timeout: Optional[float] = 60.0) -> Any:
        return self._client.call("serve_call", app=app, payload=payload,
                                 app_method=method, timeout=timeout)

    def stream(self, app: str, payload: Any = None, *,
               method: str = "__call__",
               item_timeout: float = 60.0) -> Iterator[Any]:
        """Server-streaming call: yields items as the replica produces them.
        Subscribe-then-call ordering guarantees no item is missed."""
        channel = f"serve-stream:{uuid.uuid4().hex}"
        q: "queue.Queue" = queue.Queue()
        self._client.subscribe(channel, q.put)
        try:
            self._client.call("serve_stream", app=app, channel=channel,
                              payload=payload, app_method=method, timeout=60.0)
            while True:
                try:
                    msg = q.get(timeout=item_timeout)
                except queue.Empty:
                    raise TimeoutError(
                        f"stream from app '{app}' produced no item in "
                        f"{item_timeout}s") from None
                if not isinstance(msg, dict):
                    continue
                if msg.get("end"):
                    return
                if "error" in msg:
                    raise RuntimeError(f"stream failed: {msg['error']}")
                yield msg.get("item")
        finally:
            # per-call channel: drop it on both ends or a long-lived client
            # accumulates one dead subscription per stream() call
            self._client.unsubscribe(channel)

    def close(self) -> None:
        self._client.close()
