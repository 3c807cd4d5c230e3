"""Dashboard head: the cluster's HTTP observability plane.

Reference capability: python/ray/dashboard/head.py:61 (aiohttp head server +
state endpoints), _private/metrics_agent.py:483 (per-node metrics ->
Prometheus scrape), _private/profiling.py:20-40 (`ray timeline` chrome
trace). Redesign: ONE stdlib-asyncio HTTP server inside the head node agent's
process, aggregating straight from the GCS and peer agents — no separate
dashboard/agent process tree to operate:

- ``/api/nodes|actors|objects|tasks|jobs|pgs|summary`` — the state API as JSON
- ``/metrics``      — Prometheus text, fanned out to every node agent (each
                      sample labeled ``node="..."``)
- ``/api/timeline`` — chrome-trace JSON built from task-state transitions;
                      loads directly in Perfetto / chrome://tracing
- ``/``             — minimal live HTML overview (auto-refreshing tables)

The head agent starts it and publishes the address under GCS KV
``dashboard:address`` so the CLI and drivers can discover it.
"""

from __future__ import annotations

import asyncio
import json
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.core.rpc import RpcClient
from ray_tpu_torch.utils.logging import get_logger

logger = get_logger("dashboard")


def _jsonable(v: Any) -> Any:
    """Fallback encoder: state records may carry pickled blobs (actor
    options) or sets — render them legibly instead of failing the page."""
    if isinstance(v, (bytes, bytearray)):
        return f"<{len(v)} bytes>"
    if isinstance(v, (set, frozenset)):
        return sorted(v)
    return repr(v)


class DashboardHead:
    """Runs on the head agent's event loop; borrows its GCS/peer clients."""

    def __init__(self, agent, host: str = "127.0.0.1", port: int = 0):
        self._agent = agent
        self._host = host
        self._port = port
        self._server: Optional[asyncio.AbstractServer] = None

    @property
    def address(self) -> str:
        return f"http://{self._host}:{self._port}"

    async def start(self) -> str:
        self._server = await asyncio.start_server(self._on_conn, self._host, self._port)
        self._port = self._server.sockets[0].getsockname()[1]
        logger.info("dashboard at %s", self.address)
        return self.address

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()

    # ------------------------------------------------------------- http core
    async def _on_conn(self, reader: asyncio.StreamReader,
                       writer: asyncio.StreamWriter) -> None:
        try:
            line = await reader.readline()
            if not line:
                return
            parts = line.decode("latin1").split(" ")
            if len(parts) < 2:
                return
            method = parts[0].upper()
            path = parts[1].split("?", 1)[0]
            length = 0
            bad_length = False
            while True:
                h = (await reader.readline()).decode("latin1").strip()
                if not h:
                    break
                if ":" in h:
                    k, v = h.split(":", 1)
                    if k.strip().lower() == "content-length":
                        try:
                            length = int(v.strip() or 0)
                        except ValueError:
                            bad_length = True
            # 16 MiB cap: the dashboard port is unauthenticated — a huge
            # declared length must not buffer unbounded memory
            if bad_length or length < 0 or length > 16 << 20:
                writer.write(b"HTTP/1.1 400 Bad Request\r\nContent-Length: 0"
                             b"\r\nConnection: close\r\n\r\n")
                await writer.drain()
                return
            req_body = await reader.readexactly(length) if length else b""
            try:
                status, body, ctype = await self._route(path, method, req_body)
            except Exception as e:  # noqa: BLE001 - surface as 500
                logger.exception("dashboard handler error for %s", path)
                status, body, ctype = 500, str(e).encode(), b"text/plain"
            reason = {200: b"OK", 202: b"Accepted", 400: b"Bad Request",
                      404: b"Not Found", 409: b"Conflict",
                      500: b"Internal Server Error"}
            writer.write(
                b"HTTP/1.1 " + str(status).encode() + b" " + reason.get(status, b"") +
                b"\r\nContent-Type: " + ctype +
                b"\r\nContent-Length: " + str(len(body)).encode() +
                b"\r\nAccess-Control-Allow-Origin: *"
                b"\r\nConnection: close\r\n\r\n" + body
            )
            await writer.drain()
        except (ConnectionResetError, BrokenPipeError, asyncio.IncompleteReadError):
            pass
        finally:
            try:
                writer.close()
            except Exception:  # noqa: BLE001
                pass

    async def _route(self, path: str, method: str = "GET",
                     req_body: bytes = b"") -> Tuple[int, bytes, bytes]:
        if path.startswith("/api/serve/"):
            return await self._serve_rest(path, method, req_body)
        if path in ("/", "/index.html"):
            return 200, _INDEX_HTML, b"text/html"
        if path == "/-/healthz":
            return 200, b"ok", b"text/plain"
        if path == "/metrics":
            return 200, (await self._metrics()).encode(), b"text/plain; version=0.0.4"
        if path == "/api/timeline":
            return 200, json.dumps(await self._timeline()).encode(), b"application/json"
        api = {
            "/api/nodes": self._nodes,
            "/api/actors": self._actors,
            "/api/objects": self._objects,
            "/api/tasks": self._tasks,
            "/api/jobs": self._jobs,
            "/api/pgs": self._pgs,
            "/api/summary": self._summary,
        }.get(path)
        if api is None:
            return 404, b"not found", b"text/plain"
        body = json.dumps(await api(), default=_jsonable).encode()
        return 200, body, b"application/json"

    # ------------------------------------------------------------- serve rest
    async def _serve_rest(self, path: str, method: str,
                          req_body: bytes) -> Tuple[int, bytes, bytes]:
        """Declarative serve REST (reference: dashboard serve module +
        serve/schema.py). Validation is pure; apply rides the GCS-KV config
        bus consumed by the running controller (schema.py module docs)."""
        from ray_tpu_torch.serve import schema

        if path == "/api/serve/applications" and method == "GET":
            out: Dict[str, Any] = {}
            for label, key in (("config", schema.CONFIG_KEY),
                               ("pending", schema.PENDING_KEY),
                               ("status", schema.STATUS_KEY)):
                raw = await self._agent.gcs.call("kv_get", key=key)
                out[label] = json.loads(raw) if raw else None
            return 200, json.dumps(out).encode(), b"application/json"
        if path == "/api/serve/applications" and method == "PUT":
            try:
                try:
                    cfg = json.loads(req_body)
                except json.JSONDecodeError:
                    import yaml

                    cfg = yaml.safe_load(req_body)
                cfg = schema.validate_config(cfg)
            except Exception as e:  # noqa: BLE001 - client error
                return 400, f"invalid config: {e}".encode(), b"text/plain"
            if not await self._serve_running():
                return 409, (b"no running serve controller - deploy via "
                             b"'serve deploy' CLI first"), b"text/plain"
            await self._agent.gcs.call(
                "kv_put", key=schema.PENDING_KEY,
                value=json.dumps(cfg).encode())
            return 202, b"config accepted; controller will reconcile", b"text/plain"
        if path == "/api/serve/rollback" and method == "POST":
            prev = await self._agent.gcs.call("kv_get", key=schema.PREV_KEY)
            if not prev:
                return 409, b"no previous config to roll back to", b"text/plain"
            if not await self._serve_running():
                return 409, b"no running serve controller", b"text/plain"
            await self._agent.gcs.call(
                "kv_put", key=schema.ROLLBACK_KEY, value=b"1")
            return 202, b"rollback accepted", b"text/plain"
        return 404, b"not found", b"text/plain"

    async def _serve_running(self) -> bool:
        try:
            actor_hex = await self._agent.gcs.call(
                "get_named_actor", name="SERVE_CONTROLLER", namespace="serve")
            return actor_hex is not None
        except Exception:  # noqa: BLE001
            return False

    # ------------------------------------------------------------- state api
    async def _nodes(self) -> List[Dict[str, Any]]:
        return await self._agent.gcs.call("get_nodes")

    async def _actors(self) -> Any:
        return await self._agent.gcs.call("list_actors")

    async def _objects(self) -> Any:
        return await self._agent.gcs.call("list_objects", limit=1000)

    async def _pgs(self) -> Any:
        return await self._agent.gcs.call("placement_group_table")

    async def _jobs(self) -> List[Dict[str, Any]]:
        gcs = self._agent.gcs
        out = []
        for key in await gcs.call("kv_keys", prefix="job:"):
            raw = await gcs.call("kv_get", key=key)
            if raw:
                try:
                    out.append(json.loads(raw))
                except json.JSONDecodeError:
                    pass
        return out

    async def _summary(self) -> Dict[str, Any]:
        gcs = self._agent.gcs
        nodes = await gcs.call("get_nodes")
        return {
            "nodes_alive": sum(1 for n in nodes if n["Alive"]),
            "nodes_total": len(nodes),
            "resources_total": await gcs.call("cluster_resources"),
            "resources_available": await gcs.call("available_resources"),
            "dashboard": self.address,
        }

    async def _each_agent(self, method: str) -> List[Tuple[Dict[str, Any], Any]]:
        """Fan a no-arg RPC out to every alive agent; skip the unreachable."""
        nodes = [n for n in await self._agent.gcs.call("get_nodes") if n["Alive"]]

        async def one(node):
            if node["NodeID"] == self._agent.hex:
                # local fast path: call our own handler directly
                return node, await getattr(self._agent, f"rpc_{method}")()
            client = await self._agent._peer(node["NodeID"])  # noqa: SLF001
            if client is None:
                return node, None
            return node, await client.call(method, timeout=10)

        results = await asyncio.gather(*[one(n) for n in nodes],
                                       return_exceptions=True)
        return [r for r in results if not isinstance(r, BaseException)
                and r[1] is not None]

    async def _tasks(self) -> List[Dict[str, Any]]:
        out = []
        for node, states in await self._each_agent("task_states"):
            for task_id, state in states.items():
                out.append({"task_id": task_id, "state": state,
                            "node_id": node["NodeID"]})
        return out

    # --------------------------------------------------------------- metrics
    async def _metrics(self) -> str:
        chunks = []
        seen_meta = set()
        for _node, text in await self._each_agent("metrics_text"):
            for line in text.splitlines():
                if line.startswith("#"):
                    # HELP/TYPE lines must appear once per family
                    if line in seen_meta:
                        continue
                    seen_meta.add(line)
                chunks.append(line)
        return "\n".join(chunks) + "\n"

    # -------------------------------------------------------------- timeline
    async def _timeline(self) -> Dict[str, Any]:
        """Chrome-trace (catapult) JSON: one 'X' span per task-state phase,
        grouped by node (pid) — loads in Perfetto / chrome://tracing."""
        import asyncio as _asyncio

        events: List[Dict[str, Any]] = []
        # the two cluster fan-outs are independent: fetch concurrently
        task_fan, profile_fan = await _asyncio.gather(
            self._each_agent("task_events"), self._each_agent("profile_events"))
        for node, task_events in task_fan:
            pid = f"node:{node['NodeID'][:8]}"
            for task_id, transitions in task_events.items():
                tid = task_id[:12]
                for i, (ts, state) in enumerate(transitions):
                    if i + 1 < len(transitions):
                        dur_us = max(1.0, (transitions[i + 1][0] - ts) * 1e6)
                    else:
                        dur_us = 1.0  # terminal state: zero-width marker
                    events.append({
                        "name": state,
                        "cat": "task",
                        "ph": "X",
                        "ts": ts * 1e6,
                        "dur": dur_us,
                        "pid": pid,
                        "tid": tid,
                        "args": {"task_id": task_id},
                    })
        # user profile spans (ray_tpu_torch.profile(...) inside tasks; reference:
        # profile_event.h spans on the `ray timeline` view)
        for node, spans in profile_fan:
            pid = f"node:{node['NodeID'][:8]}"
            for s in spans:
                events.append({
                    "name": s.get("name", "span"),
                    "cat": "user",
                    "ph": "X",
                    "ts": s["start"] * 1e6,
                    "dur": max(1.0, (s["end"] - s["start"]) * 1e6),
                    "pid": pid,
                    "tid": f"worker:{str(s.get('worker_id', ''))[:8]}",
                    "args": {k: v for k, v in s.items()
                             if k in ("task_id", "extra")},
                })
        return {"traceEvents": events, "displayTimeUnit": "ms"}


_INDEX_HTML = b"""<!doctype html>
<html><head><title>ray_tpu_torch dashboard</title><style>
body{font-family:monospace;margin:24px;background:#111;color:#ddd}
h1{font-size:18px} h2{font-size:14px;margin-top:20px;color:#8bf}
table{border-collapse:collapse;margin-top:6px}
td,th{border:1px solid #333;padding:3px 8px;font-size:12px;text-align:left}
a{color:#8bf}
</style></head><body>
<h1>ray_tpu_torch dashboard</h1>
<p><a href="/api/nodes">nodes</a> | <a href="/api/actors">actors</a> |
<a href="/api/tasks">tasks</a> | <a href="/api/objects">objects</a> |
<a href="/api/jobs">jobs</a> | <a href="/api/pgs">placement groups</a> |
<a href="/api/summary">summary</a> | <a href="/metrics">metrics</a> |
<a href="/api/timeline">timeline</a> (load in <a
href="https://ui.perfetto.dev">Perfetto</a>)</p>
<h2>Cluster</h2><div id="summary">loading...</div>
<h2>Nodes</h2><table id="nodes"></table>
<h2>Actors</h2><table id="actors"></table>
<script>
function row(cells, tag){const tr=document.createElement('tr');
 cells.forEach(c=>{const td=document.createElement(tag||'td');
 td.textContent=typeof c==='object'?JSON.stringify(c):c;tr.appendChild(td)});
 return tr}
async function refresh(){
 try{
  const s=await (await fetch('/api/summary')).json();
  document.getElementById('summary').textContent=
   `${s.nodes_alive}/${s.nodes_total} nodes alive | total=` +
   JSON.stringify(s.resources_total)+` available=`+
   JSON.stringify(s.resources_available);
  const nodes=await (await fetch('/api/nodes')).json();
  const nt=document.getElementById('nodes');nt.innerHTML='';
  nt.appendChild(row(['node','alive','address','resources'],'th'));
  nodes.forEach(n=>nt.appendChild(row([n.NodeID.slice(0,12),n.Alive,
   n.NodeManagerAddress,n.Resources])));
  const actors=await (await fetch('/api/actors')).json();
  const at=document.getElementById('actors');at.innerHTML='';
  at.appendChild(row(['actor','class','state','node'],'th'));
  (actors||[]).forEach(a=>at.appendChild(row([
   (a.actor_id||'').slice(0,12),a.class_name,a.state,
   (a.node_id||'').slice(0,12)])));
 }catch(e){console.log(e)}
 setTimeout(refresh,2000)}
refresh()
</script></body></html>
"""
