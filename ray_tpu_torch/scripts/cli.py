"""Operator CLI: ``python -m ray_tpu_torch <command>`` (own copy of the JAX
package's CLI, with GPU cards).

Reference capability: python/ray/scripts/scripts.py:2592-2652 (``ray start/
stop/status``) + the state/job CLIs. Session bookkeeping lives in
``~/.ray_tpu_torch/session`` (JSON: gcs address + process-group ids) so
``stop`` can tear down what ``start`` launched; session dirs are
``$TMPDIR/ray_tpu_torch/session-*`` (``/tmp`` when TMPDIR is unset). Neither
path is the JAX package's, so the two CLIs never stop each other's processes.

Commands:
    start --head [--num-cpus N] [--num-gpus N] [--port P] [--resources k=v]
    start --address HOST:PORT [--num-cpus N] ...      (join existing cluster)
    stop
    status
    list nodes|actors|objects|tasks|jobs|pgs
    submit [--working-dir D] [--no-wait] -- CMD...
    logs JOB_ID [--follow]

``--num-gpus`` (alias ``--num-tpus``, the JAX package's name) of 0 lets the
agent count the cards it sees; start it under ``CUDA_VISIBLE_DEVICES=""``
for a node without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile
import time
import uuid
from typing import Any, Dict, List, Optional

SESSION_FILE = os.path.expanduser("~/.ray_tpu_torch/session")
# the directory that holds the ray_tpu_torch package: the daemons import it
# whatever the caller's working directory
PKG_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _load_session() -> Optional[Dict[str, Any]]:
    try:
        with open(SESSION_FILE) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _save_session(data: Dict[str, Any]) -> None:
    """Merge with any existing session so a second `start` on the same
    machine (head + worker) doesn't orphan the first node's processes."""
    prev = _load_session() or {}
    data = dict(data)
    data["pids"] = prev.get("pids", []) + data.get("pids", [])
    data.setdefault("gcs_address", prev.get("gcs_address"))
    os.makedirs(os.path.dirname(SESSION_FILE), exist_ok=True)
    with open(SESSION_FILE, "w") as f:
        json.dump(data, f)


def _resolve_address(args) -> str:
    addr = getattr(args, "address", None) or os.environ.get("RAY_TPU_ADDRESS")
    if not addr:
        sess = _load_session()
        addr = sess["gcs_address"] if sess else None
    if not addr:
        sys.exit("no cluster address: pass --address, set RAY_TPU_ADDRESS, "
                 "or run `ray_tpu_torch start --head` first")
    return addr


def _wait_ready(path: str, proc: subprocess.Popen, what: str, timeout=40.0) -> str:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if os.path.exists(path):
            content = open(path).read().strip()
            if content:
                return content
        if proc.poll() is not None:
            sys.exit(f"{what} exited with {proc.returncode}")
        time.sleep(0.05)
    sys.exit(f"{what} did not become ready in {timeout}s")


def cmd_start(args) -> None:
    session_dir = args.session_dir or os.path.join(
        tempfile.gettempdir(), "ray_tpu_torch", f"session-{uuid.uuid4().hex[:8]}")
    os.makedirs(session_dir, exist_ok=True)
    env = dict(os.environ)
    env["RAY_TPU_SESSION_DIR"] = session_dir
    env["PYTHONPATH"] = os.pathsep.join(p for p in (PKG_ROOT, env.get("PYTHONPATH", "")) if p)
    procs: List[int] = []

    if args.head:
        ready = os.path.join(session_dir, "gcs.ready")
        gcs_log = open(os.path.join(session_dir, "gcs.log"), "ab")
        cmd = [sys.executable, "-m", "ray_tpu_torch.core.gcs.server", "--ready-file", ready]
        if args.port:
            cmd += ["--port", str(args.port)]
        gcs = subprocess.Popen(cmd, env=env, stdout=gcs_log,
                               stderr=subprocess.STDOUT, start_new_session=True)
        gcs_address = _wait_ready(ready, gcs, "GCS")
        procs.append(gcs.pid)
    else:
        gcs_address = _resolve_address(args)

    ready = os.path.join(session_dir, f"agent-{uuid.uuid4().hex[:6]}.ready")
    agent_log = open(os.path.join(session_dir, "agent.log"), "ab")
    cmd = [
        sys.executable, "-m", "ray_tpu_torch.core.node.agent",
        "--gcs", gcs_address, "--session-dir", session_dir,
        "--ready-file", ready,
    ]
    if args.num_cpus is not None:
        cmd += ["--num-cpus", str(args.num_cpus)]
    if args.num_gpus:
        cmd += ["--num-gpus", str(args.num_gpus)]
    for kv in args.resources or []:
        cmd += ["--resource", kv]
    for kv in args.labels or []:
        cmd += ["--label", kv]
    if args.head:
        cmd += ["--head"]
    agent = subprocess.Popen(cmd, env=env, stdout=agent_log,
                             stderr=subprocess.STDOUT, start_new_session=True)
    _wait_ready(ready, agent, "node agent")
    procs.append(agent.pid)

    _save_session({"gcs_address": gcs_address, "pids": procs,
                   "session_dir": session_dir})
    role = "head" if args.head else "worker"
    print(f"started {role} node; GCS at {gcs_address}")
    print(f"session dir: {session_dir}")
    if args.head:
        print(f'connect with: ray_tpu_torch.init(address="{gcs_address}") '
              f"or RAY_TPU_ADDRESS={gcs_address}")


def _node_prefixes(gcs_address: str) -> List[str]:
    """The 8-character node-id prefixes that name the session's /dev/shm
    files (every node the GCS has seen, dead ones included)."""
    from ray_tpu_torch.core.rpc import SyncRpcClient

    try:
        gcs = SyncRpcClient(gcs_address)
        try:
            return [n["NodeID"][:8] for n in gcs.call("get_nodes", timeout=2.0)]
        finally:
            gcs.close()
    except Exception:  # noqa: BLE001 - GCS already dead: sweep dead arenas only
        return []


def _sweep_shm(prefixes: List[str]) -> None:
    """Unlink the session's /dev/shm files: a SIGKILLed agent cannot remove
    its arena or its objects itself. Scoped to the session's node ids (and
    arenas whose owner died), so other clusters on the machine are untouched."""
    from ray_tpu_torch.core.shm_store import SHM_PREFIX, sweep_dead_arenas

    try:
        names = os.listdir("/dev/shm")
    except OSError:
        return
    for name in names:
        if name.startswith(SHM_PREFIX) and any(p in name for p in prefixes):
            try:
                os.unlink(os.path.join("/dev/shm", name))
            except OSError:
                pass
    sweep_dead_arenas()


def cmd_stop(_args) -> None:
    sess = _load_session()
    if not sess:
        print("no session on record")
        return
    prefixes = _node_prefixes(sess["gcs_address"])
    # stop running jobs first: they live in their own process groups, so the
    # pid kills below would otherwise orphan them against a dead cluster
    try:
        from ray_tpu_torch.job.sdk import JobStatus, JobSubmissionClient

        client = JobSubmissionClient(sess["gcs_address"])
        for job in client.list_jobs():
            if job.get("status") == JobStatus.RUNNING:
                client.stop_job(job["job_id"])
                print(f"stopped job {job['job_id']}")
        client.close()
    except Exception:  # noqa: BLE001 - cluster may already be half-dead
        pass
    killed = []
    for pid in reversed(sess.get("pids", [])):
        try:
            os.killpg(os.getpgid(pid), signal.SIGKILL)
            killed.append(pid)
            print(f"killed process group {pid}")
        except ProcessLookupError:
            pass
        except Exception as e:  # noqa: BLE001
            print(f"failed to kill {pid}: {e}")
    _wait_gone(killed)
    _sweep_shm(prefixes)
    try:
        os.unlink(SESSION_FILE)
    except OSError:
        pass


def _wait_gone(pids: List[int], timeout: float = 10.0) -> None:
    """Wait until the killed processes are gone (reaped by whoever owns
    them), so the arena sweep sees their owners dead."""
    deadline = time.monotonic() + timeout
    for pid in pids:
        while time.monotonic() < deadline:
            try:
                with open(f"/proc/{pid}/stat") as f:
                    if f.read().rsplit(")", 1)[1].split()[0] == "Z":
                        break  # a zombie holds no memory and no file
            except OSError:
                break
            time.sleep(0.05)


def _connect(args):
    import ray_tpu_torch

    ray_tpu_torch.init(address=_resolve_address(args))


def cmd_status(args) -> None:
    _connect(args)
    from ray_tpu_torch.util import state

    s = state.cluster_summary()
    print(f"nodes alive:     {s['nodes']}")
    total, avail = s["resources_total"], s["resources_available"]
    for k in sorted(total):
        if k.startswith("node:"):
            continue
        print(f"  {k:<20} {avail.get(k, 0.0):.1f} / {total[k]:.1f}")
    d = s["debug"]
    print(f"actors: {d['actors']}  objects: {d['objects']}  "
          f"pgs: {d['pgs']}  tracked refs: {d['tracked_refs']}")
    print(f"gcs uptime: {d['uptime_s']:.0f}s")


def cmd_list(args) -> None:
    _connect(args)
    from ray_tpu_torch.util import state

    what = args.what
    rows: Any
    if what == "nodes":
        rows = state.list_nodes()
    elif what == "actors":
        rows = state.list_actors()
    elif what == "objects":
        rows = state.list_objects()
    elif what == "tasks":
        rows = state.list_tasks()
    elif what == "jobs":
        rows = state.list_jobs()
    elif what == "pgs":
        rows = state.list_placement_groups()
    else:  # pragma: no cover - argparse restricts choices
        sys.exit(f"unknown listing {what}")
    print(json.dumps(rows, indent=2, default=str))


def _dashboard_address(args) -> str:
    _connect(args)
    from ray_tpu_torch.core.worker import require_worker

    raw = require_worker().runtime.kv_get("dashboard:address")
    if not raw:
        sys.exit("no dashboard registered (head started with dashboard_port=-1?)")
    return raw.decode()


def cmd_dashboard(args) -> None:
    print(_dashboard_address(args))


def cmd_timeline(args) -> None:
    """Dump the cluster's chrome-trace timeline (reference: `ray timeline`,
    _private/profiling.py:20-40) — open the file in ui.perfetto.dev."""
    import urllib.request

    addr = _dashboard_address(args)
    with urllib.request.urlopen(f"{addr}/api/timeline", timeout=30) as resp:
        data = resp.read()
    out = args.output or "ray-tpu-torch-timeline.json"
    with open(out, "wb") as f:
        f.write(data)
    n = len(json.loads(data).get("traceEvents", []))
    print(f"wrote {n} trace events to {out} (load in ui.perfetto.dev)")


def _stream_job_logs(client, job_id: str) -> str:
    """Follow a job's log via absolute offsets (a sliding tail would stop
    advancing past the tail window) until it reaches a terminal status.
    Returns the final status."""
    from ray_tpu_torch.job.sdk import JobStatus

    offset = 0
    while True:
        status = client.get_job_status(job_id)
        while True:
            text, offset = client.read_job_logs_from(job_id, offset)
            if not text:
                break
            sys.stdout.write(text)
            sys.stdout.flush()
        if status in (JobStatus.SUCCEEDED, JobStatus.FAILED, JobStatus.STOPPED):
            return status
        time.sleep(0.3)


def cmd_submit(args) -> None:
    from ray_tpu_torch.job.sdk import JobStatus, JobSubmissionClient

    import shlex

    if not args.cmd or not " ".join(args.cmd).strip():
        sys.exit("usage: ray_tpu_torch submit [options] -- CMD [ARGS...]")
    client = JobSubmissionClient(_resolve_address(args))
    # shlex.join: the agent re-splits with shlex.split, so argv boundaries
    # (paths/args with spaces) must survive the round trip
    entrypoint = shlex.join(args.cmd)
    job_id = client.submit_job(entrypoint, working_dir=args.working_dir)
    print(f"submitted {job_id}: {entrypoint}")
    if args.no_wait:
        return
    status = _stream_job_logs(client, job_id)
    print(f"\njob {job_id}: {status}")
    sys.exit(0 if status == JobStatus.SUCCEEDED else 1)


def cmd_logs(args) -> None:
    from ray_tpu_torch.job.sdk import JobSubmissionClient

    client = JobSubmissionClient(_resolve_address(args))
    if not args.follow:
        sys.stdout.write(client.get_job_logs(args.job_id))
        return
    _stream_job_logs(client, args.job_id)


def cmd_serve(args) -> None:
    """`serve deploy/status/rollback` (reference: serve CLI -> schema flow)."""
    import json

    import ray_tpu_torch
    from ray_tpu_torch.serve import schema

    ray_tpu_torch.init(address=_resolve_address(args), log_to_driver=False)
    if args.serve_command == "deploy":
        cfg = schema.load_yaml(args.config_file)
        status = schema.apply_config(cfg, wait_for_ready=not args.no_wait)
        print(json.dumps(status, indent=2))
        sys.exit(1 if status["errors"] else 0)
    if args.serve_command == "status":
        from ray_tpu_torch import serve
        from ray_tpu_torch.serve import api as serve_api

        out = {"config": schema.current_config()}
        try:
            serve_api._state["controller"] = ray_tpu_torch.get_actor(
                "SERVE_CONTROLLER", namespace="serve")
            out["applications"] = serve.status()
        except ValueError:
            out["applications"] = {}
        print(json.dumps(out, indent=2, default=str))
        return
    if args.serve_command == "rollback":
        print(json.dumps(schema.rollback(), indent=2))
        return


def cmd_stack(args) -> None:
    """All thread stacks of every cluster component (reference: `ray stack`
    py-spy dumps; here interpreter-level via dump_stacks RPCs)."""
    from ray_tpu_torch.core.rpc import SyncRpcClient

    addr = _resolve_address(args)
    gcs = SyncRpcClient(addr)
    try:
        print(f"=== GCS {addr} ===")
        print(gcs.call("dump_stacks", timeout=15.0))
        for n in gcs.call("get_nodes"):
            if not n.get("Alive"):
                continue
            agent_addr = n["NodeManagerAddress"]
            print(f"=== node agent {n['NodeID'][:8]} @ {agent_addr} ===")
            agent = SyncRpcClient(agent_addr)
            try:
                print(agent.call("dump_stacks", timeout=15.0))
                for worker_id, dump in (agent.call(
                        "dump_worker_stacks", timeout=30.0) or {}).items():
                    print(f"=== worker {worker_id[:12]} "
                          f"(node {n['NodeID'][:8]}) ===")
                    print(dump)
            finally:
                agent.close()
    finally:
        gcs.close()


def cmd_memory(args) -> None:
    """Object-table dump with sizes/locations/holders (reference:
    `ray memory` ref-count debugging)."""
    from ray_tpu_torch.core.rpc import SyncRpcClient

    gcs = SyncRpcClient(_resolve_address(args))
    try:
        objs = gcs.call("list_objects", limit=args.limit)
    finally:
        gcs.close()
    total = sum(o["size"] or 0 for o in objs)
    print(f"{'OBJECT':48}  {'SIZE':>12}  {'LOCS':>4}  {'HOLDERS':>7}  LINEAGE")
    for o in sorted(objs, key=lambda x: -(x["size"] or 0)):
        print(f"{o['object_id'][:48]:48}  {o['size'] or 0:>12}  "
              f"{len(o['locations']):>4}  {o['holders']:>7}  "
              f"{'yes' if o['has_lineage'] else ''}")
    print(f"-- {len(objs)} objects, {total / 1e6:.1f} MB total")


def cmd_up(args) -> None:
    from ray_tpu_torch.autoscaler import launcher

    state = launcher.up(launcher.load_config(args.config_file))
    print(json.dumps({k: state[k] for k in
                      ("cluster_name", "gcs_address", "session_dir")}, indent=2))
    print(f"exec with: ray_tpu_torch exec {state['cluster_name']} -- CMD")


def cmd_down(args) -> None:
    from ray_tpu_torch.autoscaler import launcher

    launcher.down(args.cluster_name)
    print(f"cluster '{args.cluster_name}' torn down")


def cmd_exec(args) -> None:
    from ray_tpu_torch.autoscaler import launcher

    if not args.cmd:
        sys.exit("usage: ray_tpu_torch exec NAME -- CMD [ARGS...]")
    proc = launcher.exec_cmd(args.cluster_name, args.cmd)
    sys.exit(proc.returncode)


def cmd_attach(args) -> None:
    from ray_tpu_torch.autoscaler import launcher

    sys.exit(launcher.attach(args.cluster_name))


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(prog="ray_tpu_torch", description=__doc__)
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("up", help="launch a cluster from a YAML config")
    p.add_argument("config_file")
    p.set_defaults(fn=cmd_up)

    p = sub.add_parser("down", help="tear down a launched cluster")
    p.add_argument("cluster_name")
    p.set_defaults(fn=cmd_down)

    p = sub.add_parser("exec", help="run a command against a launched cluster")
    p.add_argument("cluster_name")
    p.add_argument("cmd", nargs=argparse.REMAINDER)
    p.set_defaults(fn=cmd_exec)

    p = sub.add_parser("attach", help="shell with the cluster env exported")
    p.add_argument("cluster_name")
    p.set_defaults(fn=cmd_attach)

    p = sub.add_parser("stack", help="dump all thread stacks of every component")
    p.add_argument("--address", default=None)
    p.set_defaults(fn=cmd_stack)

    p = sub.add_parser("memory", help="object table: sizes/locations/holders")
    p.add_argument("--address", default=None)
    p.add_argument("--limit", type=int, default=1000)
    p.set_defaults(fn=cmd_memory)

    p = sub.add_parser("start", help="start a head or worker node")
    p.add_argument("--head", action="store_true")
    p.add_argument("--address", default=None, help="GCS address to join")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--num-cpus", type=int, default=None)
    # --num-tpus: the JAX package's name, kept as an alias; 0 lets the agent
    # count the cards it sees
    p.add_argument("--num-gpus", "--num-tpus", dest="num_gpus", type=int, default=0)
    p.add_argument("--resources", action="append", default=[])
    p.add_argument("--labels", action="append", default=[])
    p.add_argument("--session-dir", default=None)
    p.set_defaults(fn=cmd_start)

    p = sub.add_parser("stop", help="stop nodes started on this machine")
    p.set_defaults(fn=cmd_stop)

    p = sub.add_parser("status", help="cluster summary")
    p.add_argument("--address", default=None)
    p.set_defaults(fn=cmd_status)

    p = sub.add_parser("list", help="list cluster state")
    p.add_argument("what", choices=["nodes", "actors", "objects", "tasks", "jobs", "pgs"])
    p.add_argument("--address", default=None)
    p.set_defaults(fn=cmd_list)

    p = sub.add_parser("dashboard", help="print the dashboard HTTP address")
    p.add_argument("--address", default=None)
    p.set_defaults(fn=cmd_dashboard)

    p = sub.add_parser("timeline", help="dump chrome-trace timeline JSON")
    p.add_argument("--address", default=None)
    p.add_argument("-o", "--output", default=None)
    p.set_defaults(fn=cmd_timeline)

    p = sub.add_parser("submit", help="submit a driver script as a job")
    p.add_argument("--address", default=None)
    p.add_argument("--working-dir", default=None)
    p.add_argument("--no-wait", action="store_true")
    p.add_argument("cmd", nargs=argparse.REMAINDER,
                   help="entrypoint, e.g. -- python train.py")
    p.set_defaults(fn=cmd_submit)

    p = sub.add_parser("logs", help="fetch or follow job logs")
    p.add_argument("job_id")
    p.add_argument("--address", default=None)
    p.add_argument("--follow", action="store_true")
    p.set_defaults(fn=cmd_logs)

    p = sub.add_parser("serve", help="declarative serve deploy/status/rollback")
    serve_sub = p.add_subparsers(dest="serve_command", required=True)
    sp = serve_sub.add_parser("deploy", help="apply a YAML app config")
    sp.add_argument("config_file")
    sp.add_argument("--address", default=None)
    sp.add_argument("--no-wait", action="store_true")
    sp.set_defaults(fn=cmd_serve)
    sp = serve_sub.add_parser("status", help="declarative config + app status")
    sp.add_argument("--address", default=None)
    sp.set_defaults(fn=cmd_serve)
    sp = serve_sub.add_parser("rollback", help="revert to the previous config")
    sp.add_argument("--address", default=None)
    sp.set_defaults(fn=cmd_serve)

    args = parser.parse_args(argv)
    if getattr(args, "cmd", None) and args.cmd and args.cmd[0] == "--":
        args.cmd = args.cmd[1:]
    args.fn(args)


if __name__ == "__main__":
    main()
