"""Cluster state API: list/inspect nodes, actors, objects, tasks, jobs, logs
(own copy of ray_tpu.util.state).

Reference capability: python/ray/util/state/api.py (list_nodes/actors/
objects/tasks, get_log:1168) — there backed by the dashboard's state head;
here the client aggregates straight from the GCS + node agents (no separate
observability service to run).
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

from ray_tpu_torch.core.rpc import SyncRpcClient
from ray_tpu_torch.core.worker import require_worker


def _gcs() -> SyncRpcClient:
    w = require_worker()
    gcs = getattr(w.runtime, "gcs", None)
    if gcs is None:
        raise RuntimeError(
            "the state API requires a cluster runtime "
            "(ray_tpu_torch.init(address=...)); the in-process backend has no GCS"
        )
    return gcs


def _agents() -> List[Dict[str, Any]]:
    return [n for n in _gcs().call("get_nodes") if n["Alive"]]


def list_nodes() -> List[Dict[str, Any]]:
    return _gcs().call("get_nodes")


def list_actors() -> List[Dict[str, Any]]:
    return _gcs().call("list_actors")


def list_objects(limit: int = 1000) -> List[Dict[str, Any]]:
    return _gcs().call("list_objects", limit=limit)


def list_placement_groups() -> Dict[str, Dict[str, Any]]:
    return _gcs().call("placement_group_table")


def list_tasks() -> List[Dict[str, Any]]:
    """Per-task lifecycle states aggregated from every node agent."""
    out: List[Dict[str, Any]] = []
    for node in _agents():
        client = SyncRpcClient(node["NodeManagerAddress"])
        try:
            for task_id, state in client.call("task_states").items():
                out.append({"task_id": task_id, "state": state,
                            "node_id": node["NodeID"]})
        except Exception:  # noqa: BLE001 - a dying node must not break listing
            continue
        finally:
            client.close()
    return out


def list_jobs() -> List[Dict[str, Any]]:
    """The jobs recorded under the GCS KV's ``job:`` keys, read through
    ``job/sdk.py:list_jobs_from_gcs`` as the JAX package's is."""
    from ray_tpu_torch.job.sdk import list_jobs_from_gcs

    return list_jobs_from_gcs(_gcs())


def cluster_summary() -> Dict[str, Any]:
    gcs = _gcs()
    return {
        "debug": gcs.call("debug_state"),
        "nodes": len([n for n in gcs.call("get_nodes") if n["Alive"]]),
        "resources_total": gcs.call("cluster_resources"),
        "resources_available": gcs.call("available_resources"),
    }


def _agent_for(node_id: Optional[str]) -> Optional[str]:
    for n in _agents():
        if node_id is None or n["NodeID"] == node_id:
            return n["NodeManagerAddress"]
    return None


def get_log(filename: str, node_id: Optional[str] = None,
            tail_bytes: int = 65536) -> bytes:
    addr = _agent_for(node_id)
    if addr is None:
        raise ValueError(f"no alive node {node_id}")
    client = SyncRpcClient(addr)
    try:
        return client.call("get_log", name=filename, tail_bytes=tail_bytes)
    finally:
        client.close()


def list_logs(node_id: Optional[str] = None) -> List[str]:
    addr = _agent_for(node_id)
    if addr is None:
        raise ValueError(f"no alive node {node_id}")
    client = SyncRpcClient(addr)
    try:
        return client.call("list_logs")
    finally:
        client.close()
