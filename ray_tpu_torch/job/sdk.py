"""Job submission SDK (own copy of ray_tpu.job.sdk).

Reference capability: python/ray/dashboard/modules/job/sdk.py:35
(JobSubmissionClient, submit_job:125, get_job_status, get_job_logs,
stop_job) — there an HTTP client against the dashboard's job head; here a
thin RPC client against the head node agent (the job supervisor), with job
metadata mirrored in GCS KV so status is queryable from anywhere.
"""

from __future__ import annotations

import json
import time
from typing import Any, Dict, List, Optional

from ray_tpu_torch.core.rpc import SyncRpcClient


def list_jobs_from_gcs(gcs: SyncRpcClient) -> List[Dict[str, Any]]:
    """Single source of truth for the job-KV schema (shared by the SDK and
    the state API)."""
    out = []
    for key in gcs.call("kv_keys", prefix="job:"):
        raw = gcs.call("kv_get", key=key)
        if raw:
            try:
                out.append(json.loads(raw))
            except ValueError:
                pass
    return out


class JobStatus:
    RUNNING = "RUNNING"
    SUCCEEDED = "SUCCEEDED"
    FAILED = "FAILED"
    STOPPED = "STOPPED"


class JobSubmissionClient:
    """address = GCS host:port (jobs run on the head node's agent)."""

    def __init__(self, address: str):
        self.gcs = SyncRpcClient(address)
        nodes = [n for n in self.gcs.call("get_nodes") if n["Alive"]]
        if not nodes:
            raise RuntimeError(f"no alive nodes at {address}")
        head = next((n for n in nodes if n.get("is_head")), nodes[0])
        self.agent = SyncRpcClient(head["NodeManagerAddress"])

    def submit_job(
        self,
        entrypoint: str,
        env: Optional[Dict[str, str]] = None,
        working_dir: Optional[str] = None,
    ) -> str:
        """entrypoint: shell command, e.g. "python train.py --epochs 3".
        The driver process gets RAY_TPU_ADDRESS so ray_tpu_torch.init() inside it
        connects to this cluster."""
        return self.agent.call(
            "submit_job", entrypoint=entrypoint, env=env, working_dir=working_dir
        )

    def get_job_status(self, job_id: str) -> Optional[str]:
        raw = self.gcs.call("kv_get", key=f"job:{job_id}")
        if raw is None:
            return None
        return json.loads(raw)["status"]

    def get_job_info(self, job_id: str) -> Optional[Dict[str, Any]]:
        raw = self.gcs.call("kv_get", key=f"job:{job_id}")
        return json.loads(raw) if raw else None

    def get_job_logs(self, job_id: str, tail_bytes: int = 65536) -> str:
        return self.agent.call(
            "job_logs", job_id=job_id, tail_bytes=tail_bytes
        ).decode(errors="replace")

    def read_job_logs_from(self, job_id: str, offset: int,
                           max_bytes: int = 65536) -> tuple:
        """Absolute-offset streaming read: returns (text, next_offset).
        Followers use this instead of the sliding tail (which silently stops
        advancing once a log exceeds the tail window)."""
        out = self.agent.call(
            "job_logs", job_id=job_id, tail_bytes=max_bytes, offset=offset
        )
        return out["data"].decode(errors="replace"), out["offset"]

    def stop_job(self, job_id: str) -> bool:
        return self.agent.call("stop_job", job_id=job_id)

    def list_jobs(self) -> List[Dict[str, Any]]:
        return list_jobs_from_gcs(self.gcs)

    def wait_until_finished(self, job_id: str, timeout: float = 300.0) -> str:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            status = self.get_job_status(job_id)
            if status in (JobStatus.SUCCEEDED, JobStatus.FAILED, JobStatus.STOPPED):
                return status
            time.sleep(0.25)
        raise TimeoutError(f"job {job_id} still running after {timeout}s")

    def close(self) -> None:
        self.agent.close()
        self.gcs.close()
