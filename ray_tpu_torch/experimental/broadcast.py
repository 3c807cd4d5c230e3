"""Proactive object broadcast (own copy of ray_tpu.experimental.broadcast;
reference: push_manager.h pushes; the
ray.experimental broadcast-ish utilities). ``broadcast(ref)`` replicates a
sealed object to every alive node (or an explicit node list) via the
agents' binomial push tree — each node uploads at most twice, so an N-node
broadcast completes in ~log2(N) rounds instead of N serial pulls from the
one seeded copy."""

from __future__ import annotations

from typing import List, Optional

import ray_tpu_torch
from ray_tpu_torch.core.object_ref import ObjectRef


def broadcast(ref: ObjectRef, node_ids: Optional[List[str]] = None,
              timeout: float = 600.0) -> int:
    """Replicate ``ref`` to ``node_ids`` (default: every alive node).
    Returns the number of nodes newly holding a copy. Local runtime: no-op
    (single store)."""
    from ray_tpu_torch.core.worker import global_worker

    runtime = global_worker().runtime
    agent = getattr(runtime, "agent", None)
    if agent is None:
        return 0  # in-process runtime: one store, nothing to push
    # make sure the object is local to OUR agent (the tree root)
    ray_tpu_torch.wait([ref], num_returns=1, timeout=timeout)
    if node_ids is None:
        node_ids = [n["NodeID"] for n in runtime.nodes() if n.get("Alive", True)]
    targets = [n for n in node_ids if n != runtime.node_hex]
    if not targets:
        return 0
    agent.call("ensure_local", object_id=ref.id.hex(), timeout_s=timeout,
               timeout=timeout + 5)
    out = agent.call("push_object", object_id=ref.id.hex(), targets=targets,
                     timeout=timeout)
    failed = out.get("failed") or {}
    if failed:
        from ray_tpu_torch.utils.logging import get_logger

        get_logger("broadcast").warning(
            "broadcast of %s missed %d node(s): %s",
            ref.id.hex()[:16], len(failed),
            {k[:8]: v for k, v in failed.items()})
    return int(out.get("pushed", 0))
