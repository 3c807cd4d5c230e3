"""Agent-side full re-registration after a GCS restart.

The agent detects the new GCS incarnation from the ``gcs_epoch`` riding
every heartbeat ack (or a ``False`` ack: the restarted GCS had no snapshot
and lost the node table entirely), then re-plays its durable local truth so
the directory converges without any history replay:

- the node itself (resources, labels, address);
- every SEALED object in the local store, over the batched
  ``register_objects`` channel (this is what confirms the reconstruction
  window's provisional locations);
- every live actor worker (``actor_started`` re-binds the restored actor
  record to the worker's address);
- in-progress task pins (``pin_tasks`` re-asserts leases taken after the
  last snapshot, so in-flight returns can't be GC'd mid-outage).

One resync runs at a time; triggers arriving mid-run are coalesced into a
single follow-up pass (the epoch may have bumped AGAIN under chaos).
"""

from __future__ import annotations

import asyncio
from typing import Any, Dict, List

from ray_tpu_torch.core.config import config
from ray_tpu_torch.utils.logging import get_logger

logger = get_logger("agent_resync")


def trigger_resync(agent, reason: str) -> None:
    """Idempotent kick: start (or queue a re-run of) the resync task.
    Safe to call from the heartbeat loop on every epoch-bump observation."""
    from ray_tpu_torch.core.rpc import spawn

    if getattr(agent, "_resync_task", None) is not None and \
            not agent._resync_task.done():
        agent._resync_rerun = True
        return
    agent._resync_rerun = False
    agent._resync_task = spawn(full_resync(agent, reason))


async def full_resync(agent, reason: str) -> None:
    """Named coroutine (visible in dump_stacks as ``full_resync``) doing the
    re-registration passes; loops while triggers landed mid-run."""
    while True:
        try:
            await _resync_once(agent, reason)
        except Exception:  # noqa: BLE001 - the next heartbeat re-triggers
            logger.exception("GCS resync failed (will retry on next "
                             "heartbeat epoch observation)")
            return
        if not getattr(agent, "_resync_rerun", False):
            return
        agent._resync_rerun = False
        reason = "re-triggered during resync"


async def _resync_once(agent, reason: str) -> None:
    logger.info("full GCS resync (%s)", reason)
    resp = await agent.gcs.call(
        "register_node",
        node_id=agent.hex,
        address=agent.rpc.address,
        resources=agent.total_resources,
        labels=agent.labels,
        is_head=agent.is_head,
    )
    epoch = (resp or {}).get("gcs_epoch")
    if epoch is not None:
        agent._last_gcs_epoch = epoch
    agent._hb_full_pending = True

    # -- objects: every sealed local copy re-enters the directory ----------
    regs: List[Dict[str, Any]] = []
    for oid, size in agent.store.sealed_items():
        h = oid.hex()
        owner, contained = agent._object_meta.get(h, ("", None))
        if h in agent.error_objects and not owner.endswith(":error"):
            owner = (owner or "task") + ":error"
        regs.append({"object_id": h, "size": size, "node_id": agent.hex,
                     "owner": owner, "contained": contained})
    batch = max(1, config.recovery_resync_batch)
    for i in range(0, len(regs), batch):
        await agent.gcs.call("register_objects", regs=regs[i:i + batch])

    # -- actors: re-bind restored records to their live workers ------------
    actors = 0
    for w in list(agent._workers.values()):
        if w.actor_id is None or w.state == "DEAD" or w.address is None:
            continue
        try:
            ok = await agent.gcs.call("actor_started", actor_id=w.actor_id,
                                      node_id=agent.hex, address=w.address)
            actors += 1
            if ok is False:
                # record unknown even after restore (created inside the last
                # snapshot interval): the owning driver's parked create_actor
                # retry re-registers it; nothing to do here
                logger.warning("actor %s unknown to restarted GCS",
                               w.actor_id[:8])
        except Exception:  # noqa: BLE001 - per-actor; keep resyncing
            logger.exception("actor_started resync failed")

    # -- leases: re-assert pins of tasks still in flight on this node ------
    pins = [dict(p) for p in agent._active_pins.values()]
    if pins:
        await agent.gcs.call("pin_tasks", pins=pins)

    agent._resyncs += 1
    logger.info("resync done: %d objects, %d actors, %d pins re-registered",
                len(regs), actors, len(pins))
