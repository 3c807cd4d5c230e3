"""GCE GPU-VM cloud provider behind the CloudProvider interface (the port's
counterpart of the JAX package's GceTpuProvider).

Reference capability: python/ray/autoscaler/_private/gcp/node_provider.py.
A group of ``hosts`` GPU VMs is provisioned by ONE ``gcloud compute
instances bulk create`` call, every VM carrying the group's label; each VM's
startup script then starts a node agent joining the same GCS with its cards
and the group's slice label — the contract FakeCloudProvider simulates, so
the autoscaler/InstanceManager logic above is identical in CI and on a real
cloud.

This provider shells out to ``gcloud`` (no cloud SDK dependency baked into
the image); it raises a clear error when gcloud is unavailable. Methods are
deliberately thin: each maps to one control-plane call, and poll() derives
instance state from ``gcloud compute instances list`` filtered by the
label. The state machine is the TPU provider's: pending deletes freeze a
group, a group absent from two polls in a row is gone, a failed delete is
retried after a backoff, and deleting a group ends all its peers at once.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import time
import uuid
from typing import Any, Dict, List

from ray_tpu_torch.autoscaler.instance_manager import (
    FAILED, REQUESTED, RUNNING, STARTING, TERMINATED, CloudProvider, Instance,
)
from ray_tpu_torch.autoscaler.node_provider import node_gpus
from ray_tpu_torch.core.accelerators import SLICE_LABEL
from ray_tpu_torch.utils.logging import get_logger

logger = get_logger("autoscaler.gce")

# the GCE label every VM of a group carries (value: the group id)
GROUP_LABEL = "rtpt-group"
# the port's machine prefix (the JAX package's is rtpu-)
NAME_PREFIX = "rtpt-"
# every host starts a node agent pointed at the GCS, with its cards and the
# group's slice label (mirrors FakeCloudProvider._launch); it listens on the
# VM's first address, which the GCS and the other nodes reach, not loopback
AGENT_SCRIPT = ("python -m ray_tpu_torch.core.node.agent --gcs {gcs} --num-gpus {gpus} "
                "--host \"$(hostname -I | cut -d' ' -f1)\" "
                "--label " + SLICE_LABEL + "={slice}")


def group_slice_label(group_config: Dict[str, Any], group_id: str) -> str:
    """The slice label every node of the group registers with."""
    return f"{group_config.get('slice_label', 'gpu')}-{group_id}"

# gcloud VM status -> instance-manager state (PREEMPTED: see _vm_state)
_STATE_MAP = {
    "PROVISIONING": STARTING,
    "STAGING": STARTING,
    "RUNNING": RUNNING,
    "STOPPING": TERMINATED,
    "TERMINATED": TERMINATED,
    "PREEMPTED": FAILED,
}


def _vm_state(vm: Dict[str, Any]) -> str:
    """The VM's status, or PREEMPTED for a spot VM that was stopped (GCE
    reports a preempted VM as STOPPING, then TERMINATED)."""
    status = vm.get("status", "")
    scheduling = vm.get("scheduling") or {}
    spot = scheduling.get("provisioningModel") == "SPOT" or scheduling.get("preemptible")
    if status in ("STOPPING", "TERMINATED") and spot:
        return "PREEMPTED"
    return status


class GceGpuProvider(CloudProvider):
    """GPU-VM groups via gcloud (one bulk create per group; ``machine_type``
    like "a3-highgpu-8g" and ``num_gpus`` come from the group config)."""

    def __init__(self, project: str, zone: str, gcs_address: str,
                 machine_type: str = "a3-highgpu-8g",
                 image_family: str = "common-cu124-ubuntu-2204",
                 image_project: str = "deeplearning-platform-release",
                 startup_script: str = ""):
        if shutil.which("gcloud") is None:
            raise RuntimeError(
                "GceGpuProvider requires the gcloud CLI on PATH. Install the "
                "Google Cloud SDK, or use FakeCloudProvider for local testing."
            )
        self.project = project
        self.zone = zone
        self.gcs_address = gcs_address
        self.machine_type = machine_type
        self.image_family = image_family
        self.image_project = image_project
        # "": each group's own AGENT_SCRIPT (its cards and slice label)
        self.startup_script = startup_script
        self._instances: Dict[str, Instance] = {}
        # groups whose gcloud delete failed: retried by poll() until it
        # lands (the group is already drained, so nothing else re-triggers
        # terminate() for it). gid -> earliest next retry time; the backoff
        # keeps a hanging delete (300s subprocess timeout) from stalling
        # every poll cycle.
        self._pending_deletes: Dict[str, float] = {}
        self.delete_retry_s = 60.0
        # group id -> consecutive polls absent from `instances list` (grace
        # against transiently partial/empty list responses)
        self._missing_polls: Dict[str, int] = {}

    def _gcloud(self, *args: str) -> Any:
        # `instances list` takes a list of zones, the other verbs one
        zone_flag = "--zones" if args[1:3] == ("instances", "list") else "--zone"
        try:
            out = subprocess.run(
                ["gcloud", *args, "--project", self.project, zone_flag,
                 self.zone, "--format", "json"],
                capture_output=True, text=True, timeout=300,
            )
        except subprocess.SubprocessError as e:
            # normalize hangs (TimeoutExpired) etc. into the RuntimeError the
            # retry machinery catches — a hung delete must still enter
            # _pending_deletes
            raise RuntimeError(f"gcloud {' '.join(args[:3])}: {e!r}") from e
        if out.returncode != 0:
            raise RuntimeError(f"gcloud {' '.join(args[:3])}: {out.stderr[:500]}")
        return json.loads(out.stdout or "null")

    def request_group(self, group_config: Dict[str, Any]) -> List[Instance]:
        hosts = int(group_config.get("hosts", 1))
        name = f"{NAME_PREFIX}{uuid.uuid4().hex[:8]}"
        script = self.startup_script or AGENT_SCRIPT.format(
            gcs=self.gcs_address, gpus=node_gpus(group_config),
            slice=group_slice_label(group_config, name))
        args = [
            "compute", "instances", "bulk", "create",
            "--name-pattern", f"{name}-#",
            "--count", str(hosts),
            "--machine-type", group_config.get("machine_type", self.machine_type),
            "--image-family", group_config.get("image_family", self.image_family),
            "--image-project", group_config.get("image_project", self.image_project),
            "--maintenance-policy", "TERMINATE",
            "--labels", f"{GROUP_LABEL}={name}",
            "--metadata", f"startup-script={script}",
        ]
        if group_config.get("spot"):
            args += ["--provisioning-model", "SPOT"]
        self._gcloud(*args)
        out = []
        for h in range(hosts):
            # bulk create numbers the pattern's # from 1
            inst = Instance(
                instance_id=f"{name}-{h + 1}", group_id=name,
                node_config=dict(group_config), state=REQUESTED,
            )
            self._instances[inst.instance_id] = inst
            out.append(inst)
        return out

    def poll(self) -> None:
        try:
            listed = self._gcloud("compute", "instances", "list", "--filter",
                                  f"labels.{GROUP_LABEL}:*") or []
        except RuntimeError:
            logger.exception("instances list failed")
            return
        states = {vm["name"].rsplit("/", 1)[-1]: _vm_state(vm) for vm in listed}
        listed_groups = {(vm.get("labels") or {}).get(GROUP_LABEL) for vm in listed}
        live_groups = {i.group_id for i in self._instances.values()
                       if i.state not in (TERMINATED, FAILED)}
        for gid in live_groups:
            if gid in listed_groups:
                self._missing_polls.pop(gid, None)
            else:
                self._missing_polls[gid] = self._missing_polls.get(gid, 0) + 1
        # retry failed deletes (the group was already drained, so no other
        # path re-issues them). A pending group confirmed absent — the same
        # 2-consecutive-poll grace as below, so one partial listing can't
        # leak a live VM — is already gone server-side; don't shell out a
        # doomed NOT_FOUND delete for it.
        for gid, next_retry in list(self._pending_deletes.items()):
            if gid not in listed_groups and self._missing_polls.get(gid, 0) >= 2:
                self._pending_deletes.pop(gid, None)
                self._finish_group(gid)
            elif gid in listed_groups and time.monotonic() >= next_retry:
                if self._try_delete(gid):
                    self._pending_deletes.pop(gid, None)
                    self._finish_group(gid)
                else:
                    # recompute the clock AFTER the attempt: a delete that
                    # blocked to its 300s subprocess timeout must still get
                    # a full backoff window, not an already-expired one
                    self._pending_deletes[gid] = (
                        time.monotonic() + self.delete_retry_s)
        for inst in self._instances.values():
            if inst.state in (TERMINATED, FAILED):
                continue
            if inst.group_id in self._pending_deletes:
                # delete in flight: freeze the state machine so a still-RUNNING
                # listing can't resurrect a drained group back to RUNNING
                continue
            cloud_state = states.get(inst.instance_id)
            if cloud_state is None:
                # the VM is absent from the listing. A REQUESTED instance may
                # simply not appear yet; for anything past that, require two
                # consecutive absent polls of its group (one transient
                # partial/empty list response must not strand a live group)
                # before declaring it externally deleted.
                if inst.state != REQUESTED and \
                        self._missing_polls.get(inst.group_id, 0) >= 2:
                    inst.transition(TERMINATED)
                continue
            mapped = _STATE_MAP.get(cloud_state, inst.state)
            if mapped != inst.state:
                inst.transition(mapped)
        # drop counters for groups with no live instances left (group names
        # are fresh uuids, so stale entries would otherwise accumulate)
        still_live = {i.group_id for i in self._instances.values()
                      if i.state not in (TERMINATED, FAILED)}
        for gid in list(self._missing_polls):
            if gid not in still_live:
                del self._missing_polls[gid]

    def _try_delete(self, group_id: str) -> bool:
        names = sorted(i.instance_id for i in self._instances.values()
                       if i.group_id == group_id)
        try:
            self._gcloud("compute", "instances", "delete", *names, "--quiet")
            return True
        except RuntimeError:
            logger.exception("instances delete failed for group %s", group_id)
            return False

    def delete_group(self, group_id: str, instance_ids: List[str] = ()) -> bool:
        """Delete every VM of a group in one call, now; False when the delete
        failed. ``instance_ids`` names the VMs of a group an earlier process
        requested (``down`` reads them from the cluster's state file)."""
        for iid in instance_ids:
            self._instances.setdefault(
                iid, Instance(instance_id=iid, group_id=group_id, state=RUNNING))
        if not self._try_delete(group_id):
            return False
        self._finish_group(group_id)
        return True

    def _finish_group(self, group_id: str) -> None:
        self._missing_polls.pop(group_id, None)
        for p in self._instances.values():
            if p.group_id == group_id and p.state != TERMINATED:
                p.transition(TERMINATED)

    def terminate(self, instance: Instance) -> None:
        # one delete removes every VM of the group; peers are transitioned
        # together, so later terminate() calls for the same group fast-path
        # out here
        if instance.state == TERMINATED:
            return
        gid = instance.group_id
        if gid in self._pending_deletes:
            return  # delete already queued; poll() keeps retrying it
        if not self.delete_group(gid):
            self._pending_deletes[gid] = time.monotonic() + self.delete_retry_s

    def instances(self) -> List[Instance]:
        return list(self._instances.values())
