"""GceGpuProvider's state machine (``ray_tpu_torch.autoscaler.gce``, the
port's counterpart of the JAX package's GceTpuProvider) with ``_gcloud``
replaced by an in-memory cloud that speaks the ``compute instances`` verbs.

The seven cases of ``tests/test_gce_provider.py``, on GPU VMs: the status
mapping, a delete ending every peer with a fast path for the rest, a failed
delete freezing the group and backing off, the retry landing after the
backoff, a pending delete confirmed by two absent polls, one transient
absence, an external delete after the grace. Added: a preempted spot VM
fails, and the agent's startup script is the port's module.
"""

import pytest

import ray_tpu_torch.autoscaler.gce as gce_mod
from ray_tpu_torch.autoscaler.gce import GROUP_LABEL, GceGpuProvider
from ray_tpu_torch.autoscaler.instance_manager import (
    DRAINING, FAILED, REQUESTED, RUNNING, STARTING, TERMINATED,
)


class _FakeGce(GceGpuProvider):
    """GceGpuProvider with _gcloud replaced by an in-memory cloud."""

    def __init__(self):
        # bypass the gcloud-on-PATH check; set the same fields __init__ would
        self.project = "p"
        self.zone = "z"
        self.gcs_address = "host:1"
        self.machine_type = "a3-highgpu-8g"
        self.image_family = "f"
        self.image_project = "i"
        self.startup_script = ""
        self._instances = {}
        self._pending_deletes = {}
        self._missing_polls = {}
        self.delete_retry_s = 60.0
        # fake cloud state: VM name -> {"status", "labels", "scheduling"}
        self.cloud = {}
        self.fail_delete = False
        self.delete_calls = 0
        self.creates = []

    def _gcloud(self, *args):
        verb = args[2]
        if args[2:4] == ("bulk", "create"):
            self.creates.append(args)
            pattern = args[args.index("--name-pattern") + 1]
            label = dict([args[args.index("--labels") + 1].split("=", 1)])
            spot = "--provisioning-model" in args
            for i in range(int(args[args.index("--count") + 1])):
                self.cloud[pattern.replace("#", str(i + 1))] = {
                    "status": "PROVISIONING", "labels": label,
                    "scheduling": {"provisioningModel": "SPOT" if spot else "STANDARD"}}
            return {}
        if verb == "list":
            return [dict(vm, name=f"projects/p/zones/z/instances/{n}")
                    for n, vm in self.cloud.items()]
        if verb == "delete":
            self.delete_calls += 1
            if self.fail_delete:
                raise RuntimeError("gcloud delete: injected failure")
            for name in args[3:]:
                if not name.startswith("--"):
                    self.cloud.pop(name, None)
            return {}
        raise AssertionError(f"unexpected gcloud verb {verb}")

    def set_group(self, gid, status):
        for vm in self.cloud.values():
            if vm["labels"][GROUP_LABEL] == gid:
                vm["status"] = status

    def pop_group(self, gid):
        return {n: self.cloud.pop(n) for n in [n for n, vm in self.cloud.items()
                                               if vm["labels"][GROUP_LABEL] == gid]}


@pytest.fixture
def prov():
    return _FakeGce()


def _group(prov, hosts=2, **kw):
    insts = prov.request_group({"machine_type": "a3-highgpu-8g", "num_gpus": 8,
                                "hosts": hosts, **kw})
    assert all(i.state == REQUESTED for i in insts)
    return insts[0].group_id, insts


def test_poll_maps_cloud_states(prov):
    gid, insts = _group(prov)
    prov.poll()
    assert all(i.state == STARTING for i in insts)  # PROVISIONING -> STARTING
    prov.set_group(gid, "STAGING")
    prov.poll()
    assert all(i.state == STARTING for i in insts)
    prov.set_group(gid, "RUNNING")
    prov.poll()
    assert all(i.state == RUNNING for i in insts)


def test_terminate_removes_all_peers_and_fast_paths(prov):
    gid, insts = _group(prov)
    prov.set_group(gid, "RUNNING")
    prov.poll()
    prov.terminate(insts[0])
    assert all(i.state == TERMINATED for i in insts)
    assert not prov.cloud
    calls = prov.delete_calls
    prov.terminate(insts[1])  # peer already TERMINATED: no gcloud call
    assert prov.delete_calls == calls


def test_failed_delete_enters_pending_and_freezes_state(prov):
    gid, insts = _group(prov)
    prov.set_group(gid, "RUNNING")
    prov.poll()
    for i in insts:
        i.transition(DRAINING)  # what drain_and_terminate_group does
    prov.fail_delete = True
    prov.terminate(insts[0])
    assert gid in prov._pending_deletes
    assert all(i.state == DRAINING for i in insts)
    # a still-RUNNING listing must NOT resurrect the drained group to RUNNING
    prov.poll()
    assert all(i.state == DRAINING for i in insts)
    # and the backoff must hold: polling again within the window makes no
    # further delete attempts
    calls = prov.delete_calls
    prov.poll()
    assert prov.delete_calls == calls


def test_pending_delete_retries_after_backoff_and_lands(prov, monkeypatch):
    gid, insts = _group(prov)
    prov.set_group(gid, "RUNNING")
    prov.poll()
    prov.fail_delete = True
    prov.terminate(insts[0])
    assert gid in prov._pending_deletes
    # jump past the backoff window; the retry succeeds this time
    prov.fail_delete = False
    monkeypatch.setattr(gce_mod.time, "monotonic",
                        lambda base=gce_mod.time.monotonic(): base + 120.0)
    prov.poll()
    assert gid not in prov._pending_deletes
    assert all(i.state == TERMINATED for i in insts)
    assert not prov.cloud


def test_pending_delete_confirmed_gone_needs_two_absent_polls(prov):
    gid, insts = _group(prov)
    prov.set_group(gid, "RUNNING")
    prov.poll()
    prov.fail_delete = True
    prov.terminate(insts[0])
    # the VMs disappear server-side (the delete actually landed remotely)
    prov.pop_group(gid)
    prov.poll()  # first absence: grace — nothing finalized yet
    assert gid in prov._pending_deletes
    assert all(i.state != TERMINATED for i in insts)
    prov.poll()  # second absence: confirmed gone, no doomed delete call
    calls_before = prov.delete_calls
    assert gid not in prov._pending_deletes
    assert all(i.state == TERMINATED for i in insts)
    assert prov.delete_calls == calls_before
    assert gid not in prov._missing_polls  # counter cleaned up


def test_transient_listing_absence_does_not_kill_live_group(prov):
    gid, insts = _group(prov)
    prov.set_group(gid, "RUNNING")
    prov.poll()
    # one transient partial listing: group temporarily absent
    saved = prov.pop_group(gid)
    prov.poll()
    assert all(i.state == RUNNING for i in insts)
    prov.cloud.update(saved)  # it reappears: counter resets
    prov.poll()
    assert prov._missing_polls.get(gid, 0) == 0
    assert all(i.state == RUNNING for i in insts)


def test_externally_deleted_group_terminates_after_grace(prov):
    gid, insts = _group(prov)
    prov.set_group(gid, "RUNNING")
    prov.poll()
    prov.pop_group(gid)  # reaped behind our back
    prov.poll()
    assert all(i.state == RUNNING for i in insts)  # grace poll 1
    prov.poll()
    assert all(i.state == TERMINATED for i in insts)
    assert gid not in prov._missing_polls


# ------------------------------------------------------------------- added
def test_preempted_spot_vm_fails_and_stopped_vm_terminates(prov):
    gid, insts = _group(prov, spot=True)
    prov.set_group(gid, "RUNNING")
    prov.poll()
    prov.cloud[insts[0].instance_id]["status"] = "TERMINATED"  # preempted
    prov.poll()
    assert insts[0].state == FAILED and insts[1].state == RUNNING
    gid2, insts2 = _group(prov)
    prov.set_group(gid2, "RUNNING")
    prov.poll()
    prov.cloud[insts2[0].instance_id]["status"] = "STOPPING"  # not spot: stopped
    prov.poll()
    assert insts2[0].state == TERMINATED


def test_one_bulk_create_per_group_starts_the_ports_agent(prov):
    gid, insts = _group(prov, hosts=3, slice_label="h100-24")
    assert len(prov.creates) == 1 and gid.startswith("rtpt-")
    args = prov.creates[0]
    assert args[args.index("--count") + 1] == "3"
    assert [i.instance_id for i in insts] == [f"{gid}-1", f"{gid}-2", f"{gid}-3"]
    script = args[args.index("--metadata") + 1]
    # the agent listens on the VM's first address, where the GCS reaches it
    assert script == ("startup-script=python -m ray_tpu_torch.core.node.agent --gcs host:1 "
                      "--num-gpus 8 --host \"$(hostname -I | cut -d' ' -f1)\" "
                      f"--label ray_tpu.io/slice=h100-24-{gid}")
