"""GPU accelerator manager: card detection, the node's resource and labels,
per-process card visibility (the port's counterpart of
ray_tpu.core.accelerators, which does the same for TPU chips).

Reference capability: python/ray/_private/accelerators/nvidia_gpu.py (card
detection, ``CUDA_VISIBLE_DEVICES`` so a worker sees its cards only).

- Detection counts the cards ``nvidia-smi`` lists, else the card device
  files (``/dev/nvidia0``...) as the JAX package counts ``/dev/accel*``:
  the agent never imports torch for it, so no CUDA context is created in a
  daemon. An inherited ``CUDA_VISIBLE_DEVICES`` restricts the node to the
  cards it names.
- Any subset of cards is handed to a worker through ``CUDA_VISIBLE_DEVICES``
  (GPUs need no bounds recipe, where libtpu needs one per subset size).
- Labels keep the JAX package's keys: ``ACCEL_LABEL`` carries the card's
  product name and ``SLICE_LABEL`` the host, one NVLink domain, so the
  GCS's same-slice preference for ``STRICT_PACK`` keeps a gang on one host.
"""

from __future__ import annotations

import functools
import glob
import os
import shutil
import socket
import subprocess
from typing import Dict, List, Optional, Tuple

CUDA_VISIBLE_DEVICES_ENV = "CUDA_VISIBLE_DEVICES"
# test/dev override: pretend this many cards exist (the counterpart of the
# JAX package's RAY_TPU_FAKE_TPU_CHIPS)
FAKE_GPUS_ENV = "RAY_TPU_FAKE_GPUS"
# the slice label's value when a launcher groups hosts itself (the JAX
# package's name for the same override)
SLICE_NAME_ENV = "RAY_TPU_SLICE_NAME"

SLICE_LABEL = "ray_tpu.io/slice"
ACCEL_LABEL = "ray_tpu.io/accelerator"


@functools.lru_cache(maxsize=1)
def _smi_names() -> Tuple[str, ...]:
    """The product names of the cards ``nvidia-smi`` lists (asked once a
    process; it creates no CUDA context). Empty without ``nvidia-smi``."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return ()
    try:
        out = subprocess.run([smi, "--query-gpu=name", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return ()
    if out.returncode != 0:
        return ()
    return tuple(line.strip() for line in out.stdout.splitlines() if line.strip())


def _host_device_ids() -> List[str]:
    """CUDA ordinals (``0..n-1``) of the cards this process could see before
    any inherited visibility: n is the count of cards ``nvidia-smi`` lists,
    else of the card device files (``/dev/nvidia0``...) where it is
    missing. nvidia-smi comes first: a sandboxed machine with one H100 was
    seen to expose two device files. A device file's own number is the
    host's index, which a container that exposes one card of many does not
    renumber, so only the count is used. Neither way creates a CUDA
    context."""
    n = len(_smi_names())
    if not n:
        n = len([p for p in glob.glob("/dev/nvidia[0-9]*")
                 if p[len("/dev/nvidia"):].isdigit()])
    return [str(i) for i in range(n)]


def device_ids() -> List[str]:
    """The ids, in ``CUDA_VISIBLE_DEVICES`` terms, of the cards this node may
    hand out: the fake count's ``0..n-1``, else the host's cards, restricted
    to an inherited ``CUDA_VISIBLE_DEVICES`` where one is set."""
    fake = os.environ.get(FAKE_GPUS_ENV)
    if fake:
        return [str(i) for i in range(int(fake))]
    host = _host_device_ids()
    visible = os.environ.get(CUDA_VISIBLE_DEVICES_ENV)
    if visible is None or not host:
        return host
    out: List[str] = []
    for v in (v.strip() for v in visible.split(",")):
        if not v or (v.lstrip("-").isdigit() and int(v) < 0):
            break  # CUDA stops at the first invalid entry
        out.append(v)
    return out[:len(host)]


def detect_num_chips() -> int:
    """Cards this node owns (the JAX package's name, kept)."""
    return len(device_ids())


def accelerator_type() -> Optional[str]:
    """The card's product name (``NVIDIA H100 80GB HBM3``) from
    ``nvidia-smi``. None without a card, and for fake cards."""
    if os.environ.get(FAKE_GPUS_ENV) or not device_ids():
        return None
    names = _smi_names()
    return names[0] if names else None


def slice_name() -> str:
    """The node's NVLink domain: its host, unless overridden."""
    return os.environ.get(SLICE_NAME_ENV) or socket.gethostname()


def node_gpu_labels() -> Dict[str, str]:
    """Topology labels the GCS planner keys on (same-slice gang placement)."""
    labels: Dict[str, str] = {SLICE_LABEL: slice_name()}
    acc = accelerator_type()
    if acc:
        labels[ACCEL_LABEL] = acc
    return labels


def node_gpu_resources(num_chips: Optional[int] = None) -> Dict[str, float]:
    """The node's GPU resource (``{"GPU": n}``; empty without a card)."""
    chips = detect_num_chips() if num_chips is None else num_chips
    return {"GPU": float(chips)} if chips > 0 else {}


def visible_chip_env(chip_ids: List[int], total_chips: int) -> Dict[str, str]:
    """Env that restricts a worker to cards ``chip_ids`` (indices into this
    node's cards, 0..total_chips-1), for any subset."""
    ids = device_ids()
    if len(ids) < total_chips:  # a count given explicitly, beyond detection
        ids = ids + [str(i) for i in range(len(ids), total_chips)]
    return {CUDA_VISIBLE_DEVICES_ENV: ",".join(ids[c] for c in chip_ids)}
