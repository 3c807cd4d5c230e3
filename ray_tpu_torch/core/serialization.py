"""Process-local Arrow decode accounting (own copy of the counters of
ray_tpu.core.serialization that Data's shuffle coordinator reads).

The rest of the serializer (the IPC path, out-of-band Arrow buffers, the
tensor reducers) belongs to the cluster runtime and comes with that slice.
In the in-process runtime nothing is decoded from IPC payloads, so both
counters stay 0.
"""

from __future__ import annotations

from typing import Dict

# Bytes of Arrow columns reconstructed as views over an IPC payload
# (zero-copy) and bytes whose layout forced a copy or decode on access.
# Sampled by the shuffle coordinator's baseline and diff.
arrow_decode_stats: Dict[str, int] = {"zero_copy_bytes": 0, "copied_bytes": 0}


def arrow_decode_snapshot() -> Dict[str, int]:
    return dict(arrow_decode_stats)
