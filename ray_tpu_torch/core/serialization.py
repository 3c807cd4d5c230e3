"""Object serialization: cloudpickle + pickle-5 out-of-band buffers (own
copy of ray_tpu.core.serialization, with a torch tensor reducer where the
JAX package has its jax.Array one).

Capability-equivalent to the reference's serialization stack
(reference: python/ray/_private/serialization.py + includes/serialization.pxi):

- values are pickled with cloudpickle (protocol 5); large contiguous buffers
  (numpy arrays, tensors' host bytes, arrow buffers, bytes) are extracted
  out-of-band so the object store can hold them contiguously and readers can
  reconstruct **zero-copy** views over shared memory;
- ``ObjectRef``s contained inside a value are captured during serialization
  (the borrowing hook) so the runtime can track nested references;
- a custom-serializer registry mirrors ``ray.util.register_serializer``.

Wire format of a stored object:
    [u32 n_buffers][u64 meta_len][u64 len_0]...[u64 len_{n-1}][meta_pickle][buf_0]...[buf_n]
with 64-byte alignment for each out-of-band buffer so numpy views are
aligned for vectorized readers.

A ``torch.Tensor`` (or ``nn.Parameter``) travels as ONE contiguous host
buffer, out of band, with its dtype, shape and device type beside it
(bf16 and the other dtypes numpy lacks go as unsigned integers of their
width: bf16 as ``uint16``); torch's own storage pickling is never used, since it copies in band
and would rebuild a CUDA tensor in a process that has no card. At load, a
tensor that left from ``cuda`` lands on ``cuda`` in a process that sees a
card and on the CPU otherwise; any other tensor lands on the CPU. A loaded
CPU tensor owns its memory (one copy out of the payload): torch has no
read-only tensors, and a tensor aliasing the shared store would let one
reader's write corrupt every other reader's object.
"""

from __future__ import annotations

import pickle
import struct
import sys
import threading
import warnings
from typing import Any, Callable, Dict, List, Optional, Tuple

import cloudpickle

ALIGN = 64

_custom_serializers: Dict[type, Tuple[Callable, Callable]] = {}
_custom_lock = threading.Lock()

# Thread-local capture of ObjectRefs encountered while pickling a value.
_capture = threading.local()

# Thread-local marker for reads whose source buffer is PINNED for the
# caller's lifetime (a worker resolving task args: the agent holds the deps
# pinned until the task completes). Inside this window an arena-backed read
# may decode directly over the live shm mapping — columns/arrays alias the
# arena instead of a heap copy. Outside it (driver gets, ad-hoc gets inside
# task bodies), nothing guarantees the slot isn't evicted+recycled later,
# so readers must copy (PR 3's read_chunk_raw copy-under-pressure rule).
_pinned_reads = threading.local()

# Process-local decode accounting for the columnar exchange: bytes of Arrow
# columns reconstructed as views over the IPC payload (zero-copy) vs bytes
# of columns whose layout forces a copy/decode on access (pyobj and other
# non-fixed-width fallbacks). Sampled by ShuffleCoordinator baseline/diff.
arrow_decode_stats: Dict[str, int] = {"zero_copy_bytes": 0, "copied_bytes": 0}


class pinned_reads:
    """``with serialization.pinned_reads():`` — marks the current thread as
    holding pins over every object it reads (nestable)."""

    def __enter__(self):
        _pinned_reads.depth = getattr(_pinned_reads, "depth", 0) + 1
        return self

    def __exit__(self, *exc):
        _pinned_reads.depth = getattr(_pinned_reads, "depth", 1) - 1
        return False


def pinned_reads_active() -> bool:
    return getattr(_pinned_reads, "depth", 0) > 0


def arrow_decode_snapshot() -> Dict[str, int]:
    return dict(arrow_decode_stats)


def register_serializer(cls: type, *, serializer: Callable, deserializer: Callable) -> None:
    """Register a custom reducer for ``cls`` (like ray.util.register_serializer)."""
    with _custom_lock:
        _custom_serializers[cls] = (serializer, deserializer)


def deregister_serializer(cls: type) -> None:
    with _custom_lock:
        _custom_serializers.pop(cls, None)


class _Pickler(cloudpickle.Pickler):
    def reducer_override(self, obj: Any):
        # ObjectRef capture hook: record and serialize by id.
        from ray_tpu_torch.core.object_ref import ObjectRef

        if isinstance(obj, ObjectRef):
            captured = getattr(_capture, "refs", None)
            if captured is not None:
                captured.append(obj)
            return (_reconstruct_ref, (obj.id.binary(), obj.owner_hint))
        if _is_torch_tensor(obj):
            # Tensors travel as one host buffer (out-of-band) and are
            # re-placed at load (see the module docstring for the rule).
            return _reduce_tensor(obj)
        if _is_arrow_table(obj):
            _sync_arrow_serializer()
        with _custom_lock:
            entry = _custom_serializers.get(type(obj))
        if entry is not None:
            ser, deser = entry
            return (_apply_deserializer, (deser, ser(obj)))
        return NotImplemented


def _apply_deserializer(deser: Callable, payload: Any) -> Any:
    return deser(payload)


def _reconstruct_ref(id_bytes: bytes, owner_hint: Optional[str]):
    from ray_tpu_torch.core.ids import ObjectID
    from ray_tpu_torch.core.object_ref import ObjectRef
    from ray_tpu_torch.core.worker import maybe_register_borrowed_ref

    ref = ObjectRef(ObjectID(id_bytes), owner_hint=owner_hint, _borrowed=True)
    maybe_register_borrowed_ref(ref)
    return ref


def _is_torch_tensor(obj: Any) -> bool:
    # a tensor cannot exist unless torch is imported: never import it here.
    # Only plain tensors and parameters: subclasses (DTensor, fake tensors)
    # keep their own pickling.
    torch = sys.modules.get("torch")
    return torch is not None and type(obj) in (torch.Tensor, torch.nn.Parameter)


# element width -> a torch integer dtype to reinterpret the bytes as (its
# numpy array is then viewed as the unsigned dtype of that width)
_INT_OF_WIDTH = {1: "uint8", 2: "int16", 4: "int32", 8: "int64"}


def _reduce_tensor(t: Any):
    torch = sys.modules["torch"]
    device_type = t.device.type
    host = t.detach()
    if device_type != "cpu":
        host = host.cpu()
    host = host.contiguous()
    try:
        arr = host.numpy()
        as_int = False
    except TypeError:  # bf16, fp8...: numpy has no such dtype (bf16 goes as uint16)
        width = host.element_size()
        arr = host.view(getattr(torch, _INT_OF_WIDTH[width])).numpy().view(f"uint{8 * width}")
        as_int = True
    dtype_name = str(t.dtype).split(".", 1)[1]
    return (_reconstruct_tensor,
            (arr, dtype_name, as_int, device_type, t.requires_grad,
             type(t) is torch.nn.Parameter))


def _reconstruct_tensor(arr: Any, dtype_name: str, as_int: bool, device_type: str,
                        requires_grad: bool, is_param: bool) -> Any:
    import torch

    with warnings.catch_warnings():
        # the payload view is read-only; the tensor over it is only ever
        # the source of one copy below, never written
        warnings.simplefilter("ignore", UserWarning)
        src = torch.from_numpy(arr.view(_INT_OF_WIDTH[arr.itemsize]) if as_int else arr)
    if device_type == "cuda" and torch.cuda.is_available():
        t = src.to("cuda")
    else:
        t = src.clone()
    if as_int:
        t = t.view(getattr(torch, dtype_name))
    if is_param:
        return torch.nn.Parameter(t, requires_grad=requires_grad)
    return t.requires_grad_(requires_grad) if requires_grad else t


# ---------------------------------------------------------------------------
# Columnar exchange: pa.Table <-> Arrow IPC stream bytes, out-of-band.
#
# A Table's default pickle materializes every column through in-band bytes
# (decode = full copy). Under RTPU_COLUMNAR_EXCHANGE the Table instead
# reduces to ONE Arrow IPC stream buffer wrapped in a PickleBuffer, which
# serialize()'s buffer_callback extracts out-of-band into the object
# payload (64-byte aligned). unpack(zero_copy=True) hands the deserializer
# a memoryview over the stored payload, and ``pa.ipc.open_stream`` over it
# is zero-copy for fixed-width layouts — the reconstructed columns are
# views of the payload (the shm arena itself on the pinned worker-arg
# path). Registered lazily through register_serializer on the first Table
# pickled, so importing this module never imports pyarrow.
# ---------------------------------------------------------------------------
def _is_arrow_table(obj: Any) -> bool:
    mod = type(obj).__module__
    return mod.split(".")[0] == "pyarrow" and type(obj).__name__ == "Table"


def _table_to_ipc(table: Any) -> "pickle.PickleBuffer":
    import pyarrow as pa

    sink = pa.BufferOutputStream()
    with pa.ipc.new_stream(sink, table.schema) as writer:
        writer.write_table(table)
    return pickle.PickleBuffer(sink.getvalue())


def _ipc_to_table(buf: Any) -> Any:
    import pyarrow as pa

    # registers the ray_tpu_torch.pyobj extension type before the schema is
    # parsed (an unknown extension would decay to its storage type)
    from ray_tpu_torch.data.block import classify_table_bytes

    table = pa.ipc.open_stream(pa.py_buffer(buf)).read_all()
    fast, fallback = classify_table_bytes(table)
    arrow_decode_stats["zero_copy_bytes"] += fast
    arrow_decode_stats["copied_bytes"] += fallback
    return table


def _sync_arrow_serializer() -> None:
    """Keep the pa.Table registry entry in step with the columnar flag:
    register the IPC serializer when enabled, drop it when disabled (so the
    Table falls back to its default pickle for A/B). Never clobbers a
    user-registered Table serializer."""
    import pyarrow as pa

    from ray_tpu_torch.core.config import columnar_exchange_enabled

    with _custom_lock:
        entry = _custom_serializers.get(pa.Table)
        ours = entry is not None and entry[0] is _table_to_ipc
        if columnar_exchange_enabled():
            if entry is None:
                _custom_serializers[pa.Table] = (_table_to_ipc, _ipc_to_table)
        elif ours:
            del _custom_serializers[pa.Table]


def serialize(value: Any) -> Tuple[bytes, List["pickle.PickleBuffer"], List[Any]]:
    """Serialize to (meta, oob_buffers, contained_refs).

    Tensors are converted to one host buffer before pickling (device
    buffers never travel through the host object store as anything else).
    """
    import io

    buffers: List[pickle.PickleBuffer] = []
    _capture.refs = []
    try:
        f = io.BytesIO()
        pickler = _Pickler(f, protocol=5, buffer_callback=buffers.append)
        pickler.dump(value)
        meta = f.getvalue()
        refs = list(_capture.refs)
    finally:
        _capture.refs = None
    return meta, buffers, refs


def pack(value: Any) -> Tuple[bytes, List[Any]]:
    """Serialize and frame into one contiguous payload. Returns (payload, refs)."""
    meta, buffers, refs = serialize(value)
    raws = [b.raw() for b in buffers]
    header = struct.pack("<IQ", len(raws), len(meta))
    lens = b"".join(struct.pack("<Q", len(r)) for r in raws)
    prefix_len = len(header) + len(lens) + len(meta)
    parts = [header, lens, meta]
    offset = prefix_len
    for r in raws:
        pad = (-offset) % ALIGN
        parts.append(b"\x00" * pad)
        offset += pad
        parts.append(r)
        offset += len(r)
    return b"".join(parts), refs


def packed_size(value: Any) -> int:
    payload, _ = pack(value)
    return len(payload)


# ---------------------------------------------------------------------------
# Cross-language (xlang) object format: C++/other-language clients cannot
# produce or parse pickle, so xlang tasks exchange values as
# [4-byte magic][msgpack body] (reference capability: java/xlang cross-
# language serialization — realized with msgpack, the wire format the rest
# of this runtime already speaks). Discriminator safety: a real packed
# object starts with u32 n_buffers, and "RTXL" would decode to ~1.3e9
# buffers, which no legitimate payload has.
# ---------------------------------------------------------------------------
XLANG_MAGIC = b"RTXL"


def xlang_pack(value: Any) -> bytes:
    """msgpack-encode a plain value (None/bool/int/float/str/bytes/list/
    dict). Raises TypeError for anything richer — xlang results must stay in
    the cross-language type universe."""
    import msgpack

    try:
        return XLANG_MAGIC + msgpack.packb(value, use_bin_type=True)
    except (TypeError, ValueError) as e:
        raise TypeError(
            f"xlang task result must be msgpack-serializable "
            f"(got {type(value).__name__}): {e}"
        ) from None


def is_xlang_payload(payload: memoryview | bytes) -> bool:
    return bytes(payload[:4]) == XLANG_MAGIC


def unpack(payload: memoryview | bytes, zero_copy: bool = True) -> Any:
    """Reconstruct a value from a framed payload.

    With ``zero_copy=True`` and a memoryview over shared memory, numpy arrays
    alias the store buffer (read-only), like plasma's zero-copy gets.
    """
    view = memoryview(payload)
    if is_xlang_payload(view):
        import msgpack

        return msgpack.unpackb(bytes(view[4:]), raw=False, strict_map_key=False)
    n_buffers, meta_len = struct.unpack_from("<IQ", view, 0)
    off = 12
    lengths = []
    for _ in range(n_buffers):
        (ln,) = struct.unpack_from("<Q", view, off)
        lengths.append(ln)
        off += 8
    meta = bytes(view[off : off + meta_len])
    pos = off + meta_len
    bufs = []
    for ln in lengths:
        pos += (-pos) % ALIGN
        b = view[pos : pos + ln]
        if not zero_copy:
            b = memoryview(bytes(b))
        bufs.append(b)
        pos += ln
    return pickle.loads(meta, buffers=bufs)


def dumps(value: Any) -> bytes:
    """Plain in-band pickle (for RPC payloads, small control messages)."""
    return cloudpickle.dumps(value, protocol=5)


def loads(data: bytes) -> Any:
    return pickle.loads(data)
