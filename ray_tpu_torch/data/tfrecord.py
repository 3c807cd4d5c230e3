"""TFRecord file format + tf.train.Example wire codec, dependency-free.

Reference capability: python/ray/data/_internal/datasource/tfrecords_datasource.py
(reads TFRecord files of tf.train.Example protos). TensorFlow is not in this
image, so both layers are implemented natively:

- framing: each record is [u64 length][u32 masked-crc32c(length)]
  [payload][u32 masked-crc32c(payload)];
- payload: a tf.train.Example protobuf — a tiny fixed schema (Features =
  map<string, Feature>, Feature = oneof bytes/float/int64 list) decoded with
  a ~100-line varint wire parser instead of a TF dependency.

CRC32C here is table-driven pure Python (~MB/s): fine for record *framing*
checks and test-size files; pass ``verify_crc=False`` (the default for
reads) to skip payload CRCs on bulk pipelines.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Iterator, List, Tuple, Union

# --------------------------------------------------------------------------- #
# crc32c (Castagnoli) + TFRecord masking
# --------------------------------------------------------------------------- #
_CRC_TABLE: List[int] = []


def _crc_table() -> List[int]:
    if not _CRC_TABLE:
        poly = 0x82F63B78
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            _CRC_TABLE.append(c)
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    table = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


# --------------------------------------------------------------------------- #
# protobuf wire helpers (just what Example needs)
# --------------------------------------------------------------------------- #
def _write_varint(n: int, out: bytearray) -> None:
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint too long")


def _tag(field: int, wire: int) -> int:
    return field << 3 | wire


def _write_len_delimited(field: int, payload: bytes, out: bytearray) -> None:
    _write_varint(_tag(field, 2), out)
    _write_varint(len(payload), out)
    out += payload


def _iter_fields(buf: bytes) -> Iterator[Tuple[int, int, Any]]:
    """Yields (field_number, wire_type, value); value is bytes for
    len-delimited, int for varint/fixed."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wire == 2:  # length-delimited
            length, pos = _read_varint(buf, pos)
            val = buf[pos : pos + length]
            pos += length
        elif wire == 5:  # fixed32
            val = struct.unpack_from("<I", buf, pos)[0]
            pos += 4
        elif wire == 1:  # fixed64
            val = struct.unpack_from("<Q", buf, pos)[0]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


FeatureValue = Union[List[bytes], List[float], List[int]]


def encode_example(features: Dict[str, Any]) -> bytes:
    """dict -> serialized tf.train.Example. Values may be bytes/str/int/float
    or lists thereof; numpy arrays are flattened to their list form."""
    import numpy as np

    feats = bytearray()
    for name, value in features.items():
        if isinstance(value, np.ndarray):
            value = value.ravel().tolist()
        if not isinstance(value, (list, tuple)):
            value = [value]
        inner = bytearray()  # BytesList/FloatList/Int64List
        if value and isinstance(value[0], (bytes, str)):
            for v in value:
                _write_len_delimited(
                    1, v.encode() if isinstance(v, str) else v, inner)
            kind = 1
        elif value and isinstance(value[0], float):
            packed = struct.pack(f"<{len(value)}f", *value)
            _write_len_delimited(1, packed, inner)
            kind = 2
        else:  # ints (or empty -> int64 list)
            packed = bytearray()
            for v in value:
                _write_varint(v & 0xFFFFFFFFFFFFFFFF, packed)
            _write_len_delimited(1, bytes(packed), inner)
            kind = 3
        feature = bytearray()
        _write_len_delimited(kind, bytes(inner), feature)
        entry = bytearray()  # map entry {key=1, value=2}
        _write_len_delimited(1, name.encode(), entry)
        _write_len_delimited(2, bytes(feature), entry)
        _write_len_delimited(1, bytes(entry), feats)
    out = bytearray()  # Example {features=1}
    _write_len_delimited(1, bytes(feats), out)
    return bytes(out)


def _decode_list(kind: int, buf: bytes) -> FeatureValue:
    values: List[Any] = []
    for field, wire, val in _iter_fields(buf):
        if field != 1:
            continue
        if kind == 1:  # BytesList
            values.append(val)
        elif kind == 2:  # FloatList: packed or repeated fixed32
            if wire == 2:
                values.extend(struct.unpack(f"<{len(val) // 4}f", val))
            else:
                values.append(struct.unpack("<f", struct.pack("<I", val))[0])
        else:  # Int64List: packed or repeated varint
            if wire == 2:
                pos = 0
                while pos < len(val):
                    v, pos = _read_varint(val, pos)
                    values.append(v - (1 << 64) if v >= 1 << 63 else v)
            else:
                values.append(val - (1 << 64) if val >= 1 << 63 else val)
    return values


def decode_example(payload: bytes) -> Dict[str, FeatureValue]:
    """serialized tf.train.Example -> {name: list of bytes|float|int}."""
    out: Dict[str, FeatureValue] = {}
    for field, _wire, features_buf in _iter_fields(payload):
        if field != 1:
            continue
        for f2, _w2, entry in _iter_fields(features_buf):
            if f2 != 1:
                continue
            name, feature = "", b""
            for f3, _w3, val in _iter_fields(entry):
                if f3 == 1:
                    name = val.decode()
                elif f3 == 2:
                    feature = val
            for kind, _w4, lst in _iter_fields(feature):
                out[name] = _decode_list(kind, lst)
    return out


# --------------------------------------------------------------------------- #
# Record framing
# --------------------------------------------------------------------------- #
def read_records(path: str, verify_crc: bool = False) -> Iterator[bytes]:
    with open(path, "rb") as f:
        while True:
            header = f.read(12)
            if len(header) < 12:
                return
            (length,) = struct.unpack("<Q", header[:8])
            (len_crc,) = struct.unpack("<I", header[8:])
            if verify_crc and masked_crc(header[:8]) != len_crc:
                raise ValueError(f"corrupt record length CRC in {path}")
            payload = f.read(length)
            (data_crc,) = struct.unpack("<I", f.read(4))
            if verify_crc and masked_crc(payload) != data_crc:
                raise ValueError(f"corrupt record payload CRC in {path}")
            yield payload


def write_records(path: str, payloads: Iterator[bytes]) -> int:
    """Write raw records; returns count. (Writer exists so tests and
    ``Dataset.write_tfrecords`` can produce files TF itself can read.)"""
    n = 0
    with open(path, "wb") as f:
        for payload in payloads:
            header = struct.pack("<Q", len(payload))
            f.write(header)
            f.write(struct.pack("<I", masked_crc(header)))
            f.write(payload)
            f.write(struct.pack("<I", masked_crc(payload)))
            n += 1
    return n


def write_tfrecords(path: str, examples: List[Dict[str, Any]]) -> int:
    return write_records(path, (encode_example(e) for e in examples))
