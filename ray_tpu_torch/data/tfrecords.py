# Copied from ray_tpu/data/tfrecords.py (JAX-free).
"""TFRecord container + tf.train.Example codec, dependency-free.

Reference: python/ray/data/_internal/datasource/tfrecords_datasource.py
— the reference reads TFRecords through tensorflow. TensorFlow isn't
in this environment (and pulling it in for a framing format would be
absurd on a TPU host that runs JAX), so both layers are implemented
directly:

- container framing: every record is
    uint64le length | uint32le masked-crc32c(length bytes)
    | payload | uint32le masked-crc32c(payload)
  with CRC32C (Castagnoli) and TF's rotate-and-offset masking.
- payload codec: the tf.train.Example proto subset — Features =
  map<string, Feature>, Feature = one of BytesList / FloatList /
  Int64List — parsed/emitted with a ~50-line protobuf wire walker
  (varint + length-delimited fields; packed and unpacked scalars).

Both directions round-trip with real TF output; CRCs are verified on
read (corrupt files fail loudly, matching TF's DataLossError).
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Iterator, List

# ---------------------------------------------------------------------------
# CRC32C (software, table-driven) + TF masking
# ---------------------------------------------------------------------------

_CRC_TABLE: List[int] = []


def _build_table() -> None:
    poly = 0x82F63B78  # reversed Castagnoli polynomial
    for n in range(256):
        crc = n
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        _CRC_TABLE.append(crc)


_build_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for byte in data:
        crc = _CRC_TABLE[(crc ^ byte) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# container framing
# ---------------------------------------------------------------------------

def read_records(path: str) -> Iterator[bytes]:
    with open(path, "rb") as f:
        while True:
            header = f.read(12)
            if not header:
                return
            if len(header) < 12:
                raise ValueError(f"{path}: truncated record header")
            (length,) = struct.unpack("<Q", header[:8])
            (len_crc,) = struct.unpack("<I", header[8:12])
            if _masked_crc(header[:8]) != len_crc:
                raise ValueError(f"{path}: corrupt length crc")
            payload = f.read(length)
            footer = f.read(4)
            if len(payload) < length or len(footer) < 4:
                raise ValueError(f"{path}: truncated record")
            (data_crc,) = struct.unpack("<I", footer)
            if _masked_crc(payload) != data_crc:
                raise ValueError(f"{path}: corrupt data crc")
            yield payload


def write_records(path: str, payloads) -> None:
    with open(path, "wb") as f:
        for payload in payloads:
            header = struct.pack("<Q", len(payload))
            f.write(header)
            f.write(struct.pack("<I", _masked_crc(header)))
            f.write(payload)
            f.write(struct.pack("<I", _masked_crc(payload)))


# ---------------------------------------------------------------------------
# protobuf wire helpers
# ---------------------------------------------------------------------------

def _read_varint(buf: bytes, pos: int):
    result = shift = 0
    while True:
        byte = buf[pos]
        pos += 1
        result |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return result, pos
        shift += 7


def _write_varint(value: int) -> bytes:
    out = bytearray()
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _fields(buf: bytes) -> Iterator[tuple]:
    """(field_number, wire_type, value) triples; value is int for
    varint/fixed, bytes for length-delimited."""
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:  # varint
            value, pos = _read_varint(buf, pos)
        elif wire == 2:  # length-delimited
            length, pos = _read_varint(buf, pos)
            value = buf[pos : pos + length]
            pos += length
        elif wire == 5:  # fixed32
            value = buf[pos : pos + 4]
            pos += 4
        elif wire == 1:  # fixed64
            value = buf[pos : pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, value


def _ld(field: int, payload: bytes) -> bytes:
    """Length-delimited field."""
    return _write_varint(field << 3 | 2) + _write_varint(
        len(payload)
    ) + payload


# ---------------------------------------------------------------------------
# tf.train.Example
# ---------------------------------------------------------------------------

def _decode_feature(buf: bytes) -> Any:
    for field, wire, value in _fields(buf):
        if field == 1:  # BytesList
            return [
                v for f, w, v in _fields(value) if f == 1
            ]
        if field == 2:  # FloatList
            floats: List[float] = []
            for f, w, v in _fields(value):
                if f != 1:
                    continue
                if w == 2:  # packed
                    floats.extend(
                        struct.unpack(f"<{len(v) // 4}f", v)
                    )
                else:  # unpacked fixed32
                    floats.append(struct.unpack("<f", v)[0])
            return floats
        if field == 3:  # Int64List
            ints: List[int] = []
            for f, w, v in _fields(value):
                if f != 1:
                    continue
                if w == 2:  # packed varints
                    pos = 0
                    while pos < len(v):
                        n, pos = _read_varint(v, pos)
                        ints.append(_signed64(n))
                else:
                    ints.append(_signed64(v))
            return ints
    return []


def _signed64(n: int) -> int:
    return n - (1 << 64) if n >= 1 << 63 else n


def decode_example(payload: bytes) -> Dict[str, Any]:
    """tf.train.Example bytes -> {feature: scalar or list}. Singleton
    lists unwrap (the common one-value-per-feature case); bytes values
    decode to str when they are valid UTF-8."""
    row: Dict[str, Any] = {}
    for field, _, value in _fields(payload):
        if field != 1:  # Example.features
            continue
        for f2, _, entry in _fields(value):
            if f2 != 1:  # Features.feature map entry
                continue
            key, feature = None, []
            for f3, _, v3 in _fields(entry):
                if f3 == 1:
                    key = v3.decode("utf-8")
                elif f3 == 2:
                    feature = _decode_feature(v3)
            if key is None:
                continue
            values = [
                v.decode("utf-8", "surrogateescape")
                if isinstance(v, bytes) and _is_text(v)
                else v
                for v in feature
            ]
            row[key] = values[0] if len(values) == 1 else values
    return row


def _is_text(raw: bytes) -> bool:
    try:
        raw.decode("utf-8")
        return True
    except UnicodeDecodeError:
        return False


def _encode_feature(values: Any) -> bytes:
    import numpy as np

    if isinstance(values, np.ndarray):
        # Array columns are the common TPU input-pipeline case;
        # features are 1-D lists, so flatten (shape restored by the
        # consumer's reshape, as with TF's own FixedLenFeature).
        kind = values.dtype.kind
        flat = values.reshape(-1)
        if kind in "iub":
            values = [int(v) for v in flat]
        elif kind == "f":
            values = [float(v) for v in flat]
        elif kind in "SU":
            values = list(flat)
        else:
            raise TypeError(
                f"cannot encode ndarray feature of dtype "
                f"{values.dtype}"
            )
    if not isinstance(values, (list, tuple)):
        values = [values]
    if not values:
        return b""
    first = values[0]
    if isinstance(first, (bytes, str)):
        items = b"".join(
            _ld(1, v.encode() if isinstance(v, str) else v)
            for v in values
        )
        return _ld(1, items)  # bytes_list
    if isinstance(first, (np.floating, float)):
        packed = struct.pack(
            f"<{len(values)}f", *(float(v) for v in values)
        )
        return _ld(2, _ld(1, packed))  # float_list, packed
    if isinstance(first, (np.integer, np.bool_, int, bool)):
        packed = b"".join(
            _write_varint(int(v) & 0xFFFFFFFFFFFFFFFF)
            for v in values
        )
        return _ld(3, _ld(1, packed))  # int64_list, packed
    raise TypeError(
        f"cannot encode feature of {type(first).__name__}"
    )


def encode_example(row: Dict[str, Any]) -> bytes:
    entries = b""
    for key, values in row.items():
        entry = _ld(1, key.encode("utf-8")) + _ld(
            2, _encode_feature(values)
        )
        entries += _ld(1, entry)
    return _ld(1, entries)  # Example.features
