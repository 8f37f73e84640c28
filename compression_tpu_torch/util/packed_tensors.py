"""Packed representation of compressed tensors (.tfci container format).

Byte-compatible reimplementation of the reference's
python/util/packed_tensors.py:25-100 without a TensorFlow dependency: the
container is a serialized ``tf.train.Example`` protobuf whose feature "MD"
holds a model identifier and features chr(1), chr(2), ... hold rank-1
int/float/bytes tensors.  A minimal hand-rolled protobuf wire-format
encoder/decoder reproduces TF's serialization byte-for-byte (protobuf map
entries are emitted in key-sorted order, matching the C++ serializer).
"""

from __future__ import annotations

import struct

import numpy as np

__all__ = ["PackedTensors"]


# --- protobuf wire-format primitives ---------------------------------------
def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _tag(field: int, wire_type: int) -> bytes:
    return _varint((field << 3) | wire_type)


def _len_delim(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


def _zigzag_free_int64(v: int) -> int:
    # int64 fields use two's complement varints (10 bytes when negative).
    return v & 0xFFFFFFFFFFFFFFFF


# --- Feature encoding -------------------------------------------------------
def _encode_bytes_list(values) -> bytes:
    payload = b"".join(_len_delim(1, v) for v in values)
    return _len_delim(1, payload)  # Feature.bytes_list = field 1


def _encode_float_list(values) -> bytes:
    # FloatList.value = repeated float, packed (field 1).
    packed = struct.pack(f"<{len(values)}f", *values)
    payload = _len_delim(1, packed) if values else b""
    return _len_delim(2, payload)  # Feature.float_list = field 2


def _encode_int64_list(values) -> bytes:
    packed = b"".join(_varint(_zigzag_free_int64(int(v))) for v in values)
    payload = _len_delim(1, packed) if len(values) else b""
    return _len_delim(3, payload)  # Feature.int64_list = field 3


def _decode_feature(buf: bytes):
    """Returns (kind, values) for one Feature message."""
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        assert wire == 2, "Feature fields are length-delimited"
        size, pos = _read_varint(buf, pos)
        payload = buf[pos : pos + size]
        pos += size
        if field == 1:  # bytes_list
            values, p = [], 0
            while p < len(payload):
                t, p = _read_varint(payload, p)
                assert t >> 3 == 1
                n, p = _read_varint(payload, p)
                values.append(payload[p : p + n])
                p += n
            return "bytes", values
        if field == 2:  # float_list
            values, p = [], 0
            while p < len(payload):
                t, p = _read_varint(payload, p)
                assert t >> 3 == 1
                if t & 7 == 2:  # packed
                    n, p = _read_varint(payload, p)
                    values.extend(
                        struct.unpack(f"<{n // 4}f", payload[p : p + n]))
                    p += n
                else:  # unpacked
                    values.append(
                        struct.unpack("<f", payload[p : p + 4])[0])
                    p += 4
            return "float", values
        if field == 3:  # int64_list
            values, p = [], 0
            while p < len(payload):
                t, p = _read_varint(payload, p)
                assert t >> 3 == 1
                if t & 7 == 2:
                    n, p = _read_varint(payload, p)
                    end = p + n
                    while p < end:
                        v, p = _read_varint(payload, p)
                        values.append(
                            v - (1 << 64) if v >= (1 << 63) else v)
                else:
                    v, p = _read_varint(payload, p)
                    values.append(v - (1 << 64) if v >= (1 << 63) else v)
            return "int64", values
    return "bytes", []


class PackedTensors:
    """Packs rank-1 tensor values (+ model id) into one Example string."""

    def __init__(self, string=None):
        self._features: dict[str, tuple[str, list]] = {}
        if string:
            self.string = string

    @property
    def model(self) -> str:
        kind, values = self._features["MD"]
        return values[0].decode("ascii")

    @model.setter
    def model(self, value: str):
        self._features["MD"] = ("bytes", [value.encode("ascii")])

    @model.deleter
    def model(self):
        del self._features["MD"]

    @property
    def string(self) -> bytes:
        """Serialized Example, byte-identical to TF's serializer."""
        entries = []
        # Protobuf map serialization order is unspecified by the wire
        # format, and TF's upb runtime observably emits hash-table order
        # (e.g. MD, \x03, \x01, \x02 — see golden_model.npz), which is
        # runtime-version-dependent.  Whole-container byte identity with
        # TF is therefore not a stable contract; the interop contract is
        # parse-level (feature values byte-identical), which is what the
        # golden tests pin.  We emit a deterministic order: "MD" first,
        # then ascending keys.
        keys = sorted(self._features)
        if "MD" in self._features:
            keys.remove("MD")
            keys.insert(0, "MD")
        for key in keys:
            kind, values = self._features[key]
            if kind == "bytes":
                feature = _encode_bytes_list(values)
            elif kind == "float":
                feature = _encode_float_list(values)
            else:
                feature = _encode_int64_list(values)
            entry = _len_delim(1, key.encode("utf-8")) + _len_delim(2, feature)
            entries.append(_len_delim(1, entry))  # Features.feature map entry
        features = b"".join(entries)
        return _len_delim(1, features)  # Example.features = field 1

    @string.setter
    def string(self, value: bytes):
        self._features = {}
        pos = 0
        buf = bytes(value)
        while pos < len(buf):
            tag, pos = _read_varint(buf, pos)
            assert tag >> 3 == 1 and tag & 7 == 2, "expected Example.features"
            size, pos = _read_varint(buf, pos)
            features_buf = buf[pos : pos + size]
            pos += size
            fpos = 0
            while fpos < len(features_buf):
                ftag, fpos = _read_varint(features_buf, fpos)
                assert ftag >> 3 == 1 and ftag & 7 == 2
                fsize, fpos = _read_varint(features_buf, fpos)
                entry = features_buf[fpos : fpos + fsize]
                fpos += fsize
                epos = 0
                key = None
                feature = b""
                while epos < len(entry):
                    etag, epos = _read_varint(entry, epos)
                    esize, epos = _read_varint(entry, epos)
                    payload = entry[epos : epos + esize]
                    epos += esize
                    if etag >> 3 == 1:
                        key = payload.decode("utf-8")
                    else:
                        feature = payload
                assert key is not None
                self._features[key] = _decode_feature(feature)

    @property
    def num_tensors(self) -> int:
        """Number of packed tensors (container arity, excluding model id)."""
        return len([k for k in self._features if k != "MD"])

    def pack(self, tensors):
        """Packs a list of rank-1 arrays / lists of bytes."""
        for i, tensor in enumerate(tensors):
            key = chr(i + 1)
            if isinstance(tensor, (list, tuple)) and all(
                    isinstance(v, bytes) for v in tensor):
                self._features[key] = ("bytes", list(tensor))
                continue
            arr = np.asarray(tensor)
            if arr.ndim != 1:
                raise RuntimeError(f"Unexpected tensor rank: {arr.ndim}.")
            if np.issubdtype(arr.dtype, np.integer):
                self._features[key] = ("int64", [int(v) for v in arr])
            elif np.issubdtype(arr.dtype, np.floating):
                self._features[key] = ("float", [float(v) for v in arr])
            elif arr.dtype.kind in ("S", "O"):
                self._features[key] = (
                    "bytes", [bytes(v) for v in arr])
            else:
                raise RuntimeError(f"Unexpected dtype: '{arr.dtype}'.")
        i = len(tensors)
        while chr(i + 1) in self._features:
            del self._features[chr(i + 1)]
            i += 1

    def unpack_raw(self):
        """Unpacks all features in order without a dtype spec.

        Bytes features come back as list[bytes]; int features as int64
        arrays; float features as float32 arrays.  The introspective
        analog of the reference tfci 'tensors' subcommand
        (reference models/tfci.py:204-216).
        """
        out = []
        i = 1
        while chr(i) in self._features:
            kind, values = self._features[chr(i)]
            if kind == "bytes":
                out.append(list(values))
            elif kind == "int64":
                out.append(np.asarray(values, np.int64))
            else:
                out.append(np.asarray(values, np.float32))
            i += 1
        return out

    def unpack(self, dtypes):
        """Unpacks values given a list of numpy dtypes (or 'bytes')."""
        tensors = []
        for i, dtype in enumerate(dtypes):
            kind, values = self._features[chr(i + 1)]
            if dtype in ("bytes", bytes, object):
                tensors.append(list(values))
            else:
                tensors.append(np.asarray(values, dtype))
        return tensors
