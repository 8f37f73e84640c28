"""Reads a .tfci container: a serialized ``tf.train.Example`` whose
feature "MD" names the model and whose features chr(1), chr(2), ... hold
the packed tensors (TFC's python/util/packed_tensors.py).  Only the
protobuf wire format is needed: Example.features (1) -> map entries (1)
of key (1) and Feature (2); a Feature holds a bytes_list (1), float_list
(2) or int64_list (3)."""

from __future__ import annotations

import struct


def _varint(buf, pos):
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _fields(buf):
    """(field number, wire type, payload) of each field of a message."""
    pos = 0
    while pos < len(buf):
        tag, pos = _varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 2:
            size, pos = _varint(buf, pos)
            yield field, wire, buf[pos: pos + size]
            pos += size
        elif wire == 0:
            value, pos = _varint(buf, pos)
            yield field, wire, value
        elif wire == 5:
            yield field, wire, buf[pos: pos + 4]
            pos += 4
        else:
            raise ValueError(f"unexpected wire type {wire}")


def _feature(buf):
    for kind, _, payload in _fields(buf):
        values = []
        for _, wire, item in _fields(payload):
            if kind == 1:
                values.append(bytes(item))
            elif kind == 2:
                if wire == 2:
                    values.extend(struct.unpack(f"<{len(item) // 4}f", item))
                else:
                    values.append(struct.unpack("<f", item)[0])
            elif wire == 2:
                p = 0
                while p < len(item):
                    v, p = _varint(item, p)
                    values.append(v - (1 << 64) if v >> 63 else v)
            else:
                values.append(item - (1 << 64) if item >> 63 else item)
        return values
    return []


def read(container):
    """(model id, [tensor values in order]); a tensor is a list of bytes
    or of numbers."""
    features = {}
    for _, _, feats in _fields(bytes(container)):
        for _, _, entry in _fields(feats):
            key, value = None, b""
            for field, _, payload in _fields(entry):
                if field == 1:
                    key = bytes(payload).decode("utf-8")
                else:
                    value = payload
            features[key] = _feature(value)
    model = features.pop("MD")[0].decode("ascii")
    tensors = []
    i = 1
    while chr(i) in features:
        tensors.append(features.pop(chr(i)))
        i += 1
    return model, tensors
