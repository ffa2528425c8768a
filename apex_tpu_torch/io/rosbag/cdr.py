"""CDR (Common Data Representation) serialization for ROS2 messages.

The port's copy of the JAX package's CDR codec, byte for byte:
XCDR1 little-endian with the 4-byte encapsulation header
(0x00 0x01 0x00 0x00 for CDR_LE), natural alignment relative to the start
of the payload (after the header), strings as uint32 length + bytes + NUL.

The codec is schema-driven: see messages.py for the schema language.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Tuple

_PRIM = {
    "bool": ("?", 1),
    "int8": ("b", 1),
    "uint8": ("B", 1),
    "int16": ("h", 2),
    "uint16": ("H", 2),
    "int32": ("i", 4),
    "uint32": ("I", 4),
    "int64": ("q", 8),
    "uint64": ("Q", 8),
    "float32": ("f", 4),
    "float64": ("d", 8),
}

CDR_LE_HEADER = b"\x00\x01\x00\x00"


class CdrReader:
    def __init__(self, data: bytes, has_header: bool = True):
        self.data = data
        if has_header:
            if len(data) < 4:
                raise ValueError("CDR payload too short for encapsulation header")
            if data[1] not in (0x01, 0x00):
                raise ValueError(f"unsupported CDR encapsulation {data[:2].hex()}")
            self.little = data[1] == 0x01
            self.pos = 4
            self.base = 4
        else:
            self.little = True
            self.pos = 0
            self.base = 0

    def _align(self, n: int):
        rel = self.pos - self.base
        pad = (-rel) % n
        self.pos += pad

    def prim(self, t: str):
        fmt, size = _PRIM[t]
        self._align(size)
        e = "<" if self.little else ">"
        (v,) = struct.unpack_from(e + fmt, self.data, self.pos)
        self.pos += size
        return v

    def string(self) -> str:
        n = self.prim("uint32")
        s = self.data[self.pos : self.pos + n - 1].decode("utf-8") if n > 0 else ""
        self.pos += n
        return s

    def prim_array(self, t: str, count: int):
        fmt, size = _PRIM[t]
        self._align(size)
        e = "<" if self.little else ">"
        vals = list(struct.unpack_from(f"{e}{count}{fmt}", self.data, self.pos))
        self.pos += size * count
        return vals

    def sequence_length(self) -> int:
        return self.prim("uint32")

    def raw(self, count: int) -> bytes:
        b = self.data[self.pos : self.pos + count]
        self.pos += count
        return b


class CdrWriter:
    def __init__(self, with_header: bool = True):
        self.buf = bytearray()
        if with_header:
            self.buf += CDR_LE_HEADER
            self.base = 4
        else:
            self.base = 0

    def _align(self, n: int):
        rel = len(self.buf) - self.base
        pad = (-rel) % n
        self.buf += b"\x00" * pad

    def prim(self, t: str, v):
        fmt, size = _PRIM[t]
        self._align(size)
        self.buf += struct.pack("<" + fmt, v)

    def string(self, s: str):
        b = s.encode("utf-8") + b"\x00"
        self.prim("uint32", len(b))
        self.buf += b

    def prim_array(self, t: str, vals):
        fmt, size = _PRIM[t]
        self._align(size)
        self.buf += struct.pack(f"<{len(vals)}{fmt}", *vals)

    def sequence_length(self, n: int):
        self.prim("uint32", n)

    def raw(self, b: bytes):
        self.buf += bytes(b)

    def getvalue(self) -> bytes:
        return bytes(self.buf)


# ---------------------------------------------------------------------------
# Schema-driven encode/decode. A schema is a list of (field_name, field_type)
# where field_type is:
#   - a primitive name ("float64", ...), "string"
#   - ("array", elem_type, length)      fixed-size array
#   - ("sequence", elem_type)           dynamic array
#   - a nested schema name (str present in the registry)
# ---------------------------------------------------------------------------


def decode(schema_name: str, registry: Dict[str, List[Tuple[str, Any]]],
           reader: CdrReader) -> Dict[str, Any]:
    out = {}
    for fname, ftype in registry[schema_name]:
        out[fname] = _decode_field(ftype, registry, reader)
    return out


def _decode_field(ftype, registry, reader):
    if isinstance(ftype, tuple):
        kind = ftype[0]
        if kind == "array":
            _, elem, n = ftype
            if elem in _PRIM:
                return reader.prim_array(elem, n)
            return [_decode_field(elem, registry, reader) for _ in range(n)]
        if kind == "sequence":
            _, elem = ftype
            n = reader.sequence_length()
            if elem in _PRIM:
                return reader.prim_array(elem, n) if n else []
            if elem == "string":
                return [reader.string() for _ in range(n)]
            return [_decode_field(elem, registry, reader) for _ in range(n)]
        raise ValueError(f"unknown composite field type {ftype}")
    if ftype in _PRIM:
        return reader.prim(ftype)
    if ftype == "string":
        return reader.string()
    return decode(ftype, registry, reader)


def encode(schema_name: str, registry: Dict[str, List[Tuple[str, Any]]],
           msg: Dict[str, Any], writer: CdrWriter):
    for fname, ftype in registry[schema_name]:
        _encode_field(ftype, registry, msg.get(fname), writer, f"{schema_name}.{fname}")


def _default_for(ftype, registry):
    if isinstance(ftype, tuple):
        if ftype[0] == "array":
            return [_default_for(ftype[1], registry)] * ftype[2] if ftype[1] not in _PRIM \
                else [0] * ftype[2]
        return []
    if ftype in _PRIM:
        return False if ftype == "bool" else 0
    if ftype == "string":
        return ""
    return {f: _default_for(t, registry) for f, t in registry[ftype]}


def _encode_field(ftype, registry, value, writer, where):
    if value is None:
        value = _default_for(ftype, registry)
    if isinstance(ftype, tuple):
        kind = ftype[0]
        if kind == "array":
            _, elem, n = ftype
            if len(value) != n:
                raise ValueError(f"{where}: expected {n} elements, got {len(value)}")
            if elem in _PRIM:
                writer.prim_array(elem, value)
            else:
                for v in value:
                    _encode_field(elem, registry, v, writer, where)
            return
        if kind == "sequence":
            _, elem = ftype
            writer.sequence_length(len(value))
            if elem in _PRIM:
                writer.prim_array(elem, value)
            elif elem == "string":
                for s in value:
                    writer.string(s)
            else:
                for v in value:
                    _encode_field(elem, registry, v, writer, where)
            return
        raise ValueError(f"unknown composite field type {ftype}")
    if ftype in _PRIM:
        writer.prim(ftype, value)
        return
    if ftype == "string":
        writer.string(value)
        return
    encode(ftype, registry, value, writer)
