"""MCAP storage backend (pure-Python reader/writer, no mcap package).

Mirrors the reference's MCAP backend (crates/apex-io/src/rosbag/storage/
mcap.rs). Implements the MCAP v0 container format directly:

    <magic> Header (Schema | Channel | Message | Chunk)* DataEnd
    (summary section records)* Footer <magic>

Writer emits a summary section (Schema/Channel/Statistics) and a valid
Footer; the data section is either an unchunked stream (default) or
compressed chunks (``compression="zstd"|"zlib"|"lz4"``, matching the
reference's zstd chunk writing in rosbag/types.rs:176-190). Reader
handles unchunked records plus uncompressed ("" / "none"), zlib, zstd,
and (when the lz4 package exists) lz4 chunks.
"""

from __future__ import annotations

import pathlib
import struct
import zlib
from typing import Dict, Iterator, List, Optional, Tuple


def _zstd():
    import zstandard

    return zstandard


def _compress(compression: str, raw: bytes) -> bytes:
    if compression == "zstd":
        return _zstd().ZstdCompressor().compress(raw)
    if compression == "zlib":
        return zlib.compress(raw)
    if compression == "lz4":  # pragma: no cover - lz4 not in this image
        import lz4.frame

        return lz4.frame.compress(raw)
    raise ValueError(f"unsupported MCAP chunk compression {compression!r}")


def _decompress(compression: str, payload: bytes, uncompressed_size: int) -> bytes:
    if compression in ("", "none"):
        return payload
    if compression == "zstd":
        return _zstd().ZstdDecompressor().decompress(
            payload, max_output_size=uncompressed_size
        )
    if compression == "zlib":
        return zlib.decompress(payload)
    if compression == "lz4":  # pragma: no cover - lz4 not in this image
        try:
            import lz4.frame
        except ImportError as e:
            raise NotImplementedError(
                "MCAP lz4 chunks need the lz4 package (not in this image); "
                "re-write the bag with zstd/zlib compression"
            ) from e
        return lz4.frame.decompress(payload)
    raise NotImplementedError(f"MCAP chunk compression {compression!r} not supported")

MAGIC = b"\x89MCAP0\r\n"

OP_HEADER = 0x01
OP_FOOTER = 0x02
OP_SCHEMA = 0x03
OP_CHANNEL = 0x04
OP_MESSAGE = 0x05
OP_CHUNK = 0x06
OP_MESSAGE_INDEX = 0x07
OP_CHUNK_INDEX = 0x08
OP_ATTACHMENT = 0x09
OP_ATTACHMENT_INDEX = 0x0A
OP_STATISTICS = 0x0B
OP_METADATA = 0x0C
OP_METADATA_INDEX = 0x0D
OP_SUMMARY_OFFSET = 0x0E
OP_DATA_END = 0x0F


def _u16(v):
    return struct.pack("<H", v)


def _u32(v):
    return struct.pack("<I", v)


def _u64(v):
    return struct.pack("<Q", v)


def _pstr(s: str) -> bytes:
    b = s.encode("utf-8")
    return _u32(len(b)) + b


def _record(op: int, payload: bytes) -> bytes:
    return bytes([op]) + _u64(len(payload)) + payload


class _Cursor:
    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos

    def u8(self):
        v = self.data[self.pos]
        self.pos += 1
        return v

    def u16(self):
        (v,) = struct.unpack_from("<H", self.data, self.pos)
        self.pos += 2
        return v

    def u32(self):
        (v,) = struct.unpack_from("<I", self.data, self.pos)
        self.pos += 4
        return v

    def u64(self):
        (v,) = struct.unpack_from("<Q", self.data, self.pos)
        self.pos += 8
        return v

    def string(self):
        n = self.u32()
        s = self.data[self.pos : self.pos + n].decode("utf-8")
        self.pos += n
        return s

    def raw(self, n):
        b = self.data[self.pos : self.pos + n]
        self.pos += n
        return b

    @property
    def remaining(self):
        return len(self.data) - self.pos


class McapStorageWriter:
    """``compression=None`` writes a plain unchunked stream; "zstd" /
    "zlib" / "lz4" buffer messages into chunks of ~``chunk_size`` bytes
    of uncompressed records and write each as a compressed Chunk record
    (reference types.rs:176-190)."""

    def __init__(self, path, profile: str = "ros2", library: str = "apex_tpu_torch",
                 compression: Optional[str] = None, chunk_size: int = 1 << 20):
        self.path = pathlib.Path(path)
        self.compression = None if compression in (None, "", "none") else compression
        if self.compression is not None:
            _compress(self.compression, b"")  # fail fast on unknown codec
        self.chunk_size = chunk_size
        self._chunk_buf = bytearray()
        self._chunk_start: Optional[int] = None
        self._chunk_end: Optional[int] = None
        self.f = open(self.path, "wb")
        self.f.write(MAGIC)
        self.f.write(_record(OP_HEADER, _pstr(profile) + _pstr(library)))
        self._schema_ids: Dict[str, int] = {}
        self._channel_ids: Dict[str, int] = {}
        self._channel_records: List[bytes] = []
        self._schema_records: List[bytes] = []
        self._msg_count = 0
        self._seq: Dict[int, int] = {}

    def _flush_chunk(self):
        if not self._chunk_buf:
            return
        raw = bytes(self._chunk_buf)
        payload = _compress(self.compression, raw)
        rec = (
            _u64(self._chunk_start or 0) + _u64(self._chunk_end or 0)
            + _u64(len(raw)) + _u32(zlib.crc32(raw))
            + _pstr(self.compression) + _u64(len(payload)) + payload
        )
        self.f.write(_record(OP_CHUNK, rec))
        self._chunk_buf.clear()
        self._chunk_start = self._chunk_end = None

    def add_topic(self, name: str, type_name: str, qos: str = "") -> int:
        if name in self._channel_ids:
            return self._channel_ids[name]
        if type_name not in self._schema_ids:
            sid = len(self._schema_ids) + 1
            self._schema_ids[type_name] = sid
            rec = _record(
                OP_SCHEMA, _u16(sid) + _pstr(type_name) + _pstr("ros2msg") + _u32(0)
            )
            self._schema_records.append(rec)
            self.f.write(rec)
        cid = len(self._channel_ids)
        self._channel_ids[name] = cid
        meta = b""  # empty metadata map
        rec = _record(
            OP_CHANNEL,
            _u16(cid) + _u16(self._schema_ids[type_name]) + _pstr(name)
            + _pstr("cdr") + _u32(len(meta)) + meta,
        )
        self._channel_records.append(rec)
        self.f.write(rec)
        return cid

    def write(self, topic_name: str, timestamp_ns: int, data: bytes):
        cid = self._channel_ids[topic_name]
        seq = self._seq.get(cid, 0)
        self._seq[cid] = seq + 1
        rec = _record(
            OP_MESSAGE,
            _u16(cid) + _u32(seq) + _u64(timestamp_ns) + _u64(timestamp_ns) + data,
        )
        if self.compression is not None:
            self._chunk_buf += rec
            if self._chunk_start is None:
                self._chunk_start = timestamp_ns
            self._chunk_end = max(self._chunk_end or 0, timestamp_ns)
            if len(self._chunk_buf) >= self.chunk_size:
                self._flush_chunk()
        else:
            self.f.write(rec)
        self._msg_count += 1

    def close(self):
        if self.compression is not None:
            self._flush_chunk()
        self.f.write(_record(OP_DATA_END, _u32(0)))
        summary_start = self.f.tell()
        for rec in self._schema_records + self._channel_records:
            self.f.write(rec)
        stats = (
            _u64(self._msg_count) + _u16(len(self._schema_ids))
            + _u32(len(self._channel_ids)) + _u32(0) + _u32(0) + _u32(0)
            + _u64(0) + _u64(0) + _u32(0)
        )
        self.f.write(_record(OP_STATISTICS, stats))
        self.f.write(_record(OP_FOOTER, _u64(summary_start) + _u64(0) + _u32(0)))
        self.f.write(MAGIC)
        self.f.close()


class McapStorageReader:
    def __init__(self, path):
        self.path = pathlib.Path(path)
        data = self.path.read_bytes()
        if data[:8] != MAGIC:
            raise ValueError(f"{path}: not an MCAP file")
        self.data = data
        self.schemas: Dict[int, str] = {}
        self.channels: Dict[int, Tuple[str, int]] = {}  # id -> (topic, schema_id)
        self._messages: List[Tuple[int, int, bytes]] = []  # (ts, channel, data)
        self._parse()

    def _parse_records(self, cur: _Cursor, end: int):
        while cur.pos < end:
            op = cur.u8()
            length = cur.u64()
            body = _Cursor(cur.raw(length))
            if op == OP_SCHEMA:
                sid = body.u16()
                name = body.string()
                self.schemas[sid] = name
            elif op == OP_CHANNEL:
                cid = body.u16()
                sid = body.u16()
                topic = body.string()
                self.channels[cid] = (topic, sid)
            elif op == OP_MESSAGE:
                cid = body.u16()
                body.u32()  # sequence
                log_time = body.u64()
                body.u64()  # publish time
                self._messages.append((log_time, cid, body.raw(body.remaining)))
            elif op == OP_CHUNK:
                body.u64()  # start time
                body.u64()  # end time
                uncompressed_size = body.u64()
                body.u32()  # crc
                compression = body.string()
                rec_size = body.u64()
                payload = body.raw(rec_size)
                inner = _decompress(compression, payload, uncompressed_size)
                ic = _Cursor(inner)
                self._parse_records(ic, len(inner))
            elif op == OP_DATA_END:
                return
            # all other records skipped

    def _parse(self):
        cur = _Cursor(self.data, 8)
        self._parse_records(cur, len(self.data) - 8 - 20 - 9)

    def topics(self) -> List[Tuple[int, str, str, str, str]]:
        out = []
        for cid in sorted(self.channels):
            topic, sid = self.channels[cid]
            out.append((cid, topic, self.schemas.get(sid, ""), "cdr", ""))
        return out

    def messages(
        self, topic_names: Optional[List[str]] = None
    ) -> Iterator[Tuple[str, str, int, bytes]]:
        wanted = set(topic_names) if topic_names else None
        for ts, cid, data in sorted(self._messages, key=lambda m: m[0]):
            topic, sid = self.channels[cid]
            if wanted is None or topic in wanted:
                yield topic, self.schemas.get(sid, ""), ts, data

    def message_count(self) -> int:
        return len(self._messages)

    def close(self):
        pass
