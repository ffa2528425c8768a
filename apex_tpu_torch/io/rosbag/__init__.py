"""ROS2 bag I/O of the port: sqlite3 + MCAP storage backends, CDR codec,
message registry, metadata.yaml. Host code (the standard library only; the
port keeps its own copy of ``apex_tpu.io.rosbag``): the same bytes on disk,
and bags written by either package read by the other. Neither PyYAML nor
``zstandard`` is needed, unless an MCAP file with zstd chunks is written or
read.

High-level API:

    with Reader("my_bag/") as r:                      # dir or single file
        for topic, type_name, t_ns, msg in r.messages(decode=True):
            ...

    with Writer("out_bag", storage="sqlite3") as w:   # or "mcap"
        w.add_topic("/odom", "nav_msgs/msg/Odometry")
        w.write("/odom", t_ns, msg_dict)
"""

from __future__ import annotations

import pathlib
from typing import Dict, Iterator, List, Optional, Tuple

from . import messages as msgtypes
from .mcap_storage import McapStorageReader, McapStorageWriter
from .messages import REGISTRY, deserialize, serialize
from .metadata import read_metadata, write_metadata
from .sqlite_storage import SqliteStorageReader, SqliteStorageWriter


def _detect_storage(path: pathlib.Path):
    """Resolve (storage_kind, data_file) from a bag directory or file."""
    path = pathlib.Path(path)
    if path.is_dir():
        meta = read_metadata(path)
        if meta:
            ident = meta["storage_identifier"]
            rel = meta["relative_file_paths"][0]
            return ident, path / rel
        for ext, kind in ((".db3", "sqlite3"), (".mcap", "mcap")):
            hits = sorted(path.glob(f"*{ext}"))
            if hits:
                return kind, hits[0]
        raise FileNotFoundError(f"no bag storage file found in {path}")
    if path.suffix == ".db3":
        return "sqlite3", path
    if path.suffix == ".mcap":
        return "mcap", path
    raise ValueError(f"cannot determine bag storage type for {path}")


class Reader:
    def __init__(self, path):
        self.kind, data_file = _detect_storage(pathlib.Path(path))
        if self.kind == "sqlite3":
            self.storage = SqliteStorageReader(data_file)
        elif self.kind == "mcap":
            self.storage = McapStorageReader(data_file)
        else:
            raise ValueError(f"unsupported storage {self.kind!r}")

    def topics(self) -> List[Tuple[int, str, str, str, str]]:
        return self.storage.topics()

    def messages(
        self, topics: Optional[List[str]] = None, decode: bool = True
    ) -> Iterator[Tuple[str, str, int, object]]:
        for topic, type_name, ts, raw in self.storage.messages(topics):
            if decode and type_name in REGISTRY:
                yield topic, type_name, ts, deserialize(type_name, raw)
            else:
                yield topic, type_name, ts, raw

    def message_count(self) -> int:
        return self.storage.message_count()

    def close(self):
        self.storage.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class Writer:
    """Writes a rosbag2-layout bag directory: <name>/<name>_0.<ext> +
    metadata.yaml."""

    def __init__(self, path, storage: str = "sqlite3",
                 compression: Optional[str] = None):
        """``compression`` ("zstd"/"zlib"; mcap storage only) writes the
        data section as compressed chunks (reference types.rs:176-190)."""
        self.dir = pathlib.Path(path)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.storage_kind = storage
        ext = {"sqlite3": "db3", "mcap": "mcap"}[storage]
        self.data_file = self.dir / f"{self.dir.name}_0.{ext}"
        if storage == "sqlite3":
            if compression:
                raise ValueError(
                    "compression is supported for mcap storage only "
                    "(rosbag2 sqlite3 bags are uncompressed)"
                )
            self.storage = SqliteStorageWriter(self.data_file)
        else:
            self.storage = McapStorageWriter(self.data_file, compression=compression)
        self._topics: Dict[str, Dict] = {}
        self._count = 0
        self._t_min = None
        self._t_max = None

    def add_topic(self, name: str, type_name: str, qos: str = ""):
        self.storage.add_topic(name, type_name, qos)
        self._topics[name] = {"name": name, "type": type_name, "qos": qos,
                              "message_count": 0}

    def write(self, topic: str, timestamp_ns: int, msg, type_name: Optional[str] = None):
        """msg may be a dict (serialized via the registry) or raw bytes."""
        if isinstance(msg, (bytes, bytearray)):
            raw = bytes(msg)
        else:
            tname = type_name or self._topics[topic]["type"]
            raw = serialize(tname, msg)
        self.storage.write(topic, timestamp_ns, raw)
        self._topics[topic]["message_count"] += 1
        self._count += 1
        self._t_min = timestamp_ns if self._t_min is None else min(self._t_min, timestamp_ns)
        self._t_max = timestamp_ns if self._t_max is None else max(self._t_max, timestamp_ns)

    def close(self):
        self.storage.close()
        write_metadata(
            self.dir,
            self.storage_kind,
            [self.data_file.name],
            list(self._topics.values()),
            self._count,
            starting_time_ns=self._t_min or 0,
            duration_ns=(self._t_max - self._t_min) if self._count else 0,
        )

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


__all__ = [
    "Reader",
    "Writer",
    "REGISTRY",
    "serialize",
    "deserialize",
    "msgtypes",
    "read_metadata",
    "write_metadata",
    "SqliteStorageReader",
    "SqliteStorageWriter",
    "McapStorageReader",
    "McapStorageWriter",
]
