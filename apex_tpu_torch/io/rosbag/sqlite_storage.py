"""rosbag2 sqlite3 storage backend.

Mirrors the reference (crates/apex-io/src/rosbag/storage/sqlite.rs): the
standard rosbag2 schema —

    topics(id, name, type, serialization_format, offered_qos_profiles)
    messages(id, topic_id, timestamp, data)

Compatible with bags written by rosbag2/python-rosbags.
"""

from __future__ import annotations

import pathlib
import sqlite3
from typing import Iterator, List, Optional, Tuple


class SqliteStorageReader:
    def __init__(self, path):
        self.path = pathlib.Path(path)
        if not self.path.exists():
            raise FileNotFoundError(self.path)
        self.conn = sqlite3.connect(str(self.path))

    def topics(self) -> List[Tuple[int, str, str, str, str]]:
        cur = self.conn.execute(
            "SELECT id, name, type, serialization_format, offered_qos_profiles "
            "FROM topics ORDER BY id"
        )
        return cur.fetchall()

    def messages(
        self, topic_names: Optional[List[str]] = None
    ) -> Iterator[Tuple[str, str, int, bytes]]:
        """Yields (topic_name, type_name, timestamp_ns, raw_cdr) in time order."""
        q = (
            "SELECT t.name, t.type, m.timestamp, m.data FROM messages m "
            "JOIN topics t ON m.topic_id = t.id "
        )
        params: tuple = ()
        if topic_names:
            q += f"WHERE t.name IN ({','.join('?' * len(topic_names))}) "
            params = tuple(topic_names)
        q += "ORDER BY m.timestamp"
        yield from self.conn.execute(q, params)

    def message_count(self) -> int:
        return self.conn.execute("SELECT COUNT(*) FROM messages").fetchone()[0]

    def close(self):
        self.conn.close()


class SqliteStorageWriter:
    def __init__(self, path):
        self.path = pathlib.Path(path)
        self.conn = sqlite3.connect(str(self.path))
        self.conn.executescript(
            """
            CREATE TABLE IF NOT EXISTS schema(
              schema_version INTEGER PRIMARY KEY,
              ros_distro TEXT NOT NULL);
            CREATE TABLE IF NOT EXISTS metadata(
              id INTEGER PRIMARY KEY, metadata_version INTEGER NOT NULL,
              metadata TEXT NOT NULL);
            CREATE TABLE IF NOT EXISTS topics(
              id INTEGER PRIMARY KEY, name TEXT NOT NULL, type TEXT NOT NULL,
              serialization_format TEXT NOT NULL,
              offered_qos_profiles TEXT NOT NULL);
            CREATE TABLE IF NOT EXISTS messages(
              id INTEGER PRIMARY KEY, topic_id INTEGER NOT NULL,
              timestamp INTEGER NOT NULL, data BLOB NOT NULL);
            CREATE INDEX IF NOT EXISTS timestamp_idx ON messages (timestamp ASC);
            """
        )
        self.conn.execute(
            "INSERT OR IGNORE INTO schema(schema_version, ros_distro) VALUES (3, 'apex')"
        )
        self._topic_ids = {}

    def add_topic(self, name: str, type_name: str, qos: str = "") -> int:
        if name in self._topic_ids:
            return self._topic_ids[name]
        cur = self.conn.execute(
            "INSERT INTO topics(name, type, serialization_format, "
            "offered_qos_profiles) VALUES (?, ?, 'cdr', ?)",
            (name, type_name, qos),
        )
        self._topic_ids[name] = cur.lastrowid
        return cur.lastrowid

    def write(self, topic_name: str, timestamp_ns: int, data: bytes):
        if topic_name not in self._topic_ids:
            raise KeyError(f"topic {topic_name!r} not added")
        self.conn.execute(
            "INSERT INTO messages(topic_id, timestamp, data) VALUES (?, ?, ?)",
            (self._topic_ids[topic_name], timestamp_ns, sqlite3.Binary(data)),
        )

    def close(self):
        self.conn.commit()
        self.conn.close()
