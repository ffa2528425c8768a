"""DDS live subscription (feature-gated backend, testable pipeline).

Mirrors the reference's `dds` cargo feature (crates/apex-io/src/dds/):
DdsSubscriberConfig + DdsSubscriber (subscriber.rs:12-79), rt/ topic and
type-name mangling (subscriber.rs:53-77), QoS mapping (qos_mapping.rs),
CDR encapsulation-header reconstruction (raw_bytes.rs), and a
multi-topic DdsListener delivering ReceivedMessage over a channel
(listener.rs:12-124).

Design difference vs the reference: the wire backend is pluggable. A
``CycloneDdsTransport`` wraps Eclipse CycloneDDS when installed (like
the reference's rustdds feature gate — a missing SDK raises a clear
error at construction, never at import), while ``LoopbackTransport`` is
an in-process bus that exercises the entire subscription pipeline
(QoS, topic mangling, CDR decode, delivery queue) without a DDS stack —
the analogue of the reference's fixture-driven listener tests.

API:
    sub = DdsSubscriber(DdsSubscriberConfig(topic="/odom",
                                            message_type="nav_msgs/msg/Odometry"))
    rx = sub.listen()                       # queue.Queue of ReceivedMessage
    msg = rx.get(timeout=1.0)

    listener = DdsListener(domain_id=0, transport=LoopbackTransport())
    listener.subscribe("/imu", "sensor_msgs/msg/Imu", callback)
"""

from __future__ import annotations

import dataclasses
import enum
import queue
import threading
import time
from typing import Callable, Dict, List, Optional

from .rosbag.messages import REGISTRY, deserialize


# ---------------------------------------------------------------------------
# QoS (reference rosbag/types.rs:48-130 + dds/qos_mapping.rs)
# ---------------------------------------------------------------------------


class QosReliability(enum.Enum):
    RELIABLE = "reliable"
    BEST_EFFORT = "best_effort"


class QosDurability(enum.Enum):
    VOLATILE = "volatile"
    TRANSIENT_LOCAL = "transient_local"


def to_dds_reliability(r: QosReliability) -> dict:
    """QoS mapping (qos_mapping.rs:4-11): reliable gets a bounded blocking
    time; everything else is best-effort."""
    if r is QosReliability.RELIABLE:
        return {"kind": "reliable", "max_blocking_time_ms": 100}
    return {"kind": "best_effort"}


def to_dds_durability(d: QosDurability) -> dict:
    if d is QosDurability.TRANSIENT_LOCAL:
        return {"kind": "transient_local"}
    return {"kind": "volatile"}


def to_dds_history(depth: int) -> dict:
    """depth <= 0 -> keep-all (qos_mapping.rs:20-26)."""
    if depth <= 0:
        return {"kind": "keep_all"}
    return {"kind": "keep_last", "depth": depth}


# ---------------------------------------------------------------------------
# Name mangling + CDR payload reconstruction
# ---------------------------------------------------------------------------


def ros_topic_to_dds(topic: str) -> str:
    """ROS2 topic -> DDS wire name: `/imu` -> `rt/imu`
    (subscriber.rs:53-60)."""
    stripped = topic.lstrip("/")
    return stripped if stripped.startswith("rt/") else f"rt/{stripped}"


def ros_type_to_dds(type_name: str) -> str:
    """ROS2 type -> DDS wire type: `sensor_msgs/msg/Imu` ->
    `sensor_msgs::msg::dds_::Imu_` (subscriber.rs:65-72)."""
    parts = type_name.split("/", 2)
    if len(parts) == 3:
        return f"{parts[0]}::{parts[1]}::dds_::{parts[2]}_"
    return type_name


# DDS RTPS representation identifiers (raw_bytes.rs:20-46)
CDR_BE = b"\x00\x00"
CDR_LE = b"\x00\x01"
PL_CDR_BE = b"\x00\x02"
PL_CDR_LE = b"\x00\x03"
SUPPORTED_ENCODINGS = (CDR_BE, CDR_LE, PL_CDR_BE, PL_CDR_LE)


def reconstruct_cdr_payload(body: bytes, encoding: bytes = CDR_LE) -> bytes:
    """DDS stacks strip the 4-byte CDR encapsulation header before handing
    bytes to the decoder; rebuild it so the rosbag CDR codec (which expects
    data[0:4] to be the header) decodes unchanged (raw_bytes.rs:20-40)."""
    if encoding in (CDR_LE, PL_CDR_LE):
        header = b"\x00\x01\x00\x00"
    else:
        header = b"\x00\x00\x00\x00"
    return header + body


# ---------------------------------------------------------------------------
# Messages and transports
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ReceivedMessage:
    """One delivered sample (listener.rs:12-20)."""

    topic: str  # ROS2-style name ("/odom")
    type_name: str  # ROS2 type ("nav_msgs/msg/Odometry")
    timestamp_ns: int
    data: object  # decoded dict when the type is registered, else raw bytes
    raw: bytes = b""


class LoopbackTransport:
    """In-process DDS bus: subscriptions are fan-out callbacks keyed by the
    DDS wire topic. ``publish`` accepts raw header-stripped bytes (as a DDS
    stack would deliver) or a message dict (serialized via the registry)."""

    def __init__(self):
        self._subs: Dict[str, List[Callable]] = {}
        self._lock = threading.Lock()

    def subscribe_raw(self, dds_topic: str, qos: dict, on_bytes: Callable):
        with self._lock:
            self._subs.setdefault(dds_topic, []).append(on_bytes)

    def publish(self, topic: str, type_name: str, msg, encoding: bytes = CDR_LE):
        from .rosbag.messages import serialize

        if isinstance(msg, (bytes, bytearray)):
            body = bytes(msg)
        else:
            body = serialize(type_name, msg)[4:]  # strip header, like a stack
        dds_topic = ros_topic_to_dds(topic)
        with self._lock:
            subs = list(self._subs.get(dds_topic, []))
        for cb in subs:
            cb(body, encoding)

    def close(self):
        with self._lock:
            self._subs.clear()


class CycloneDdsTransport:
    """Eclipse CycloneDDS backend (feature-gated like the reference's
    rustdds dependency)."""

    def __init__(self, domain_id: int = 0):  # pragma: no cover - needs SDK
        try:
            from cyclonedds.domain import DomainParticipant  # type: ignore
        except ImportError as e:
            raise ImportError(
                "DDS live subscription requires the 'cyclonedds' package "
                "(the analogue of the reference's `dds` cargo feature). "
                "Use LoopbackTransport for in-process tests or the rosbag "
                "Reader for offline data."
            ) from e
        self.participant = DomainParticipant(domain_id)
        self._readers = []

    def subscribe_raw(self, dds_topic, qos, on_bytes):  # pragma: no cover
        from cyclonedds.core import Listener  # type: ignore
        from cyclonedds.sub import DataReader  # type: ignore
        from cyclonedds.topic import Topic  # type: ignore
        from cyclonedds.util import types as _t  # noqa: F401

        topic = Topic(self.participant, dds_topic, bytes)

        class _L(Listener):
            def on_data_available(self, reader):
                for sample in reader.take(N=64):
                    on_bytes(bytes(sample), CDR_LE)

        self._readers.append(DataReader(self.participant, topic, listener=_L()))

    def close(self):  # pragma: no cover
        self._readers.clear()


# ---------------------------------------------------------------------------
# Subscriber + listener
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DdsSubscriberConfig:
    """Reference DdsSubscriberConfig (subscriber.rs:12-34)."""

    topic: str = ""
    message_type: str = ""
    reliability: QosReliability = QosReliability.BEST_EFFORT
    durability: QosDurability = QosDurability.VOLATILE
    history_depth: int = 10
    domain_id: int = 0
    channel_capacity: int = 4096


class DdsSubscriber:
    """Single-topic subscriber delivering ReceivedMessage over a bounded
    queue (the mpsc channel of subscriber.rs:79)."""

    def __init__(self, config: Optional[DdsSubscriberConfig] = None,
                 transport=None, **kw):
        if config is None:
            config = DdsSubscriberConfig(**kw) if kw else DdsSubscriberConfig()
        if not config.topic:
            raise ValueError("topic name must not be empty")
        self.config = config
        self.transport = transport if transport is not None else \
            CycloneDdsTransport(config.domain_id)
        self._queue: "queue.Queue[ReceivedMessage]" = queue.Queue(
            maxsize=config.channel_capacity)
        self.dropped = 0

    @staticmethod
    def ros2_to_dds_topic(topic: str) -> str:
        return ros_topic_to_dds(topic)

    @staticmethod
    def ros2_type_to_dds_type(type_name: str) -> str:
        return ros_type_to_dds(type_name)

    def _on_bytes(self, body: bytes, encoding: bytes):
        raw = reconstruct_cdr_payload(body, encoding)
        tname = self.config.message_type
        data = deserialize(tname, raw) if tname in REGISTRY else raw
        msg = ReceivedMessage(
            topic="/" + ros_topic_to_dds(self.config.topic)[3:],
            type_name=tname,
            timestamp_ns=time.time_ns(),
            data=data,
            raw=raw,
        )
        try:
            self._queue.put_nowait(msg)
        except queue.Full:  # keep-latest semantics under backpressure
            self.dropped += 1

    def listen(self) -> "queue.Queue[ReceivedMessage]":
        qos = {
            "reliability": to_dds_reliability(self.config.reliability),
            "durability": to_dds_durability(self.config.durability),
            "history": to_dds_history(self.config.history_depth),
        }
        self.transport.subscribe_raw(
            ros_topic_to_dds(self.config.topic), qos, self._on_bytes)
        return self._queue

    def close(self):
        self.transport.close()


class DdsListener:
    """Multi-topic listener with per-topic callbacks (listener.rs:101-124)."""

    def __init__(self, domain_id: int = 0, transport=None):
        self.transport = transport if transport is not None else \
            CycloneDdsTransport(domain_id)
        self.subscriptions: Dict[str, dict] = {}

    def subscribe(self, topic: str, type_name: str, callback: Callable):
        dds_topic = ros_topic_to_dds(topic)
        entry = {"topic": topic, "type": type_name, "callback": callback,
                 "received": 0}
        self.subscriptions[dds_topic] = entry

        def on_bytes(body, encoding, _entry=entry):
            raw = reconstruct_cdr_payload(body, encoding)
            data = deserialize(type_name, raw) if type_name in REGISTRY else raw
            _entry["received"] += 1
            _entry["callback"](topic, data)

        self.transport.subscribe_raw(dds_topic, {}, on_bytes)
        return entry

    def close(self):
        self.transport.close()
