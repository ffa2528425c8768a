"""The port's DDS subscription pipeline (``apex_tpu_torch.io.dds``) over the
in-process ``LoopbackTransport``: every case of ``tests/test_dds.py``, the
``cyclonedds`` gate of ``tests/test_misc.py``, and the delivered samples
against the JAX package's on the same messages (host code, CPU)."""

import pytest

import apex_tpu.io.dds as jax_dds
from apex_tpu_torch.io.dds import (
    CDR_BE,
    CDR_LE,
    DdsListener,
    DdsSubscriber,
    DdsSubscriberConfig,
    LoopbackTransport,
    QosDurability,
    QosReliability,
    reconstruct_cdr_payload,
    ros_topic_to_dds,
    ros_type_to_dds,
    to_dds_durability,
    to_dds_history,
    to_dds_reliability,
)
from test_torch_jit import one_thread  # noqa: F401 (autouse: one BLAS thread per module)

ODOM = {
    "header": {"stamp": {"sec": 4, "nanosec": 5}, "frame_id": "odom"},
    "child_frame_id": "base",
    "pose": {"pose": {"position": {"x": 1.5, "y": 0.0, "z": 0.0},
                      "orientation": {"x": 0, "y": 0, "z": 0, "w": 1.0}},
             "covariance": [0.0] * 36},
    "twist": {"twist": {"linear": {"x": 0, "y": 0, "z": 0},
                        "angular": {"x": 0, "y": 0, "z": 0}},
              "covariance": [0.0] * 36},
}


def test_topic_and_type_mangling():
    assert ros_topic_to_dds("/imu") == "rt/imu"
    assert ros_topic_to_dds("imu/data") == "rt/imu/data"
    assert ros_topic_to_dds("rt/imu") == "rt/imu"
    assert ros_type_to_dds("sensor_msgs/msg/Imu") == "sensor_msgs::msg::dds_::Imu_"
    assert ros_type_to_dds("weird") == "weird"


def test_qos_mapping():
    assert to_dds_reliability(QosReliability.RELIABLE)["max_blocking_time_ms"] == 100
    assert to_dds_reliability(QosReliability.BEST_EFFORT)["kind"] == "best_effort"
    assert to_dds_durability(QosDurability.TRANSIENT_LOCAL)["kind"] == "transient_local"
    assert to_dds_history(0)["kind"] == "keep_all"
    assert to_dds_history(7) == {"kind": "keep_last", "depth": 7}


def test_cdr_header_reconstruction():
    assert reconstruct_cdr_payload(b"xyz", CDR_LE)[:4] == b"\x00\x01\x00\x00"
    assert reconstruct_cdr_payload(b"xyz", CDR_BE)[:4] == b"\x00\x00\x00\x00"
    assert reconstruct_cdr_payload(b"xyz")[4:] == b"xyz"


def test_subscriber_loopback_decode():
    bus = LoopbackTransport()
    sub = DdsSubscriber(
        DdsSubscriberConfig(topic="/odom", message_type="nav_msgs/msg/Odometry"),
        transport=bus,
    )
    rx = sub.listen()
    bus.publish("/odom", "nav_msgs/msg/Odometry", ODOM)
    got = rx.get(timeout=1.0)
    assert got.topic == "/odom"
    assert got.data["pose"]["pose"]["position"]["x"] == 1.5
    assert got.data["header"]["stamp"]["sec"] == 4


def test_subscriber_unknown_type_passthrough():
    bus = LoopbackTransport()
    sub = DdsSubscriber(topic="/x", message_type="my_msgs/msg/Custom", transport=bus)
    rx = sub.listen()
    bus.publish("/x", "my_msgs/msg/Custom", b"\x01\x02\x03")
    got = rx.get(timeout=1.0)
    assert got.data == b"\x00\x01\x00\x00\x01\x02\x03"  # raw incl. header


def test_subscriber_backpressure_drops():
    bus = LoopbackTransport()
    sub = DdsSubscriber(
        DdsSubscriberConfig(topic="/s", message_type="std_msgs/msg/Int32", channel_capacity=3),
        transport=bus,
    )
    rx = sub.listen()
    for i in range(10):
        bus.publish("/s", "std_msgs/msg/Int32", {"data": i})
    assert rx.qsize() == 3
    assert sub.dropped == 7


def test_listener_multi_topic():
    bus = LoopbackTransport()
    lst = DdsListener(transport=bus)
    seen = []
    lst.subscribe("/a", "std_msgs/msg/String", lambda t, m: seen.append((t, m["data"])))
    lst.subscribe("/b", "std_msgs/msg/Int32", lambda t, m: seen.append((t, m["data"])))
    bus.publish("/a", "std_msgs/msg/String", {"data": "hi"})
    bus.publish("/b", "std_msgs/msg/Int32", {"data": 9})
    bus.publish("/a", "std_msgs/msg/String", {"data": "again"})
    assert seen == [("/a", "hi"), ("/b", 9), ("/a", "again")]
    assert lst.subscriptions["rt/a"]["received"] == 2


def test_empty_topic_rejected():
    with pytest.raises(ValueError, match="topic"):
        DdsSubscriber(DdsSubscriberConfig(message_type="std_msgs/msg/Bool"),
                      transport=LoopbackTransport())


def test_dds_gated():
    """tests/test_misc.py's gate: without ``cyclonedds`` the default
    transport raises an ``ImportError`` that names it."""
    assert ros_topic_to_dds("/odom") == "rt/odom"
    assert ros_topic_to_dds("rt/odom") == "rt/odom"
    with pytest.raises(ImportError, match="cyclonedds"):
        DdsSubscriber(topic="/odom", message_type="nav_msgs/msg/Odometry")
    with pytest.raises(ImportError, match="cyclonedds"):
        DdsListener()


@pytest.mark.parametrize("encoding", [CDR_LE, CDR_BE], ids=["cdr_le", "cdr_be"])
def test_delivery_equals_jax(encoding):
    """The same samples published on both packages' buses reach a
    subscriber and a listener with the same raw bytes and decoded dicts:
    Odometry dicts serialized little-endian, and raw big-endian Point
    bodies (the rebuilt header tells the codec their byte order)."""
    import struct

    import apex_tpu_torch.io.dds as port_dds

    if encoding == CDR_LE:
        topic, type_name = "/odom", "nav_msgs/msg/Odometry"
        sent = [dict(ODOM, child_frame_id=f"base{i}") for i in range(5)]
    else:
        topic, type_name = "/p", "geometry_msgs/msg/Point"
        sent = [struct.pack(">3d", float(i), 2.0, -3.0) for i in range(5)]
    delivered = {}
    for name, pkg in (("port", port_dds), ("jax", jax_dds)):
        bus = pkg.LoopbackTransport()
        rx = pkg.DdsSubscriber(topic=topic, message_type=type_name, transport=bus).listen()
        seen = []
        pkg.DdsListener(transport=bus).subscribe(
            topic, type_name, lambda t, m, seen=seen: seen.append((t, m)))
        for msg in sent:
            bus.publish(topic, type_name, msg, encoding=encoding)
        samples = [rx.get(timeout=1.0) for _ in sent]
        assert rx.empty()
        delivered[name] = ([(s.topic, s.type_name, s.data, s.raw) for s in samples], seen)
    assert delivered["port"] == delivered["jax"]
    data = [d for _, _, d, _ in delivered["port"][0]]
    assert data == (sent if encoding == CDR_LE
                    else [{"x": float(i), "y": 2.0, "z": -3.0} for i in range(5)])
