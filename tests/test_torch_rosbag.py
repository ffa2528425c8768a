"""The port's ROS2 bag I/O (``apex_tpu_torch.io.rosbag``) and ``bag_tools``
against the JAX package's, on the CPU (host code; no solver).

- Every case of ``tests/test_rosbag.py``, run against the port.
- The same bytes: ``serialize`` of every registered type (zero-filled) and
  of the sample messages, and MCAP files given the same ``library`` string.
- Bags written by either package read by the other: sqlite3, MCAP plain,
  ``zlib`` and ``zstd`` chunks.
- ``metadata.yaml`` without PyYAML: the port's text equals
  ``yaml.safe_dump(..., sort_keys=False)`` of the same mapping, its reader
  equals ``yaml.safe_load``, and a subprocess with neither ``yaml`` nor
  ``zstandard`` importable writes and reads bags (as on a machine without
  them).
- ``bag_tools``: ``info`` stdout and ``extract`` CSV equal to the JAX CLI's
  on the same bag (as ``tests/test_cli.py``)."""

import contextlib
import io
import math
import random
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import yaml

import apex_tpu.io.rosbag as jax_rosbag
from apex_tpu.cli import bag_tools as jax_bag_tools
from apex_tpu_torch.cli import bag_tools
from apex_tpu_torch.io.rosbag import (
    McapStorageReader,
    McapStorageWriter,
    REGISTRY,
    Reader,
    Writer,
    deserialize,
    read_metadata,
    serialize,
)
from apex_tpu_torch.io.rosbag import metadata as port_metadata
from test_torch_jit import one_thread  # noqa: F401 (autouse: one BLAS thread per module)

REPO = Path(__file__).resolve().parent.parent


def odom_msg(x, y, yaw, t_sec):
    return {
        "header": {"stamp": {"sec": t_sec, "nanosec": 500}, "frame_id": "odom"},
        "child_frame_id": "base_link",
        "pose": {
            "pose": {
                "position": {"x": x, "y": y, "z": 0.0},
                "orientation": {
                    "x": 0.0, "y": 0.0,
                    "z": math.sin(yaw / 2), "w": math.cos(yaw / 2),
                },
            },
            "covariance": [0.01] * 36,
        },
        "twist": {
            "twist": {
                "linear": {"x": 1.0, "y": 0.0, "z": 0.0},
                "angular": {"x": 0.0, "y": 0.0, "z": 0.1},
            },
            "covariance": [0.0] * 36,
        },
    }


SAMPLES = [
    ("std_msgs/msg/String", {"data": "hello apex"}),
    ("std_msgs/msg/Float64", {"data": 3.14159}),
    ("geometry_msgs/msg/Point", {"x": 1.0, "y": -2.0, "z": 3.5}),
    (
        "geometry_msgs/msg/PoseStamped",
        {
            "header": {"stamp": {"sec": 7, "nanosec": 13}, "frame_id": "map"},
            "pose": {
                "position": {"x": 1.0, "y": 2.0, "z": 3.0},
                "orientation": {"x": 0.0, "y": 0.0, "z": 0.0, "w": 1.0},
            },
        },
    ),
    ("nav_msgs/msg/Odometry", odom_msg(1.0, 2.0, 0.3, 5)),
    (
        "sensor_msgs/msg/Imu",
        {
            "header": {"stamp": {"sec": 1, "nanosec": 2}, "frame_id": "imu"},
            "orientation": {"x": 0.0, "y": 0.0, "z": 0.0, "w": 1.0},
            "orientation_covariance": list(np.eye(3).ravel()),
            "angular_velocity": {"x": 0.1, "y": 0.2, "z": 0.3},
            "angular_velocity_covariance": [0.0] * 9,
            "linear_acceleration": {"x": 0.0, "y": 0.0, "z": 9.81},
            "linear_acceleration_covariance": [0.0] * 9,
        },
    ),
    (
        "tf2_msgs/msg/TFMessage",
        {
            "transforms": [
                {
                    "header": {"stamp": {"sec": 0, "nanosec": 0}, "frame_id": "map"},
                    "child_frame_id": "odom",
                    "transform": {
                        "translation": {"x": 0.5, "y": 0.0, "z": 0.0},
                        "rotation": {"x": 0.0, "y": 0.0, "z": 0.0, "w": 1.0},
                    },
                }
            ]
        },
    ),
    (
        "sensor_msgs/msg/JointState",
        {
            "header": {"stamp": {"sec": 3, "nanosec": 4}, "frame_id": ""},
            "name": ["j1", "j2"],
            "position": [0.1, 0.2],
            "velocity": [],
            "effort": [],
        },
    ),
]
SAMPLE_IDS = [t for t, _ in SAMPLES]


# ---------------------------------------------------------------------------
# tests/test_rosbag.py, against the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("type_name,msg", SAMPLES, ids=SAMPLE_IDS)
def test_cdr_roundtrip(type_name, msg):
    raw = serialize(type_name, msg)
    out = deserialize(type_name, raw)

    def compare(a, b, where=""):
        if isinstance(a, dict):
            for k in a:
                compare(a[k], b[k], where + "." + k)
        elif isinstance(a, list):
            assert len(a) == len(b), where
            for i, (x, y) in enumerate(zip(a, b)):
                compare(x, y, f"{where}[{i}]")
        elif isinstance(a, float):
            np.testing.assert_allclose(a, b, rtol=1e-6, err_msg=where)
        else:
            assert a == b, where

    compare(msg, out)


def test_cdr_alignment():
    """uint8 followed by float64 requires 7 pad bytes."""
    from apex_tpu_torch.io.rosbag.cdr import CdrReader, CdrWriter, decode, encode

    reg = {"Test": [("a", "uint8"), ("b", "float64"), ("c", "int16")]}
    w = CdrWriter()
    encode("Test", reg, {"a": 7, "b": 2.5, "c": -3}, w)
    raw = w.getvalue()
    assert len(raw) == 4 + 8 + 8 + 2  # header + aligned u8 + f64 + i16
    out = decode("Test", reg, CdrReader(raw))
    assert out == {"a": 7, "b": 2.5, "c": -3}


@pytest.mark.parametrize("storage", ["sqlite3", "mcap"])
def test_bag_roundtrip(tmp_path, storage):
    bag = tmp_path / f"test_bag_{storage}"
    with Writer(bag, storage=storage) as w:
        w.add_topic("/odom", "nav_msgs/msg/Odometry")
        w.add_topic("/chatter", "std_msgs/msg/String")
        for i in range(10):
            w.write("/odom", 1_000_000_000 * i, odom_msg(float(i), 0.0, 0.1 * i, i))
        w.write("/chatter", 500, {"data": "static"})

    meta = read_metadata(bag)
    assert meta["storage_identifier"] == storage
    assert meta["message_count"] == 11

    with Reader(bag) as r:
        topics = {t[1]: t[2] for t in r.topics()}
        assert topics["/odom"] == "nav_msgs/msg/Odometry"
        assert r.message_count() == 11
        msgs = list(r.messages(topics=["/odom"]))
        assert len(msgs) == 10
        topic, tname, ts, msg = msgs[3]
        assert topic == "/odom" and ts == 3_000_000_000
        np.testing.assert_allclose(msg["pose"]["pose"]["position"]["x"], 3.0)
        assert [m[2] for m in msgs] == sorted(m[2] for m in msgs)


@pytest.mark.parametrize("storage", ["sqlite3", "mcap"])
def test_bag_read_raw_unknown_type(tmp_path, storage):
    bag = tmp_path / f"raw_bag_{storage}"
    with Writer(bag, storage=storage) as w:
        w.add_topic("/custom", "my_msgs/msg/Unknown")
        w.write("/custom", 42, b"\x00\x01\x00\x00rawbytes")
    with Reader(bag) as r:
        msgs = list(r.messages())
        assert msgs[0][3] == b"\x00\x01\x00\x00rawbytes"  # undecoded passthrough


def test_mcap_structure(tmp_path):
    bag = tmp_path / "m"
    with Writer(bag, storage="mcap") as w:
        w.add_topic("/p", "geometry_msgs/msg/Point")
        w.write("/p", 1, {"x": 1.0, "y": 2.0, "z": 3.0})
    f = next(bag.glob("*.mcap"))
    data = f.read_bytes()
    assert data[:8] == data[-8:] == b"\x89MCAP0\r\n"
    r = McapStorageReader(f)
    assert r.message_count() == 1
    (topic, tname, ts, raw), = list(r.messages())
    assert deserialize(tname, raw)["y"] == 2.0


def test_writer_unknown_topic_raises(tmp_path):
    with Writer(tmp_path / "b", storage="sqlite3") as w:
        with pytest.raises(KeyError):
            w.write("/nope", 0, b"x")
        w.add_topic("/ok", "std_msgs/msg/Bool")
        w.write("/ok", 0, {"data": True})


def test_registry_coverage():
    needed = [
        "nav_msgs/msg/Odometry", "nav_msgs/msg/Path", "nav_msgs/msg/GridCells",
        "geometry_msgs/msg/PoseStamped", "geometry_msgs/msg/TransformStamped",
        "geometry_msgs/msg/AccelWithCovarianceStamped",
        "geometry_msgs/msg/PolygonStamped", "geometry_msgs/msg/InertiaStamped",
        "sensor_msgs/msg/Imu", "sensor_msgs/msg/PointCloud2",
        "sensor_msgs/msg/PointCloud", "sensor_msgs/msg/MultiEchoLaserScan",
        "sensor_msgs/msg/MultiDOFJointState", "sensor_msgs/msg/Joy",
        "sensor_msgs/msg/LaserScan", "sensor_msgs/msg/CameraInfo",
        "stereo_msgs/msg/DisparityImage",
        "tf2_msgs/msg/TFMessage", "tf2_msgs/msg/TF2Error",
        "std_msgs/msg/Empty", "std_msgs/msg/UInt64MultiArray",
    ]
    for t in needed:
        assert t in REGISTRY
    assert len(REGISTRY) >= 94


def test_registry_all_types_roundtrip_zero_filled():
    for t in sorted(REGISTRY):
        raw = serialize(t, {})
        out = deserialize(t, raw)
        assert isinstance(out, dict)


@pytest.mark.parametrize("compression", ["zstd", "zlib"])
def test_mcap_compressed_roundtrip(tmp_path, compression):
    bag = tmp_path / f"c_{compression}"
    with Writer(bag, storage="mcap", compression=compression) as w:
        w.add_topic("/odom", "nav_msgs/msg/Odometry")
        for i in range(25):
            w.write("/odom", 10_000 * i, odom_msg(float(i), 1.0, 0.0, i))
    f = next(bag.glob("*.mcap"))
    assert compression.encode() in f.read_bytes()
    with Reader(bag) as r:
        msgs = list(r.messages(topics=["/odom"]))
        assert len(msgs) == 25
        assert msgs[7][3]["pose"]["pose"]["position"]["x"] == 7.0


def test_mcap_multi_chunk_flush(tmp_path):
    f = tmp_path / "multi.mcap"
    w = McapStorageWriter(f, compression="zstd", chunk_size=256)
    w.add_topic("/s", "std_msgs/msg/String")
    for i in range(50):
        w.write("/s", i, serialize("std_msgs/msg/String", {"data": f"msg {i:04d}" * 4}))
    w.close()
    r = McapStorageReader(f)
    msgs = list(r.messages())
    assert len(msgs) == 50
    assert [m[2] for m in msgs] == list(range(50))
    assert f.read_bytes().count(b"zstd") > 1


def test_sqlite_compression_rejected(tmp_path):
    with pytest.raises(ValueError, match="mcap"):
        Writer(tmp_path / "x", storage="sqlite3", compression="zstd")


# ---------------------------------------------------------------------------
# the same bytes as the JAX package
# ---------------------------------------------------------------------------


def test_registry_equals_jax():
    assert len(REGISTRY) == 99
    assert REGISTRY == jax_rosbag.REGISTRY


@pytest.mark.parametrize("type_name", sorted(jax_rosbag.REGISTRY))
def test_serialize_zero_filled_bytes_equal_jax(type_name):
    raw = serialize(type_name, {})
    assert raw == jax_rosbag.serialize(type_name, {})
    assert deserialize(type_name, raw) == jax_rosbag.deserialize(type_name, raw)


@pytest.mark.parametrize("type_name,msg", SAMPLES, ids=SAMPLE_IDS)
def test_serialize_sample_bytes_equal_jax(type_name, msg):
    raw = serialize(type_name, msg)
    assert raw == jax_rosbag.serialize(type_name, msg)
    assert deserialize(type_name, raw) == jax_rosbag.deserialize(type_name, raw)


STORAGES = {"sqlite3": ("sqlite3", None), "mcap": ("mcap", None),
            "mcap_zlib": ("mcap", "zlib"), "mcap_zstd": ("mcap", "zstd")}


def _write_bag(pkg, bag, storage, compression):
    with pkg.Writer(bag, storage=storage, compression=compression) as w:
        w.add_topic("/odom", "nav_msgs/msg/Odometry")
        w.add_topic("/tf", "tf2_msgs/msg/TFMessage")
        w.add_topic("/custom", "my_msgs/msg/Unknown")
        for i in range(30):
            w.write("/odom", 1_000_000 * i + 7, odom_msg(0.5 * i, -0.25 * i, 0.01 * i, i))
            if i % 3 == 0:
                w.write("/tf", 1_000_000 * i + 3, SAMPLES[6][1])
        w.write("/custom", 5, b"\x00\x01\x00\x00opaque")


def _read_bag(pkg, bag):
    with pkg.Reader(bag) as r:
        return r.kind, r.topics(), r.message_count(), list(r.messages())


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("case", list(STORAGES))
def test_bags_cross_read(tmp_path, case, writer):
    """A bag written by one package reads the same through both."""
    storage, compression = STORAGES[case]
    port_pkg = sys.modules["apex_tpu_torch.io.rosbag"]
    bag = tmp_path / "bag"
    _write_bag(port_pkg if writer == "port" else jax_rosbag, bag, storage, compression)
    got, want = _read_bag(port_pkg, bag), _read_bag(jax_rosbag, bag)
    assert got == want
    assert got[2] == 41 and got[0] == storage
    assert read_metadata(bag) == jax_rosbag.read_metadata(bag)


@pytest.mark.parametrize("compression", [None, "zlib", "zstd"])
def test_mcap_bytes_equal_jax(tmp_path, compression):
    """Given the same ``library`` string, the MCAP file is the JAX
    package's byte for byte."""
    from apex_tpu.io.rosbag.mcap_storage import McapStorageWriter as JaxMcapWriter

    files = {}
    for name, cls in (("port", McapStorageWriter), ("jax", JaxMcapWriter)):
        files[name] = tmp_path / f"{name}.mcap"
        w = cls(files[name], library="apex_tpu", compression=compression, chunk_size=2048)
        w.add_topic("/odom", "nav_msgs/msg/Odometry")
        w.add_topic("/s", "std_msgs/msg/String")
        for i in range(40):
            w.write("/odom", 100 * i, serialize("nav_msgs/msg/Odometry", odom_msg(i, 0, 0, i)))
            w.write("/s", 100 * i + 1, serialize("std_msgs/msg/String", {"data": f"m{i}"}))
        w.close()
    assert files["port"].read_bytes() == files["jax"].read_bytes()


# ---------------------------------------------------------------------------
# metadata.yaml without PyYAML
# ---------------------------------------------------------------------------

QOS = ("- history: 3\n  depth: 0\n  reliability: 1\n  durability: 2\n  deadline:\n"
       "    sec: 9223372036854775807\n    nsec: 4294967295\n  lifespan:\n"
       "    sec: 9223372036854775807\n    nsec: 4294967295\n  liveliness: 1\n"
       "  liveliness_lease_duration:\n    sec: 9223372036854775807\n"
       "    nsec: 4294967295\n  avoid_ros_namespace_conventions: false")

# strings that take each of PyYAML's styles: plain, single-quoted (empty,
# implicit types, indicators, trailing space, long folded text, breaks),
# double-quoted (break + indentation, specials, non-ASCII)
ODD_STRINGS = ["/odom", "", "123", "1.5", "true", "null", "~", "0x1F", "2020-01-01", "<<",
               "- a", "a: b", "#c", "a #c", "it's", " lead", "trail ", "---x", "[x]",
               "word " * 40, "plain " * 30 + "end", "a\nb", "a\n\nb\n", QOS, "tab\there",
               "caf\xe9", "nul\0", "\u2028x", "q\"uote\\"]


def _meta(strings):
    return {"rosbag2_bagfile_information": {
        "version": 5, "storage_identifier": "sqlite3",
        "relative_file_paths": ["bag_0.db3"] + strings[:3],
        "duration": {"nanoseconds": 151137181},
        "starting_time": {"nanoseconds_since_epoch": 1585866235112411371},
        "message_count": 7,
        "topics_with_message_count": [
            {"topic_metadata": {"name": s, "type": "std_msgs/msg/String",
                                "serialization_format": "cdr", "offered_qos_profiles": s},
             "message_count": i}
            for i, s in enumerate(strings)],
        "compression_format": "", "compression_mode": "", "files": [], "custom": {}}}


@pytest.mark.parametrize("case", ["writer", "odd_strings", "random_strings"])
def test_metadata_text_equals_pyyaml(tmp_path, case):
    """The port's emitter gives ``yaml.safe_dump(..., sort_keys=False)``'s
    text, and its reader ``yaml.safe_load``'s document."""
    if case == "writer":
        port_metadata.write_metadata(
            tmp_path, "mcap", ["b_0.mcap"],
            [{"name": "/odom", "type": "nav_msgs/msg/Odometry", "qos": QOS, "message_count": 3},
             {"name": "/tf", "type": "tf2_msgs/msg/TFMessage", "message_count": 2}],
            5, starting_time_ns=10, duration_ns=20)
        text = (tmp_path / "metadata.yaml").read_text()
        jax_rosbag.write_metadata(tmp_path, "mcap", ["b_0.mcap"],
                                  [{"name": "/odom", "type": "nav_msgs/msg/Odometry",
                                    "qos": QOS, "message_count": 3},
                                   {"name": "/tf", "type": "tf2_msgs/msg/TFMessage",
                                    "message_count": 2}],
                                  5, starting_time_ns=10, duration_ns=20)
        assert text == (tmp_path / "metadata.yaml").read_text()
        assert read_metadata(tmp_path) == jax_rosbag.read_metadata(tmp_path)
        return
    if case == "odd_strings":
        docs = [_meta(ODD_STRINGS)]
    else:
        rng = random.Random(0)
        alphabet = list("ab xy:#-'\"\n\t/_.,[]{}!&*|>%@`?~=<019") + ["\xe9", "\x85", "  "]
        docs = [_meta(["".join(rng.choice(alphabet) for _ in range(rng.choice([1, 3, 9, 90])))
                       for _ in range(40)]) for _ in range(25)]
    for doc in docs:
        text = yaml.safe_dump(doc, sort_keys=False)
        assert port_metadata.dump(doc) == text
        assert port_metadata.load(text) == yaml.safe_load(text)


def test_metadata_reads_rosbag2_text(tmp_path):
    """A metadata.yaml as rosbag2 writes it (indented sequences, a QoS
    string double-quoted with escapes, ``~``), read as PyYAML reads it."""
    quoted = '"' + QOS.replace("\n", "\\n") + '"'
    text = f'''rosbag2_bagfile_information:
  version: 5
  storage_identifier: sqlite3
  duration:
    nanoseconds: 151137181
  starting_time:
    nanoseconds_since_epoch: 1585866235112411371
  message_count: 7
  topics_with_message_count:
    - topic_metadata:
        name: /parameter_events
        type: rcl_interfaces/msg/ParameterEvent
        serialization_format: cdr
        offered_qos_profiles: {quoted}
      message_count: 0
    - topic_metadata:
        name: "/rosout"   # a comment
        type: 'rcl_interfaces/msg/Log'
        serialization_format: cdr
        offered_qos_profiles: "- history: 3\\n  depth: 0\\n  reliability: 1\\n  \\
          durability: 1"
      message_count: 7
  compression_format: ""
  compression_mode: ""
  relative_file_paths:
    - rosbag2_2020_04_02-15_23_55_0.db3
  files:
    - path: rosbag2_2020_04_02-15_23_55_0.db3
      starting_time:
        nanoseconds_since_epoch: 1585866235112411371
      duration:
        nanoseconds: 151137181
      message_count: 7
  custom_data: ~
  ros_distro: rolling
'''
    assert port_metadata.load(text) == yaml.safe_load(text)
    (tmp_path / "metadata.yaml").write_text(text)
    meta = read_metadata(tmp_path)
    assert meta["topics_with_message_count"][0]["topic_metadata"]["offered_qos_profiles"] == QOS
    assert meta["files"][0]["message_count"] == 7 and meta["custom_data"] is None


@pytest.mark.parametrize("case", ["sqlite3", "mcap_zlib"])
def test_bags_without_yaml_or_zstandard(tmp_path, case):
    """With ``yaml`` and ``zstandard`` not importable, the port writes and
    reads a bag; the JAX package then reads it the same."""
    storage, compression = STORAGES[case]
    code = (
        "import sys\n"
        "sys.modules['yaml'] = None\n"
        "sys.modules['zstandard'] = None\n"
        "from apex_tpu_torch.io.rosbag import Reader, Writer, read_metadata\n"
        "from apex_tpu_torch.cli import bag_tools\n"
        f"with Writer(sys.argv[1], storage={storage!r}, compression={compression!r}) as w:\n"
        "    w.add_topic('/p', 'geometry_msgs/msg/Point')\n"
        "    for i in range(20):\n"
        "        w.write('/p', i, {'x': float(i), 'y': 0.5, 'z': -1.0})\n"
        "with Reader(sys.argv[1]) as r:\n"
        "    msgs = list(r.messages())\n"
        "assert [m[3]['x'] for m in msgs] == [float(i) for i in range(20)], msgs\n"
        "assert read_metadata(sys.argv[1])['message_count'] == 20\n"
        "assert bag_tools.main(['info', sys.argv[1]]) == 0\n"
        "bad = [m for m in ('yaml', 'zstandard', 'jax', 'apex_tpu') if sys.modules.get(m)]\n"
        "assert not bad, bad\n"
    )
    bag = tmp_path / "bag"
    subprocess.run([sys.executable, "-c", code, str(bag)], cwd=REPO, check=True, timeout=120,
                   capture_output=True)
    with jax_rosbag.Reader(bag) as r:
        assert [m[3]["x"] for m in r.messages()] == [float(i) for i in range(20)]


# ---------------------------------------------------------------------------
# bag_tools
# ---------------------------------------------------------------------------


def _stdout(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return out.getvalue()


def test_bag_tools_cli(tmp_path):
    """tests/test_cli.py's ``bag_tools`` case, through the port's CLI."""
    bag = tmp_path / "bag"
    assert bag_tools.main(["write-dummy", str(bag), "--count", "5"]) == 0
    assert bag_tools.main(["info", str(bag)]) == 0
    out = tmp_path / "f"
    assert bag_tools.main(["filter", str(bag), str(out), "--topics", "/odom"]) == 0
    csvp = tmp_path / "x.csv"
    assert bag_tools.main(["extract", str(out), "--topic", "/odom", "--out", str(csvp)]) == 0
    assert csvp.exists()


@pytest.mark.parametrize("storage", ["sqlite3", "mcap"])
def test_bag_tools_output_equals_jax(tmp_path, storage):
    """``write-dummy`` writes the same messages, and ``info`` / ``filter`` /
    ``extract`` print and write what the JAX CLI does on the same bag."""
    bags = {}
    for name, cli in (("port", bag_tools), ("jax", jax_bag_tools)):
        bags[name] = tmp_path / name / "bag"
        _stdout(cli.main, ["write-dummy", str(bags[name]), "--count", "12",
                           "--storage", storage])
    assert _read_bag(jax_rosbag, bags["port"])[1:] == _read_bag(jax_rosbag, bags["jax"])[1:]
    bag = bags["jax"]
    assert _stdout(bag_tools.main, ["info", str(bag)]) == _stdout(
        jax_bag_tools.main, ["info", str(bag)])
    for name, cli in (("port", bag_tools), ("jax", jax_bag_tools)):
        _stdout(cli.main, ["filter", str(bag), str(tmp_path / name / "f"), "--topics", "/odom"])
        _stdout(cli.main, ["extract", str(bag), "--topic", "/odom", "--out",
                           str(tmp_path / name / "x.csv")])
    assert _read_bag(jax_rosbag, tmp_path / "port" / "f") == _read_bag(
        jax_rosbag, tmp_path / "jax" / "f")
    csv_text = (tmp_path / "port" / "x.csv").read_bytes().decode()
    assert csv_text == (tmp_path / "jax" / "x.csv").read_bytes().decode()
    assert len(csv_text.splitlines()) == 13
    assert _stdout(bag_tools.main, ["extract", str(bag), "--topic", "/odom"]) == csv_text
