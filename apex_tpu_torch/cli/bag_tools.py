"""ROS2 bag utility CLIs of the port: the JAX package's ``bag_tools`` with
the same commands, output text and CSV (the reference apex-io bins bag_info,
bag_filter, extract_topic_data, write_dummy_bag). Host code only: it reads
and writes bags through ``apex_tpu_torch.io.rosbag``. ``filter`` adds the
kept topics in name order.

Usage:
    python -m apex_tpu_torch.cli.bag_tools info <bag>
    python -m apex_tpu_torch.cli.bag_tools filter <bag> <out_bag> --topics /odom /tf
    python -m apex_tpu_torch.cli.bag_tools extract <bag> --topic /odom --out data.csv
    python -m apex_tpu_torch.cli.bag_tools write-dummy <out_bag> [--storage mcap]
"""

from __future__ import annotations

import argparse
import math
import sys


def cmd_info(args):
    from apex_tpu_torch.io.rosbag import Reader, read_metadata

    meta = read_metadata(args.bag)
    r = Reader(args.bag)
    print(f"bag: {args.bag}")
    print(f"storage: {r.kind}")
    if meta:
        print(f"duration: {meta['duration']['nanoseconds'] / 1e9:.3f} s")
        print(f"start: {meta['starting_time']['nanoseconds_since_epoch']} ns")
    print(f"messages: {r.message_count()}")
    print("topics:")
    counts = {}
    for topic, _, _, _ in r.messages(decode=False):
        counts[topic] = counts.get(topic, 0) + 1
    for tid, name, type_name, fmt, _ in r.topics():
        print(f"  {name:<30} {type_name:<40} {counts.get(name, 0):>8} msgs [{fmt}]")
    r.close()
    return 0


def cmd_filter(args):
    from apex_tpu_torch.io.rosbag import Reader, Writer

    r = Reader(args.bag)
    keep = set(args.topics)
    types = {name: type_name for _, name, type_name, _, _ in r.topics()}
    missing = keep - set(types)
    if missing:
        sys.exit(f"topics not in bag: {sorted(missing)}")
    with Writer(args.out, storage=args.storage or r.kind) as w:
        for t in sorted(keep):
            w.add_topic(t, types[t])
        n = 0
        for topic, _, ts, raw in r.messages(topics=sorted(keep), decode=False):
            w.write(topic, ts, raw)
            n += 1
    print(f"wrote {n} messages on {len(keep)} topics to {args.out}")
    r.close()
    return 0


def _flatten(msg, prefix=""):
    out = {}
    if isinstance(msg, dict):
        for k, v in msg.items():
            out.update(_flatten(v, f"{prefix}.{k}" if prefix else k))
    elif isinstance(msg, list):
        if len(msg) <= 8:
            for i, v in enumerate(msg):
                out.update(_flatten(v, f"{prefix}[{i}]"))
        else:
            out[prefix + ".len"] = len(msg)
    else:
        out[prefix] = msg
    return out


def cmd_extract(args):
    import csv

    from apex_tpu_torch.io.rosbag import Reader

    r = Reader(args.bag)
    rows = []
    for topic, type_name, ts, msg in r.messages(topics=[args.topic]):
        if isinstance(msg, bytes):
            sys.exit(f"no schema registered for messages on {args.topic}")
        row = {"timestamp_ns": ts}
        row.update(_flatten(msg))
        rows.append(row)
    r.close()
    if not rows:
        sys.exit(f"no messages on topic {args.topic}")
    keys = sorted({k for row in rows for k in row}, key=lambda k: (k != "timestamp_ns", k))
    out = open(args.out, "w", newline="") if args.out else sys.stdout
    writer = csv.DictWriter(out, fieldnames=keys)
    writer.writeheader()
    writer.writerows(rows)
    if args.out:
        out.close()
        print(f"wrote {len(rows)} rows to {args.out}")
    return 0


def cmd_write_dummy(args):
    from apex_tpu_torch.io.rosbag import Writer

    with Writer(args.out, storage=args.storage) as w:
        w.add_topic("/odom", "nav_msgs/msg/Odometry")
        w.add_topic("/tf", "tf2_msgs/msg/TFMessage")
        for i in range(args.count):
            t = i * 100_000_000
            yaw = 0.05 * i
            w.write("/odom", t, {
                "header": {"stamp": {"sec": t // 10**9, "nanosec": t % 10**9},
                           "frame_id": "odom"},
                "child_frame_id": "base_link",
                "pose": {"pose": {
                    "position": {"x": math.cos(yaw) * i * 0.1,
                                 "y": math.sin(yaw) * i * 0.1, "z": 0.0},
                    "orientation": {"x": 0.0, "y": 0.0,
                                    "z": math.sin(yaw / 2), "w": math.cos(yaw / 2)},
                }, "covariance": [0.0] * 36},
                "twist": {"twist": {"linear": {"x": 1.0, "y": 0.0, "z": 0.0},
                                    "angular": {"x": 0.0, "y": 0.0, "z": 0.05}},
                          "covariance": [0.0] * 36},
            })
            w.write("/tf", t, {"transforms": [{
                "header": {"stamp": {"sec": t // 10**9, "nanosec": t % 10**9},
                           "frame_id": "map"},
                "child_frame_id": "odom",
                "transform": {"translation": {"x": 0.0, "y": 0.0, "z": 0.0},
                              "rotation": {"x": 0.0, "y": 0.0, "z": 0.0, "w": 1.0}},
            }]})
    print(f"wrote dummy bag with {2 * args.count} messages to {args.out}")
    return 0


def main(argv=None):
    p = argparse.ArgumentParser(prog="bag_tools", description="apex-tpu rosbag utilities")
    sub = p.add_subparsers(dest="cmd", required=True)

    pi = sub.add_parser("info")
    pi.add_argument("bag")
    pi.set_defaults(fn=cmd_info)

    pf = sub.add_parser("filter")
    pf.add_argument("bag")
    pf.add_argument("out")
    pf.add_argument("--topics", nargs="+", required=True)
    pf.add_argument("--storage", default=None, choices=["sqlite3", "mcap"])
    pf.set_defaults(fn=cmd_filter)

    pe = sub.add_parser("extract")
    pe.add_argument("bag")
    pe.add_argument("--topic", required=True)
    pe.add_argument("--out", default=None)
    pe.set_defaults(fn=cmd_extract)

    pw = sub.add_parser("write-dummy")
    pw.add_argument("out")
    pw.add_argument("--storage", default="sqlite3", choices=["sqlite3", "mcap"])
    pw.add_argument("--count", type=int, default=50)
    pw.set_defaults(fn=cmd_write_dummy)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
