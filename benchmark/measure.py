"""Run one cell several times, one process per run, and summarize: each
run's result line and checks, and for each end-to-end metric the spread of
the runs without a trace (the distance between the first and third
quartiles, ``statistics.quantiles(values, n=4)``, over the median).

    python benchmark/measure.py --workload <cell> --seconds <s>
        --seeds 11,12,13 [--trace-seeds 14] [--control-seeds 15,16,17]
        [--out results.jsonl]

Each run's record (command, exit code, wall seconds, last stdout line,
the tail of stderr) is appended to ``--out`` as one JSON line.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def card():
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "no nvidia-smi"


def one(workload, seed, seconds, trace, control, timeout):
    cmd = [sys.executable, os.path.join(HERE, "run.py"), "--workload", workload, "--seed",
           str(seed), "--seconds", str(seconds), "--trace", str(trace)]
    if control:
        cmd.append("--control")
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=timeout)
        rc, out, err = proc.returncode, proc.stdout, proc.stderr
    except subprocess.TimeoutExpired as e:
        rc, out, err = 124, e.stdout or "", e.stderr or ""
        out, err = (x.decode() if isinstance(x, bytes) else x for x in (out, err))
    lines = out.strip().splitlines()
    line = None
    if lines:
        try:
            line = json.loads(lines[-1])
        except json.JSONDecodeError:
            line = None
    return {"workload": workload, "seed": seed, "seconds": seconds, "trace": trace,
            "control": control, "rc": rc, "wall_s": time.perf_counter() - t0, "line": line,
            "stderr_tail": err[-3000:]}


def spread(values):
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2 if q2 else float("nan")


def main():
    p = argparse.ArgumentParser(description="Run one cell several times and summarize.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--trace-seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--timeout", type=float, default=1500)
    p.add_argument("--out", default=None)
    a = p.parse_args()

    def seeds(s):
        return [int(x) for x in s.split(",") if x]

    print(f"# card: {card()}", flush=True)
    plan = ([(s, 0, False) for s in seeds(a.seeds)] + [(s, 1, False) for s in seeds(a.trace_seeds)]
            + [(s, 0, True) for s in seeds(a.control_seeds)])
    runs = []
    for seed, trace, control in plan:
        rec = one(a.workload, seed, a.seconds, trace, control, a.timeout)
        runs.append(rec)
        if a.out:
            with open(a.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
        line = rec["line"] or {}
        metrics = {k: v["value"] for k, v in (line.get("metrics") or {}).items()}
        print(json.dumps({"seed": seed, "trace": trace, "control": control, "rc": rec["rc"],
                          "wall_s": round(rec["wall_s"], 1), "correct": line.get("correct"),
                          "attempted": line.get("attempted"), "metrics": metrics,
                          "device": line.get("device"), "walls": line.get("solve_walls_s"),
                          "checks": line.get("checks")}),
              flush=True)
        if rec["line"] is None:
            print(rec["stderr_tail"][-1500:], flush=True)
    timed = [r["line"]["metrics"] for r in runs
             if r["line"] and not r["trace"] and not r["control"]]
    if len(timed) >= 2:
        for name in timed[0]:
            vals = [m[name]["value"] for m in timed if name in m]
            print(f"# {name}: median {statistics.median(vals)!r} spread {spread(vals)!r} "
                  f"values {vals}", flush=True)


if __name__ == "__main__":
    main()
