"""One run of one cell: set-up, a measured window, the per-layer readings
(``--trace 1``), the comparison with the reference, and the result line.

A cell (``BENCHMARK.json`` ``workloads``) names a configuration and a
traffic mix; the harness finds each by name:

- ``benchmark/configs/<config>.json``: the deployment: ``problem``
  (``bundle_adjustment`` | ``pose_graph``), ``generator`` (a name in
  ``generators.GENERATORS`` or of a file ``benchmark/generators/<name>.py``,
  and its sizes), ``build`` (options of the
  problem builder), ``solver`` (the optimizer's configuration fields, with
  ``mode`` and ``dtype``), and optionally ``reference``: the name of its
  plain reference's file;
- ``benchmark/references/<reference>.py``: the plain reference that judges
  the configuration (``PROBLEM``, ``KIND``, ``MODELS``, optionally
  ``Settings``; the interface is in ``reference.py``'s docstring, and it
  runs in float32 too, for ``--control``); without the key,
  ``reference.builtin(problem)``. ``reference_for`` resolves either, once,
  for ``reference_settings``, the control and ``judge``;
- ``benchmark/traffic/<traffic>.json``: the parameters of the mix: the
  name of its loop, solver overrides, the quality gate and how many
  answers keep their variables for the comparison;
- ``benchmark/loops/<loop>.py``: the loop a traffic file names:
  ``window(...)``, which sets up, drives the program for the window and
  returns its answers, ``compared(spec, data, seed)``, the problems
  whose answers the reference checks, and optionally ``traced(...)``, the
  traced pass that ``--trace 1`` runs after the window;
- ``benchmark/limits/<cell>.json``: the limit of each number compared;
- ``benchmark/metrics/<metric>.py``: a reader, ``read(record) -> float or
  None``, of each per-layer metric the cell reports.

With ``--trace 1`` the window is the same as without, timed by CUDA events
around each parent-graph launch; after it, the loop's traced pass records
the program's own trace (spans, stamped device phases, work counters) for
the readers that need it (``Record.trace``). Neither touches what the
end-to-end metrics measure.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import random
import statistics
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import torch

from . import compare, generators, program, reference

FORBIDDEN = {"jax", "jaxlib", "flax", "apex_tpu"}
GIB = float(2 ** 30)
# the traced pass: each of its two stretches lasts at least this long and
# this many solves
TRACE_SECONDS = 10.0
TRACE_SOLVES = 3
# entries of each list of the result's breakdown
BREAKDOWN_ENTRIES = 10


def load(root, workload):
    """The cell's specification from the files under ``root``."""
    root = Path(root)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: {sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    e2e = [m for m in spec["end_to_end"] if workload in m.get("workloads", [workload])]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m else m["moves"] in moved)]
    bench = root / "benchmark"
    traffic = json.loads((bench / "traffic" / f"{cell['traffic']}.json").read_text())
    loop = _module(bench / "loops" / f"{traffic['loop']}.py")
    config = json.loads((root / configs[cell["config"]]["file"]).read_text())
    return {
        "cell": cell,
        "config": config,
        "reference": reference_for(bench, config),
        "traffic": traffic,
        "loop": SimpleNamespace(window=loop.window, compared=loop.compared,
                                traced=getattr(loop, "traced", None)),
        "limits": json.loads((bench / "limits" / f"{workload}.json").read_text()),
        "end_to_end": e2e,
        "per_layer": per_layer,
        "readers": {m["name"]: _module(bench / "metrics" / f"{m['name']}.py").read
                    for m in per_layer},
    }


def _module(path):
    name = f"benchmark_{path.parent.name}_" + path.stem.replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reference_for(bench, config):
    """The plain reference that judges ``config``: the file
    ``bench/references/<name>.py`` that its ``reference`` key names, or
    without the key ``reference.builtin`` of its problem."""
    kind = config["problem"]
    if "reference" not in config:
        return reference.builtin(kind)
    path = bench / "references" / f"{config['reference']}.py"
    if not path.is_file():
        raise SystemExit(f"unknown reference {config['reference']!r}: no file {path}")
    module = _module(path)
    if module.KIND != kind:
        raise SystemExit(f"the reference {path} serves {module.KIND!r}, not the "
                         f"configuration's problem {kind!r}")
    settings = getattr(module, "Settings", reference.Settings)
    if not issubclass(settings, reference.Settings):
        raise SystemExit(f"the Settings of the reference {path} do not extend reference.Settings")
    return reference.Reference(module.PROBLEM, dict(reference.MODELS[kind], **module.MODELS),
                               settings)


def solver_options(spec, data):
    """The configuration's solver fields with the traffic's overrides; a
    quality gate in pixels becomes ``min_cost_threshold``."""
    opts = dict(spec["config"]["solver"])
    opts.update(spec["traffic"].get("solver", {}))
    px = opts.pop("min_cost_threshold_rmse_px", None)
    if px is not None:
        opts["min_cost_threshold"] = px * px * observations(data)
    return opts


def observations(data):
    return data["observations"].shape[0] if "observations" in data else 0


def reference_settings(ref, opts):
    """The settings of the reference ``ref`` (``reference_for``) from the
    solver fields; a field or a value it does not model raises, so that a
    configuration never meets a reference that ignores part of it."""
    fields = set(ref.settings.__dataclass_fields__)
    for key, value in opts.items():
        if key in ref.models:
            if ref.models[key] is not None and value not in ref.models[key]:
                raise ValueError(f"the reference does not model {key}={value!r}")
        elif key not in fields:
            raise ValueError(f"the reference does not model the solver field {key!r}")
    return ref.settings(**{k: v for k, v in opts.items() if k in fields})


class Record:
    """What the window recorded, for the per-layer readers."""

    def __init__(self, spec, data, device, device_kind):
        self.kind = spec["config"]["problem"]
        self.data, self.device, self.device_kind = data, device, device_kind
        self.dtype = program.DTYPES[spec["config"]["solver"]["dtype"]]
        self.solves = []  # dicts: wall_s, iterations, host_reads
        self.setup = {}  # seconds of each step of the set-up, by name
        self.window_s = 0.0
        self.graph_s = None  # summed CUDA-event time of parent-graph launches
        self.graph_launches = 0
        self.compiled = None  # the window's compiled problem, for the traced pass
        # the traced pass: {"trace": the program's trace, "solves", "iterations",
        # "setup": seconds of the capture solve's spans by name}
        self.trace = None

    def time_kernel(self, fn, args, launches=200):
        """Device seconds per call of ``fn(*args)`` by CUDA events over
        ``launches`` calls after a warm-up; None off the card."""
        if self.device.type != "cuda":
            return None
        for _ in range(5):
            fn(*args)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn(*args)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 1e3 / launches


class _GraphClock:
    """CUDA events around each parent-graph launch (the program's launch
    hook); summed once the window has closed."""

    def __init__(self):
        self.pairs = []

    def __call__(self, launch):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        launch()
        end.record()
        self.pairs.append((start, end))

    def seconds(self):
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.pairs) / 1e3


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Sampler:
    """Which answers keep their variables: the first and the last of the
    window and ``k`` more drawn from the seed (reservoir sampling)."""

    def __init__(self, seed, k):
        self.rng, self.k = random.Random(seed), k
        self.first, self.last, self.pool, self.seen = None, None, [], 0

    def offer(self, answer):
        if self.first is None:
            self.first = answer
            return
        if self.last is not None:
            self.seen += 1
            if len(self.pool) < self.k:
                self.pool.append(self.last)
            else:
                j = self.rng.randrange(self.seen)
                if j < self.k:
                    self.pool[j] = self.last
        self.last = answer

    def kept(self):
        return [a for a in [self.first, *self.pool, self.last] if a is not None]


def strip(answer):
    """The answer without its variables: gated, but not compared."""
    return program.Answer(answer.status, answer.iterations, answer.initial_cost,
                          answer.final_cost, None)


def _percentile(values, q):
    if len(values) < 2:
        return values[0] if values else math.nan
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]


def _control_cases(spec, data, seed, device):
    """The reference in the program's place, one precision below the
    configuration's (float32 for float64): its answers for the problems a
    run compares."""
    ref = spec["reference"]
    cases = []
    for part in spec["loop"].compared(spec, data, seed):
        opts = solver_options(spec, part)
        low = reference.levenberg_marquardt(ref.problem(part, torch.float32, device),
                                            reference_settings(ref, opts))
        ans = program.Answer(low.status, low.iterations, low.initial_cost, low.final_cost, None)
        ans.arrays = low.values
        cases.append((part, [ans]))
    return cases


def judge(spec, cases, device, gate_answers):
    """The numbers compared and their limits, reference solves included."""
    ref = spec["reference"]
    full = []
    for part, answers in cases:
        opts = solver_options(spec, part)
        ref_problem = ref.problem(part, torch.float64, device)
        result = reference.levenberg_marquardt(ref_problem, reference_settings(ref, opts))
        full.append((part, result, ref_problem, answers))
    values = compare.numbers(spec["config"]["problem"], full)
    gate = spec["traffic"].get("gate", {})
    values.update(compare.gate_numbers(gate, [a for _, a, n in gate_answers],
                                       [n for _, _, n in gate_answers]))
    limits = dict(spec["limits"], **compare.gate_limits(gate))
    return compare.checks(values, limits)


def run(spec, seed, seconds, trace, t_process, device=None, control=False, out=sys.stdout,
        trace_seconds=TRACE_SECONDS):
    """One run of the cell; prints the result line and returns the exit
    code. ``trace_seconds``: the least length of each stretch of the traced
    pass."""
    device = torch.device(device or "cuda")
    chips = spec["cell"]["chips"]
    if device.type == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"this cell needs {chips} CUDA device(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device_kind = torch.cuda.get_device_name(device)
    else:
        device_kind = "cpu"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_data = time.perf_counter()
    data = generators.make(spec["config"]["generator"], seed)
    opts = solver_options(spec, data)
    record = Record(spec, data, device, device_kind)
    record.setup.update(start_s=t_data - t_process, data_s=time.perf_counter() - t_data)
    if control:
        cases = _control_cases(spec, data, seed, device)
        gate_answers = [(part, a, observations(part)) for part, ans in cases for a in ans]
        rows = judge(spec, cases, device, gate_answers)
        return _report(out, rows, len(gate_answers), 0, {}, None, None)

    clock = _GraphClock() if trace and device.type == "cuda" else None
    t_start, cases, attempted, failed = spec["loop"].window(spec, data, opts, device, seconds,
                                                            seed, record, clock)
    peak = torch.cuda.max_memory_reserved(device) if device.type == "cuda" else 0
    if clock is not None:
        record.graph_s, record.graph_launches = clock.seconds(), len(clock.pairs)
    if trace and spec["loop"].traced is not None:
        spec["loop"].traced(opts, device, record, trace_seconds)
    record.compiled = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    walls = [s["wall_s"] for s in record.solves]
    metrics = {}
    if trace:
        for m in spec["per_layer"]:
            value = spec["readers"][m["name"]](record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = {"setup_s": t_start - t_process,
               "solve_s": record.window_s / max(len(walls), 1),
               "solve_p95_s": _percentile(walls, 95),
               "peak_mem_gib": peak / GIB}
        for m in spec["end_to_end"]:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}

    gate_answers = [(part, a, observations(part)) for part, ans in cases for a in ans]
    failed += sum(not math.isfinite(a.final_cost) for _, a, _ in gate_answers)
    rows = judge(spec, cases, device, gate_answers)
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": device_kind,
           "count": chips, "memory_peak_bytes": int(peak)}
    breakdown = None
    if trace:
        dev["busy_s"] = record.graph_s if record.graph_s is not None else 0.0
        dev["window_s"] = record.window_s
        breakdown = _breakdown(record)
    return _report(out, rows, attempted, failed, metrics, dev, breakdown, walls, record.setup)


def _breakdown(record):
    """The harness's own view of the window: the graph launches' device
    time, and where the host held the card outside them; then, from the
    traced pass, the device seconds of each top-level stamped phase and the
    device's idle seconds by innermost host span, the largest first."""
    walls = sum(s["wall_s"] for s in record.solves)
    graph = record.graph_s or 0.0
    ops = [["parent CUDA graph launches (CUDA events)", graph]]
    gaps = [["host, outside parent-graph launches, inside solves", walls - graph],
            ["host, between solves", record.window_s - walls]]
    if record.trace is not None:
        trace = record.trace["trace"]
        phases = {}
        for p in trace["phases"]:
            if p["parent"] is None:
                phases[p["path"]] = phases.get(p["path"], 0.0) + p["total_ns"] / 1e9
        idle = program.idle_by_span(trace) or {}
        for out, label, seconds in ((ops, "stamped", phases), (gaps, "idle in", idle)):
            ranked = sorted(seconds.items(), key=lambda kv: -kv[1])
            out += [[f"traced pass, {label} {name}", value]
                    for name, value in ranked[:BREAKDOWN_ENTRIES - len(out)]]
    return {"device_ops": ops, "idle_gaps": gaps}


def _finite(x):
    """JSON has no infinity or NaN: such a number is written as null."""
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_finite(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return None
    return x


def _report(out, rows, attempted, failed, metrics, device, breakdown, walls=(), setup=None):
    """Prints the checks and the result line; none where a forbidden module
    has loaded by now, the reference's solves included."""
    found = sorted({name.split(".")[0] for name in list(sys.modules)} & FORBIDDEN)
    if found:
        print(f"modules that must not load were loaded: {found}", file=sys.stderr)
        return 3
    correct = failed == 0 and all(ok for *_, ok in rows)
    for name, value, limit, ok in rows:
        print(f"check {name} {value!r} limit {limit!r} {'ok' if ok else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    line = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
            "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    if walls:
        # the spread of the window's solves: min, quartiles, max, first, last
        line["solve_walls_s"] = [min(walls), *statistics.quantiles(walls, n=4), max(walls),
                                 walls[0], walls[-1]] if len(walls) > 1 else walls
    if setup:
        # where setup_s went: process start to the run, data, build, compile,
        # the warm-up solve
        line["setup_split_s"] = setup
    line["checks"] = {name: [value, limit] for name, value, limit, _ in rows}
    print(json.dumps(_finite(line)), file=out, flush=True)
    return 0
