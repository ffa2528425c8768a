"""``mode="jit"``'s device loop: a whole solve recorded as a tree of CUDA
graphs, branches and loops, and run as one CUDA graph whose IF and WHILE
conditional nodes decide the branches and the trips on the device.

The JAX package runs a whole solve as one ``lax.while_loop`` whose retry
ladders, refinement gate and PCG loop are nested ``while_loop`` / ``cond``
(``apex_tpu/optim/lm.py`` ``_optimize_jit``). PyTorch 2.11 captures no
conditional node, so the port records the program itself and builds the
graph (``kernels/graph_conditional.py``, ``csrc/graph_conditional.cu``):

- **capture** (a CUDA problem, once per problem): ``cond_update(pred, fn,
  *state)`` ends the graph being captured; ``fn`` is captured as a program
  of its own that writes the new state in place; a new graph starts after
  it. ``while_update`` records its body once the same way. ``Captured``
  then builds one parent graph from the recorded tree: each captured graph
  (``torch.cuda.CUDAGraph(keep_graph=True)``) a child-graph node, each
  branch an IF node behind a kernel that sets its handle from ``pred`` (a
  0-d bool on the device), each loop a WHILE node whose body ends in a
  kernel that sets the handle to ``flag && trips < max_trips``. A launch
  of it reads nothing back.
- **eager** (python mode, which runs the step that jit mode captures, and
  a CPU problem in ``mode="jit"``): the same branches as plain PyTorch,
  each reading its flag back once.
- **warm-up** (before a capture): ``fn`` always runs and ``torch.where``
  keeps the old state where ``pred`` is false, so every kernel of every
  branch is initialized before capture, with no host read.

``while_update(pred, body, max_trips, *state)`` is the reference's
``lax.while_loop``: ``state = body(*state)`` while ``pred(*state)`` holds,
``max_trips`` trips at most (eager: one read per trip; warm-up: every trip
masked by ``torch.where``, or the first ``warmup_trips``). The LM loop
(``optim/lm.py``), the general tier's and the QR sweep's retry ladders and
both PCG loops (in chunks of ``PCG_CHUNK`` masked iterations) run through
it. A loop whose body holds a call that a conditional node's body cannot
hold stays on the host, named at its call site (``host=reason``): the QR
solvers' LM loop (``lm.QR_HOST_LOOP``). Its body's graphs are replayed by
PyTorch one by one, and every branch and loop in it reads its flag.

``masked_update`` is the branch that never reads: both sides run and
``torch.where`` selects (inside a PCG chunk, the done flag frozen on the
device). ``assign`` writes a step's result into its state: in place under
capture, a new tuple otherwise.

Every graph of a problem shares one memory pool. Tensors that cross from
one graph to a later one stay referenced by the program, and every state
tensor is allocated outside capture, so no launch overwrites a live value.
The captured ``CUDAGraph`` objects stay referenced as long as the parent
graph lives: its child nodes point into their pool.

Counters: ``captures`` (programs captured), ``graphs`` (CUDA graphs in
them), ``launches`` (launches of parent graphs), ``replays`` (captured
graphs run by them), ``host_reads`` (device values read by the jit loop:
branch flags in eager form, the status and the result), ``status_reads``
(those of the status) and ``replayed`` (each captured kernel's launches
made by graphs, by name: ``reset_counters`` leaves it, so a caller can
count a kernel across code that resets the others). A launch of a graph
never calls the kernels' wrappers, so each captured graph carries the
launches its capture recorded. On the device each IF node counts the
times it was taken and each WHILE node its trips; ``tally`` derives
``replays`` and the kernels' launches from those counts once they are read
back, with the solve's result.

Other modules' work counters (``linalg.banded.cr_*``,
``linalg.schur.pcg_*``) count where the work runs, and a trace
(``utils.profiling``) reports each of them. ``count(owner, name)``
adds now in eager form; under capture the graph being captured carries the
count, and ``tally`` adds it once per device execution of that graph; the
warm-up adds nothing. ``count_on_device`` adds a device value (PCG's live
iterations): in eager form now, with one read; under capture through an
accumulator read with the result, recorded only while tracing is on
(``utils.profiling``), so that a graph captured with tracing off holds no
node of it.
``launch_hook``, where set, wraps every launch of a parent graph:
``launch_hook(launch)`` must call ``launch()`` once (the benchmark's
harness times the launches with it). The program's own timing of the
launches is the tracer's: with tracing on, its CUDA events wrap each
launch (``profiling.launch_interval``).

Every call on the steps captures on the H100 with torch 2.11 under the
default ``preferred_linalg_library``: batched ``cholesky_ex`` and
``solve_triangular``, single ``cholesky_solve``, ``qr``, ``index_add_``,
the landmark kernel and the SPD inverse kernel. Only a batched
``cholesky_solve`` would go to MAGMA, which synchronizes and fails under
capture; no step calls one.
"""

from __future__ import annotations

import functools
import weakref

import torch

from ..kernels import graph_conditional as gc
from ..kernels import landmark_blocks, schur_apply, schur_assemble, spd_inverse
from ..kernels.build import current_stream
from ..utils import profiling

# PCG iterations per trip of its device loop in jit mode
PCG_CHUNK = 4

captures = 0
graphs = 0
launches = 0
replays = 0
host_reads = 0
status_reads = 0

# the kernels whose launches a captured graph carries: {name: wrapper module}
_KERNELS = {"landmark_blocks": landmark_blocks, "spd_clamped_inv": spd_inverse,
            "schur_assemble": schur_assemble, "schur_apply": schur_apply}
# their launches made by parent graphs and host replays, by name
replayed = dict.fromkeys(_KERNELS, 0)
launch_hook = None
# count_on_device's accumulators: {(owner id, name, device): (owner, name, 0-d int64)}
_accumulators = {}

# "eager" | "warmup" | "capture"
_mode = "eager"
_recorder = None
for _name in ("launches", "replays", "host_reads"):
    profiling.watch(globals(), _name)


def reset_counters() -> None:
    global captures, graphs, launches, replays, host_reads, status_reads
    captures = graphs = launches = replays = host_reads = status_reads = 0


def read_flag(pred) -> bool:
    """One host read of a 0-d device bool."""
    global host_reads
    host_reads += 1
    return bool(pred)


def read_status(status) -> int:
    """One host read of the jit loop's 0-d status."""
    global host_reads, status_reads
    host_reads += 1
    status_reads += 1
    return int(status)


class _Mode:
    """Sets the branches' mode (and the recorder under capture) for a
    ``with`` block, and restores the previous one on leaving it, also when
    the block raises: a failed capture leaves later solves in eager mode."""

    def __init__(self, mode, recorder=None):
        self.mode, self.recorder = mode, recorder

    def __enter__(self):
        global _mode, _recorder
        self.prev = _mode, _recorder
        _mode, _recorder = self.mode, self.recorder
        profiling.set_form(_mode)
        return self.recorder

    def __exit__(self, *exc):
        global _mode, _recorder
        _mode, _recorder = self.prev
        profiling.set_form(_mode)


def warmup_mode():
    """Run steps in their warm-up form: every branch taken and selected by
    ``torch.where``, no host read."""
    return _Mode("warmup")


def warming_up() -> bool:
    """Whether steps run in their warm-up form: a counter of the work done
    leaves the warm-up's copy of a step out."""
    return _mode == "warmup"


def recording() -> bool:
    """Whether steps run to be captured: in their warm-up or capture form,
    not eager. A call that a conditional node's body cannot hold takes its
    capturable form only then."""
    return _mode != "eager"


def count(owner, name, n=1) -> None:
    """Add ``n`` units of work to ``owner[name]`` (a module's ``globals()``)
    where the work runs: now in eager form, once per device execution of
    the graph being captured under capture (``tally``), never in the
    warm-up form. A trace reports the counter (``profiling.watch``)."""
    profiling.watch(owner, name)
    if _mode == "eager":
        owner[name] += n
    elif _mode == "capture":
        _recorder.counted.append((owner, name, n))


def counts_on_device() -> bool:
    """Whether ``count_on_device`` counts: in eager form always, under
    warm-up and capture only while tracing is on."""
    return _mode == "eager" or profiling.tracing()


def count_on_device(owner, name, value) -> None:
    """Add the 0-d integer device tensor ``value`` to ``owner[name]``, where
    ``counts_on_device()``: now in eager form (one read), else with the
    solve's one read (``device_counts``)."""
    if not counts_on_device():
        return
    if _mode == "eager":
        profiling.watch(owner, name)
        owner[name] += int(value)
        return
    key = (id(owner), name, value.device)
    if key not in _accumulators:
        profiling.watch(owner, name)
        if _mode == "capture":
            raise RuntimeError(f"{name}: a device count first met under capture; the "
                               "warm-up makes its accumulator")
        _accumulators[key] = (owner, name, torch.zeros((), dtype=torch.int64,
                                                       device=value.device))
    if _mode == "capture":
        _accumulators[key][2].add_(value)


def device_counts(device):
    """count_on_device's accumulators on ``device`` (a tensor's device, with
    its index): [(owner, name, 0-d tensor)], read with a solve's result and
    handed to ``add_device_counts``."""
    return [acc for key, acc in _accumulators.items() if key[2] == device]


def zero_device_counts(device) -> None:
    for _, _, acc in device_counts(device):
        acc.zero_()


def add_device_counts(accumulators, values) -> None:
    for (owner, name, _), value in zip(accumulators, values):
        owner[name] += int(value)


def assign(state, new):
    """The step's result as its state: copied into ``state`` in place under
    capture (``state`` is static there), ``new`` itself otherwise."""
    if _mode == "capture":
        for old, value in zip(state, new):
            old.copy_(value)
        return tuple(state)
    return tuple(new)


def masked_update(pred, fn, *state):
    """``fn(*state)`` where ``pred`` holds, else ``state``, both computed and
    selected on the device."""
    return tuple(torch.where(pred, value, old) for old, value in zip(state, fn(*state)))


def cond_update(pred, fn, *state):
    """``fn(*state)`` where the 0-d bool tensor ``pred`` holds, else
    ``state`` unchanged (a tuple either way). Under capture the tensors of
    ``state`` are overwritten in place, so they must belong to the caller
    alone."""
    if _mode == "warmup":
        return masked_update(pred, fn, *state)
    if _mode == "eager":
        return tuple(fn(*state)) if read_flag(pred) else tuple(state)
    body = _recorder.program_of(fn, state)
    _recorder.append(_Branch(pred, body))
    return tuple(state)


def ladder(bad, stage_fn, stages, *state):
    """A retry ladder as the reference's ``while_loop``: stage ``k``
    (``state = stage_fn(k, *state)``) runs only where ``bad(*state)`` holds
    after stage ``k - 1``, nested in it, ``stages`` times at most."""
    return cond_update(bad(*state), functools.partial(_ladder_stage, bad, stage_fn, stages, 0),
                       *state)


def _ladder_stage(bad, stage_fn, stages, stage, *state):
    """Stage ``stage`` of ``ladder``, and the rest nested in it. A module
    function, not a closure that calls itself: such a closure is a
    reference cycle, and it kept the solve's inputs (``stage_fn``'s
    closure: a CR solve's band, a dense H) alive until the garbage collector
    ran, one set per LM iteration in python mode."""
    state = stage_fn(stage, *state)
    if stage + 1 < stages:
        return cond_update(bad(*state),
                           functools.partial(_ladder_stage, bad, stage_fn, stages, stage + 1),
                           *state)
    return state


def while_update(pred, body, max_trips, *state, warmup_trips=None, host=None):
    """``state = body(*state)`` while the 0-d bool ``pred(*state)`` holds,
    ``max_trips`` times at most (a tuple either way). Under capture
    ``body`` is one program run once per trip of a WHILE node, writing
    ``state`` in place, so its tensors must belong to the caller alone.
    The warm-up form runs ``warmup_trips`` masked trips (all of them by
    default): every trip runs the same kernels.

    ``host``, a reason, keeps the loop on the host on a card: the flag is
    read before each trip and the body's graphs, with every branch and loop
    in them, are replayed one by one, each branch reading its flag. A call
    site passes it where its body holds a library call that a conditional
    node's body cannot hold (an allocation inside the capture)."""
    if _mode == "warmup":
        trips = max_trips if warmup_trips is None else min(max_trips, warmup_trips)
        for _ in range(trips):
            state = masked_update(pred(*state), body, *state)
        return tuple(state)
    if _mode == "eager":
        for _ in range(max_trips):
            if not read_flag(pred(*state)):
                break
            state = body(*state)
        return tuple(state)
    flag = pred(*state)

    def trip(*state):
        new = body(*state)
        for old, value in zip(state, new):
            old.copy_(value)
        flag.copy_(pred(*state))
        return state

    trip_program = _recorder.program_of(trip, state)
    _recorder.append(_Loop(flag, trip_program, max_trips, host))
    return tuple(state)


class _Graph:
    """A captured CUDA graph (``None`` under a recorder that captures
    nothing), its node count, the kernel launches it recorded and the work
    counted while it was captured (``count``)."""

    def __init__(self, graph, nodes, launched, counted=()):
        self.graph = graph
        self.nodes = nodes
        self.launched = launched
        self.counted = counted


class _Branch:
    host = None

    def __init__(self, pred, body):
        self.pred = pred
        self.body = body
        self.slot = None


class _Loop:
    def __init__(self, flag, body, max_trips, host=None):
        self.flag = flag
        self.body = body
        self.max_trips = max_trips
        self.host = host
        self.slot = None


class _Recorder:
    """Records a program tree under capture: ``begin_graph`` / ``end_graph``
    delimit one CUDA graph, ``program_of`` records a nested program."""

    def __init__(self, pool):
        self.pool = pool
        self.programs = [[]]
        self.graph = None
        self.captured = {}
        self.counted = []

    def append(self, item):
        self.programs[-1].append(item)

    def program_of(self, fn, state):
        """``fn(*state)`` recorded as a program of its own, ending in
        ``state`` written in place; the graph being captured ends before it
        and a new one begins after it."""
        self.end_graph()
        self.programs.append([])
        self.begin_graph()
        new = fn(*state)
        for old, value in zip(state, new):
            old.copy_(value)
        self.end_graph()
        body = self.programs.pop()
        self.begin_graph()
        return body

    def begin_graph(self):
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        self.captured = {name: k.captured for name, k in _KERNELS.items()}
        self.counted = []
        self.graph.capture_begin(pool=self.pool)

    def end_graph(self):
        global graphs
        self.graph.capture_end()
        launched = {name: k.captured - self.captured[name] for name, k in _KERNELS.items()}
        self.append(_Graph(self.graph, gc.nodes(self.graph.raw_cuda_graph()), launched,
                           tuple(self.counted)))
        graphs += 1
        self.graph = None


def record(fn, state, recorder):
    """``fn(*state)`` recorded by ``recorder`` in capture mode: the program
    tree (a list of ``_Graph``, ``_Branch`` and ``_Loop``). ``fn`` must end
    in ``assign(state, ...)``."""
    with _Mode("capture", recorder) as rec:
        rec.begin_graph()
        out = fn(*state)
        rec.end_graph()
    if any(a is not b for a, b in zip(out, state)):
        raise RuntimeError("a captured step must end in graphs.assign(state, ...)")
    return rec.programs[0]


def _empty(program) -> bool:
    return all(isinstance(item, _Graph) and item.nodes == 0 for item in program)


class _Parent:
    """One instantiated CUDA graph built from a program with no host-driven
    item, and the device counts of its conditional nodes (``counts[k]``:
    taken or total trips, the running trip count)."""

    def __init__(self, program, device):
        self.program = program  # keeps the captured graphs and their pool
        self.device = device
        self.launches = 0
        self.counts = torch.zeros((self._number(program, 0), 2), dtype=torch.int64,
                                  device=device)
        prev = gc.use_device(device.index)
        try:
            self.graph = gc.create()
            # freed with the parent; left to the process's end at exit,
            # where the CUDA context may be gone first
            weakref.finalize(self, gc.destroy, self.graph).atexit = False
            self._add(self.graph, program)
            self.exec = gc.instantiate(self.graph)
            weakref.finalize(self, gc.destroy_exec, self.exec).atexit = False
        finally:
            gc.use_device(prev)

    def _number(self, program, k):
        for item in program:
            if isinstance(item, (_Branch, _Loop)):
                item.slot = k
                k = self._number(item.body, k + 1)
        return k

    def _add(self, graph, program):
        """The nodes of ``program`` in ``graph``, each after the one
        before it: the last node (``None`` when it adds none)."""
        dep = None
        for item in program:
            if isinstance(item, _Graph):
                if item.nodes:
                    dep = gc.add_child(graph, dep, item.graph.raw_cuda_graph())
            elif item.host:
                raise RuntimeError(f"a branch kept on the host ({item.host}) inside one "
                                   "decided on the device: keep the enclosing one on the "
                                   "host too")
            elif _empty(item.body):
                continue
            elif isinstance(item, _Branch):
                dep, body = gc.add_if(graph, dep, item.pred.data_ptr(),
                                      self.counts[item.slot].data_ptr())
                self._add(body, item.body)
            else:
                slots = self.counts[item.slot].data_ptr()
                dep, body, handle = gc.add_while(graph, dep, item.flag.data_ptr(), slots,
                                                 item.max_trips)
                last = self._add(body, item.body)
                gc.add_while_next(body, last, handle, item.flag.data_ptr(), slots,
                                  item.max_trips)
        return dep

    def launch(self):
        global launches
        gc.launch(self.exec, current_stream(self.device.index), self.device.index)
        self.launches += 1
        launches += 1

    def tally(self, counts) -> None:
        """Add to ``replays`` and the kernels' replayed launches what the
        launches since the counts were zeroed ran, ``counts`` being the
        device counts read back (rows of [taken or trips, running])."""
        _tally(self.program, self.launches, counts)


def _count_replays(graph, execs) -> None:
    """``execs`` runs of the captured ``graph`` in the counters."""
    global replays
    if graph.nodes:
        replays += execs
    for name, n in graph.launched.items():
        replayed[name] += execs * n
    for owner, name, n in graph.counted:
        owner[name] += execs * n


def _tally(program, execs, counts) -> None:
    for item in program:
        if isinstance(item, _Graph):
            _count_replays(item, execs)
        elif not _empty(item.body):
            _tally(item.body, int(counts[item.slot][0]), counts)


def _replay(program):
    """A host-driven item's program: each graph replayed by PyTorch, each
    branch and loop reading its flag."""
    for item in program:
        if isinstance(item, _Graph):
            if item.nodes:
                item.graph.replay()
            _count_replays(item, 1)
        elif isinstance(item, _Loop):
            for _ in range(item.max_trips):
                if not read_flag(item.flag):
                    break
                _replay(item.body)
        elif read_flag(item.pred):
            _replay(item.body)


class Captured:
    """``fn(*state) -> state`` over static state tensors on one CUDA device,
    warmed up once and captured once (``fn`` reads nothing back and ends in
    ``assign``); ``launch()`` runs it. Its top-level items run in order:
    each stretch of items decided on the device as one parent graph, each
    host-driven branch or loop from the host. ``pool`` shares graph memory
    with the other programs of the same problem. ``counts()`` are the
    parents' device counts, zeroed by ``zero_counts`` and read by the
    caller with its result, then handed to ``tally``."""

    def __init__(self, fn, state, pool):
        global captures
        self.state = tuple(state)
        device = self.state[0].device
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        # warm-up: every branch runs (library handles and workspaces, the
        # kernels' builds and attributes), on copies of the state
        with profiling.span("graphs.warmup"):
            with warmup_mode(), torch.cuda.stream(side):
                fn(*(t.clone() for t in self.state))
            side.synchronize()
        # the warm-up's freed blocks stay cached in the default pool, where
        # the capture's private pool cannot take them: hand them back first
        torch.cuda.empty_cache()
        with profiling.span("graphs.record"):
            with torch.cuda.stream(side):
                self.program = record(fn, self.state, _Recorder(pool))
            torch.cuda.current_stream().wait_stream(side)
        captures += 1
        with profiling.span("graphs.instantiate"):
            self.parts, stretch = [], []
            for item in self.program + [None]:
                if item is None or not isinstance(item, _Graph) and item.host:
                    if not _empty(stretch):
                        self.parts.append(_Parent(stretch, device))
                    stretch = []
                    if item is not None:
                        self.parts.append(item)
                else:
                    stretch.append(item)
        self.parents = [p for p in self.parts if isinstance(p, _Parent)]

    def zero_counts(self):
        for p in self.parents:
            p.counts.zero_()
            p.launches = 0
        zero_device_counts(self.state[0].device)

    def counts(self):
        """The parents' device counts, one flat int64 tensor."""
        return torch.cat([p.counts.flatten() for p in self.parents]
                         + [torch.zeros(0, dtype=torch.int64, device=self.state[0].device)])

    def launch(self):
        for part in self.parts:
            if isinstance(part, _Parent):
                run = part.launch if launch_hook is None else functools.partial(launch_hook,
                                                                                part.launch)
                profiling.launch_interval(run, part.device.index)
            else:
                _replay([part])

    def tally(self, counts):
        """Counters from ``counts()`` read back (a flat list)."""
        k = 0
        for p in self.parents:
            n = p.counts.numel()
            p.tally([counts[i:i + 2] for i in range(k, k + n, 2)])
            k += n
