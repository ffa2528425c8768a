"""``mode="jit"``'s device loop: an LM / Gauss-Newton iteration recorded as
a short program of CUDA graphs, replayed, with the step's data-dependent
branches decided between the graphs by one host read each.

The JAX package runs a whole solve as one ``lax.while_loop`` whose retry
ladders, refinement gate and PCG loop are nested ``while_loop`` / ``cond``
(``apex_tpu/optim/lm.py`` ``_optimize_jit``). PyTorch 2.11 captures no
conditional node, so a branch here splits the capture
(``cond_update(pred, fn, *state)``):

- **capture** (a CUDA problem, once per problem): the graph being captured
  ends at the branch; ``fn`` is captured as a program of its own that writes
  the new state in place; a new graph starts after it. Replaying the step
  replays each graph in turn and, at a branch, reads ``pred`` back (a
  0-d bool on the device) and replays ``fn``'s program only when it holds.
  A ladder costs one read when its first attempt is good, PCG one read per
  ``PCG_CHUNK`` iterations.
- **eager** (a CPU problem, ``mode="jit"``): the same reads, the same
  branches, run as plain PyTorch.
- **warm-up** (before a capture): ``fn`` always runs and ``torch.where``
  keeps the old state where ``pred`` is false, so every kernel of every
  branch is initialized before capture, with no host read.

``while_update(pred, body, max_trips, *state)`` is the reference's
``lax.while_loop``: ``body`` is captured once, as one program, and replayed
while a one-byte flag, ``pred`` of the state after each trip, holds, for
``max_trips`` trips at most (eager: one read per trip; warm-up: every trip
masked by ``torch.where``). The general tier's and the QR sweep's retry
ladders and plain PCG (in chunks of ``PCG_CHUNK`` iterations) run through
it.

``uncaptured(fn, *inputs)`` is a call that cannot be captured: torch
2.11's ``linalg.eigh`` reads its error flag back after the factorization.
Under capture the graph ends there and the call runs eagerly between two
graphs at every replay, its results copied into static outputs.

``masked_update`` is the branch that never reads: both sides run and
``torch.where`` selects (inside a PCG chunk, the done flag frozen on the
device). ``assign`` writes a step's result into its state: in place under
capture, a new tuple otherwise.

Every graph of a problem shares one memory pool. Tensors that cross from
one graph to a later one stay referenced by the program, and every state
tensor is allocated outside capture, so no replay overwrites a live value.

Counters: ``captures`` (programs captured), ``graphs`` (CUDA graphs in
them), ``replays`` (graph replays), ``uncaptured_calls`` (``uncaptured``
calls made by replays), ``host_reads`` (device values read by the jit
loop: branch flags, the status and the result), ``status_reads`` (those of
the status) and ``kernel_launches`` (the
landmark kernel's launches made by replays: a replay never calls its
wrapper, so each graph carries the launches its capture recorded).

Every other call on the steps captures on the H100 with torch 2.11 under
the default ``preferred_linalg_library``: batched ``cholesky_ex`` and
``solve_triangular``, single ``cholesky_solve``, ``qr``, ``index_add_`` and
the landmark kernel. Only a batched ``cholesky_solve`` would go to MAGMA,
which synchronizes and fails under capture; no step calls one.

Python mode takes the same branches in eager form, so a ladder or a gate
reads its flag there exactly as the loop it replaces did.
"""

from __future__ import annotations

import torch

from ..kernels import landmark_blocks

# PCG iterations between two reads of its continue flag in jit mode
PCG_CHUNK = 4

captures = 0
graphs = 0
replays = 0
uncaptured_calls = 0
host_reads = 0
status_reads = 0
kernel_launches = 0

# "eager" | "warmup" | "capture"
_mode = "eager"
_recorder = None


def reset_counters() -> None:
    global captures, graphs, replays, uncaptured_calls, host_reads, status_reads
    global kernel_launches
    captures = graphs = replays = uncaptured_calls = host_reads = status_reads = 0
    kernel_launches = 0


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
        return self.recorder

    def __exit__(self, *exc):
        global _mode, _recorder
        _mode, _recorder = self.prev


def warmup_mode():
    """Run steps in their warm-up form: every branch taken and selected by
    ``torch.where``, no host read."""
    return _Mode("warmup")


def warming_up() -> bool:
    """Whether steps run in their warm-up form: a counter of the work done
    leaves the warm-up's copy of a step out."""
    return _mode == "warmup"


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
    rec = _recorder
    rec.end_graph()
    rec.programs.append([])
    rec.begin_graph()
    new = fn(*state)
    for old, value in zip(state, new):
        old.copy_(value)
    rec.end_graph()
    body = rec.programs.pop()
    rec.programs[-1].append(_Branch(pred, body))
    rec.begin_graph()
    return tuple(state)


def ladder(bad, stage_fn, stages, *state):
    """A retry ladder as the reference's ``while_loop``: stage ``k``
    (``state = stage_fn(k, *state)``) runs only where ``bad(*state)`` holds
    after stage ``k - 1``, nested in it, ``stages`` times at most."""
    def run(stage, *state):
        def body(*state):
            state = stage_fn(stage, *state)
            return run(stage + 1, *state) if stage + 1 < stages else state
        return cond_update(bad(*state), body, *state)

    return run(0, *state)


def while_update(pred, body, max_trips, *state):
    """``state = body(*state)`` while the 0-d bool ``pred(*state)`` holds,
    ``max_trips`` times at most (a tuple either way). Under capture
    ``body`` is one program replayed once per trip, writing ``state`` in
    place, so its tensors must belong to the caller alone."""
    if _mode == "warmup":
        for _ in range(max_trips):
            state = masked_update(pred(*state), body, *state)
        return tuple(state)
    if _mode == "eager":
        for _ in range(max_trips):
            if not read_flag(pred(*state)):
                break
            state = body(*state)
        return tuple(state)
    rec = _recorder
    flag = pred(*state)
    rec.end_graph()
    rec.programs.append([])
    rec.begin_graph()
    new = body(*state)
    for old, value in zip(state, new):
        old.copy_(value)
    flag.copy_(pred(*state))
    rec.end_graph()
    trip = rec.programs.pop()
    rec.programs[-1].append(_Loop(flag, trip, max_trips))
    rec.begin_graph()
    return tuple(state)


def uncaptured(fn, *inputs):
    """``fn(*inputs)``, a tensor of the shape and dtype of ``inputs[0]``,
    for a call that cannot be captured. Under capture it runs at replay,
    between two graphs, into a static output allocated here."""
    if _mode != "capture":
        return fn(*inputs)
    rec = _recorder
    rec.end_graph()
    # outside any capture: the replayed graphs never reuse this memory
    out = torch.empty_like(inputs[0])
    rec.programs[-1].append(_Uncaptured(fn, inputs, out))
    rec.begin_graph()
    return out


class _Uncaptured:
    def __init__(self, fn, inputs, out):
        self.fn = fn
        self.inputs = inputs
        self.out = out


class _Graph:
    def __init__(self, graph, kernel_launches):
        self.graph = graph
        self.kernel_launches = kernel_launches


class _Branch:
    def __init__(self, pred, body):
        self.pred = pred
        self.body = body


class _Loop:
    def __init__(self, flag, body, max_trips):
        self.flag = flag
        self.body = body
        self.max_trips = max_trips


class _Recorder:
    def __init__(self, pool):
        self.pool = pool
        self.programs = [[]]
        self.graph = None
        self.launched = 0

    def begin_graph(self):
        self.graph = torch.cuda.CUDAGraph()
        self.launched = landmark_blocks.captured
        self.graph.capture_begin(pool=self.pool)

    def end_graph(self):
        global graphs
        self.graph.capture_end()
        self.programs[-1].append(_Graph(self.graph, landmark_blocks.captured - self.launched))
        graphs += 1
        self.graph = None


def _replay(program):
    global replays, kernel_launches, uncaptured_calls
    for item in program:
        if isinstance(item, _Graph):
            item.graph.replay()
            replays += 1
            kernel_launches += item.kernel_launches
        elif isinstance(item, _Uncaptured):
            item.out.copy_(item.fn(*item.inputs))
            uncaptured_calls += 1
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
    ``assign``); ``replay()`` runs it. ``pool`` shares graph memory with the
    other programs of the same problem."""

    def __init__(self, fn, state, pool):
        global captures
        self.state = tuple(state)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        # warm-up: every branch runs (library handles and workspaces, the
        # landmark kernel's build and attributes), on copies of the state
        with warmup_mode(), torch.cuda.stream(side):
            fn(*(t.clone() for t in self.state))
        side.synchronize()
        with _Mode("capture", _Recorder(pool)) as rec, torch.cuda.stream(side):
            rec.begin_graph()
            out = fn(*self.state)
            rec.end_graph()
        self.program = rec.programs[0]
        torch.cuda.current_stream().wait_stream(side)
        if any(a is not b for a, b in zip(out, self.state)):
            raise RuntimeError("a captured step must end in graphs.assign(state, ...)")
        captures += 1

    def replay(self):
        _replay(self.program)
