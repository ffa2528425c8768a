"""The ``ctypes`` binding of ``csrc/graph_conditional.cu``: one parent CUDA
graph built from PyTorch's captured graphs, with IF and WHILE conditional
nodes (``optim/graphs.py`` walks the program tree and calls these).

Each function raises ``RuntimeError`` with the CUDA error's name when its
entry point fails; nothing falls back. The library is built with ``nvcc``
into ``build/apex_tpu_torch/`` at first use (``kernels/build.py``).
"""

from __future__ import annotations

import ctypes

from . import build as _build

SOURCE = _build.CSRC / "graph_conditional.cu"
_lib = None

_P = ctypes.c_void_p
_PP = ctypes.POINTER(ctypes.c_void_p)
_SIGNATURES = {
    "gc_error_string": ([ctypes.c_int], ctypes.c_char_p),
    "gc_versions": ([ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)], ctypes.c_int),
    "gc_use_device": ([ctypes.c_int, ctypes.POINTER(ctypes.c_int)], ctypes.c_int),
    "gc_graph_create": ([_PP], ctypes.c_int),
    "gc_graph_destroy": ([_P], ctypes.c_int),
    "gc_graph_nodes": ([_P, ctypes.POINTER(ctypes.c_ulonglong)], ctypes.c_int),
    "gc_add_child": ([_P, _P, _P, _PP], ctypes.c_int),
    "gc_add_if": ([_P, _P, _P, _P, _PP, _PP], ctypes.c_int),
    "gc_add_while": ([_P, _P, _P, _P, ctypes.c_longlong, _PP, _PP,
                      ctypes.POINTER(ctypes.c_ulonglong)], ctypes.c_int),
    "gc_add_while_next": ([_P, _P, ctypes.c_ulonglong, _P, _P, ctypes.c_longlong, _PP],
                          ctypes.c_int),
    "gc_instantiate": ([_P, _PP], ctypes.c_int),
    "gc_launch": ([_P, _P, ctypes.c_int], ctypes.c_int),
    "gc_exec_destroy": ([_P], ctypes.c_int),
    "gc_graph_census": ([_P, ctypes.POINTER(ctypes.c_longlong)], ctypes.c_int),
}

# node types (cudaGraphNodeType) and the kernel and memcpy kinds of census()
CENSUS = ("kernel", "memcpy", "memset", "host", "graph", "empty", "wait_event",
          "event_record", "semaphore_signal", "semaphore_wait", "mem_alloc", "mem_free",
          "batch_mem_op", "conditional", "type14", "type15", "cooperative_kernel",
          "cluster_kernel", "programmatic_kernel", "memcpy_not_device_to_device")


def build():
    """Compile (once per source and flag set), load and bind the library."""
    global _lib
    if _lib is None:
        lib = _build.shared_library("graph_conditional")
        for name, (args, res) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, res
        _lib = lib
    return _lib


def _check(err, what):
    if err != 0:
        raise RuntimeError(f"{what} failed: CUDA error {err} "
                           f"({_lib.gc_error_string(err).decode()})")


def versions():
    """(CUDA runtime version this library was built against, driver version)."""
    lib = build()
    rt, drv = ctypes.c_int(), ctypes.c_int()
    _check(lib.gc_versions(ctypes.byref(rt), ctypes.byref(drv)), "cudaRuntimeGetVersion")
    return rt.value, drv.value


def use_device(device) -> int:
    """Make ``device`` current for the library's runtime; returns the
    device that was current."""
    prev = ctypes.c_int()
    _check(build().gc_use_device(device, ctypes.byref(prev)), "cudaSetDevice")
    return prev.value


def create():
    g = ctypes.c_void_p()
    _check(build().gc_graph_create(ctypes.byref(g)), "cudaGraphCreate")
    return g.value


def destroy(graph):
    _check(_lib.gc_graph_destroy(graph), "cudaGraphDestroy")


def nodes(graph) -> int:
    n = ctypes.c_ulonglong()
    _check(build().gc_graph_nodes(graph, ctypes.byref(n)), "cudaGraphGetNodes")
    return n.value


def census(graph) -> dict:
    """What ``graph`` holds, child graphs included: {kind: count}, the
    kinds of ``CENSUS`` with a count above 0."""
    counts = (ctypes.c_longlong * len(CENSUS))()
    _check(build().gc_graph_census(graph, counts), "cudaGraphGetNodes")
    return {k: c for k, c in zip(CENSUS, counts) if c}


def add_child(graph, dep, child):
    node = ctypes.c_void_p()
    err = _lib.gc_add_child(graph, dep, child, ctypes.byref(node))
    if err != 0:
        _check(err, f"child graph node of a graph holding {census(child)}")
    return node.value


def add_if(graph, dep, pred_ptr, slots_ptr):
    """(IF node, its body graph)."""
    node, body = ctypes.c_void_p(), ctypes.c_void_p()
    _check(_lib.gc_add_if(graph, dep, pred_ptr, slots_ptr, ctypes.byref(node),
                          ctypes.byref(body)), "IF node")
    return node.value, body.value


def add_while(graph, dep, flag_ptr, slots_ptr, max_trips):
    """(WHILE node, its body graph, its handle)."""
    node, body, handle = ctypes.c_void_p(), ctypes.c_void_p(), ctypes.c_ulonglong()
    _check(_lib.gc_add_while(graph, dep, flag_ptr, slots_ptr, max_trips, ctypes.byref(node),
                             ctypes.byref(body), ctypes.byref(handle)), "WHILE node")
    return node.value, body.value, handle.value


def add_while_next(body, dep, handle, flag_ptr, slots_ptr, max_trips):
    node = ctypes.c_void_p()
    _check(_lib.gc_add_while_next(body, dep, handle, flag_ptr, slots_ptr, max_trips,
                                  ctypes.byref(node)), "WHILE next kernel node")
    return node.value


def instantiate(graph):
    ex = ctypes.c_void_p()
    _check(_lib.gc_instantiate(graph, ctypes.byref(ex)), "cudaGraphInstantiate")
    return ex.value


def launch(exec_, stream, device):
    _check(_lib.gc_launch(exec_, stream, device), "cudaGraphLaunch")


def destroy_exec(exec_):
    _check(_lib.gc_exec_destroy(exec_), "cudaGraphExecDestroy")
