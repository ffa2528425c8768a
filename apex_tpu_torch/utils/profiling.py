"""Profiling helpers (counterpart of ``apex_tpu/utils/profiling.py``): a
context manager around a ``torch.profiler`` trace, a wall-clock section
timer with a Ceres-style report, and a decorator that names a span in the
trace. Nothing runs unless asked for.
"""

from __future__ import annotations

import contextlib
import functools
import os
import sys
import tempfile
import time
from collections import defaultdict
from typing import Dict, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function

TRACE_NAME = "trace.json"


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None, name: str = TRACE_NAME):
    """Capture a ``torch.profiler`` trace of the block (host, and the card's
    kernels where CUDA is available) and write it as a Chrome trace to
    ``log_dir/name`` (default: ``apex_tpu_torch_profile/trace.json`` under
    the system's temporary directory), saying where on stderr. The block
    gets the ``torch.profiler.profile`` object. View the file in Perfetto
    or chrome://tracing."""
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "apex_tpu_torch_profile")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, name)
    prof.export_chrome_trace(path)
    print(f"[apex-tpu] profiler trace written to {path}", file=sys.stderr)


class SectionTimer:
    """Accumulating wall-clock timer: timer.section('assemble'): ..."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = [f"{'section':>20} {'calls':>7} {'total':>10} {'mean':>10}"]
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t, n = self.totals[name], self.counts[name]
            lines.append(f"{name:>20} {n:>7} {t*1e3:>9.2f}m {t/n*1e3:>9.3f}m")
        return "\n".join(lines)


def annotate(name: Optional[str] = None):
    """Decorator running the function inside a ``record_function`` span of
    that name (the function's own by default), as the solvers' spans are."""

    def deco(fn):
        scope = name or fn.__name__

        @functools.wraps(fn)
        def wrapper(*args, **kw):
            with record_function(scope):
                return fn(*args, **kw)

        return wrapper

    return deco
