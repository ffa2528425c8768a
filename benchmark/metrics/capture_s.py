"""capture_s: host seconds of the ``lm.capture`` span of the traced pass's
first solve: warming up, recording and instantiating the solver's CUDA
graphs, with tracing on."""

from harness import trace


def read(record):
    t = trace.usable(record)
    return None if t is None else t["setup"].get("lm.capture")
