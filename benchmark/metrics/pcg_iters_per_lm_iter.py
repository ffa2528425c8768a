"""pcg_iters_per_lm_iter: live PCG iterations (the program's counter
``pcg_iterations``, counted on the device in graphs captured with tracing
on) per LM iteration of the traced pass."""

from harness import trace


def read(record):
    work = trace.counters(record)
    if work is None or "pcg_iterations" not in work:
        return None
    return work["pcg_iterations"] / record.trace["iterations"]
