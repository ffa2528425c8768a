"""pcg_masked_share: the share of the PCG iterations executed that did no
work, in percent: 100 (``pcg_executed`` - ``pcg_iterations``) /
``pcg_executed`` over the traced pass (a WHILE trip runs a whole chunk of
iterations, the ones past convergence masked)."""

from harness import trace


def read(record):
    work = trace.counters(record)
    if work is None or "pcg_iterations" not in work:
        return None
    executed = work.get("pcg_executed", 0)
    return trace.share(executed - work["pcg_iterations"], executed)
