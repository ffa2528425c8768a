"""linear_solve_ms_per_iter: device milliseconds per LM iteration of the
stamped linear solve over the traced pass: ``schur.precondition`` +
``schur.pcg`` + ``schur.back_substitute`` for bundle adjustment, every
top-level ``cr.*`` phase (block cyclic reduction, its refinement and
retries) for pose graphs. None off the card (no stamps)."""

from harness import trace

SCHUR = ("schur.precondition", "schur.pcg", "schur.back_substitute")


def read(record):
    t = trace.usable(record)
    if t is None:
        return None
    if record.kind == "bundle_adjustment":
        return trace.ms_per_iter(record, SCHUR)
    return trace.ms_per_iter(record, [p for p in trace.top_level_phases(t)
                                      if p.startswith("cr.")])
