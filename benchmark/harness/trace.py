"""What the per-layer readers take from the traced pass (``Record.trace``,
``loops/warm.py``'s ``traced``): the program's trace of the pass's second
stretch, with its solves and LM iterations, and the capture solve's set-up
spans. Every function here gives None where the pass left nothing to read:
no traced pass, no LM iteration, or a trace whose bounded buffers dropped
records, since a sum over what was kept would read low."""

from __future__ import annotations


def usable(record):
    """The traced pass, or None where there is none to read."""
    t = record.trace
    if t is None or not t["iterations"] or any(t["trace"]["dropped"].values()):
        return None
    return t


def phase_ns(t, path):
    """Device nanoseconds stamped for the phase ``path`` (as
    ``schur.assemble>schur.assemble_kernel``), summed over devices; None
    where it was never stamped."""
    found = [p["total_ns"] for p in t["trace"]["phases"] if p["path"] == path]
    return sum(found) if found else None


def phase_count(t, path):
    """How often the phase ``path`` was stamped; None where never."""
    found = [p["count"] for p in t["trace"]["phases"] if p["path"] == path]
    return sum(found) if found else None


def top_level_phases(t):
    """The paths of the stamped phases that no stamped phase encloses."""
    return sorted({p["path"] for p in t["trace"]["phases"] if p["parent"] is None})


def ms_per_iter(record, paths):
    """Device milliseconds of the phases ``paths`` per LM iteration of the
    traced pass; None where none of them was stamped (the stamps need the
    card)."""
    t = usable(record)
    if t is None:
        return None
    found = [ns for ns in (phase_ns(t, p) for p in paths) if ns is not None]
    return sum(found) / 1e6 / t["iterations"] if found else None


def counters(record):
    """The work counters of the traced pass (the change of each since the
    reset; one that never counted is not there, and reads 0); None where
    there is no pass to read."""
    t = usable(record)
    return None if t is None else t["trace"]["counters"]


def share(part, whole):
    """100 part / whole; None where the whole is missing or 0."""
    if not whole:
        return None
    return 100.0 * part / whole
