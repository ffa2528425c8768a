"""linearize_ms_per_iter: device milliseconds per LM iteration of the
stamped linearization and assembly over the traced pass:
``schur.assemble`` for bundle adjustment, ``banded.linearize`` +
``banded.assemble`` for pose graphs. None off the card (no stamps)."""

from harness import trace

PHASES = {"bundle_adjustment": ("schur.assemble",),
          "pose_graph": ("banded.linearize", "banded.assemble")}


def read(record):
    return trace.ms_per_iter(record, PHASES[record.kind])
