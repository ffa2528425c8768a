"""general_assemble_ms_per_iter: device milliseconds per LM iteration of
the general-sparsity tier's stamped linearization and block assembly,
``general.assemble``, over the traced pass. None off the card (no stamps)
and on a tier that did not run."""

from harness import trace


def read(record):
    return trace.ms_per_iter(record, ("general.assemble",))
