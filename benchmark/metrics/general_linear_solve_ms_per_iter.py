"""general_linear_solve_ms_per_iter: device milliseconds per LM iteration
of the general-sparsity tier's stamped solve over the traced pass:
``general.eliminate`` + ``general.core`` + ``general.back_substitute`` +
``general.retry`` (the retry ladder's attempts, each a whole solve). None
off the card (no stamps) and on a tier that did not run."""

from harness import trace

PHASES = ("general.eliminate", "general.core", "general.back_substitute", "general.retry")


def read(record):
    return trace.ms_per_iter(record, PHASES)
