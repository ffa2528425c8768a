"""general_extra_solves_share: the general-sparsity tier's retry-ladder
attempts per solve, in percent: 100 ``general_retries`` /
``general_solves`` over the traced pass. None where the tier counted no
solve (another tier, or a program without the counters)."""

from harness import trace


def read(record):
    work = trace.counters(record)
    if work is None:
        return None
    return trace.share(work.get("general_retries", 0), work.get("general_solves", 0))
