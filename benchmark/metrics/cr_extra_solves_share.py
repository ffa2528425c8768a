"""cr_extra_solves_share: block cyclic reduction's solves past the first,
in percent: 100 (``cr_refines`` + ``cr_retries``) / ``cr_solves`` over the
traced pass."""

from harness import trace


def read(record):
    work = trace.counters(record)
    if work is None:
        return None
    return trace.share(work.get("cr_refines", 0) + work.get("cr_retries", 0),
                       work.get("cr_solves", 0))
