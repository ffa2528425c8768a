"""host_reads: device values the jit loop read back per solve (the change
of ``optim.graphs.host_reads`` across each solve), the mean over the
window."""


def read(record):
    if not record.solves:
        return None
    return sum(s["host_reads"] for s in record.solves) / len(record.solves)
