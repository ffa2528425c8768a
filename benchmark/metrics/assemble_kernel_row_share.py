"""assemble_kernel_row_share: the share of the rows the implicit Schur
assembly summed that the assembly kernels took, in percent: 100
``assemble_kernel_rows`` / ``assemble_rows`` over the traced pass (the rest
took the generic path)."""

from harness import trace


def read(record):
    work = trace.counters(record)
    if work is None:
        return None
    return trace.share(work.get("assemble_kernel_rows", 0), work.get("assemble_rows", 0))
