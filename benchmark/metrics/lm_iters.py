"""lm_iters: LM iterations per solve (``SolverResult.iterations``), the mean
over the window."""


def read(record):
    if not record.solves:
        return None
    return sum(s["iterations"] for s in record.solves) / len(record.solves)
