"""graph_ms_per_iter: device milliseconds of the parent CUDA graph launches
(CUDA events around each launch, through the program's launch hook),
summed over the window, per LM iteration run in it."""


def read(record):
    iterations = sum(s["iterations"] for s in record.solves)
    if not record.graph_launches or not iterations:
        return None
    return 1e3 * record.graph_s / iterations
