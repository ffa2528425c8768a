"""general_core_roofline: the general-sparsity tier's dense core against
the card's FP64 peak, in percent. Each core factorization of the traced
pass has the width n = ``general_core_cols`` / ``general_core_factors``,
the program's own; its work is a Cholesky of n x n and the two triangular
solves of one right-hand side (``flops.cholesky_solve_flops``). The least
time of that work at the FP64 tensor-core peak, over the device time
stamped in every ``general.core`` phase (retries' included). None off the
card (no stamps) and where the tier factored no core."""

from harness import flops, trace


def read(record):
    t = trace.usable(record)
    if t is None:
        return None
    work = t["trace"]["counters"]
    factors, cols = work.get("general_core_factors", 0), work.get("general_core_cols", 0)
    core_ns = sum(p["total_ns"] for p in t["trace"]["phases"] if p["name"] == "general.core")
    if not factors or not core_ns:
        return None
    n = cols / factors
    return flops.share_of_fp64_peak(record.device_kind,
                                    factors * flops.cholesky_solve_flops(n), core_ns / 1e9)
