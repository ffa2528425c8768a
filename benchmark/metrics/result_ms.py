"""result_ms: host milliseconds of the program's result path per solve,
the mean of its ``lm.result`` spans (tally, ``SolverResult``,
``problem.values_dict``) over the traced pass."""

from harness import trace


def read(record):
    t = trace.usable(record)
    if t is None:
        return None
    spans = [s["end_ns"] - s["start_ns"] for s in t["trace"]["spans"] if s["name"] == "lm.result"]
    return sum(spans) / 1e6 / len(spans) if spans else None
