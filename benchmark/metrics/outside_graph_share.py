"""outside_graph_share: the share of the solves' wall time in which no
parent CUDA graph launch ran on the card, in percent: 100 (1 - event time
of the launches / wall time of the solves), over the window. Host work,
copies and eager kernels outside the graphs all count as outside; it is
not an idle share."""


def read(record):
    wall = sum(s["wall_s"] for s in record.solves)
    if not record.graph_launches or not wall:
        return None
    return 100.0 * (1.0 - record.graph_s / wall)
