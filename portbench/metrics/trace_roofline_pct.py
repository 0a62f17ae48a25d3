"""Traversal kernels: the share of their roofline, the least time of the
profiled frames' launches (harness/bounds.py: the bytes their rays and
the scene fix, at the card's peak bandwidth) over their device time."""

from harness.bounds import bound_seconds, traversal_bytes


def read(run):
    if run.trace is None or run.trace.trace_s <= 0 or not run.traversal_calls:
        return None
    least = bound_seconds(traversal_bytes(run.traversal_calls,
                                          run.num_triangles))
    return 100.0 * least / run.trace.trace_s
