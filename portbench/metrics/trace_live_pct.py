"""Traversal kernels: the share of the lanes launched into K1/K2 that are
live, 100 x the live lanes over the lanes of the profiled frames'
traversal calls (run.traversal_calls); nothing where no call was logged.
Deep compaction raises it by launching a bounce on a prefix of the
wavefront that holds its live lanes."""


def read(run):
    lanes = sum(n for _, n, _ in run.traversal_calls)
    if lanes <= 0:
        return None
    return 100.0 * sum(live for _, _, live in run.traversal_calls) / lanes
