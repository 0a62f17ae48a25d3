"""Traversal kernels: device ms a profiled frame of K1 (closest_kernel)
and K2 (occlusion_kernel)."""


def read(run):
    if run.trace is None or run.trace.trace_s <= 0:
        return None
    return 1e3 * run.trace.trace_s / run.trace.frames
