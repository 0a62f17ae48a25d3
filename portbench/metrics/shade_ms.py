"""Integrator: device ms a profiled frame outside the traversal kernels
and outside ReSTIR (shading, light selection, gathers, accumulation)."""


def read(run):
    if run.trace is None or run.trace.busy_s <= 0:
        return None
    return 1e3 * run.trace.shade_s / run.trace.frames
