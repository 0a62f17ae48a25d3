"""ReSTIR DI: device ms a profiled frame under integrator/restir.py's
restir_direct, its traversal kernels excluded; nothing where the frame
runs no ReSTIR."""


def read(run):
    if run.trace is None or not run.trace.restir_spans:
        return None
    return 1e3 * run.trace.restir_s / run.trace.frames
