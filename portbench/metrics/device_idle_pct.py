"""Device: the share of a frame in which no operation ran on the card:
the profiled frames' device busy time a frame over the mean time of the
same run's frames before them (host clock, each frame from step() to the
end of its sync), so the profiler's own cost on the host stays out."""


def read(run):
    if run.trace is None or run.trace.busy_s <= 0 or not run.before_ms:
        return None
    frame_s = 1e-3 * sum(run.before_ms) / len(run.before_ms)
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.frames / frame_s)
