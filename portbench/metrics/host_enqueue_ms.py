"""Renderer: host ms from step()'s call to its return, before the sync,
mean over the window's frames before the profiled ones."""


def read(run):
    if not run.enqueue_ms:
        return None
    return sum(run.enqueue_ms) / len(run.enqueue_ms)
