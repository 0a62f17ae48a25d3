"""Scene bake: host seconds of ProgressiveRenderer(...) in set-up (the
bake on the host, the native BVH build, the upload)."""


def read(run):
    return run.bake_s
