"""Where the port's native libraries are built and kept: the counterpart of
raytracer_tpu/utils/compile_cache.py, whose persistent XLA cache makes a
second process start warm. The port's warm start is its built libraries
(the CUDA kernels and the C++ BVH builder, ops/_build.py): a process that
finds a library built from the same source, headers and flags loads it
instead of compiling.

The directory is `$RAYTRACER_TPU_CACHE_DIR/raytracer_tpu_torch` when the
JAX package's variable is set (a subdirectory of the port's own, so the
two packages never share a file), else `raytracer_tpu_torch/_build/` in
the package, which .gitignore lists. It is resolved at each build, so the
variable may be set after import.
"""

from __future__ import annotations

import os

ENV_VAR = "RAYTRACER_TPU_CACHE_DIR"
PACKAGE_BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")


def build_dir() -> str:
    """The build directory (see the module docstring); not created here."""
    root = os.environ.get(ENV_VAR)
    if root:
        return os.path.join(os.path.abspath(os.path.expanduser(root)),
                            "raytracer_tpu_torch")
    return PACKAGE_BUILD_DIR
