"""ctypes binding for the native C++ BVH builder (native/bvh_builder.cpp).

Same builder and same C interface as `raytracer_tpu.accel.native_builder`,
but the port does not rely on a prebuilt `native/libbvh.so`: at first use
it compiles the repository's `native/bvh_builder.cpp` with `g++` into the
port's build directory (utils/compile_cache.py: `raytracer_tpu_torch/_build/`
or under $RAYTRACER_TPU_CACHE_DIR), keyed by a hash of the source, so a
fresh checkout builds it without a separate step. A
300k-triangle numpy build costs minutes of per-node Python; the native one
seconds.

`available()` is False when there is no source or no `g++`, or the compile
fails; `accel.bvh.build_bvh` then uses the numpy builder. Which builder ran
is logged.
"""

from __future__ import annotations

import ctypes
import logging
import os
import shutil
from typing import Optional

import numpy as np

log = logging.getLogger(__name__)

_SOURCE = os.path.abspath(os.path.join(
    os.path.dirname(__file__), "..", "..", "native", "bvh_builder.cpp"))

_lib: Optional[ctypes.CDLL] = None
_load_attempted = False


def _compile() -> Optional[str]:
    """Compile the builder (once per source hash); returns the library
    path, or None when it cannot be built."""
    from raytracer_tpu_torch.ops._build import compile_library

    if not os.path.exists(_SOURCE) or shutil.which("g++") is None:
        return None
    try:
        return compile_library(["g++", "-O2", "-fPIC", "-shared"], _SOURCE,
                               "libbvh")
    except RuntimeError as e:
        log.warning("native BVH builder failed to compile: %s", e)
        return None


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_attempted
    if _load_attempted:
        return _lib
    _load_attempted = True
    from raytracer_tpu_torch.ops._build import library_load

    with library_load("libbvh"):
        path = _compile()
        lib = None if path is None else ctypes.CDLL(path)
    if lib is None:
        return None
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.bvh_build.argtypes = [
        ctypes.c_int64,  # num_tris
        f32p, f32p, f32p,  # v0, e1, e2 [T,3]
        ctypes.c_int32,  # leaf_size
        f32p, f32p,  # out nodes_min/max [2T,3]
        i32p, i32p, i32p, i32p, i32p,  # skip, first, count, order, parent
    ]
    lib.bvh_build.restype = ctypes.c_int64  # node count (<0 = error)
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def build_bvh_native(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray,
                     leaf_size: int = 8):
    from raytracer_tpu_torch.accel.bvh import BVH, build_bvh_numpy

    lib = _load()
    if lib is None:
        return build_bvh_numpy(v0, e1, e2, leaf_size)

    t = len(v0)
    cap = max(2 * t, 2)
    nodes_min = np.empty((cap, 3), np.float32)
    nodes_max = np.empty((cap, 3), np.float32)
    skip = np.empty(cap, np.int32)
    first = np.empty(cap, np.int32)
    count = np.empty(cap, np.int32)
    order = np.empty(t, np.int32)
    parent = np.empty(cap, np.int32)
    nn = lib.bvh_build(
        t,
        np.ascontiguousarray(v0, np.float32),
        np.ascontiguousarray(e1, np.float32),
        np.ascontiguousarray(e2, np.float32),
        leaf_size,
        nodes_min, nodes_max, skip, first, count, order, parent,
    )
    if nn < 0:
        log.warning("native BVH builder returned %d; using numpy", nn)
        return build_bvh_numpy(v0, e1, e2, leaf_size)
    return BVH(
        nodes_min=nodes_min[:nn].copy(),
        nodes_max=nodes_max[:nn].copy(),
        nodes_skip=skip[:nn].copy(),
        nodes_first=first[:nn].copy(),
        nodes_count=count[:nn].copy(),
        tri_order=order,
        parent=parent[:nn].copy(),
    )
