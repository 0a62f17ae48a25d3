"""Build and load the port's native libraries: the CUDA kernels
(csrc/*.cu: the render path's quad_traverse, binary_traverse and
light_select, the traversal lab's lab_traverse, lab2_traverse and
lab3_traverse, and the bf16 throughput lab's bf16_lab) and, for
accel/native_builder.py, the C++ BVH builder.

Each source is compiled into a shared library with a plain C interface, in
the build directory (utils/compile_cache.py: `raytracer_tpu_torch/_build/`,
or under $RAYTRACER_TPU_CACHE_DIR), named by a hash of the source, the
headers it includes and the flags, at first use; later uses in any process
load the cached library. The CUDA libraries are loaded with ctypes: every
pointer and the stream are `c_void_p`. Nothing here runs at import time. Each
library has its own lock, so two threads build two libraries at once.

Flags: sm_90a (Hopper), -O3, and -fmad=false, which keeps nvcc from
contracting a*b+c into one rounding so the kernels equal their plain torch
versions bit for bit.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time

from raytracer_tpu_torch.utils import compile_cache, profiling

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
# A directory set here overrides compile_cache.build_dir() (tests set it).
BUILD_DIR = None
# Device helpers shared by the traversal kernels (#included by each .cu;
# persistent_walk.cuh by quad_traverse.cu, binary_traverse.cu,
# lab_traverse.cu and lab2_traverse.cu).
CUDA_HEADERS = (os.path.join(CSRC_DIR, "traverse_common.cuh"),
                os.path.join(CSRC_DIR, "persistent_walk.cuh"))

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
]

_locks_guard = threading.Lock()
_locks = {}
_libs = {}
# library stem -> {"seconds": build seconds (0 when cached), "log": the
# compiler's output, "path": the library}
build_info = {}


def build_dir() -> str:
    """The directory libraries are built into: BUILD_DIR when set, else
    compile_cache.build_dir()."""
    return BUILD_DIR or compile_cache.build_dir()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = []
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    for path in candidates:
        if os.path.exists(path):
            return path
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (CUDA_HOME or nvcc on PATH)")


def compile_library(argv, src: str, stem: str, headers=()) -> str:
    """Compile `src` into build_dir()/<stem>_<hash>.so with the compiler
    command `argv` (flags included; the hash covers the source, the files
    in `headers` and argv), unless that library is there already. Returns
    its path; raises with the compiler's output on failure. The library is
    written under a private name and renamed, so concurrent first users
    never load a half-written file."""
    key = hashlib.sha256()
    for path in (src, *headers):
        with open(path, "rb") as f:
            key.update(f.read())
    key.update(" ".join(argv[1:]).encode())
    out_dir = build_dir()
    path = os.path.join(out_dir, f"{stem}_{key.hexdigest()[:16]}.so")
    if os.path.exists(path):
        build_info[stem] = {"seconds": 0.0, "log": "cached", "path": path}
        return path
    os.makedirs(out_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run([*argv, "-o", tmp, src], capture_output=True,
                          text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"{os.path.basename(argv[0])} failed to build {src} (exit "
            f"{proc.returncode}):\n{proc.stderr}{proc.stdout}")
    os.replace(tmp, path)
    build_info[stem] = {"seconds": seconds,
                        "log": (proc.stderr + proc.stdout).strip(),
                        "path": path}
    return path


def ptxas_spills(log_text: str, kernel: str):
    """(spill store bytes, spill load bytes) of the first function whose
    mangled name contains `kernel`, from a -Xptxas=-v build log; ("?",
    "?") when the log does not hold it (a cached library)."""
    found = False
    for line in log_text.splitlines():
        if "Function properties for" in line:
            found = kernel in line
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and found:
            return int(m.group(1)), int(m.group(2))
    return "?", "?"


def bind(lib: ctypes.CDLL, signatures) -> ctypes.CDLL:
    """Set `lib`'s entry points' argtypes from `signatures` (entry point ->
    argtypes) and their restype to int, the launch's cudaError_t."""
    for fn, argtypes in signatures.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def _cuda_lib(name: str, signatures, headers=CUDA_HEADERS) -> ctypes.CDLL:
    """csrc/<name>.cu built (stem lib<name>; its hash covers `headers`, the
    repo's headers it includes) and loaded once per process, its entry
    points bound to `signatures`; the first load is a `rt.kernel_load`
    span (`library_load`)."""
    with _locks_guard:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        stem = f"lib{name}"
        with library_load(stem):
            lib = bind(ctypes.CDLL(compile_library(
                [_nvcc(), *NVCC_FLAGS], os.path.join(CSRC_DIR, f"{name}.cu"),
                stem, headers=headers)), signatures)
        _libs[name] = lib
        return lib


@contextlib.contextmanager
def library_load(stem: str):
    """The `rt.kernel_load` span of a library's first load in the process:
    attributes `library` (the stem) and `built` (compiled now, not found in
    the build directory)."""
    with profiling.span("rt.kernel_load", library=stem) as attrs:
        yield
        if attrs is not None:
            attrs["built"] = build_info.get(stem, {}).get("seconds", 0) > 0


_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int
_F32 = ctypes.c_float


# The persistent walks' scene arguments (csrc/persistent_walk.cuh), after
# the rays: root, node rows, ptris, leaf counts, leaf, stack need, the ray
# counter; then the outputs and the stream.
_SCENE = [_I32, _P, _P, _P, _I32, _I32, _P]
QUAD_TRAVERSE_SIGNATURES = {
    "quad_closest": [_P, _P, _P, _I64, *_SCENE, _P, _P, _P, _P, _P],
    "quad_occlusion": [_P, _P, _P, _P, _I64, *_SCENE, _P, _P],
    "quad_launch_info": [_I32, _I32, _P],
}


def quad_traverse_lib() -> ctypes.CDLL:
    """The 4-wide tree's traversal kernels (csrc/quad_traverse.cu)."""
    return _cuda_lib("quad_traverse", QUAD_TRAVERSE_SIGNATURES)


# csrc/binary_traverse.cu's entry points: as the 4-wide tree's, with the
# launch's t_min after the ray count.
BINARY_TRAVERSE_SIGNATURES = {
    "binary_closest": [_P, _P, _P, _I64, _F32, *_SCENE, _P, _P, _P, _P, _P],
    "binary_occlusion": [_P, _P, _P, _P, _I64, _F32, *_SCENE, _P, _P],
    "binary_launch_info": [_I32, _I32, _P],
}


def binary_traverse_lib() -> ctypes.CDLL:
    """The binary tree's traversal kernels (csrc/binary_traverse.cu)."""
    return _cuda_lib("binary_traverse", BINARY_TRAVERSE_SIGNATURES)


def light_select_lib() -> ctypes.CDLL:
    """NEE's light selection kernel (csrc/light_select.cu, which includes no
    repo header): the lane inputs, the light rows, L, n, draw, mis, the
    outputs, the drawn counter and the stream."""
    return _cuda_lib("light_select", {
        "light_select": [_P, _P, _P, _P, _P, _P, _P, _P, _I32, _I64, _I32,
                         _I32, _P, _P, _P, _P, _P, _P, _P, _P],
    }, headers=())


def lab_traverse_lib() -> ctypes.CDLL:
    """The traversal lab's binary and 4-wide kernels (csrc/lab_traverse.cu;
    L1, L9 and L2 take the persistent walks' scene arguments)."""
    return _cuda_lib("lab_traverse", {
        "lab_closest": [_P, _P, _P, _I64, *_SCENE, _I32, _I32, _P, _P, _P,
                        _P, _P, _P, _P],
        "lab_occlusion": [_P, _P, _P, _P, _I64, *_SCENE, _I32, _P, _P, _P,
                          _P],
        "lab_closest4": [_P, _P, _P, _I64, *_SCENE, _I32, _P, _P, _P, _P,
                         _P],
        "lab_launch_info": [_I32, _I32, _P],
    })


def lab2_traverse_lib() -> ctypes.CDLL:
    """The traversal lab's deferred-leaf (binary, 4-wide, 8-wide, any-hit)
    and component-major kernels (csrc/lab2_traverse.cu; L3-L8 take the
    persistent walks' scene arguments)."""
    return _cuda_lib("lab2_traverse", {
        "lab_closest_cm": [_P, _P, _P, _I64, *_SCENE, _P, _P, _P, _P, _P],
        "lab_closest_queued": [_P, _P, _P, _I64, *_SCENE, _I32, _I32, _P,
                               _P, _P, _P, _P, _P, _P],
        "lab_closest_pair": [_P, _P, _P, _I64, *_SCENE, _I32, _I32, _P, _P,
                             _P, _P, _P],
        "lab_closest4_queued": [_P, _P, _P, _I64, *_SCENE, _I32, _I32, _I32,
                                _P, _P, _P, _P, _P],
        "lab_closest8_queued": [_P, _P, _P, _I64, *_SCENE, _I32, _P, _P,
                                _P, _P, _P],
        "lab_occlusion4_queued": [_P, _P, _P, _P, _I64, *_SCENE, _I32, _I32,
                                  _P, _P],
        "lab2_launch_info": [_I32, _I32, _P],
    })


def lab3_traverse_lib() -> ctypes.CDLL:
    """The fixed-sequence labs' kernels, L11a, L11b and L10, and the check
    of their reciprocal (csrc/lab3_traverse.cu)."""
    row = [_P, _P, _I64, _P, _I32, _I32, _I32, _P, _P, _P]
    return _cuda_lib("lab3_traverse", {
        "lab_visit": row, "lab_leaf_visit": row, "lab_smem": row,
        "lab_rcp_check": [_P, _P], "lab3_launch_info": [_I32, _P],
    })


def bf16_lab_lib() -> ctypes.CDLL:
    """The packed-bf16 throughput lab's kernels, L12 (csrc/bf16_lab.cu,
    which includes no repo header)."""
    return _cuda_lib("bf16_lab", {
        "lab_bf16": [_P, _P, _I64, _I32, _I32, _P, _P],
    }, headers=())
