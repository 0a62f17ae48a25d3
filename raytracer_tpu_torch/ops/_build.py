"""Build and load the port's native libraries: the CUDA kernels
(csrc/*.cu) and, for accel/native_builder.py, the C++ BVH builder.

Each source is compiled into a shared library with a plain C interface, in
`raytracer_tpu_torch/_build/`, named by a hash of the source and the
flags, at first use; later uses in any process load the cached library.
The CUDA library is loaded with ctypes: every pointer and the stream are
`c_void_p`. Nothing here runs at import time.

Flags: sm_90a (Hopper), -O3, and -fmad=false, which keeps nvcc from
contracting a*b+c into one rounding so the kernels equal their plain torch
versions bit for bit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(PACKAGE_DIR, "_build")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
]

_lock = threading.Lock()
_libs = {}
# library stem -> {"seconds": build seconds (0 when cached), "log": the
# compiler's output}
build_info = {}


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


def compile_library(argv, src: str, stem: str) -> str:
    """Compile `src` into BUILD_DIR/<stem>_<hash>.so with the compiler
    command `argv` (flags included; the hash covers the source and argv),
    unless that library is there already. Returns its path; raises with
    the compiler's output on failure. The library is written under a
    private name and renamed, so concurrent first users never load a
    half-written file."""
    with open(src, "rb") as f:
        key = hashlib.sha256(f.read() + " ".join(argv[1:]).encode())
    path = os.path.join(BUILD_DIR, f"{stem}_{key.hexdigest()[:16]}.so")
    if os.path.exists(path):
        build_info[stem] = {"seconds": 0.0, "log": "cached"}
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
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
                        "log": (proc.stderr + proc.stdout).strip()}
    return path


def quad_traverse_lib() -> ctypes.CDLL:
    """The traversal kernels' library (csrc/quad_traverse.cu), built and
    loaded once per process."""
    with _lock:
        lib = _libs.get("quad_traverse")
        if lib is not None:
            return lib
        lib = ctypes.CDLL(compile_library(
            [_nvcc(), *NVCC_FLAGS],
            os.path.join(CSRC_DIR, "quad_traverse.cu"), "libquad_traverse"))
        p = ctypes.c_void_p
        i64 = ctypes.c_int64
        i32 = ctypes.c_int
        lib.quad_closest.argtypes = [p, p, p, i64, i32, p, p, p, i32,
                                     p, p, p, p, p]
        lib.quad_closest.restype = ctypes.c_int
        lib.quad_occlusion.argtypes = [p, p, p, p, i64, i32, p, p, p, i32,
                                       p, p]
        lib.quad_occlusion.restype = ctypes.c_int
        _libs["quad_traverse"] = lib
        return lib
