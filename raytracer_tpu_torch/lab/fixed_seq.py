"""The fixed-sequence harness of the microbenchmark labs L10-L12
(lab/visit_cost_lab.py, lab/smem_lab.py, lab/bf16_lab.py), the part that
tools/visit_cost_lab.py, tools/smem_lab.py and tools/bf16_lab.py share:
the constant rays, the iteration counts, the timing loop, the integer
conversions their outputs go through, and the checks and launcher of
csrc/lab3_traverse.cu (L10, L11).

A fixed-sequence kernel walks the same rows in the same order for every
ray (row i % rows at iteration i), so each variant does the same number of
iterations whatever the scene; what it computes per iteration is the
variant. Two launch sizes:

  - lab size, the JAX lab's own tile (4096 rays for L11a, 1024 and 4096
    for L11b, 1024 for L10): a warp or two per SM, so the kernel's
    clock64() cycles per iteration (the mean over warps of each warp's
    clock delta over the K iterations) are the latency of one iteration;
  - card size, every SM full: its SM count x its resident threads per SM
    (270,336 rays on a 132-SM H100), timed by CUDA events, which gives ns
    per ray-iteration and the kernel's share of its bound.

The lab's rays are the JAX labs' `jnp.ones(...) * 0.1` (visit_cost_lab.py
:262, smem_lab.py:145): origin and direction 0.1 in every component, the
same ray in every lane.

The TPU kernels' int32 arithmetic wraps, and their f32 -> int32
conversions saturate (NaN -> 0), as CUDA's cvt.rzi does; torch's
`.to(torch.int32)` on the CPU gives INT_MIN out of range. The plain
versions therefore convert with sat_i32 and wrap with wrap_i32.
"""

from __future__ import annotations

import torch

from raytracer_tpu_torch.lab import rays as lab_rays
from raytracer_tpu_torch.ops.quad_traverse import _ptr, _require, _stream

TILE_S, TILE_L = 32, 128  # the TPU lab's ray tile (pallas_traverse.py:50)
WARP = 32  # the card's reduction scope in L11a (one warp of rays)
K_VISIT = 262_144  # L11a internal-node visits (visit_cost_lab.py:28)
K_LEAF = K_VISIT // 8  # L11b leaf visits of 8 triangles (:211)
K_SMEM = 65_536  # L10 leaf visits (smem_lab.py:22)
K_CHECK = 256  # iterations of the kernel-vs-plain checks on the card
T_MIN, T_CAP = 1e-3, 1e4  # the labs' t_min and their rays' t cap
REPS = 3  # timed launches per variant and size

_I32_MIN, _I32_MAX = -2 ** 31, 2 ** 31 - 1


def sat_i32(x):
    """f32 -> i32 as JAX's astype and CUDA's (int) convert: truncation
    toward zero, saturating at the int32 range, NaN -> 0."""
    x = torch.nan_to_num(x.double(), nan=0.0, posinf=_I32_MAX,
                         neginf=_I32_MIN)
    return torch.clamp(x, _I32_MIN, _I32_MAX).to(torch.int64).to(torch.int32)


def wrap_i32(x):
    """Integers (any integer dtype) to int32 with two's-complement
    wrap-around, as the TPU's and the kernels' int32 sums."""
    x = x.to(torch.int64)
    return (torch.remainder(x + 2 ** 31, 2 ** 32) - 2 ** 31).to(torch.int32)


def lab_rays_const(n, device):
    """(origin, direction) f32[n,3], every component 0.1: the JAX labs'
    rays."""
    ray = torch.full((n, 3), 0.1, dtype=torch.float32, device=device)
    return ray, ray.clone()


def card_rays(device):
    """Rays that fill every SM of `device`: SM count x resident threads per
    SM."""
    props = torch.cuda.get_device_properties(device)
    per_sm = getattr(props, "max_threads_per_multi_processor", 2048)
    return props.multi_processor_count * per_sm


def sizes(device, lab_sizes):
    """[(label, rays)]: each lab size, then the card size."""
    return ([(f"lab{n}", n) for n in lab_sizes]
            + [("card", card_rays(device))])


def cycles_buffer(n, device):
    """The per-warp clock64() deltas a kernel writes: i64[ceil(n/32)]."""
    return torch.zeros(((n + WARP - 1) // WARP,), dtype=torch.int64,
                       device=device)


def check_k(k):
    if not 0 <= k < 2 ** 31:
        raise ValueError(f"iterations {k} out of range")


def check_cycles(cycles, n, device):
    if cycles is None:
        return
    if cycles.device != device or cycles.dtype != torch.int64 \
            or tuple(cycles.shape) != ((n + WARP - 1) // WARP,):
        raise ValueError("cycles must be cycles_buffer(n, device)")


def timed(fn, k, n, reps=REPS):
    """Run fn(cycles) on the card once after a warm-up launch (a cold first
    launch reads the rows from device memory) to read its per-warp cycles,
    then time it: {"ms": CUDA-event mean of `reps` launches,
    "cycles_per_iter": the mean over warps of clock cycles over `k`
    iterations, "ns_per_ray_iter": ms over n x k}. fn returns the kernel's
    output, kept under "out"."""
    device = torch.device("cuda", torch.cuda.current_device())
    cycles = cycles_buffer(n, device)
    fn(None)
    out = fn(cycles)
    torch.cuda.synchronize()
    cyc = float(cycles.double().mean()) / max(k, 1)
    ms = lab_rays.cuda_ms(lambda: fn(None), reps)
    return {"ms": ms, "cycles_per_iter": cyc,
            "ns_per_ray_iter": ms * 1e6 / max(n * k, 1), "rays": n, "k": k,
            "out": out}


def leaf_out(btri, bt):
    """The TPU leaf labs' output (L10, L11b): btri + int(bt), int32."""
    return wrap_i32(btri.to(torch.int64) + sat_i32(bt))


def check_inputs(origin, direction, rows, width, variant, variants):
    """Refuse an unknown variant, rays other than f32[N,3] and a table other
    than f32[rows >= 1, width] on the rays' device (16-byte aligned on
    CUDA); returns N."""
    if variant not in variants:
        raise ValueError(f"unknown variant {variant!r}; expected one of "
                         f"{variants}")
    n = origin.shape[0]
    _require("origin", origin, torch.float32, (n, 3), origin.device)
    _require("direction", direction, torch.float32, (n, 3), origin.device)
    if rows.dim() != 2 or rows.shape[1] != width or rows.shape[0] == 0:
        raise ValueError(f"rows of width {width} expected, got "
                         f"{tuple(rows.shape)}")
    _require("rows", rows, torch.float32, tuple(rows.shape), origin.device,
             vec=origin.is_cuda)
    return n


def launch(entry, origin, direction, rows, k, variant_code, cycles):
    """Launch csrc/lab3_traverse.cu's `entry` (lab_visit, lab_leaf_visit or
    lab_smem) on rays f32[N,3] over `rows` for k iterations with the
    kernel's `variant_code`; returns its output i32[N]."""
    from raytracer_tpu_torch.ops import _build

    n, dev = origin.shape[0], origin.device
    check_cycles(cycles, n, dev)
    out = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return out
    lib = _build.lab3_traverse_lib()
    with torch.cuda.device(dev):
        rc = getattr(lib, entry)(
            _ptr(origin), _ptr(direction), n, _ptr(rows), rows.shape[0], k,
            variant_code, _ptr(out),
            None if cycles is None else _ptr(cycles), _stream(dev))
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError {rc}")
    return out


# lab3_launch_info's kernels by index: L11a's variants in lab_visit's
# order (visit_cost_lab.VISIT_VARIANTS), L11b's in lab_leaf_visit's
# (LEAF_VARIANTS: base and ilp on direct loads, slice and sliceilp on a
# warp's ring in shared memory), L10's smem and transp (one kernel on the
# block's staged ring); each (label, its mangled name's distinctive part).
LAUNCH_KERNELS = (
    *((f"L11a {v}", f"visit_kernelILi{i}E") for i, v in enumerate(
        ("full", "nored", "noslab", "extracts", "rowonly", "empty"))),
    ("L11b base", "leaf_visit_kernelILb0E"),
    ("L11b ilp", "leaf_visit_kernelILb1E"),
    ("L11b slice", "slice_visit_kernelILb0E"),
    ("L11b sliceilp", "slice_visit_kernelILb1E"),
    ("L10 smem", "staged_kernelILb0E"), ("L10 transp", "staged_kernelILb1E"))
LAUNCH_INFO_KEYS = ("registers", "local_bytes", "static_smem_bytes",
                    "blocks_per_sm", "threads")


def launch_index(label):
    """The index in LAUNCH_KERNELS (and lab3_launch_info) of the kernel
    labelled `label` ("L11b base", "L10 smem", ...)."""
    return [name for name, _ in LAUNCH_KERNELS].index(label)


def launch_info(index, device):
    """What a launch of LAUNCH_KERNELS[index] looks like on `device`
    (csrc/lab3_traverse.cu:lab3_launch_info): LAUNCH_INFO_KEYS, and
    "spills", the ptxas spill stores and loads in bytes ("?" when the
    library was loaded from the build directory's cache)."""
    import ctypes

    from raytracer_tpu_torch.ops import _build

    out = (ctypes.c_int * len(LAUNCH_INFO_KEYS))()
    with torch.cuda.device(device):
        rc = _build.lab3_traverse_lib().lab3_launch_info(index, out)
    if rc != 0:
        raise RuntimeError(f"lab3_launch_info failed: cudaError {rc}")
    info = dict(zip(LAUNCH_INFO_KEYS, out))
    log = _build.build_info.get("liblab3_traverse", {}).get("log", "")
    info["spills"] = _build.ptxas_spills(log, LAUNCH_KERNELS[index][1])
    return info


def launch_line(index, device):
    """One line of launch_info(index, device)."""
    i = launch_info(index, device)
    st, ld = i["spills"]
    warps = i["threads"] // 32 * i["blocks_per_sm"]
    return (f"{LAUNCH_KERNELS[index][0]} launch: {i['registers']} registers, "
            f"spill stores {st} B, spill loads {ld} B, local "
            f"{i['local_bytes']} B a thread, static shared "
            f"{i['static_smem_bytes']} B a block, {i['blocks_per_sm']} blocks "
            f"of {i['threads']} a SM ({warps} warps)")


def line(label, variant, r, unit):
    """One lab line of timed()'s result `r`."""
    return (f"{label:8s} {variant:9s} {r['rays']:7d} rays: {r['ms']:10.3f} "
            f"ms  {r['cycles_per_iter']:8.1f} cyc/{unit}  "
            f"{r['ns_per_ray_iter']:.6f} ns/ray-{unit}")


# The floats whose reciprocal the leaf labs take by rcp_fast: |x| in
# [2^-126, 2^126), both signs (exponent fields 1-252).
RCP_FLOATS = 2 * 252 * 2 ** 23


def rcp_check(device):
    """csrc/lab3_traverse.cu:lab_rcp_check on `device`: (floats checked,
    floats where the leaf labs' reciprocal differs from the IEEE
    division). The first must be RCP_FLOATS, the second 0."""
    from raytracer_tpu_torch.ops import _build

    counts = torch.zeros((2,), dtype=torch.int64, device=device)
    with torch.cuda.device(device):
        rc = _build.lab3_traverse_lib().lab_rcp_check(_ptr(counts),
                                                      _stream(device))
    if rc != 0:
        raise RuntimeError(f"lab_rcp_check launch failed: cudaError {rc}")
    checked, differ = counts.tolist()
    return checked, differ
