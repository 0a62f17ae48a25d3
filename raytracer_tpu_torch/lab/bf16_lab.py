"""Packed-bf16 lab L12: does the card retire packed bf16 elementwise ops
at twice the f32 rate? The port's counterpart of tools/bf16_lab.py (`run`
:65, its `pallas_call` :73; `main` :117).

    python -m raytracer_tpu_torch.lab.bf16_lab

A chain of K = 512 steps x = x*a + b (or x = x*a) per element over
TILES = 4096 tiles of 2048 elements (8,388,608 elements), timed by CUDA
events (mean of 5), printed as the JAX lab prints it: ms and elements x K
per second (Top/s), then the f32/bf16 time ratios.

  f32, f32_mul      two f32 inputs x, y [TILES,8,128], a chain on each,
                    out = x + y; a thread holds one element of each
  bf16, bf16_mul    one bf16 input [TILES,16,128]; a thread holds one
                    __nv_bfloat162 (two elements), the packing the lab
                    asks about
  f32_ilp, bf16_ilp 8 chains per thread (f32: 4 on x, 4 on y, scaled by
                    1 + i*1e-6; bf16: 8 on x scaled by 1 + i*0.01), K/4
                    steps each, summed left to right
  f32_fma, bf16_fma the f32 and bf16 chains with one rounding per step
                    (fmaf, __hfma2): the card's fused rate. No JAX kernel
                    has them: the JAX docstring speaks of fused
                    multiply-adds, but its x*a + b rounds twice.

The first six equal the JAX kernels' bodies, as written, bit for bit: f32
rounds the product and the sum apart, bf16 rounds each op to bf16, and
the constants are the JAX scalars' bit patterns (F32_BITS, BF16_BITS).
(XLA on the CPU, compiling a whole body in interpret mode, contracts the
f32 x*a + b into one FMA, which is `f32_fma` here, and folds and factors
the f32 multiply chains.) On the lab's all-ones input, b = bf16(0.001) is
below half an ulp of x once x >= 0.25, so `bf16` and `bf16_mul` give the
same output there.

On CUDA tensors `run_bf16` launches csrc/bf16_lab.cu:lab_bf16; on CPU
tensors it runs the plain torch versions below. The fused forms' plain
versions compute each step in wider precision (f64, or f32 for bf16) and
round once; they agree with the kernels within 1 ulp.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from raytracer_tpu_torch.lab import rays as lab_rays

K = 512  # chain steps per element (bf16_lab.py:23)
TILES = 4096  # (bf16_lab.py:24)
REPS = 5
VARIANTS = ("f32", "bf16", "f32_mul", "bf16_mul", "f32_ilp", "bf16_ilp")
FUSED = ("f32_fma", "bf16_fma")
ALL = VARIANTS + FUSED  # in the order of csrc/bf16_lab.cu's variant codes
# jnp.float32(c) of a = 1.0000001, b = 1e-7, the ILP scales 1 + i*1e-6
F32_BITS = {"a": 0x3F800001, "b": 0x33D6BF95,
            "scales": (0x3F800000, 0x3F800008, 0x3F800011, 0x3F800019)}
# jnp.bfloat16(c) of a = 1.0078125, b = 0.001, the ILP scales 1 + i*0.01
BF16_BITS = {"a": 0x3F81, "b": 0x3A83,
             "scales": (0x3F80, 0x3F81, 0x3F83, 0x3F84, 0x3F85, 0x3F86,
                        0x3F88, 0x3F89)}

# Kernel launches, counted where the CUDA wrapper launches.
bf16_launches = 0


def reset_launch_counts():
    global bf16_launches
    bf16_launches = 0


def is_bf16(variant):
    return variant.startswith("bf16")


def tile_shape(variant):
    return (16, 128) if is_bf16(variant) else (8, 128)


def inputs(variant, tiles=TILES, device="cpu", seed=None):
    """The lab's inputs of `variant`: (x, y) f32[tiles,8,128] each, or (x
    bf16[tiles,16,128], None); ones (the JAX lab's) or, with a seed,
    uniform in [0.5, 2] (rounded to bf16 for bf16)."""
    shape = (tiles, *tile_shape(variant))
    n_in = 1 if is_bf16(variant) else 2
    if seed is None:
        arrs = [torch.ones(shape) for _ in range(n_in)]
    else:
        rng = np.random.default_rng(seed)
        arrs = [torch.from_numpy(rng.uniform(0.5, 2.0, shape)
                                 .astype(np.float32)) for _ in range(n_in)]
    dt = torch.bfloat16 if is_bf16(variant) else torch.float32
    arrs = [a.to(device=device, dtype=dt) for a in arrs]
    return arrs[0], (arrs[1] if n_in == 2 else None)


def f32_const(bits, device):
    return torch.tensor([bits], dtype=torch.int32,
                        device=device).view(torch.float32)[0]


def bf16_const(bits, device):
    return torch.tensor([bits], dtype=torch.int16,
                        device=device).view(torch.bfloat16)[0]


def _check(variant, x, y):
    if variant not in ALL:
        raise ValueError(f"unknown variant {variant!r}; expected one of "
                         f"{ALL}")
    want = torch.bfloat16 if is_bf16(variant) else torch.float32
    if x.dtype != want or not x.is_contiguous():
        raise ValueError(f"{variant} takes a contiguous {want} x")
    if is_bf16(variant):
        if y is not None:
            raise ValueError(f"{variant} takes one input")
        if x.numel() % 2:
            raise ValueError("the bf16 kernels take element pairs")
    elif (y is None or y.dtype != want or y.shape != x.shape
          or y.device != x.device or not y.is_contiguous()):
        raise ValueError(f"{variant} takes a contiguous f32 y like x")


def run_bf16(variant, x, y=None, k=K):
    """The `variant` chain of `k` steps over x (and y). Returns out with
    x's shape and dtype."""
    global bf16_launches
    _check(variant, x, y)
    if not 0 <= k < 2 ** 31:
        raise ValueError(f"chain steps {k} out of range")
    if x.is_cuda:
        out = _bf16_cuda(variant, x, y, k)
        bf16_launches += 1
        return out
    return bf16_plain(variant, x, y, k)


# --------------------------------------------------------------------------
# Plain torch versions.
# --------------------------------------------------------------------------

def _sum_left(xs):
    """sum(xs[1:], xs[0]): left to right."""
    s = xs[0]
    for v in xs[1:]:
        s = s + v
    return s


def bf16_plain(variant, x, y, k):
    """Plain torch version of lab_bf16's `variant`: each op of the chain
    rounds to the input's dtype, as the JAX kernel's; the fused forms
    round once per step."""
    dev = x.device
    if is_bf16(variant):
        a, b = (bf16_const(BF16_BITS[c], dev) for c in "ab")
        scales = [bf16_const(s, dev) for s in BF16_BITS["scales"]]
    else:
        a, b = (f32_const(F32_BITS[c], dev) for c in "ab")
        scales = [f32_const(s, dev) for s in F32_BITS["scales"]]
    if variant.endswith("_ilp"):
        chains = [x * s for s in scales] if is_bf16(variant) else (
            [x * s for s in scales] + [y * s for s in scales])
        for _ in range(k // 4):
            chains = [v * a + b for v in chains]
        if is_bf16(variant):
            return _sum_left(chains)
        return _sum_left(chains[:4]) + _sum_left(chains[4:])
    wide = torch.float32 if is_bf16(variant) else torch.float64
    aw, bw = a.to(wide), b.to(wide)
    xs = [x] if is_bf16(variant) else [x, y]
    for _ in range(k):
        if variant.endswith("_mul"):
            xs = [v * a for v in xs]
        elif variant.endswith("_fma"):
            xs = [(v.to(wide) * aw + bw).to(x.dtype) for v in xs]
        else:
            xs = [v * a + b for v in xs]
    return xs[0] if is_bf16(variant) else xs[0] + xs[1]


def ulp_diff(got, ref):
    """Per-element distance in units in the last place between two tensors
    of one float dtype and sign: the difference of their bit patterns."""
    as_int = torch.int16 if got.dtype == torch.bfloat16 else torch.int32
    return (got.view(as_int).to(torch.int64)
            - ref.view(as_int).to(torch.int64)).abs()


# --------------------------------------------------------------------------
# CUDA wrapper (csrc/bf16_lab.cu).
# --------------------------------------------------------------------------

def _bf16_cuda(variant, x, y, k):
    from raytracer_tpu_torch.ops import _build
    from raytracer_tpu_torch.ops.quad_traverse import _ptr, _stream

    out = torch.empty_like(x)
    lib = _build.bf16_lab_lib()
    with torch.cuda.device(x.device):
        rc = lib.lab_bf16(_ptr(x), None if y is None else _ptr(y),
                          x.numel(), k, ALL.index(variant), _ptr(out),
                          _stream(x.device))
    if rc != 0:
        raise RuntimeError(f"lab_bf16 launch failed: cudaError {rc}")
    return out


# --------------------------------------------------------------------------
# The lab.
# --------------------------------------------------------------------------

def run(device, reps=REPS, log=print, k=K, tiles=TILES):
    """Every variant on the lab's ones input. Returns {variant: {"ms",
    "out", "x", "y"}}; logs the JAX lab's lines and ratios."""
    results = {}
    elems = tiles * 16 * 128
    for variant in ALL:
        x, y = inputs(variant, tiles, device)
        out = run_bf16(variant, x, y, k)
        ms = lab_rays.cuda_ms(lambda: run_bf16(variant, x, y, k), reps)
        results[variant] = {"ms": ms, "out": out, "x": x, "y": y}
        log(f"{variant:9s} {ms:9.4f} ms  {elems * k / ms / 1e9:.3f} Top/s "
            f"({elems} elements x {k} steps)")
    for label, f, h in (("fma", "f32", "bf16"), ("mul", "f32_mul", "bf16_mul"),
                        ("ILP fma", "f32_ilp", "bf16_ilp"),
                        ("fused fma", "f32_fma", "bf16_fma")):
        log(f"{label} ratio f32/bf16: "
            f"{results[f]['ms'] / results[h]['ms']:.3f}")
    return results


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--reps", type=int, default=REPS)
    args = p.parse_args(argv)
    device = lab_rays.require_cuda()
    run(device, args.reps, log=lambda m: print(m, flush=True))
    print(f"bf16_lab on {lab_rays.card_line()} (SM clock read after the "
          "runs)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
