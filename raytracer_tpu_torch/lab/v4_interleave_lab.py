"""Interleave lab L5: two deferred-leaf walks interleaved in one instance,
the port's counterpart of tools/v4_interleave_lab.py (`run_closest_v4`
:267, its `pallas_call` :276).

    python -m raytracer_tpu_torch.lab.v4_interleave_lab [--width W
        --height H]

Bakes the atrium with leaf 8 (as the JAX lab) and on each ray set of
lab.rays.closest_sets times K1 (ops/quad_traverse.intersect_quad, the JAX
lab's production sub-packet kernel) and both variants (CUDA events, mean of
5), and prints the speed-up over K1, the triangle mismatches and the
largest |dt| against it.

The pairing: one thread walks rays 2j and 2j+1 (neighbouring pixels in the
renderer's order), each with L4's binary walk (lab/queue_walk.py) and the
production drain threshold. Where the TPU instance interleaves two 8-row
tiles, the card interleaves two rays in one thread.
  shared  (the JAX default, tools/v4_interleave_lab.py:38, :234-248) each
          step both rays take a leaf step if either one's drain condition
          holds, else both an internal step; a ray with nothing of that
          kind sits the step out. This couples the pair's leaf timing, so
          the plain version simulates the same pairs;
  switch  (:214-233) each ray takes its own kind of step: two independent
          walks, per ray L4 `base` bit for bit.

On CUDA tensors the wrapper launches csrc/lab2_traverse.cu:lab_closest_pair;
on CPU tensors it runs the plain torch version, which the kernel equals bit
for bit.
"""

from __future__ import annotations

import argparse
import sys

from raytracer_tpu_torch.lab import queue_walk as qw
from raytracer_tpu_torch.lab import rays as lab_rays
from raytracer_tpu_torch.lab.bvh4_lab import against
from raytracer_tpu_torch.ops import binary_traverse as bt
from raytracer_tpu_torch.ops import quad_traverse as qt
from raytracer_tpu_torch.ops.quad_traverse import (
    T_MIN,
    TRI_STRIDE,
    _check_rays,
    _inv_dir,
    _ptr,
    _ray_inputs,
)

LEAF_SIZE = 8
VARIANTS = ("shared", "switch")
REPS = 5

# Kernel launches, counted where the CUDA wrapper launches.
closest_launches = 0


def reset_launch_counts():
    global closest_launches
    closest_launches = 0


def run_closest_v4(origin, direction, t_max, scene, variant="shared"):
    """Closest hit of rays f32[N,3] against the binary tree of `scene`, rays
    2j and 2j+1 walked together (t_min 1e-3, t_max scalar or f32[N]; a ray
    with t_max <= 1e-3 is not walked). Returns (t f32[N], tri i32[N], u
    f32[N], v f32[N])."""
    global closest_launches
    if variant not in VARIANTS:
        raise ValueError(f"unknown v4 variant {variant!r}; expected one of "
                         f"{VARIANTS}")
    qw.check_binary(scene)
    o, d, tm = _ray_inputs(origin, direction, t_max, None)
    if o.is_cuda:
        out = _closest_v4_cuda(o, d, tm, scene, variant == "shared")
        closest_launches += 1
        return out
    return closest_v4_plain(o, d, tm, scene.binary_root, scene.pnodes,
                            scene.ptris, variant)


def closest_v4_plain(origin, direction, t_max, root, pnodes, ptris, variant,
                     counts=None):
    """Plain torch version of lab_closest_pair. Returns (t, tri, u, v).
    `counts` (nit, nleaf), i32[N] each, adds up each ray's steps and leaf
    steps, a step sat out being none: the kernel has no counters, but takes
    the same steps."""
    step = qw.binary_step(origin, _inv_dir(direction), pnodes)
    return qw.queued_walk(origin, direction, t_max, root, ptris, step,
                          paired=variant == "shared", counts=counts)


def _closest_v4_cuda(origin, direction, t_max, scene, shared):
    n, dev = _check_rays(origin, direction, t_max)
    bt._check_scene_arrays(scene, dev)
    out = qw.hit_outputs(n, dev)
    if n:
        qw.launch("lab_closest_pair", dev, _ptr(origin), _ptr(direction),
                  _ptr(t_max), n, scene.binary_root, _ptr(scene.pnodes),
                  _ptr(scene.ptris), scene.ptris.shape[1] // TRI_STRIDE,
                  qw.DRAIN_AT, int(shared), *(_ptr(t) for t in out))
    return out


def run(scene, sets, variants=VARIANTS, reps=REPS, log=print):
    """K1 and every variant on every closest-hit set; prints one line each.
    Returns {(set, variant): stats} (and {(set, "k1"): stats}) with the
    outputs under "out"."""
    results = {}
    for label, (o, d, tm) in sets.items():
        k1 = qt.intersect_quad(o, d, scene, T_MIN, tm)
        k1_ms = lab_rays.cuda_ms(
            lambda: qt.intersect_quad(o, d, scene, T_MIN, tm), reps)
        results[(label, "k1")] = dict(ms=k1_ms, out=tuple(k1[:4]))
        log(f"v4 {label:15s} production sub-packet (K1) {k1_ms:8.3f} ms")
        for variant in variants:
            out = run_closest_v4(o, d, tm, scene, variant)
            ms = lab_rays.cuda_ms(
                lambda: run_closest_v4(o, d, tm, scene, variant), reps)
            flips, tri_diff, max_dt = against(out, k1)
            mism = int((out[1] != k1.tri).sum())
            results[(label, variant)] = dict(ms=ms, flips=flips,
                                             tri_diff=tri_diff, mism=mism,
                                             max_dt=max_dt, out=out)
            log(f"v4 {label:15s} 2-way interleave {variant:6s} {ms:8.3f} ms"
                f"  ({k1_ms / ms:.2f}x)  mism {mism}  max|dt| {max_dt:.2e}"
                f"  (hit flips {flips}, tri diff {tri_diff})")
    return results


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--width", type=int, default=lab_rays.WIDTH)
    p.add_argument("--height", type=int, default=lab_rays.HEIGHT)
    p.add_argument("--reps", type=int, default=REPS)
    args = p.parse_args(argv)
    device = lab_rays.require_cuda()
    scene = lab_rays.atrium(LEAF_SIZE, device)
    sets = lab_rays.closest_sets(scene, args.width, args.height)
    run(scene, sets, reps=args.reps, log=lambda m: print(m, flush=True))
    print(f"v4_interleave_lab on {lab_rays.card_line()} (SM clock read "
          "after the runs)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
