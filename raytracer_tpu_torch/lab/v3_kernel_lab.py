"""Kernel lab L4: the deferred-leaf walk of the production sub-packet
kernel on the binary tree, with per-ray step counters, the port's
counterpart of tools/v3_kernel_lab.py (`run_closest_v3` :277, its
`pallas_call` :290).

    python -m raytracer_tpu_torch.lab.v3_kernel_lab [--width W --height H]
        [--drain-at N [N ...]]

Bakes the atrium with leaf 8 (as the JAX lab) and on each ray set of
lab.rays.closest_sets times K3 (ops/binary_traverse.intersect_bvh_binary,
the JAX lab's production reference) and each variant (CUDA events, mean of
5), and prints the mismatches against K3 (the JAX lab's count: triangle
differs and t not within rtol 1e-5), the mean and p90 steps per live ray
and the leaf steps per ray.

Variants (lab/queue_walk.py's walk, binary node step):
  base     internal-only stack, leaf children queued at push time, a leaf
           step when ln >= drain_at or only queued leaves are left
  nocond   internal steps only, leaf children dropped at push time: the
           results are wrong by design (it isolates the cost of the leaf
           steps); refused when the root is a leaf, where the TPU loop
           never ends
  dblread  base with a second, dependent node-row load per internal step
           (row max(node - 1, 0), its first float times 0.0 folded into
           the t cap); results and counts equal base's while boxes are
           finite

nit counts every step of a ray's walk and nleaf its leaf steps: per ray
what the TPU kernel counts per 8x128 tile (rows 0 and 1 of its nit
output). On CUDA tensors the wrapper launches
csrc/lab2_traverse.cu:lab_closest_queued, persistent warps on the queued
walk of L6-L8 (queued_walk) with the binary node step: the internal-node
stack (bt.stack_need(scene) entries a thread, its top in a register) and
the leaf queue in shared memory, each leaf row tested up to its count, the
counts kept by a per-ray hook. On CPU tensors it runs the plain torch
version, every slot of each row, which the kernel equals bit for bit
(counts included). On the card the lab first prints each variant's launch
shape.
"""

from __future__ import annotations

import argparse
import sys

import torch

from raytracer_tpu_torch.lab import queue_walk as qw
from raytracer_tpu_torch.lab import rays as lab_rays
from raytracer_tpu_torch.lab.bvh4_lab import against
from raytracer_tpu_torch.ops import binary_traverse as bt
from raytracer_tpu_torch.ops import quad_traverse as qt
from raytracer_tpu_torch.ops.quad_traverse import (
    T_MIN,
    _check_rays,
    _inv_dir,
    _ptr,
    _ray_inputs,
    _serial_leaf,
)

LEAF_SIZE = 8
VARIANTS = qw.L4_VARIANTS
_KERNEL_VARIANT = {variant: code for code, variant in enumerate(VARIANTS)}
REPS = 5

# Kernel launches, counted where the CUDA wrapper launches.
closest_launches = 0


def reset_launch_counts():
    global closest_launches
    closest_launches = 0


def _check(scene, drain_at, variant):
    if variant not in _KERNEL_VARIANT:
        raise ValueError(f"unknown v3 variant {variant!r}; expected one of "
                         f"{VARIANTS}")
    qw.check_drain_at(drain_at)
    qw.check_binary(scene)
    if variant == "nocond" and scene.binary_root < 0:
        raise ValueError("nocond drops every leaf, and the root is one: the "
                         "TPU kernel's loop would never end")


def run_closest_v3(origin, direction, t_max, scene, drain_at=qw.DRAIN_AT,
                   variant="base"):
    """Closest hit of rays f32[N,3] against the binary tree of `scene` by
    the deferred-leaf walk (t_min 1e-3, t_max scalar or f32[N]; a ray with
    t_max <= 1e-3 is not walked). Returns (t f32[N], tri i32[N], u f32[N],
    v f32[N], nit i32[N], nleaf i32[N])."""
    _check(scene, drain_at, variant)
    o, d, tm = _ray_inputs(origin, direction, t_max, None)
    if o.is_cuda:
        return _closest_v3_cuda(o, d, tm, scene, drain_at,
                                _KERNEL_VARIANT[variant])
    return closest_v3_plain(o, d, tm, scene.binary_root, scene.pnodes,
                            scene.ptris, drain_at, variant)


def closest_v3_plain(origin, direction, t_max, root, pnodes, ptris, drain_at,
                     variant, leaf_test=_serial_leaf):
    """Plain torch version of lab_closest_queued's `variant`. Returns (t,
    tri, u, v, nit, nleaf). `leaf_test`, queue_walk.queued_walk's leaf
    hook, replaces the every-slot serial leaf."""
    n = origin.shape[0]
    counts = tuple(torch.zeros((n,), dtype=torch.int32, device=origin.device)
                   for _ in range(2))
    step = qw.binary_step(origin, _inv_dir(direction), pnodes,
                          dblread=variant == "dblread")
    hit = qw.queued_walk(origin, direction, t_max, root, ptris, step,
                         leaf_test=leaf_test, drain_at=drain_at,
                         drop_leaves=variant == "nocond", counts=counts)
    return (*hit, *counts)


def _closest_v3_cuda(origin, direction, t_max, scene, drain_at,
                     variant_code):
    """L4 on the card: the pnodes rows, ptris and its leaf counts, the
    binary tree's stack need (bt.stack_need: its internal nodes pending,
    at most one a level, fit with room to spare) and a ray counter of its
    own; then drain_at and the variant."""
    global closest_launches
    n, dev = _check_rays(origin, direction, t_max)
    qt._check_n(n)
    need = bt.stack_need(scene)
    qw.check_need(need, "binary-BVH")
    out = qw.hit_outputs(n, dev, counters=True)
    if n:
        args, _counter = bt._launch_args(scene, dev, need)
        qw.launch("lab_closest_queued", dev, _ptr(origin), _ptr(direction),
                  _ptr(t_max), n, *args, drain_at, variant_code,
                  *(_ptr(t) for t in out))
        closest_launches += 1
    return out


# --------------------------------------------------------------------------
# The lab.
# --------------------------------------------------------------------------

def run(scene, sets, variants=VARIANTS, drain_at=qw.DRAIN_AT, reps=REPS,
        log=print):
    """K3 and every variant on every closest-hit set; prints one line each.
    Returns {(set, variant): stats} (and {(set, "k3"): stats}) with the
    outputs under "out"; on the card it first prints each variant's launch
    shape."""
    for variant in variants if scene.ptris.is_cuda else ():
        log(qw.launch_line(f"L4 {variant}", qw.l4_kernel(variant),
                           bt.stack_need(scene), scene.ptris.device))
    results = {}
    for label, (o, d, tm) in sets.items():
        k3 = bt.intersect_bvh_binary(o, d, scene, T_MIN, tm)
        k3_ms = lab_rays.cuda_ms(
            lambda: bt.intersect_bvh_binary(o, d, scene, T_MIN, tm), reps)
        results[(label, "k3")] = dict(ms=k3_ms, out=tuple(k3[:4]))
        log(f"v3 {label:15s} K3 binary_closest   {k3_ms:8.3f} ms")
        for variant in variants:
            out = run_closest_v3(o, d, tm, scene, drain_at, variant)
            ms = lab_rays.cuda_ms(
                lambda: run_closest_v3(o, d, tm, scene, drain_at, variant),
                reps)
            flips, tri_diff, max_dt = against(out, k3)
            mism = lab_rays.parity_mismatches(out, k3)
            mean, p90, leaf = qw.step_stats(out[4:], tm)
            results[(label, variant)] = dict(
                ms=ms, flips=flips, tri_diff=tri_diff, max_dt=max_dt,
                mism=mism, steps_mean=mean, steps_p90=p90, leaf_steps=leaf,
                out=out)
            log(f"v3 {label:15s} {variant:8s} drain{drain_at:2d} {ms:8.3f} ms"
                f"  mism {mism}  steps mean {mean:.3f} p90 {p90:.0f}  leaf "
                f"steps {leaf:.3f}  ({k3_ms / ms:.2f}x K3; hit flips {flips},"
                f" tri diff {tri_diff})")
    return results


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--width", type=int, default=lab_rays.WIDTH)
    p.add_argument("--height", type=int, default=lab_rays.HEIGHT)
    p.add_argument("--drain-at", type=int, nargs="+", default=[qw.DRAIN_AT],
                   help="one or more drain thresholds, each run in turn")
    p.add_argument("--reps", type=int, default=REPS)
    args = p.parse_args(argv)
    device = lab_rays.require_cuda()
    scene = lab_rays.atrium(LEAF_SIZE, device)
    sets = lab_rays.closest_sets(scene, args.width, args.height)
    for drain_at in args.drain_at:
        run(scene, sets, drain_at=drain_at, reps=args.reps,
            log=lambda m: print(m, flush=True))
    print(f"v3_kernel_lab on {lab_rays.card_line()} (SM clock read after "
          "the runs)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
