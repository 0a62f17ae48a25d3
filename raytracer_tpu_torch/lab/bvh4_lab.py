"""BVH4 lab L2: the 4-wide tree's closest hit, with the nearest hit child
pushed last (`ordered`) or the children pushed in order 0..3 (`noorder`),
the port's counterpart of tools/bvh4_lab.py (`run_closest4` :302).

    python -m raytracer_tpu_torch.lab.bvh4_lab [--width W --height H]

Bakes the atrium with leaf 8 (as the JAX lab), and on each ray set of
lab.rays.closest_sets times K1 (ops/quad_traverse.intersect_quad, the JAX
lab's sub-packet baseline) and both orders of the lab kernel (CUDA events,
mean of 5), and prints the speed-up over K1 and the hit flips, triangle
differences and largest |dt| on common hits against K1.

It runs on the bake's qnodes/qmeta: tools/bvh4_lab.py's collapse_bvh4 and
the bake's (raytracer_tpu/accel/bvh.py:334) give the same child boxes and
metas. The TPU kernel's deferred leaf queue exists because Mosaic has no
per-lane gathers; here leaves go on the ray's own stack, so against the JAX
kernel only hits at exactly equal t may name another triangle. `ordered`
is K1's own walk, and equals K1 on every ray. No counters: the TPU kernel
has none.

On CUDA tensors the wrapper launches csrc/lab_traverse.cu:lab_closest4,
K1's machinery (persistent warps, the stack in shared memory sized by the
tree's stack need with the entry visited next in a register, each node's
metas read from its qnodes row, each leaf tested up to its count); on CPU
tensors it runs the plain torch version below, which the kernel equals bit
for bit.
"""

from __future__ import annotations

import argparse
import sys

import torch

from raytracer_tpu_torch.lab import queue_walk as qw
from raytracer_tpu_torch.lab import rays as lab_rays
from raytracer_tpu_torch.ops import quad_traverse as qt
from raytracer_tpu_torch.ops.quad_traverse import (
    CAP,
    T_MIN,
    _check_rays,
    _closest_walk,
    _inv_dir,
    _ptr,
    _quad_fixed_visit,
    _quad_near_last_visit,
    _ray_inputs,
)

LEAF_SIZE = 8
ORDERS = ("ordered", "noorder")
REPS = 5

# Kernel launches, counted where the CUDA wrapper launches.
closest4_launches = 0


def reset_launch_counts():
    global closest4_launches
    closest4_launches = 0


def run_closest4(origin, direction, t_max, scene, ordered=True):
    """Closest hit of rays f32[N,3] against the 4-wide tree of `scene`
    (t_min 1e-3; a ray with t_max <= 1e-3 is not walked). Returns (t
    f32[N], tri i32[N], u f32[N], v f32[N])."""
    qw.check_need(scene.q_stack_need, "quad-BVH")
    o, d, tm = _ray_inputs(origin, direction, t_max, None)
    if o.is_cuda:
        return _closest4_cuda(o, d, tm, scene, ordered)
    return closest4_plain(o, d, tm, scene.root, scene.qmeta, scene.qnodes,
                          scene.ptris, ordered)


def closest4_plain(origin, direction, t_max, root, qmeta, qnodes, ptris,
                   ordered, counts=None, leaf_test=qt._serial_leaf):
    """Plain torch version of lab_closest4. Returns (t, tri, u, v).
    `counts` (nvisit, nleaf), i32[N] each, adds up each ray's pops: the
    kernel has no counters, but walks the same nodes. `leaf_test` is
    quad_traverse._closest_walk's leaf hook."""
    step = _quad_near_last_visit if ordered else _quad_fixed_visit
    visit = step(origin, _inv_dir(direction), qmeta, qnodes)
    return _closest_walk(origin, direction, t_max, root, ptris, visit, CAP,
                         T_MIN, leaf_test=leaf_test, counts=counts)


def _closest4_cuda(origin, direction, t_max, scene, ordered):
    """L2 on the card: the qnodes rows (their metas in float4 6; qmeta is
    not read), ptris and its leaf counts, the tree's stack need and a ray
    counter of its own."""
    global closest4_launches
    n, dev = _check_rays(origin, direction, t_max)
    qt._check_n(n)
    qw.check_quad_rows(scene, dev)
    out = qw.hit_outputs(n, dev)
    if n:
        args, _counter = qt._walk_args(scene.ptris, dev, scene.root,
                                       scene.qnodes, scene.q_stack_need)
        qw.launch("lab_closest4", dev, _ptr(origin), _ptr(direction),
                  _ptr(t_max), n, *args, int(ordered),
                  *(_ptr(t) for t in out), library="lab_traverse")
        closest4_launches += 1
    return out


def against(out, ref):
    """(hit flips, triangle differences on common hits, max |dt| on common
    hits) of closest-hit outputs (t, tri, ...) against a HitRecord or
    another output."""
    hit, ref_hit = out[1] >= 0, ref[1] >= 0
    both = hit & ref_hit
    dt = (out[0] - ref[0]).abs()[both]
    tri_diff = both & (out[1] != ref[1])
    return (int((hit != ref_hit).sum()), int(tri_diff.sum()),
            float(dt.max()) if dt.numel() else 0.0)


def run(scene, sets, reps=REPS, log=print):
    """K1 and both orders on every closest-hit set; prints one line each.
    Returns {(set, order): stats} (and {(set, "k1"): stats}) with the
    outputs under "out"; on the card it first prints each order's launch
    shape."""
    for order in ORDERS if scene.ptris.is_cuda else ():
        log(qw.launch_line(f"L2 {order}", f"closest4_{order}",
                           scene.q_stack_need, scene.ptris.device))
    results = {}
    for label, (o, d, tm) in sets.items():
        k1 = qt.intersect_quad(o, d, scene, T_MIN, tm)
        k1_ms = lab_rays.cuda_ms(
            lambda: qt.intersect_quad(o, d, scene, T_MIN, tm), reps)
        results[(label, "k1")] = dict(ms=k1_ms, out=tuple(k1[:4]))
        log(f"bvh4 {label:15s} K1 quad_closest      {k1_ms:8.3f} ms")
        for order in ORDERS:
            ordered = order == "ordered"
            out = run_closest4(o, d, tm, scene, ordered)
            ms = lab_rays.cuda_ms(
                lambda: run_closest4(o, d, tm, scene, ordered), reps)
            flips, tri_diff, max_dt = against(out, k1)
            results[(label, order)] = dict(ms=ms, flips=flips,
                                           tri_diff=tri_diff, max_dt=max_dt,
                                           out=out)
            log(f"bvh4 {label:15s} closest4 {order:8s}   {ms:8.3f} ms  "
                f"({k1_ms / ms:.2f}x K1)  hit flips {flips}  tri diff "
                f"{tri_diff}  max|dt| {max_dt:.2e}")
    return results


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--width", type=int, default=lab_rays.WIDTH)
    p.add_argument("--height", type=int, default=lab_rays.HEIGHT)
    p.add_argument("--reps", type=int, default=REPS)
    args = p.parse_args(argv)
    device = lab_rays.require_cuda()
    scene = lab_rays.atrium(LEAF_SIZE, device)
    print(f"bvh4 tree: {scene.qnodes.shape[0]} quad nodes, "
          f"{scene.pnodes.shape[0]} binary internal nodes", flush=True)
    sets = lab_rays.closest_sets(scene, args.width, args.height)
    run(scene, sets, args.reps, log=lambda m: print(m, flush=True))
    print(f"bvh4_lab on {lab_rays.card_line()} (SM clock read after "
          "the runs)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
