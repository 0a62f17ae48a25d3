"""Round-3 occlusion lab L8: the deferred-leaf any-hit walk on the 4-wide
tree with the near child pushed last, the port's counterpart of
tools/r3_occl3_lab.py (`_occlusion_kernel_ordered` :36, `run_occl_ordered`
and its `pallas_call` :129-146).

    python -m raytracer_tpu_torch.lab.r3_occl3_lab [--width W --height H
        --reps R]

Bakes the atrium with leaf 8 (as the JAX lab) and on each shadow batch of
lab.rays.shadow_sets (bounce 0; bounce 1 in the renderer's and in the
sorted order), and on the sorted bounce-1 batch sorted again by its own
origin (the JAX lab's order, tools/r3_occl3_lab.py:207-213:
lab.rays.resort_key; the sort timed apart, as occl_lab's resort), times K2
(ops/quad_traverse.occlusion_quad, the production any-hit kernel) and both
orders of L8 (CUDA events, mean of 5), runs each order's plain version
once (host clock) for its steps, and prints each order's launch shape, the
speed-up over K2, the rays whose mask differs from K2's, and the steps and
leaf steps per live ray.

Orders:
  ordered  the JAX lab's: the 2-bit argmin of t_near (:95-98) picks the
           near child, pushed last so that it pops first
  fixed    every hit child in child order: the production K2's own walk
           (raytracer_tpu/ops/pallas_subpacket.py:486-490) in queued form,
           so that L8 against it changes the order alone (the port's K2
           keeps its leaves on the stack)

Per ray: a leaf step tests its block against t_max, a triangle of the
ray's skip_object (compared as f32) not counting, and an occluded ray stops
(the per-row exit of :68-78); an internal step slab-tests against [1e-3,
t_max]. The slab cap never shrinks, so the mask does not depend on the
order: both orders equal K2's mask on every ray, and only the steps and
the time move.

On CUDA tensors the wrapper launches csrc/lab2_traverse.cu:
lab_occlusion4_queued, persistent warps with the stack (the 4-wide tree's
q_stack_need) and the leaf queue in shared memory, reading each node's
metas from its qnodes row and each leaf up to its count; an occluded ray
frees its lane at once. On CPU tensors it runs the plain torch version,
which the kernel equals bit for bit.
"""

from __future__ import annotations

import argparse
import sys

import torch

from raytracer_tpu_torch.lab import queue_walk as qw
from raytracer_tpu_torch.lab import rays as lab_rays
from raytracer_tpu_torch.lab.occl_lab import resort_perm
from raytracer_tpu_torch.ops import quad_traverse as qt
from raytracer_tpu_torch.ops.quad_traverse import (
    T_MIN,
    _check_rays,
    _inv_dir,
    _ptr,
    _ray_inputs,
    _require,
)

LEAF_SIZE = 8
ORDERS = {"ordered": True, "fixed": False}
REPS = 5

# Kernel launches, counted where the CUDA wrapper launches.
occlusion_launches = 0


def reset_launch_counts():
    global occlusion_launches
    occlusion_launches = 0


def run_occl_ordered(origin, direction, t_max, skip_object, scene,
                     ordered=True):
    """Any hit in (1e-3, t_max) of rays f32[N,3] by a triangle whose object
    is not the ray's skip_object (i32[N]), by the queued walk on the 4-wide
    tree of `scene`, the near child pushed last (`ordered`) or every child
    in child order; a ray with t_max <= 1e-3 is inactive. Returns occ
    bool[N]."""
    if not isinstance(ordered, bool):
        raise ValueError(f"unknown order {ordered!r}: ordered is True (near "
                         "child last) or False (child order)")
    qw.check_need(scene.q_stack_need, "quad-BVH")
    qw.check_drain_at(qw.DRAIN_AT, 4)
    o, d, tm = _ray_inputs(origin, direction, t_max, None)
    skip = torch.as_tensor(skip_object, device=o.device).to(
        torch.int32).expand(o.shape[0]).contiguous()
    if o.is_cuda:
        return _occl_ordered_cuda(o, d, tm, skip, scene, ordered)
    return occl_ordered_plain(o, d, tm, skip, scene.root, scene.qmeta,
                              scene.qnodes, scene.ptris, ordered)


def occl_ordered_plain(origin, direction, t_max, skip_object, root, qmeta,
                       qnodes, ptris, ordered, counts=None,
                       leaf_test=qt._any_leaf):
    """Plain torch version of lab_occlusion4_queued. Returns occ bool[N].
    `counts` (nit, nleaf), i32[N] each, adds up each ray's steps and leaf
    steps: the kernel has no counters, but takes the same steps.
    `leaf_test` is queue_walk.queued_any_walk's leaf hook."""
    step = qw.quad_step(origin, _inv_dir(direction), qmeta, qnodes, ordered)
    return qw.queued_any_walk(origin, direction, t_max, skip_object, root,
                              ptris, step, counts=counts, leaf_test=leaf_test)


def _occl_ordered_cuda(origin, direction, t_max, skip_object, scene,
                       ordered):
    """L8 on the card: the qnodes rows (their metas in float4 6; qmeta is
    not read), ptris and its leaf counts, the tree's stack need and a ray
    counter of its own."""
    global occlusion_launches
    n, dev = _check_rays(origin, direction, t_max)
    qt._check_n(n)
    _require("skip_object", skip_object, torch.int32, (n,), dev)
    qw.check_quad_rows(scene, dev)
    occ = torch.empty((n,), dtype=torch.bool, device=dev)
    if n:
        args, _counter = qt._walk_args(scene.ptris, dev, scene.root,
                                       scene.qnodes, scene.q_stack_need)
        qw.launch("lab_occlusion4_queued", dev, _ptr(origin),
                  _ptr(direction), _ptr(t_max), _ptr(skip_object), n, *args,
                  qw.DRAIN_AT, int(ordered), _ptr(occ))
        occlusion_launches += 1
    return occ


def resorted(sets, scene, reps=REPS):
    """sets plus "shadow_b1_resort": shadow_b1_sorted permuted by
    occl_lab's resort key (inactive last, then the origin's position
    Morton code), and the ms of that sort and gather (CUDA events, mean of
    `reps`)."""
    o, d, tm, skip, active = sets["shadow_b1_sorted"]

    def sort():
        perm = resort_perm(o, tm, scene)
        return tuple(a[perm] for a in (o, d, tm, skip, active))

    out = dict(sets)
    out["shadow_b1_resort"] = sort()
    return out, lab_rays.cuda_ms(sort, reps)


def run(scene, sets, reps=REPS, log=print, leaf_hooks=None):
    """K2 and both orders on every shadow set and on the resorted bounce-1
    batch, and each order's plain version once for its steps; prints one
    line each. Returns {(set, "k2"): stats, (set, order): stats} with the
    kernels' outputs under "out" and the plain versions' under "plain"
    (host ms "plain_ms", counts "counts"); the resorted set's K2 stats hold
    the sort's ms ("sort_ms"). `leaf_hooks`, as r3_oct_lab.run's, makes
    each plain run test its leaves through a new any-hit hook and puts the
    hook's total under "tests"."""
    sets, sort_ms = resorted(sets, scene, reps)
    for order in ORDERS if scene.ptris.is_cuda else ():
        log(qw.launch_line(f"L8 {order}", f"occlusion_{order}",
                           scene.q_stack_need, scene.ptris.device))
    results = {}
    for label, (o, d, tm, skip, _active) in sets.items():
        k2 = qt.occlusion_quad(o, d, T_MIN, tm, scene, skip)
        k2_ms = lab_rays.cuda_ms(
            lambda: qt.occlusion_quad(o, d, T_MIN, tm, scene, skip), reps)
        results[(label, "k2")] = dict(ms=k2_ms, out=k2)
        sort = ""
        if label == "shadow_b1_resort":
            results[(label, "k2")]["sort_ms"] = sort_ms
            sort = f" (+ sort {sort_ms:.3f} ms)"
        live = int((tm > T_MIN).sum())
        log(f"occl3 {label:17s} K2 quad_occlusion {k2_ms:8.3f} ms{sort}, "
            f"{int(k2.sum())} of {live} live rays occluded")
        for order, ordered in ORDERS.items():
            out = run_occl_ordered(o, d, tm, skip, scene, ordered)
            ms = lab_rays.cuda_ms(
                lambda: run_occl_ordered(o, d, tm, skip, scene, ordered),
                reps)
            counts = tuple(torch.zeros_like(tm, dtype=torch.int32)
                           for _ in range(2))
            _, leaf_test, total = (leaf_hooks() if leaf_hooks
                                   else (None, qt._any_leaf, None))
            plain, plain_ms = lab_rays.host_ms(
                lambda: occl_ordered_plain(o, d, tm, skip, scene.root,
                                           scene.qmeta, scene.qnodes,
                                           scene.ptris, ordered, counts,
                                           leaf_test))
            mism = int((out != k2).sum())
            steps, p90, leaf_steps = qw.step_stats(counts, tm)
            results[(label, order)] = dict(
                ms=ms, mism=mism, out=out, plain=plain, plain_ms=plain_ms,
                counts=counts, tests=total[0] if total else None)
            log(f"occl3 {label:17s} {order:8s} {ms:8.3f} ms "
                f"({k2_ms / ms:.3f}x K2)  mask mism vs K2 {mism}; "
                f"steps/ray mean {steps:.3f} p90 {p90:.0f}, leaf steps "
                f"{leaf_steps:.3f}; plain {plain_ms:.1f} ms")
    return results


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--width", type=int, default=lab_rays.WIDTH)
    p.add_argument("--height", type=int, default=lab_rays.HEIGHT)
    p.add_argument("--reps", type=int, default=REPS)
    args = p.parse_args(argv)
    device = lab_rays.require_cuda()
    scene = lab_rays.atrium(LEAF_SIZE, device)
    sets = lab_rays.shadow_sets(scene, args.width, args.height)
    run(scene, sets, args.reps, log=lambda m: print(m, flush=True))
    print(f"r3_occl3_lab on {lab_rays.card_line()} (SM clock read after "
          "the runs)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
