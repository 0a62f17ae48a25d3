"""Occlusion lab L9: the binary tree's any-hit kernel with per-ray visit
counters on the NEE shadow-ray workload, the port's counterpart of
tools/occl_lab.py (`run_occl_lab` :163).

    python -m raytracer_tpu_torch.lab.occl_lab [--width W --height H]

Bakes the atrium with leaf 8 (as the JAX lab), prints each kernel's launch
shape, builds the shadow batches of lab.rays.shadow_sets (bounce 0; bounce
1 in the renderer's and in the sorted order) and prints K4's time
(ops/binary_traverse.occlusion_bvh_binary, the walk the lab counts) and per
variant the kernel time (CUDA events, mean of 5) and its ratio to K4's,
visits per active ray, the leaf share and the occluded share.

Variants:
  base, lean  K4's walk with counters; one kernel serves both names (where
              the TPU packet refreshes its union cap and its all-occluded
              check only matters across lanes); its mask equals K4's
  noorder     children pushed right first, so left pops first (no
              near/far order)
  resort      lean on the rays permuted by occl_lab's key (inactive last,
              then position Morton, lab.rays.resort_key); the outputs are
              scattered back, so they equal lean's and only the time moves

On CUDA tensors the wrapper launches csrc/lab_traverse.cu:lab_occlusion,
K4's machinery (persistent warps, the stack in shared memory below the
entry kept in a register, bt.stack_need(scene) entries a thread, leaves
tested up to their counts); on CPU tensors it runs the plain torch
versions below, which the kernel equals bit for bit (counts included).
"""

from __future__ import annotations

import argparse
import sys

import torch

from raytracer_tpu_torch.lab import queue_walk as qw
from raytracer_tpu_torch.lab import rays as lab_rays
from raytracer_tpu_torch.ops import binary_traverse as bt
from raytracer_tpu_torch.ops import quad_traverse as qt
from raytracer_tpu_torch.ops.binary_traverse import STACK_CAP, _binary_visit
from raytracer_tpu_torch.ops.quad_traverse import (
    T_MIN,
    _any_leaf,
    _any_walk,
    _check_rays,
    _inv_dir,
    _ptr,
    _ray_inputs,
    _require,
)

LEAF_SIZE = 8
VARIANTS = ("base", "lean", "noorder", "resort")
REPS = 5

# Kernel launches, counted where the CUDA wrapper launches.
occlusion_launches = 0


def reset_launch_counts():
    global occlusion_launches
    occlusion_launches = 0


def run_occl_lab(origin, direction, t_max, skip_object, scene, variant):
    """Any hit in (1e-3, t_max) of rays f32[N,3] by a triangle whose object
    is not the ray's skip_object (i32[N]); a ray with t_max <= 1e-3 is
    inactive. Returns (occ bool[N], nvisit i32[N], nleaf i32[N])."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown occlusion-lab variant {variant!r}; "
                         f"expected one of {VARIANTS}")
    bt._check_stack(scene)
    o, d, tm = _ray_inputs(origin, direction, t_max, None)
    skip = torch.as_tensor(skip_object, device=o.device).to(
        torch.int32).expand(o.shape[0]).contiguous()
    ordered = variant != "noorder"
    if variant != "resort":
        return _occl(o, d, tm, skip, scene, ordered)
    perm = resort_perm(o, tm, scene)
    got = _occl(o[perm], d[perm], tm[perm], skip[perm], scene, ordered)
    out = tuple(torch.empty_like(g) for g in got)
    for dst, src in zip(out, got):
        dst[perm] = src
    return out


def resort_perm(origin, t_max, scene):
    """The resort variant's permutation: a stable sort by
    lab.rays.resort_key, a ray being inactive where t_max <= 1e-3."""
    return torch.argsort(lab_rays.resort_key(origin, t_max > T_MIN, scene),
                         stable=True)


def _occl(origin, direction, t_max, skip, scene, ordered):
    if origin.is_cuda:
        return _occl_lab_cuda(origin, direction, t_max, skip, scene, ordered)
    return occl_lab_plain(origin, direction, t_max, skip, scene.binary_root,
                          scene.pnodes, scene.ptris, ordered)


def occl_lab_plain(origin, direction, t_max, skip_object, root, pnodes,
                   ptris, ordered, leaf_test=_any_leaf):
    """Plain torch version of lab_occlusion. Returns (occ, nvisit, nleaf).
    `leaf_test` is quad_traverse._any_walk's leaf hook."""
    n = origin.shape[0]
    counts = tuple(torch.zeros((n,), dtype=torch.int32, device=origin.device)
                   for _ in range(2))
    visit = _binary_visit(origin, _inv_dir(direction), pnodes, T_MIN,
                          ordered=ordered)
    occ = _any_walk(origin, direction, t_max, skip_object, root, ptris, visit,
                    STACK_CAP, T_MIN, counts=counts, leaf_test=leaf_test)
    return (occ, *counts)


def _occl_lab_cuda(origin, direction, t_max, skip_object, scene, ordered):
    """L9 on the card: the pnodes rows, ptris and its leaf counts, the
    tree's stack need (bt.stack_need) and a ray counter of its own."""
    global occlusion_launches
    n, dev = _check_rays(origin, direction, t_max)
    qt._check_n(n)
    _require("skip_object", skip_object, torch.int32, (n,), dev)
    out = (torch.empty((n,), dtype=torch.bool, device=dev),
           torch.empty((n,), dtype=torch.int32, device=dev),
           torch.empty((n,), dtype=torch.int32, device=dev))
    if n:
        args, _counter = bt._launch_args(scene, dev)
        qw.launch("lab_occlusion", dev, _ptr(origin), _ptr(direction),
                  _ptr(t_max), _ptr(skip_object), n, *args, int(ordered),
                  *(_ptr(t) for t in out), library="lab_traverse")
        occlusion_launches += 1
    return out


def launch_lines(scene, device):
    """The launch shape of both L9 kernels on `scene` (queue_walk
    .launch_line)."""
    return [qw.launch_line(f"L9 {order}", f"lab_occlusion_{order}",
                           bt.stack_need(scene), device)
            for order in ("ordered", "noorder")]


def run(scene, sets, reps=REPS, log=print):
    """K4, then every variant, on every shadow set of lab.rays.shadow_sets;
    prints one line each (on the card, first each kernel's launch shape).
    Returns {(set, name): stats} with name "k4" or a variant, the outputs
    under "out". As in the JAX lab, resort's time is the kernel's on the
    permuted rays; the sort and the gathers are timed apart ("sort_ms")."""
    if scene.ptris.is_cuda:
        for line in launch_lines(scene, scene.ptris.device):
            log(line)
    results = {}
    for label, (o, d, tm, skip, _active) in sets.items():
        live = int((tm > T_MIN).sum())
        k4 = bt.occlusion_bvh_binary(o, d, T_MIN, tm, scene, skip)
        k4_ms = lab_rays.cuda_ms(
            lambda: bt.occlusion_bvh_binary(o, d, T_MIN, tm, scene, skip),
            reps)
        results[(label, "k4")] = dict(ms=k4_ms, out=(k4,))
        log(f"occl {label:16s} K4       {k4_ms:8.3f} ms")
        for variant in VARIANTS:
            out = run_occl_lab(o, d, tm, skip, scene, variant)
            sort_ms = None
            if variant == "resort":
                perm = resort_perm(o, tm, scene)
                args = (o[perm], d[perm], tm[perm], skip[perm])
                ms = lab_rays.cuda_ms(lambda: _occl(*args, scene, True), reps)
                sort_ms = lab_rays.cuda_ms(
                    lambda: [a[p] for p in [resort_perm(o, tm, scene)]
                             for a in (o, d, tm, skip)], reps)
            else:
                ms = lab_rays.cuda_ms(
                    lambda: run_occl_lab(o, d, tm, skip, scene, variant),
                    reps)
            visits, leaves = int(out[1].sum()), int(out[2].sum())
            s = results[(label, variant)] = dict(
                ms=ms, rays=live, visits=visits, leaves=leaves,
                visits_per_ray=visits / max(live, 1),
                leaf_share=leaves / max(visits, 1),
                ns_per_visit=ms * 1e6 / max(visits, 1),
                occluded=int(out[0].sum()), sort_ms=sort_ms, out=out)
            sort = "" if sort_ms is None else f" (+ sort {sort_ms:.3f} ms)"
            log(f"occl {label:16s} {variant:8s} {ms:8.3f} ms ({ms / k4_ms:.2f}"
                f"x K4){sort}  visits/ray {s['visits_per_ray']:7.3f} (leaf "
                f"{100 * s['leaf_share']:.0f}%)  ns/visit "
                f"{s['ns_per_visit']:.5f}  occluded "
                f"{100 * s['occluded'] / max(live, 1):.0f}% of {live}")
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
    print(f"occl_lab on {lab_rays.card_line()} (SM clock read after "
          "the runs)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
