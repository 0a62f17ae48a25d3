"""Kernel lab L3: the binary tree's closest hit over component-major leaf
rows with a one-pass leaf reduction, the port's counterpart of
tools/v2_kernel_lab.py (`run_closest_v2` :164, its `pallas_call` :174).

    python -m raytracer_tpu_torch.lab.v2_kernel_lab [--width W --height H]

Bakes the atrium with leaf 8 (as the JAX lab), lays its leaf rows out
component-major (`to_component_major`) and on each ray set of
lab.rays.closest_sets times K3 (ops/binary_traverse.intersect_bvh_binary,
the JAX lab's production reference), L1 `base` and `leafilp`
(lab/kernel_lab.py: K3's walk with counters, its row-major leaf grouped to
the row's count or every slot through the ILP leaf) on the same bake, and
the lab kernel (CUDA events, mean of 5), and prints the mismatches against
K3 (the JAX lab's count: triangle differs and t not within rtol 1e-5). On
the card it first prints the kernel's launch shape.

The walk is K3's: leaves on the stack, the ordered binary step. A leaf
(tools/v2_kernel_lab.py:82-118, per ray) tests all its triangles against
the entry best t, takes the least valid t and, among the triangles at that
t, the largest triangle index (not the serial leaf's first; -1 takes part
in that max unless every triangle is at that t, as in the TPU kernel), and
keeps them if that t is below the best t. The kernel reads each of the 10
components a triangle needs (v0, e1, e2, tri) as float4 loads of 4
triangles; the object and pad components are never read. It returns no u,
v (the TPU kernel has none). The TPU kernel's tile height (8 or 16 rows)
has no per-ray meaning: the results do not depend on it.

On CUDA tensors the wrapper launches csrc/lab2_traverse.cu:lab_closest_cm,
K3's persistent walk (persistent_walk.cuh's closest_walk: the stack in
shared memory, bt.stack_need(scene) entries a thread, the next entry in a
register) with a leaf hook that stops each row at the float4 group holding
its last real triangle (`cm_groups`; the counts are those of the row-major
ptris); on CPU tensors it runs the plain torch version, every slot of each
row, which the kernel equals bit for bit.
"""

from __future__ import annotations

import argparse
import sys

import torch

from raytracer_tpu_torch.lab import kernel_lab
from raytracer_tpu_torch.lab import queue_walk as qw
from raytracer_tpu_torch.lab import rays as lab_rays
from raytracer_tpu_torch.lab.fixed_seq import sat_i32
from raytracer_tpu_torch.lab.bvh4_lab import against
from raytracer_tpu_torch.ops import binary_traverse as bt
from raytracer_tpu_torch.ops import quad_traverse as qt
from raytracer_tpu_torch.ops.binary_traverse import STACK_CAP, _binary_visit
from raytracer_tpu_torch.ops.quad_traverse import (
    BIG,
    T_MIN,
    TRI_STRIDE,
    _check_rays,
    _closest_walk,
    _inv_dir,
    _moller,
    _ptr,
    _ray_inputs,
    _require,
    row_counts,
)

LEAF_SIZE = 8
REPS = 5

# Kernel launches, counted where the CUDA wrapper launches.
closest_launches = 0


def reset_launch_counts():
    global closest_launches
    closest_launches = 0


def to_component_major(ptris):
    """Leaf rows [NB, leaf*12] triangle-major to component-major (as
    tools/v2_kernel_lab.py:35): out[:, leaf*c + k] = in[:, 12*k + c]."""
    nb, width = ptris.shape
    leaf = width // TRI_STRIDE
    return ptris.view(nb, leaf, TRI_STRIDE).transpose(1, 2).reshape(
        nb, width).contiguous()


def run_closest_v2(origin, direction, t_max, scene, ptris_cm):
    """Closest hit of rays f32[N,3] against the binary tree of `scene`, its
    leaf rows given component-major (`ptris_cm`, to_component_major of
    scene.ptris); t_min 1e-3, t_max scalar or f32[N]; a ray with t_max <=
    1e-3 is not walked. Returns (t f32[N], tri i32[N])."""
    bt._check_stack(scene)
    if tuple(ptris_cm.shape) != tuple(scene.ptris.shape):
        raise ValueError(f"ptris_cm has shape {tuple(ptris_cm.shape)}, "
                         f"expected {tuple(scene.ptris.shape)}")
    leaf = ptris_cm.shape[1] // TRI_STRIDE
    if leaf % 4:
        raise ValueError(f"the component-major leaf reads float4s: leaf "
                         f"{leaf} is not a multiple of 4")
    o, d, tm = _ray_inputs(origin, direction, t_max, None)
    if o.is_cuda:
        return _closest_v2_cuda(o, d, tm, scene, ptris_cm)
    return closest_v2_plain(o, d, tm, scene.binary_root, scene.pnodes,
                            ptris_cm)


def _cm_leaf(origin, direction, rows, bt_, btri, bu, bv, t_min):
    """The one-pass leaf of component-major rows [M, leaf*12]: every
    triangle against the entry best t; the least valid t (BIG when none)
    and the TPU kernel's index reduction, max over the triangles of (t at
    the least ? index : -1) (the largest index at the least t, or -1 when
    larger and some triangle is above it), kept if below the best t. u, v
    pass through unchanged."""
    ox, oy, oz = origin.unbind(1)
    dx, dy, dz = direction.unbind(1)
    leaf = rows.shape[1] // TRI_STRIDE
    tris = rows.view(-1, TRI_STRIDE, leaf).transpose(1, 2)  # [M, leaf, 12]
    tcs, trik = [], []
    for k in range(leaf):
        tri = tris[:, k]
        t, _, _, valid = _moller(ox, oy, oz, dx, dy, dz, tri, bt_, t_min)
        tcs.append(torch.where(valid, t, BIG))
        trik.append(sat_i32(tri[:, 9]))
    tc, trik = torch.stack(tcs, 1), torch.stack(trik, 1)
    tmin = tc.amin(1)
    trimax = torch.where(tc == tmin[:, None], trik, -1).amax(1)
    win = tmin < bt_
    return torch.where(win, tmin, bt_), torch.where(win, trimax, btri), bu, bv


def cm_row_counts(rows):
    """i64[M]: row_counts of component-major leaf rows [M, leaf*12] (those
    of the row-major rows they hold)."""
    m, width = rows.shape
    leaf = width // TRI_STRIDE
    return row_counts(rows.view(m, TRI_STRIDE, leaf).transpose(1, 2)
                      .reshape(m, width)).to(torch.int64)


def cm_groups(rows, bt_):
    """i64[M]: the float4 groups of 4 triangles lab_closest_cm tests in each
    component-major leaf row of `rows` [M, leaf*12] for best t `bt_`: up to
    the group that holds the row's last real triangle (cm_row_counts; at
    least one) while the best t is below BIG, else every group. The slots
    it skips never change the leaf's result."""
    leaf = rows.shape[1] // TRI_STRIDE
    count = cm_row_counts(rows)
    return torch.where(bt_ < BIG, torch.clamp_min((count + 3) // 4, 1),
                       leaf // 4)


def closest_v2_plain(origin, direction, t_max, root, pnodes, ptris_cm,
                     counts=None, leaf_test=_cm_leaf):
    """Plain torch version of lab_closest_cm. Returns (t, tri). `counts`
    (nvisit, nleaf), i32[N] each, adds up each ray's pops: the kernel has
    no counters, but pops the same entries. `leaf_test` (called as
    _cm_leaf) replaces the every-slot leaf."""
    visit = _binary_visit(origin, _inv_dir(direction), pnodes, T_MIN)
    t, tri, _, _ = _closest_walk(origin, direction, t_max, root, ptris_cm,
                                 visit, STACK_CAP, T_MIN, leaf_test=leaf_test,
                                 counts=counts)
    return t, tri


def _closest_v2_cuda(origin, direction, t_max, scene, ptris_cm):
    """L3 on the card: the pnodes rows, the component-major rows with the
    leaf counts of scene.ptris (the same triangles), K3's stack need and a
    ray counter of its own. The walk writes u and v (0s) into scratch that
    is dropped."""
    global closest_launches
    n, dev = _check_rays(origin, direction, t_max)
    qt._check_n(n)
    bt._check_scene_arrays(scene, dev)
    _require("ptris_cm", ptris_cm, torch.float32, tuple(scene.ptris.shape),
             dev, vec=True)
    out = qw.hit_outputs(n, dev)
    if n:
        args, _counter = bt._launch_args(scene, dev)
        args = (*args[:2], _ptr(ptris_cm), *args[3:])  # ptris -> ptris_cm
        qw.launch("lab_closest_cm", dev, _ptr(origin), _ptr(direction),
                  _ptr(t_max), n, *args, *(_ptr(t) for t in out))
        closest_launches += 1
    return out[:2]


YARDSTICKS = ("base", "leafilp")  # L1's variants timed beside L3


def run(scene, sets, reps=REPS, log=print):
    """K3, L1's YARDSTICKS and the lab kernel on every closest-hit set;
    prints one line each (on the card, first the kernel's launch shape).
    Returns {(set, "v2"): stats} (and {(set, "k3"): stats}, {(set,
    "l1_<variant>"): stats}) with the outputs under "out"."""
    if scene.ptris.is_cuda:
        log(qw.launch_line("L3", "closest_cm", bt.stack_need(scene),
                           scene.ptris.device))
    ptris_cm = to_component_major(scene.ptris)
    results = {}
    for label, (o, d, tm) in sets.items():
        k3 = bt.intersect_bvh_binary(o, d, scene, T_MIN, tm)
        k3_ms = lab_rays.cuda_ms(
            lambda: bt.intersect_bvh_binary(o, d, scene, T_MIN, tm), reps)
        results[(label, "k3")] = dict(ms=k3_ms, out=tuple(k3[:4]))
        for variant in YARDSTICKS:
            out = kernel_lab.run_closest_lab(o, d, tm, scene, variant)
            ms = lab_rays.cuda_ms(lambda: kernel_lab.run_closest_lab(
                o, d, tm, scene, variant), reps)
            s = results[(label, f"l1_{variant}")] = kernel_lab._stats(
                out, tm, ms)
            leaves = s["leaves"] / max(s["rays"], 1)
            log(f"v2 {label:15s} L1 {variant:8s} {ms:8.3f} ms "
                f"({ms / k3_ms:.2f}x K3)  visits/ray "
                f"{s['visits_per_ray']:.3f} ({leaves:.3f} of them leaves)")
        out = run_closest_v2(o, d, tm, scene, ptris_cm)
        ms = lab_rays.cuda_ms(
            lambda: run_closest_v2(o, d, tm, scene, ptris_cm), reps)
        flips, tri_diff, max_dt = against(out, k3)
        mism = lab_rays.parity_mismatches(out, k3)
        results[(label, "v2")] = dict(ms=ms, flips=flips, tri_diff=tri_diff,
                                      max_dt=max_dt, mism=mism, out=out)
        log(f"v2 {label:15s} K3 {k3_ms:8.3f} ms, v2 component-major "
            f"{ms:8.3f} ms ({k3_ms / ms:.2f}x; {ms / k3_ms:.2f}x K3)  "
            f"mismatches {mism}  (hit flips {flips}, tri diff {tri_diff}, "
            f"max|dt| {max_dt:.2e})")
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
    run(scene, sets, args.reps, log=lambda m: print(m, flush=True))
    print(f"v2_kernel_lab on {lab_rays.card_line()} (SM clock read after "
          "the runs)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
