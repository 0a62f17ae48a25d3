"""Round-3 kernel lab L6: the deferred-leaf walk on the 4-wide tree with
register descent, the division-free Möller–Trumbore and the ILP leaf, the
port's counterpart of tools/r3_kernel_lab.py (`make_closest_kernel` :171,
`run_closest_variant` :323, its `pallas_call` :334).

    python -m raytracer_tpu_torch.lab.r3_kernel_lab [--all | --leafpar |
        [--descent] [--divfree]] [--width W --height H]

Bakes the atrium with leaf 8 (as the JAX lab) and on each ray set of
lab.rays.closest_sets times K1 (ops/quad_traverse.intersect_quad, the
production quad kernel) and each flag combination (CUDA events, mean of 5),
and prints the speed-up over K1 and the triangle mismatches against it.
--all sweeps the four (descent, divfree) combinations, --leafpar the plain
walk and the ILP leaf; otherwise the flags name one combination.

The walk is lab/queue_walk.py's with the 4-wide node step; the flags:
  descent  (tools/r3_kernel_lab.py:196-226, :277-283) the near internal
           child stays in a register (`cur`) and the next internal step
           takes it before it pops; a near leaf goes to the queue. It pops
           in the stack version's order, so it equals it bit for bit
  divfree  (:47-99) per triangle s = det >= 0 ? 1 : -1, a = det*s, up, vp,
           tp scaled by s; accept when a > 1e-10, up >= 0, vp >= 0,
           up + vp <= a, tp > 1e-3*a and tp*den < num*a; the best t is
           (num, den) = (entry best t, 1) through the step and
           t = num*(1/den), u = bu*inv, v = bv*inv at its end. Agrees with
           the serial leaf to rounding (ties within rounding may differ)
  leafpar  (:102-140) the ILP leaf: every triangle against the entry best t,
           a min tree in which a tie keeps the lower k (leaf 8; it takes
           precedence over divfree, as in the JAX lab)

On CUDA tensors the wrapper launches
csrc/lab2_traverse.cu:lab_closest4_queued, persistent warps with the stack
(the 4-wide tree's q_stack_need) and the leaf queue in shared memory,
reading each node's metas from its qnodes row, the serial and
division-free leaves tested up to their counts (the ILP leaf takes the
whole row); descent keeps the stack's top in a register, and without it
every internal child goes through shared memory. On CPU tensors it runs
the plain torch version, which the kernel equals bit for bit.
"""

from __future__ import annotations

import argparse
import sys

import torch

from raytracer_tpu_torch.lab import queue_walk as qw
from raytracer_tpu_torch.lab import rays as lab_rays
from raytracer_tpu_torch.lab.bvh4_lab import against
from raytracer_tpu_torch.lab.kernel_lab import _ilp_leaf
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
ILP_LEAVES = (8,)  # the leaf sizes the ILP kernel is instantiated for
# (descent, divfree, leafpar) of --all and of --leafpar
ALL = ((False, False, False), (True, False, False), (False, True, False),
       (True, True, False))
LEAFPAR = ((False, False, False), (False, False, True))
REPS = 5
_SERIAL, _DIVFREE, _ILP = 0, 1, 2  # the kernel's leaf kinds

# Kernel launches, counted where the CUDA wrapper launches.
closest_launches = 0


def reset_launch_counts():
    global closest_launches
    closest_launches = 0


def name(descent, divfree, leafpar=False):
    """The combination as the JAX lab prints it."""
    return (f"descent={int(descent)} divfree={int(divfree)} "
            f"leafpar={int(leafpar)}")


def run_closest_variant(origin, direction, t_max, scene, descent, divfree,
                        leafpar=False):
    """Closest hit of rays f32[N,3] against the 4-wide tree of `scene` by
    the deferred-leaf walk with the given flags (t_min 1e-3, t_max scalar
    or f32[N]; a ray with t_max <= 1e-3 is not walked). Returns (t f32[N],
    tri i32[N], u f32[N], v f32[N])."""
    qw.check_need(scene.q_stack_need, "quad-BVH")
    qw.check_drain_at(qw.DRAIN_AT, 4)
    leaf = scene.ptris.shape[1] // TRI_STRIDE
    if leafpar and leaf not in ILP_LEAVES:
        raise ValueError(f"leafpar takes leaf sizes {ILP_LEAVES}, got {leaf}")
    o, d, tm = _ray_inputs(origin, direction, t_max, None)
    if o.is_cuda:
        return _closest_variant_cuda(o, d, tm, scene, descent,
                                     _leaf_kind(divfree, leafpar))
    return closest_variant_plain(o, d, tm, scene.root, scene.qmeta,
                                 scene.qnodes, scene.ptris, descent, divfree,
                                 leafpar)


def _leaf_kind(divfree, leafpar):
    return _ILP if leafpar else _DIVFREE if divfree else _SERIAL


def launch_kernel(descent, divfree, leafpar=False):
    """The queue_walk.launch_info key of the combination's kernel."""
    return qw.l6_kernel(descent, _leaf_kind(divfree, leafpar))


def _divfree_leaf(origin, direction, rows, bt_, btri, bu, bv, t_min):
    """tools/r3_kernel_lab.py:47 _leaf_step_divfree per ray: the accept test
    in det-scaled space, (num, den) = (entry best t, 1), one divide at the
    end. The operation order is the kernel's."""
    ox, oy, oz = origin.unbind(1)
    dx, dy, dz = direction.unbind(1)
    num, den = bt_, torch.ones_like(bt_)
    for k in range(rows.shape[1] // TRI_STRIDE):
        tri = rows[:, k * TRI_STRIDE:(k + 1) * TRI_STRIDE]
        v0x, v0y, v0z = tri[:, 0], tri[:, 1], tri[:, 2]
        e1x, e1y, e1z = tri[:, 3], tri[:, 4], tri[:, 5]
        e2x, e2y, e2z = tri[:, 6], tri[:, 7], tri[:, 8]
        px = dy * e2z - dz * e2y
        py = dz * e2x - dx * e2z
        pz = dx * e2y - dy * e2x
        det = e1x * px + e1y * py + e1z * pz
        s = torch.where(det >= 0.0, 1.0, -1.0)
        a = det * s
        tx = ox - v0x
        ty = oy - v0y
        tz = oz - v0z
        up = (tx * px + ty * py + tz * pz) * s
        qx = ty * e1z - tz * e1y
        qy = tz * e1x - tx * e1z
        qz = tx * e1y - ty * e1x
        vp = (dx * qx + dy * qy + dz * qz) * s
        tp = (e2x * qx + e2y * qy + e2z * qz) * s
        valid = ((a > 1e-10) & (up >= 0.0) & (vp >= 0.0) & (up + vp <= a)
                 & (tp > t_min * a) & (tp * den < num * a))
        num = torch.where(valid, tp, num)
        den = torch.where(valid, a, den)
        btri = torch.where(valid, tri[:, 9].to(torch.int32), btri)
        bu = torch.where(valid, up, bu)
        bv = torch.where(valid, vp, bv)
    inv = 1.0 / den
    return num * inv, btri, bu * inv, bv * inv


def closest_variant_plain(origin, direction, t_max, root, qmeta, qnodes,
                          ptris, descent, divfree, leafpar=False,
                          counts=None, leaf_test=None):
    """Plain torch version of lab_closest4_queued. Returns (t, tri, u, v).
    `counts` (nit, nleaf), i32[N] each, adds up each ray's steps and leaf
    steps: the kernel has no counters, but takes the same steps.
    `leaf_test`, queue_walk.queued_walk's leaf hook, replaces the flags'
    leaf test."""
    leaf_test = leaf_test or (_ilp_leaf if leafpar else _divfree_leaf
                              if divfree else qt._serial_leaf)
    step = qw.quad_step(origin, _inv_dir(direction), qmeta, qnodes)
    return qw.queued_walk(origin, direction, t_max, root, ptris, step,
                          leaf_test=leaf_test, descent=descent, counts=counts)


def _closest_variant_cuda(origin, direction, t_max, scene, descent,
                          leaf_kind):
    """L6 on the card: the qnodes rows (their metas in float4 6; qmeta is
    not read), ptris and its leaf counts, the tree's stack need and a ray
    counter of its own; then drain_at, descent and the leaf kind."""
    global closest_launches
    n, dev = _check_rays(origin, direction, t_max)
    qt._check_n(n)
    qw.check_quad_rows(scene, dev)
    out = qw.hit_outputs(n, dev)
    if n:
        args, _counter = qt._walk_args(scene.ptris, dev, scene.root,
                                       scene.qnodes, scene.q_stack_need)
        qw.launch("lab_closest4_queued", dev, _ptr(origin), _ptr(direction),
                  _ptr(t_max), n, *args, qw.DRAIN_AT, int(descent),
                  leaf_kind, *(_ptr(t) for t in out))
        closest_launches += 1
    return out


def run(scene, sets, combos=ALL, reps=REPS, log=print):
    """K1 and every (descent, divfree, leafpar) combination on every
    closest-hit set; prints one line each. Returns {(set, combo): stats}
    (and {(set, "k1"): stats}) with the outputs under "out"; on the card
    it first prints each combination's launch shape."""
    for combo in combos if scene.ptris.is_cuda else ():
        log(qw.launch_line(f"L6 {name(*combo)}", launch_kernel(*combo),
                           scene.q_stack_need, scene.ptris.device))
    results = {}
    for label, (o, d, tm) in sets.items():
        k1 = qt.intersect_quad(o, d, scene, T_MIN, tm)
        k1_ms = lab_rays.cuda_ms(
            lambda: qt.intersect_quad(o, d, scene, T_MIN, tm), reps)
        results[(label, "k1")] = dict(ms=k1_ms, out=tuple(k1[:4]))
        log(f"r3 {label:15s} production quad closest (K1) {k1_ms:8.3f} ms")
        for combo in combos:
            out = run_closest_variant(o, d, tm, scene, *combo)
            ms = lab_rays.cuda_ms(
                lambda: run_closest_variant(o, d, tm, scene, *combo), reps)
            flips, tri_diff, max_dt = against(out, k1)
            mism = int((out[1] != k1.tri).sum())
            results[(label, combo)] = dict(ms=ms, flips=flips,
                                           tri_diff=tri_diff, mism=mism,
                                           max_dt=max_dt, out=out)
            log(f"r3 {label:15s} {name(*combo)}: {ms:8.3f} ms  "
                f"({k1_ms / ms:.3f}x)  mism {mism}  (hit flips {flips}, tri "
                f"diff {tri_diff}, max|dt| {max_dt:.2e})")
    return results


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--all", action="store_true")
    p.add_argument("--leafpar", action="store_true")
    p.add_argument("--descent", action="store_true")
    p.add_argument("--divfree", action="store_true")
    p.add_argument("--width", type=int, default=lab_rays.WIDTH)
    p.add_argument("--height", type=int, default=lab_rays.HEIGHT)
    p.add_argument("--reps", type=int, default=REPS)
    args = p.parse_args(argv)
    if args.all:
        combos = ALL
    elif args.leafpar:
        combos = LEAFPAR
    else:
        combos = ((args.descent, args.divfree, False),)
    device = lab_rays.require_cuda()
    scene = lab_rays.atrium(LEAF_SIZE, device)
    sets = lab_rays.closest_sets(scene, args.width, args.height)
    run(scene, sets, combos, args.reps, log=lambda m: print(m, flush=True))
    print(f"r3_kernel_lab on {lab_rays.card_line()} (SM clock read after "
          "the runs)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
