"""Interleave lab L5: two deferred-leaf walks interleaved in one instance,
the port's counterpart of tools/v4_interleave_lab.py (`run_closest_v4`
:267, its `pallas_call` :276).

    python -m raytracer_tpu_torch.lab.v4_interleave_lab [--width W
        --height H] [--reps N]

Bakes the atrium with leaf 8 (as the JAX lab) and on each ray set of
lab.rays.closest_sets times K1 (ops/quad_traverse.intersect_quad, the JAX
lab's production sub-packet kernel), K3 (ops/binary_traverse
.intersect_bvh_binary), L4 `base` (lab/v3_kernel_lab.py: the same walk,
one ray a thread) at each drain threshold run, and the runs: both
variants at the production drain threshold and `switch` at drain_at 1
(CUDA events, mean of 5). It prints each run's ms and its ratio to K1, K3
and L4 `base` at its drain threshold, the triangle mismatches and the
largest |dt| against K1; on the card, first the launch shapes of L5 and
L4 `base`.

The pairing: rays 2j and 2j+1 (neighbouring pixels in the renderer's
order) form pair j, each ray walked with L4's binary walk
(lab/queue_walk.py). Where the TPU instance interleaves two 8-row tiles,
the card interleaves two rays in one thread.
  shared  (the JAX default, tools/v4_interleave_lab.py:38, :234-248) each
          step both rays take a leaf step if either one's drain condition
          holds, else both an internal step; a ray with nothing of that
          kind sits the step out. This couples the pair's leaf timing, so
          the plain version simulates the same pairs;
  switch  (:214-233) each ray takes its own kind of step: two independent
          walks, per ray L4 `base` bit for bit.
A ray with t_max <= 1e-3 is not walked.

On CUDA tensors the wrapper launches csrc/lab2_traverse.cu:lab_closest_pair,
persistent warps whose lanes fetch pairs from a counter of the launch's
own; a lane walks its pair's rays in two slots, each queued_walk's lane
state (an internal-node stack of bt.stack_need(scene) entries and a leaf
queue in shared memory, the stack's top in a register), both slots' node
rows loaded before either slot's slab test, each leaf row tested up to its
count. On CPU tensors it runs the plain torch version, every slot of each
row, which the kernel equals bit for bit.
"""

from __future__ import annotations

import argparse
import sys

from raytracer_tpu_torch.lab import queue_walk as qw
from raytracer_tpu_torch.lab import rays as lab_rays
from raytracer_tpu_torch.lab import v3_kernel_lab as v3
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
VARIANTS = qw.L5_VARIANTS
# (variant, drain_at) of run(): both variants at the production threshold;
# the lab's main() adds switch at drain_at 1.
RUNS = tuple((v, qw.DRAIN_AT) for v in VARIANTS)
REPS = 5

# Kernel launches, counted where the CUDA wrapper launches.
closest_launches = 0


def reset_launch_counts():
    global closest_launches
    closest_launches = 0


def run_closest_v4(origin, direction, t_max, scene, variant="shared",
                   drain_at=qw.DRAIN_AT):
    """Closest hit of rays f32[N,3] against the binary tree of `scene`, rays
    2j and 2j+1 walked together (t_min 1e-3, t_max scalar or f32[N]; a ray
    with t_max <= 1e-3 is not walked; drain_at in 1..LQ-2). Returns (t
    f32[N], tri i32[N], u f32[N], v f32[N])."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown v4 variant {variant!r}; expected one of "
                         f"{VARIANTS}")
    qw.check_drain_at(drain_at)
    qw.check_binary(scene)
    o, d, tm = _ray_inputs(origin, direction, t_max, None)
    if o.is_cuda:
        return _closest_v4_cuda(o, d, tm, scene, drain_at,
                                variant == "shared")
    return closest_v4_plain(o, d, tm, scene.binary_root, scene.pnodes,
                            scene.ptris, variant, drain_at=drain_at)


def closest_v4_plain(origin, direction, t_max, root, pnodes, ptris, variant,
                     counts=None, drain_at=qw.DRAIN_AT,
                     leaf_test=_serial_leaf):
    """Plain torch version of lab_closest_pair. Returns (t, tri, u, v).
    `counts` (nit, nleaf), i32[N] each, adds up each ray's steps and leaf
    steps, a step sat out being none: the kernel has no counters, but takes
    the same steps. `leaf_test`, queue_walk.queued_walk's leaf hook,
    replaces the every-slot serial leaf."""
    step = qw.binary_step(origin, _inv_dir(direction), pnodes)
    return qw.queued_walk(origin, direction, t_max, root, ptris, step,
                          leaf_test=leaf_test, drain_at=drain_at,
                          paired=variant == "shared", counts=counts)


def _closest_v4_cuda(origin, direction, t_max, scene, drain_at, shared):
    """L5 on the card: as L4 (the pnodes rows, ptris and its leaf counts,
    bt.stack_need(scene) for each of a thread's two stacks), a pair counter
    of its own (the C entry fetches (n + 1) // 2 pairs), drain_at and
    whether the pair shares its step kind."""
    global closest_launches
    n, dev = _check_rays(origin, direction, t_max)
    qt._check_n(n)
    need = bt.stack_need(scene)
    qw.check_need(need, "binary-BVH")
    out = qw.hit_outputs(n, dev)
    if n:
        args, _counter = bt._launch_args(scene, dev, need)
        qw.launch("lab_closest_pair", dev, _ptr(origin), _ptr(direction),
                  _ptr(t_max), n, *args, drain_at, int(shared),
                  *(_ptr(t) for t in out))
        closest_launches += 1
    return out


def run_key(variant, drain_at):
    """run()'s result key of a (variant, drain_at) run: the variant at the
    production drain threshold, else "<variant>_d<drain_at>"."""
    return variant if drain_at == qw.DRAIN_AT else f"{variant}_d{drain_at}"


def run(scene, sets, runs=RUNS, reps=REPS, log=print):
    """K1, K3, L4 base at each drain threshold of `runs` and every (variant,
    drain_at) of `runs` on every closest-hit set; prints one line each.
    Returns {(set, run_key(...)): stats} (and {(set, "k1"), (set, "k3"),
    (set, run_key("l4_base", drain_at)): stats}) with the outputs under
    "out"; on the card it first prints the launch shapes of L5's variants
    and L4 base."""
    drains = sorted({drain_at for _, drain_at in runs})
    if scene.ptris.is_cuda:
        need = bt.stack_need(scene)
        for variant in sorted({v for v, _ in runs}):
            log(qw.launch_line(f"L5 {variant}", qw.l5_kernel(variant), need,
                               scene.ptris.device))
        log(qw.launch_line("L4 base", qw.l4_kernel("base"), need,
                           scene.ptris.device))
    results = {}
    for label, (o, d, tm) in sets.items():
        yard = {
            "k1": lambda: qt.intersect_quad(o, d, scene, T_MIN, tm),
            "k3": lambda: bt.intersect_bvh_binary(o, d, scene, T_MIN, tm),
            **{run_key("l4_base", drain_at):
               lambda drain_at=drain_at: v3.run_closest_v3(
                   o, d, tm, scene, drain_at, "base")
               for drain_at in drains}}
        for key, fn in yard.items():
            results[(label, key)] = dict(out=tuple(fn()[:4]),
                                         ms=lab_rays.cuda_ms(fn, reps))
        ms_of = {key: results[(label, key)]["ms"] for key in yard}
        k1 = results[(label, "k1")]["out"]
        k1_ms, k3_ms = ms_of["k1"], ms_of["k3"]
        log(f"v4 {label:15s} K1 {k1_ms:8.3f} ms, K3 {k3_ms:8.3f} ms, "
            + ", ".join(f"L4 base drain{drain_at:2d} "
                        f"{ms_of[run_key('l4_base', drain_at)]:8.3f} ms"
                        for drain_at in drains))
        for variant, drain_at in runs:
            out = run_closest_v4(o, d, tm, scene, variant, drain_at)
            ms = lab_rays.cuda_ms(
                lambda: run_closest_v4(o, d, tm, scene, variant, drain_at),
                reps)
            l4_ms = ms_of[run_key("l4_base", drain_at)]
            flips, tri_diff, max_dt = against(out, k1)
            mism = int((out[1] != k1[1]).sum())
            results[(label, run_key(variant, drain_at))] = dict(
                ms=ms, flips=flips, tri_diff=tri_diff, mism=mism,
                max_dt=max_dt, out=out)
            log(f"v4 {label:15s} 2-way interleave {variant:6s} drain"
                f"{drain_at:2d} {ms:8.3f} ms  ({ms / k1_ms:.2f}x K1, "
                f"{ms / k3_ms:.2f}x K3, {ms / l4_ms:.2f}x L4 base)  mism "
                f"{mism}  max|dt| {max_dt:.2e}  (hit flips {flips}, tri "
                f"diff {tri_diff})")
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
    run(scene, sets, RUNS + (("switch", 1),), reps=args.reps,
        log=lambda m: print(m, flush=True))
    print(f"v4_interleave_lab on {lab_rays.card_line()} (SM clock read "
          "after the runs)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
