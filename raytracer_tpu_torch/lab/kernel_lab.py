"""Kernel lab L1: the binary tree's closest-hit kernel with per-ray visit
counters and its variants, the port's counterpart of tools/kernel_lab.py
(`run_closest_lab` :273, L1a; `run_closest_ts` :378, L1b).

    python -m raytracer_tpu_torch.lab.kernel_lab [--width W --height H]

Bakes the atrium with leaf 16 (RenderConfig.bvh_leaf_size, as the JAX
lab), prints each kernel's launch shape, traces the primary rays and the
bounce-1 wavefront in the renderer's and in the sorted order, and prints
K3's time (ops/binary_traverse.intersect_bvh_binary, the walk the lab
counts) and per variant the kernel time (CUDA events, mean of 5) and its
ratio to K3's, visits per live ray, the leaf share of the visits, ns per
visit (kernel time over all visits) and whether the triangles match
`base`; then L1b's time for each block size.

Variants, each computing per ray what the TPU kernel computes per packet:
  base, nored  K3's walk with counters; one kernel serves both names (for
               one ray, any(hit) and min t_near < BIG are one predicate);
               it equals K3 on every ray
  leafilp      every triangle of a leaf tested against the entry best t,
               then a pairwise min tree (a tie keeps the lower k); equals
               the serial leaf; leaf 8 or 16
  pop2, pop4   tools/kernel_lab.py:69's multi-pop loop: k = min(sp, N)
               metas read off the top, sp -= k, visited in order, each
               internal visit pushing at the current sp and seeing the best
               t of the visits before it; nvisit += k
L1b (`run_closest_ts`) is the nored kernel with the TPU's rays per packet
turned into threads per block (BLOCKS); results and counts do not change.

nvisit counts every pop of a ray's walk, nleaf its leaf pops. On CUDA
tensors the wrappers launch csrc/lab_traverse.cu:lab_closest, K3's
machinery (persistent warps, the stack in shared memory below the entry
kept in a register, `stack_need(scene, variant)` entries a thread, leaves
tested up to their counts but leafilp's); on CPU tensors they run the
plain torch versions below, which the kernels equal bit for bit (counts
included) and the tests compare with the JAX lab kernels.
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
    BIG,
    T_MIN,
    TRI_STRIDE,
    _check_rays,
    _closest_leaves,
    _closest_walk,
    _init_best,
    _init_stack,
    _inv_dir,
    _moller,
    _ptr,
    _ray_inputs,
    _serial_leaf,
)

LEAF_SIZE = 16
_KERNEL_VARIANT = {"base": 0, "nored": 0, "leafilp": 1, "pop2": 2, "pop4": 3}
VARIANTS = tuple(_KERNEL_VARIANT)
ILP_LEAVES = (8, 16)  # the leaf sizes the ILP kernel is instantiated for
THREADS = 128  # threads per block of run_closest_lab
BLOCKS = (64, 128, 256, 512, 1024)  # L1b's threads per block
REPS = 5

# Kernel launches, counted where the CUDA wrappers launch (never by the
# plain versions).
closest_launches = 0
closest_ts_launches = 0


def reset_launch_counts():
    global closest_launches, closest_ts_launches
    closest_launches = 0
    closest_ts_launches = 0


def _npop(variant):
    return int(variant[3:]) if variant.startswith("pop") else 1


def stack_need(scene, variant):
    """The stack entries a thread `variant`'s kernel takes, its plain
    walk's bound: bt.stack_need(scene) = depth + 2 for a single-pop walk;
    npop x (depth + 2) for a multi-pop one, whose step pops k <= N metas
    and pushes up to 2k, so that the stack holds at most N per level and
    2N at the top."""
    return _npop(variant) * bt.stack_need(scene)


def _check(scene, variant):
    if variant not in _KERNEL_VARIANT:
        raise ValueError(f"unknown closest-lab variant {variant!r}; "
                         f"expected one of {VARIANTS}")
    bt._check_stack(scene)
    if stack_need(scene, variant) > STACK_CAP:
        raise ValueError(f"{variant}: BVH depth {scene.bvh_max_depth} may "
                         f"overflow the stack (STACK_CAP={STACK_CAP})")
    leaf = scene.ptris.shape[1] // TRI_STRIDE
    if variant == "leafilp" and leaf not in ILP_LEAVES:
        raise ValueError(f"leafilp takes leaf sizes {ILP_LEAVES}, got {leaf}")


def run_closest_lab(origin, direction, t_max, scene, variant):
    """L1a: closest hit of rays f32[N,3] against the binary tree of `scene`
    (t_min 1e-3, t_max scalar or f32[N]; a ray with t_max <= 1e-3 is not
    walked). Returns (t f32[N], tri i32[N], u f32[N], v f32[N], nvisit
    i32[N], nleaf i32[N])."""
    _check(scene, variant)
    o, d, tm = _ray_inputs(origin, direction, t_max, None)
    if o.is_cuda:
        return _closest_lab_cuda(o, d, tm, scene, variant)
    return closest_lab_plain(o, d, tm, scene.binary_root, scene.pnodes,
                             scene.ptris, variant)


def run_closest_ts(origin, direction, t_max, scene, block):
    """L1b: the nored kernel with `block` threads per block (BLOCKS);
    returns what run_closest_lab returns."""
    _check(scene, "nored")
    if block not in BLOCKS:
        raise ValueError(f"block {block} is not one of {BLOCKS}")
    o, d, tm = _ray_inputs(origin, direction, t_max, None)
    if o.is_cuda:
        return _closest_lab_cuda(o, d, tm, scene, "nored", block)
    return closest_lab_plain(o, d, tm, scene.binary_root, scene.pnodes,
                             scene.ptris, "nored")


# --------------------------------------------------------------------------
# Plain torch versions.
# --------------------------------------------------------------------------

def _ilp_leaf(origin, direction, rows, bt_, btri, bu, bv, t_min):
    """tools/kernel_lab.py:187 leaf_fn_ilp: every triangle against the
    entry best t, then a pairwise min tree in which a tie keeps the lower
    k; the winner replaces the best hit if its t is smaller."""
    ox, oy, oz = origin.unbind(1)
    dx, dy, dz = direction.unbind(1)
    cand = []  # (t or BIG, u, v, tri) per triangle
    for k in range(rows.shape[1] // TRI_STRIDE):
        tri = rows[:, k * TRI_STRIDE:(k + 1) * TRI_STRIDE]
        t, u, v, valid = _moller(ox, oy, oz, dx, dy, dz, tri, bt_, t_min)
        cand.append((torch.where(valid, t, BIG), u, v,
                     tri[:, 9].to(torch.int32)))
    while len(cand) > 1:
        pairs = zip(cand[0::2], cand[1::2])
        cand = [tuple(torch.where(b[0] < a[0], y, x) for x, y in zip(a, b))
                for a, b in pairs]
    t, u, v, tri = cand[0]
    win = t < bt_
    return (torch.where(win, t, bt_), torch.where(win, tri, btri),
            torch.where(win, u, bu), torch.where(win, v, bv))


def _multipop_walk(origin, direction, t_max, root, ptris, visit_node, npop,
                   counts, leaf_test=_serial_leaf):
    """tools/kernel_lab.py:69 _closest_kernel_multipop per ray: each step
    reads k = min(sp, npop) metas off the top of the stack, drops them, and
    visits them in order; an internal visit pushes at the current sp and
    prunes with the best t of the visits before it; a leaf is tested by
    `leaf_test` (called as _serial_leaf)."""
    n = origin.shape[0]
    best = _init_best(t_max)
    stack, sp = _init_stack(n, root, t_max, STACK_CAP, T_MIN)
    nvisit, nleaf = counts
    below_top = torch.arange(1, npop + 1, device=origin.device)
    while True:
        live = torch.nonzero(sp > 0).squeeze(1)
        if live.numel() == 0:
            break
        spl = sp[live]
        k = torch.clamp_max(spl, npop)
        slots = torch.clamp_min(spl[:, None] - below_top, 0).long()
        metas = stack[live[:, None], slots]
        sp[live] = spl - k
        nvisit[live] += k
        for j in range(npop):
            sel = k > j
            rays, meta = live[sel], metas[sel, j]
            is_leaf = meta < 0
            nleaf[rays] += is_leaf.to(torch.int32)
            if is_leaf.any():
                _closest_leaves(origin, direction, ptris, best, rays[is_leaf],
                                meta[is_leaf], T_MIN, leaf_test)
            ii = rays[~is_leaf]
            if ii.numel():
                visit_node(stack, sp, ii, meta[~is_leaf].long(), best[0][ii])
    return best


def closest_lab_plain(origin, direction, t_max, root, pnodes, ptris,
                      variant, leaf_test=None):
    """Plain torch version of lab_closest's `variant`. Returns (t, tri, u,
    v, nvisit, nleaf). `leaf_test` (called as quad_traverse._serial_leaf)
    replaces the variant's leaf test: the serial leaf, or leafilp's ILP
    leaf."""
    n = origin.shape[0]
    counts = tuple(torch.zeros((n,), dtype=torch.int32, device=origin.device)
                   for _ in range(2))
    visit = _binary_visit(origin, _inv_dir(direction), pnodes, T_MIN)
    if leaf_test is None:
        leaf_test = _ilp_leaf if variant == "leafilp" else _serial_leaf
    npop = _npop(variant)
    if npop > 1:
        hit = _multipop_walk(origin, direction, t_max, root, ptris, visit,
                             npop, counts, leaf_test)
    else:
        hit = _closest_walk(origin, direction, t_max, root, ptris, visit,
                            STACK_CAP, T_MIN, leaf_test=leaf_test,
                            counts=counts)
    return (*hit, *counts)


# --------------------------------------------------------------------------
# CUDA wrapper (csrc/lab_traverse.cu).
# --------------------------------------------------------------------------

def _closest_lab_cuda(origin, direction, t_max, scene, variant, block=None):
    """L1 on the card: L1a's `variant` (block None, THREADS threads a
    block) or L1b, the nored kernel at `block` threads a block; the pnodes
    rows, ptris and its leaf counts, the variant's stack need and a ray
    counter of its own."""
    global closest_launches, closest_ts_launches
    n, dev = _check_rays(origin, direction, t_max)
    qt._check_n(n)
    out = qw.hit_outputs(n, dev, counters=True)
    if n:
        args, _counter = bt._launch_args(scene, dev,
                                         stack_need(scene, variant))
        qw.launch("lab_closest", dev, _ptr(origin), _ptr(direction),
                  _ptr(t_max), n, *args, _KERNEL_VARIANT[variant],
                  block or THREADS, *(_ptr(t) for t in out),
                  library="lab_traverse")
        if block is None:
            closest_launches += 1
        else:
            closest_ts_launches += 1
    return out


def launch_lines(scene, leaf, device):
    """The launch shape of every L1 kernel on `scene` (queue_walk
    .launch_line): each variant, leafilp at leaf size `leaf`, and L1b at
    each block but THREADS (base's)."""
    kernels = [(v, qw.l1_kernel(v, leaf), stack_need(scene, v))
               for v in VARIANTS if v != "nored"]
    kernels += [(f"ts{b}", qw.l1_kernel("nored", block=b),
                 stack_need(scene, "nored")) for b in BLOCKS if b != THREADS]
    return [qw.launch_line(f"L1 {name}", key, need, device)
            for name, key, need in kernels]


# --------------------------------------------------------------------------
# The lab.
# --------------------------------------------------------------------------

def _stats(out, t_max, ms):
    live = int((t_max > T_MIN).sum())
    visits, leaves = int(out[4].sum()), int(out[5].sum())
    return dict(ms=ms, rays=live, visits=visits, leaves=leaves,
                visits_per_ray=visits / max(live, 1),
                leaf_share=leaves / max(visits, 1),
                ns_per_visit=ms * 1e6 / max(visits, 1), out=out)


def run(scene, sets, reps=REPS, log=print):
    """K3, every variant, then every L1b block size, on every ray set of
    lab.rays.closest_sets; prints one line each (on the card, first each
    kernel's launch shape). Returns {(set, name): stats} with name "k3", a
    variant or f"ts{block}"; stats holds the kernel's outputs under
    "out"."""
    if scene.ptris.is_cuda:
        for line in launch_lines(scene, scene.ptris.shape[1] // TRI_STRIDE,
                                 scene.ptris.device):
            log(line)
    results = {}
    for label, (o, d, tm) in sets.items():
        k3 = bt.intersect_bvh_binary(o, d, scene, T_MIN, tm)
        k3_ms = lab_rays.cuda_ms(
            lambda: bt.intersect_bvh_binary(o, d, scene, T_MIN, tm), reps)
        results[(label, "k3")] = dict(ms=k3_ms, out=(k3.t, k3.tri, k3.u,
                                                     k3.v))
        log(f"{label:15s} K3       {k3_ms:8.3f} ms")
        ref = None
        for variant in VARIANTS:
            out = run_closest_lab(o, d, tm, scene, variant)
            ms = lab_rays.cuda_ms(
                lambda: run_closest_lab(o, d, tm, scene, variant), reps)
            s = results[(label, variant)] = _stats(out, tm, ms)
            ref = out[1] if ref is None else ref
            differ = int((out[1] != ref).sum())
            log(f"{label:15s} {variant:8s} {ms:8.3f} ms ({ms / k3_ms:.2f}x "
                f"K3)  visits/ray {s['visits_per_ray']:7.3f} (leaf "
                f"{100 * s['leaf_share']:.0f}%)  ns/visit "
                f"{s['ns_per_visit']:.5f}  match={not differ} ({differ} "
                "triangles differ from base)")
        for block in BLOCKS:
            out = run_closest_ts(o, d, tm, scene, block)
            ms = lab_rays.cuda_ms(
                lambda: run_closest_ts(o, d, tm, scene, block), reps)
            s = results[(label, f"ts{block}")] = _stats(out, tm, ms)
            log(f"{label:15s} threads/block {block:5d}: {ms:8.3f} ms "
                f"({ms / k3_ms:.2f}x K3)  visits/ray "
                f"{s['visits_per_ray']:7.3f}  total visits {s['visits']}")
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
    print(f"kernel_lab on {lab_rays.card_line()} (SM clock read after "
          "the runs)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
