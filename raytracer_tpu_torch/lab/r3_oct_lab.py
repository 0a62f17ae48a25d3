"""Round-3 oct lab L7: the deferred-leaf walk on an 8-wide (oct) tree, the
port's counterpart of tools/r3_oct_lab.py (`collapse_bvh8` :41,
`_closest_kernel8` :105, `run_closest8` and its `pallas_call` :255-279).

    python -m raytracer_tpu_torch.lab.r3_oct_lab [--width W --height H
        --reps R]

Bakes the atrium with leaf 8 (as the JAX lab), collapses its binary BVH
into the oct tree, and on each ray set of lab.rays.closest_sets (primary,
bounce 1, bounce 1 sorted; the JAX lab times only the last) times K1
(ops/quad_traverse.intersect_quad, the production 4-wide kernel) and L7
(CUDA events, mean of 5), runs L7's plain version once (host clock) for
its steps, and prints L7's launch shape, the speed-up over K1, the hit
flips and triangle differences against K1, and the steps and leaf steps
per live ray.

The oct tree (collapse_bvh8): each oct node's children are its binary
great-grandchildren, with leaves absorbed wherever they appear. A row of
onodes f32[N8,64] holds 8 x (min.xyz, max.xyz) at columns 6c:6c+6, the 8
child metas as exact-integer f32 at 48:56 (oct id >= 0, ~leaf block < 0)
and zeros at 56:64; an absent child has a NaN box, which never hits. ometa
i32[8*N8] holds the same metas. A root that is a leaf gives root ~0.

The walk is lab/queue_walk.py's with the 8-wide node step (oct_step): 8
slab tests against [1e-3, best t], the near child by a 3-bit tournament
(a tie to the lower index, a missed child counting as BIG), the hit
children pushed in child order but the near one, which goes last; a leaf
child goes into the leaf queue. The stack holds up to 7 children per oct
level: a tree whose stack need exceeds queue_walk.CAP is refused (the JAX
lab asserts; its kernel would clamp its writes at CAP - 1).

On CUDA tensors the wrapper launches csrc/lab2_traverse.cu:
lab_closest8_queued, persistent warps with the stack (the tree's stack
need) and the leaf queue in shared memory, reading each node's metas from
its onodes row and each leaf up to its count; on CPU tensors it runs the
plain torch version, which the kernel equals bit for bit.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from raytracer_tpu_torch.lab import queue_walk as qw
from raytracer_tpu_torch.lab import rays as lab_rays
from raytracer_tpu_torch.lab.bvh4_lab import against
from raytracer_tpu_torch.ops import quad_traverse as qt
from raytracer_tpu_torch.ops.quad_traverse import (
    T_MIN,
    _check_ptris,
    _check_rays,
    _inv_dir,
    _ptr,
    _ray_inputs,
    _require,
)

LEAF_SIZE = 8
WIDTH = 8  # children per oct node
REPS = 5

# Kernel launches, counted where the CUDA wrapper launches.
closest_launches = 0


def reset_launch_counts():
    global closest_launches
    closest_launches = 0


class OctTree(NamedTuple):
    """collapse_bvh8's arrays as tensors of one device, with the seconds
    the collapse took."""
    nodes: torch.Tensor  # f32[N8, 64]
    meta: torch.Tensor  # i32[8 * N8]
    root: int
    stack_need: int
    collapse_s: float


def collapse_bvh8(bvh):
    """tools/r3_oct_lab.py:41 collapse_bvh8 of the port's BVH (nodes_count,
    nodes_skip, nodes_min, nodes_max): (onodes f32[N8,64], ometa i32[8*N8],
    oroot i32[1], stack_need), stack_need = 7 * (max oct depth + 1) + 1."""
    is_leaf = bvh.nodes_count > 0
    skip = bvh.nodes_skip
    if is_leaf[0]:
        onodes = np.full((1, 64), np.nan, np.float32)
        onodes[:, 56:] = 0.0
        return (onodes, np.zeros((WIDTH,), np.int32),
                np.asarray([~0], np.int32), WIDTH)

    leaf_ids = (np.cumsum(is_leaf) - 1).astype(np.int64)
    oct_of = {}
    order = []
    children_of = {}
    depth8 = {0: 0}
    max_d8 = 0
    stack = [0]
    while stack:
        x = stack.pop()
        oct_of[x] = len(order)
        order.append(x)
        kids = []

        def descend(c, level):
            if is_leaf[c] or level == 3:
                kids.append(("leaf", int(leaf_ids[c]), c) if is_leaf[c]
                            else ("oct", None, c))
                return
            descend(c + 1, level + 1)
            descend(int(skip[c + 1]), level + 1)

        descend(x + 1, 1)
        descend(int(skip[x + 1]), 1)
        children_of[x] = kids
        for kind, _, node in reversed(kids):
            if kind == "oct":
                depth8[node] = depth8[x] + 1
                max_d8 = max(max_d8, depth8[node])
                stack.append(node)

    n8 = len(order)
    assert n8 < (1 << 24)
    onodes = np.full((n8, 64), np.nan, np.float32)
    onodes[:, 56:] = 0.0
    ometa = np.zeros((WIDTH * n8,), np.int32)
    for x in order:
        oid = oct_of[x]
        row = onodes[oid]
        for c, (kind, lid, node) in enumerate(children_of[x]):
            row[6 * c: 6 * c + 3] = bvh.nodes_min[node]
            row[6 * c + 3: 6 * c + 6] = bvh.nodes_max[node]
            meta = ~lid if kind == "leaf" else oct_of[node]
            row[48 + c] = np.float32(meta)
            ometa[WIDTH * oid + c] = meta
    return (onodes, ometa, np.asarray([0], np.int32),
            (WIDTH - 1) * (max_d8 + 1) + 1)


def oct_tree(bvh, device):
    """collapse_bvh8 of `bvh`, timed, as an OctTree on `device`."""
    t0 = time.perf_counter()
    onodes, ometa, oroot, need = collapse_bvh8(bvh)
    seconds = time.perf_counter() - t0
    return OctTree(torch.from_numpy(onodes).to(device),
                   torch.from_numpy(ometa).to(device), int(oroot[0]),
                   int(need), seconds)


def _check(tree):
    qw.check_need(tree.stack_need, "oct-tree")
    qw.check_drain_at(qw.DRAIN_AT, WIDTH)


def run_closest8(origin, direction, t_max, tree, ptris):
    """Closest hit of rays f32[N,3] against the oct tree `tree` (an OctTree)
    over the leaf rows `ptris` of the BVH it was collapsed from (t_min
    1e-3, t_max scalar or f32[N]; a ray with t_max <= 1e-3 is not walked).
    Returns (t f32[N], tri i32[N], u f32[N], v f32[N])."""
    _check(tree)
    o, d, tm = _ray_inputs(origin, direction, t_max, None)
    if o.is_cuda:
        return _closest8_cuda(o, d, tm, tree, ptris)
    return closest8_plain(o, d, tm, tree, ptris)


def closest8_plain(origin, direction, t_max, tree, ptris, counts=None,
                   leaf_test=qt._serial_leaf):
    """Plain torch version of lab_closest8_queued. Returns (t, tri, u, v).
    `counts` (nit, nleaf), i32[N] each, adds up each ray's steps and leaf
    steps: the kernel has no counters, but takes the same steps.
    `leaf_test` is queue_walk.queued_walk's leaf hook."""
    step = qw.oct_step(origin, _inv_dir(direction), tree.meta, tree.nodes)
    return qw.queued_walk(origin, direction, t_max, tree.root, ptris, step,
                          leaf_test=leaf_test, counts=counts)


def _closest8_cuda(origin, direction, t_max, tree, ptris):
    """L7 on the card: the oct rows (their metas at columns 48:56; ometa is
    not read), ptris and its leaf counts, the tree's stack need and a ray
    counter of its own."""
    global closest_launches
    n, dev = _check_rays(origin, direction, t_max)
    qt._check_n(n)
    qw.check_need(tree.stack_need, "oct-tree")
    n8 = tree.nodes.shape[0]
    _require("onodes", tree.nodes, torch.float32, (n8, 64), dev, vec=True)
    _check_ptris(ptris, dev)
    out = qw.hit_outputs(n, dev)
    if n:
        args, _counter = qt._walk_args(ptris, dev, tree.root, tree.nodes,
                                       tree.stack_need)
        qw.launch("lab_closest8_queued", dev, _ptr(origin), _ptr(direction),
                  _ptr(t_max), n, *args, qw.DRAIN_AT,
                  *(_ptr(t) for t in out))
        closest_launches += 1
    return out


def run(scene, tree, sets, reps=REPS, log=print, leaf_hooks=None):
    """K1 and L7 on every closest-hit set, and L7's plain version once for
    its steps; prints one line each. Returns {(set, "k1"): stats,
    (set, "oct"): stats} with the kernels' outputs under "out" and the
    plain version's under "plain" (its host ms under "plain_ms", its
    counts under "counts"). `leaf_hooks`, a callable that returns
    (closest-hit leaf hook, any-hit leaf hook, total) as
    chip_smoke.counting_leaf_tests does, makes the plain version test its
    leaves through a new closest-hit hook on each set (its host ms with
    it) and puts the hook's total under "tests"."""
    log(f"oct tree: {tree.nodes.shape[0]} oct nodes (quad "
        f"{scene.qnodes.shape[0]}), collapse {tree.collapse_s:.2f} s, stack "
        f"need {tree.stack_need} (CAP {qw.CAP})")
    if scene.ptris.is_cuda:
        log(qw.launch_line("L7", "closest8", tree.stack_need,
                           scene.ptris.device))
    results = {}
    for label, (o, d, tm) in sets.items():
        k1 = qt.intersect_quad(o, d, scene, T_MIN, tm)
        k1_ms = lab_rays.cuda_ms(
            lambda: qt.intersect_quad(o, d, scene, T_MIN, tm), reps)
        results[(label, "k1")] = dict(ms=k1_ms, out=tuple(k1[:4]))
        out = run_closest8(o, d, tm, tree, scene.ptris)
        ms = lab_rays.cuda_ms(
            lambda: run_closest8(o, d, tm, tree, scene.ptris), reps)
        counts = tuple(torch.zeros_like(tm, dtype=torch.int32)
                       for _ in range(2))
        leaf_test, _, total = (leaf_hooks() if leaf_hooks
                               else (qt._serial_leaf, None, None))
        plain, plain_ms = lab_rays.host_ms(
            lambda: closest8_plain(o, d, tm, tree, scene.ptris, counts,
                                   leaf_test))
        flips, tri_diff, max_dt = against(out, k1)
        steps, p90, leaf_steps = qw.step_stats(counts, tm)
        results[(label, "oct")] = dict(
            ms=ms, flips=flips, tri_diff=tri_diff, max_dt=max_dt, out=out,
            plain=plain, plain_ms=plain_ms, counts=counts,
            tests=total[0] if total else None)
        log(f"oct {label:15s} K1 {k1_ms:8.3f} ms, oct closest {ms:8.3f} ms "
            f"({k1_ms / ms:.3f}x)  hit flips {flips}  tri diff {tri_diff}  "
            f"max|dt| {max_dt:.2e}; steps/ray mean {steps:.3f} p90 {p90:.0f}, "
            f"leaf steps {leaf_steps:.3f}; plain {plain_ms:.1f} ms")
    return results


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--width", type=int, default=lab_rays.WIDTH)
    p.add_argument("--height", type=int, default=lab_rays.HEIGHT)
    p.add_argument("--reps", type=int, default=REPS)
    args = p.parse_args(argv)
    device = lab_rays.require_cuda()
    scene, bvh = lab_rays.atrium_and_bvh(LEAF_SIZE, device)
    tree = oct_tree(bvh, device)
    sets = lab_rays.closest_sets(scene, args.width, args.height)
    run(scene, tree, sets, args.reps, log=lambda m: print(m, flush=True))
    print(f"r3_oct_lab on {lab_rays.card_line()} (SM clock read after the "
          "runs)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
