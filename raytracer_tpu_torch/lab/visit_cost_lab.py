"""Visit-cost lab L11: where the time of one traversal visit goes, the
port's counterpart of tools/visit_cost_lab.py (`main` :255, its
`pallas_call` :266, L11a; `leaf_main` :219, its `pallas_call` :231, L11b).

    python -m raytracer_tpu_torch.lab.visit_cost_lab [--leaf]

Bakes the atrium with leaf 8 (as the JAX lab) and walks a fixed sequence
(lab/fixed_seq.py): row i % rows at iteration i, the same for every ray,
so each variant does the same number of visits whatever the scene. For
each variant, at the lab size and at the card size, prints the kernel's
clock64() cycles per iteration, its time (CUDA events) and ns per
ray-iteration, beside the card's SM clock; on the card it first prints
each variant's launch shape.

L11a (`run_visit`), K_VISIT = 262,144 internal-node visits over pnodes,
one component ablated at a time (csrc/lab3_traverse.cu:visit_kernel):
  full      row read, two slab tests, four reductions (near_l, near_r,
            any_l, any_r), the swap
  nored     the slab tests, no reductions (lane 0's hit_l, tn_l, tn_r)
  noslab    row read and the reductions on the constant t cap
  extracts  row read and the sum of its 12 box floats
  rowonly   row read only
  empty     loop overhead only
Each thread holds one ray; the TPU kernel's reductions over its 32x128
tile are reductions over a warp of 32 here (and over groups of 32
consecutive rays in the plain version), so the wrapper takes a multiple
of 32 rays. On the lab's rays, one ray in every lane, every scope gives
the TPU kernel's output. A minimum is one redux.sync of the values'
uint32 bit patterns, which order as the floats do because every value
reduced is positive (minimum_inputs gives them); the rows are copied 4
rows ahead of the tests (cp.async into a ring of rows in shared memory,
one a warp), so no iteration waits on its row's load.

L11b (`run_leaf_visit`), K_LEAF = 32,768 leaf visits of 8 Moller-Trumbore
tests over ptris, from best t 1e4 and best triangle -1, at the JAX lab's
tile heights 8 and 32 (1024 and 4096 rays):
  base      the serial leaf (closest_leaf's tests), the row read from
            global memory, each row's sectors touched into L1 4 visits
            ahead
  ilp       all 8 against the entry best t, then the min tree (ilp_leaf's)
  slice     base on the row as a slice (the TPU's row broadcast): a
            warp's ring of rows in shared memory, filled by cp.async rows
            ahead, read as broadcasts (csrc/lab3_traverse.cu:
            slice_visit_kernel)
  sliceilp  ilp likewise
`slice` computes what `base` computes and `sliceilp` what `ilp` does, by
other kernels.

Outputs, per ray, are the TPU kernels' int32: L11a the accumulator, L11b
btri + int(bt) (acc[:8] + bt[:8].astype(int32) for rows 0-7), wrapping
and converting as fixed_seq.wrap_i32 and sat_i32 do. On CUDA tensors the
wrappers launch csrc/lab3_traverse.cu:lab_visit and lab_leaf_visit; on CPU
tensors they run the plain torch versions below, which the kernels equal
bit for bit and the tests compare with the JAX lab kernels.
"""

from __future__ import annotations

import argparse
import re
import sys

import torch

from raytracer_tpu_torch.lab import fixed_seq as fs
from raytracer_tpu_torch.lab import rays as lab_rays
from raytracer_tpu_torch.lab.kernel_lab import _ilp_leaf
from raytracer_tpu_torch.ops.quad_traverse import (
    BIG,
    T_MIN,
    _inv_dir,
    _serial_leaf,
    _slab_children,
)

LEAF_SIZE = 8
VISIT_VARIANTS = ("full", "nored", "noslab", "extracts", "rowonly", "empty")
LEAF_VARIANTS = ("base", "ilp", "slice", "sliceilp")
# Whether a variant computes the ILP leaf (its plain version's leaf).
LEAF_ILP = {"base": 0, "slice": 0, "ilp": 1, "sliceilp": 1}
VISIT_LAB_RAYS = (fs.TILE_S * fs.TILE_L,)  # one 32x128 tile
LEAF_LAB_RAYS = (8 * fs.TILE_L, fs.TILE_S * fs.TILE_L)  # tile heights 8, 32

# Kernel launches, counted where the CUDA wrappers launch.
visit_launches = 0
leaf_visit_launches = 0


def reset_launch_counts():
    global visit_launches, leaf_visit_launches
    visit_launches = 0
    leaf_visit_launches = 0


def run_visit(origin, direction, pnodes, variant, k=fs.K_VISIT,
              cycles=None):
    """L11a: `k` visits of the fixed node sequence over pnodes f32[NI,16]
    by rays f32[N,3] (N a multiple of 32). Returns the accumulator i32[N].
    `cycles`, fixed_seq.cycles_buffer(N), receives each warp's clock64()
    cycles (CUDA only)."""
    global visit_launches
    n = fs.check_inputs(origin, direction, pnodes, 16, variant,
                       VISIT_VARIANTS)
    if n % fs.WARP:
        raise ValueError(f"L11a reduces over warps of {fs.WARP} rays: {n} "
                         "rays is not a multiple")
    fs.check_k(k)
    if origin.is_cuda:
        out = fs.launch("lab_visit", origin, direction, pnodes, k,
                      VISIT_VARIANTS.index(variant), cycles)
        visit_launches += 1
        return out
    return visit_plain(origin, direction, pnodes, variant, k)


def run_leaf_visit(origin, direction, ptris, variant, k=fs.K_LEAF,
                   cycles=None):
    """L11b: `k` visits of the fixed leaf sequence over ptris f32[NB,96]
    (leaf 8) by rays f32[N,3]. Returns btri + int(bt) i32[N]."""
    fs.check_inputs(origin, direction, ptris, LEAF_SIZE * 12, variant,
                    LEAF_VARIANTS)
    fs.check_k(k)
    if origin.is_cuda:
        return _leaf_visit_cuda(origin, direction, ptris, variant, k, cycles)
    return fs.leaf_out(*leaf_visit_plain(origin, direction, ptris, variant, k))


def _leaf_visit_cuda(origin, direction, ptris, variant, k, cycles):
    """lab_leaf_visit with the variant's code, its index in LEAF_VARIANTS
    (each variant its own kernel)."""
    global leaf_visit_launches
    out = fs.launch("lab_leaf_visit", origin, direction, ptris, k,
                    LEAF_VARIANTS.index(variant), cycles)
    leaf_visit_launches += 1
    return out


# --------------------------------------------------------------------------
# Plain torch versions.
# --------------------------------------------------------------------------

def _groups(x):
    """[N] per ray -> [N/32, 32] per warp."""
    return x.view(-1, fs.WARP)


def _per_ray(x):
    """[N/32] per warp -> [N] per ray."""
    return x.repeat_interleave(fs.WARP)


def _minimum_inputs(origin, inv, row, t_cap, variant):
    """What one iteration of `full` or `noslab` on pnodes row `row` reduces
    over a warp, per ray: (near_l, near_r), the values of its two minimums
    (a hit child's t_near, else BIG; noslab: t_cap or BIG), and (any_l,
    any_r), the flags of its two anys."""
    if variant == "noslab":
        return ((torch.where(t_cap > row[0], t_cap, BIG),
                 torch.where(t_cap > row[6], t_cap, BIG)),
                (t_cap > row[1], t_cap > row[7]))
    hit, tn = _slab_children(origin, inv, row[:12].expand(
        origin.shape[0], 12), t_cap, T_MIN)
    return ((torch.where(hit[:, 0], tn[:, 0], BIG),
             torch.where(hit[:, 1], tn[:, 1], BIG)), (hit[:, 0], hit[:, 1]))


def minimum_inputs(origin, direction, pnodes, variant, k):
    """The values `full` or `noslab` (`variant`) reduces with its two warp
    minimums over k iterations of the fixed sequence: f32[k, 2, N]. The
    kernel's redux.sync of their bit patterns gives the float minimum only
    where every one is positive."""
    t_cap = torch.full((origin.shape[0],), fs.T_CAP, dtype=torch.float32,
                       device=origin.device)
    inv = _inv_dir(direction)
    return torch.stack([torch.stack(_minimum_inputs(
        origin, inv, pnodes[it % pnodes.shape[0]], t_cap, variant)[0])
        for it in range(k)])


def visit_plain(origin, direction, pnodes, variant, k):
    """Plain torch version of lab_visit's `variant` (the reductions over
    groups of 32 consecutive rays). Returns i32[N]."""
    n = origin.shape[0]
    dev = origin.device
    acc = torch.zeros((n,), dtype=torch.int64, device=dev)
    if variant == "empty":
        return fs.wrap_i32(acc + k * (k - 1) // 2)
    inv = _inv_dir(direction)
    t_cap = torch.full((n,), fs.T_CAP, dtype=torch.float32, device=dev)
    ni = pnodes.shape[0]
    meta = fs.sat_i32(pnodes[:, 12:14]).to(torch.int64)
    for it in range(k):
        row = pnodes[it % ni]
        lmeta, rmeta = meta[it % ni]
        if variant == "rowonly":
            acc += fs.sat_i32(row[0])
            continue
        if variant == "extracts":
            s = row[0]
            for c in range(1, 12):
                s = s + row[c]
            acc += fs.sat_i32(s) + lmeta + rmeta
            continue
        if variant == "nored":
            hit, tn = _slab_children(origin, inv, row[:12].expand(n, 12),
                                     t_cap, T_MIN)
            h0, tl0, tr0 = (_per_ray(_groups(a)[:, 0]) for a in
                            (hit[:, 0], tn[:, 0], tn[:, 1]))
            acc += (torch.where(h0, lmeta, rmeta) + fs.sat_i32(tl0)
                    + fs.sat_i32(tr0))
            continue
        (near_l, near_r), (any_l, any_r) = _minimum_inputs(
            origin, inv, row, t_cap, variant)
        near_l, near_r = (_per_ray(_groups(a).amin(1))
                          for a in (near_l, near_r))
        any_l, any_r = (_per_ray(_groups(a).any(1)) for a in (any_l, any_r))
        swap = near_r < near_l
        if variant == "noslab":
            acc += torch.where(swap, rmeta, lmeta)
        else:
            acc += (torch.where(swap, rmeta, lmeta)
                    + torch.where(swap, lmeta, rmeta))
        acc += any_l.to(torch.int64) + any_r.to(torch.int64)
    return fs.wrap_i32(acc)


def leaf_visit_plain(origin, direction, ptris, variant, k):
    """Plain torch version of lab_leaf_visit's `variant`. Returns the
    per-ray record (btri i32[N], bt f32[N])."""
    n = origin.shape[0]
    dev = origin.device
    bt = torch.full((n,), fs.T_CAP, dtype=torch.float32, device=dev)
    btri = torch.full((n,), -1, dtype=torch.int32, device=dev)
    bu = bv = torch.zeros_like(bt)
    leaf = _ilp_leaf if LEAF_ILP[variant] else _serial_leaf
    nb = ptris.shape[0]
    for it in range(k):
        rows = ptris[it % nb].expand(n, ptris.shape[1])
        bt, btri, bu, bv = leaf(origin, direction, rows, bt, btri, bu, bv,
                                T_MIN)
    return btri, bt


def loop_body(sass, kernel):
    """The instructions (their text) of the longest loop that makes no call
    of the function whose name contains `kernel` in `sass` (cuobjdump -sass
    output): from a backward branch's target to the branch, both included.
    That is one iteration of L11a's K loop, and of L11b's and L10's on the
    fast path (their exact rerun, a loop that calls the division's slow
    path, is not it)."""
    ins, labels, pending, inside = [], {}, [], False
    for text in sass.splitlines():
        if "Function :" in text:
            if inside:
                break
            inside = kernel in text
            continue
        if not inside:
            continue
        m = re.match(r"\s*(\.L_x_\d+):", text)
        if m:
            pending.append(m.group(1))
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", text)
        if m:
            addr = int(m.group(1), 16)
            labels.update((label, addr) for label in pending)
            pending = []
            ins.append((addr, m.group(2)))
    longest = []
    for addr, op in ins:
        m = re.search(r"\bBRA\b.*?(?:`\((\.L_x_\d+)\)|(0x[0-9a-f]+))", op)
        if not m:
            continue
        target = labels[m.group(1)] if m.group(1) else int(m.group(2), 16)
        body = [text for a, text in ins if target <= a <= addr]
        calls = any(re.match(r"(@!?U?P\w+\s+)?CALL\b", t) for t in body)
        if target <= addr and not calls and len(body) > len(longest):
            longest = body
    return longest


# --------------------------------------------------------------------------
# The lab.
# --------------------------------------------------------------------------

def run(scene, reps=fs.REPS, log=print, k=fs.K_VISIT):
    """L11a: every variant at the lab size and at the card size, on the
    lab's rays. Returns {(size label, variant): fixed_seq.timed's dict}.
    On the card it first prints each variant's launch shape."""
    if scene.pnodes.is_cuda:
        for index in range(len(VISIT_VARIANTS)):
            log(fs.launch_line(index, scene.pnodes.device))
    results = {}
    for label, n in fs.sizes(scene.device, VISIT_LAB_RAYS):
        o, d = fs.lab_rays_const(n, scene.device)
        for variant in VISIT_VARIANTS:
            r = results[(label, variant)] = fs.timed(
                lambda c, v=variant: run_visit(o, d, scene.pnodes, v, k, c),
                k, n, reps)
            log(fs.line(label, variant, r, "iter"))
    return results


def run_leaf(scene, reps=fs.REPS, log=print, k=fs.K_LEAF):
    """L11b: every variant at both lab sizes and at the card size, on the
    lab's rays. Returns {(size label, variant): fixed_seq.timed's dict}.
    On the card it first prints each variant's launch shape."""
    if scene.ptris.is_cuda:
        for v in LEAF_VARIANTS:
            log(fs.launch_line(fs.launch_index(f"L11b {v}"),
                               scene.ptris.device))
    results = {}
    for label, n in fs.sizes(scene.device, LEAF_LAB_RAYS):
        o, d = fs.lab_rays_const(n, scene.device)
        for variant in LEAF_VARIANTS:
            r = results[(label, variant)] = fs.timed(
                lambda c, v=variant: run_leaf_visit(o, d, scene.ptris, v, k,
                                                    c),
                k, n, reps)
            log(fs.line(label, variant, r, "visit")
                + f"  ({r['cycles_per_iter'] / LEAF_SIZE:.1f} cyc/tri)")
    return results


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--leaf", action="store_true",
                   help="the leaf-visit variants (L11b)")
    p.add_argument("--reps", type=int, default=fs.REPS)
    args = p.parse_args(argv)
    device = lab_rays.require_cuda()
    scene = lab_rays.atrium(LEAF_SIZE, device)
    say = lambda m: print(m, flush=True)  # noqa: E731
    if args.leaf:
        run_leaf(scene, args.reps, log=say)
    else:
        run(scene, args.reps, log=say)
    print(f"visit_cost_lab on {lab_rays.card_line()} (SM clock read after "
          "the runs)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
