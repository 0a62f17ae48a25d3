"""The deferred-leaf ("queued") walk in plain torch: the walk of the
production sub-packet kernel K1 (raytracer_tpu/ops/pallas_subpacket.py:329)
that the traversal lab's L4 (tools/v3_kernel_lab.py), L5
(tools/v4_interleave_lab.py) and L6 (tools/r3_kernel_lab.py) vary, run per
ray and vectorised over rays. csrc/lab2_traverse.cu is its CUDA version;
the two are equal bit for bit.

State per ray: an internal-node stack of CAP entries, a leaf queue of LQ
blocks and, for descent, the node kept in a register (`cur`, -1 when
none). Each iteration every live ray takes one step:

  - a leaf step when ln >= drain_at or (no node pending and ln > 0): pop
    the queue's top block and test it with the leaf hook (serial, ILP or
    division-free) against the ray's best hit;
  - otherwise an internal step: take `cur` if descent holds one, else pop
    the stack, slab-test the node's children against [1e-3, best t] and
    push the hit ones far first, near last. A hit child with meta < 0 goes
    into the queue as ~meta; any other goes on the stack (the near one, with
    descent, into `cur`).

The node steps are the binary one (pnodes columns 0-13, far/near by the
smaller t_near) and the 4-wide one (qnodes/qmeta, the near child the TPU
kernel's 2-bit argmin). A ray whose t_max <= 1e-3 is not walked, as in
K1-K4. The slab test, Möller–Trumbore and the leaf loops are
ops/quad_traverse.py's, so every term keeps its order.
"""

from __future__ import annotations

import torch

from raytracer_tpu_torch.ops.binary_traverse import _binary_children
from raytracer_tpu_torch.ops.quad_traverse import (
    T_MIN,
    _closest_leaves,
    _init_best,
    _push,
    _quad_children,
    _serial_leaf,
)

CAP = 64  # internal-node stack entries per ray
LQ = 16  # leaf-queue blocks per ray
DRAIN_AT = 4  # the production kernel's drain threshold


def binary_step(origin, inv, pnodes, dblread=False):
    """The binary internal step: returns step(rays, node, t_cap) -> [(far
    meta, far hit), (near meta, near hit)]. `dblread` also reads row
    max(node - 1, 0) and folds its first float, times 0.0, into the t cap
    (tools/v3_kernel_lab.py:179-186)."""

    def step(rays, node, t_cap):
        if dblread:
            extra = pnodes[torch.clamp_min(node - 1, 0), 0]
            t_cap = t_cap * (1.0 + 0.0 * extra)
        return _binary_children(origin, inv, pnodes, T_MIN, rays, node,
                                t_cap)

    return step


def quad_step(origin, inv, qmeta, qnodes):
    """The 4-wide internal step: the hit children in child order but the
    near one, then the near one last."""
    metas4 = qmeta.view(-1, 4)

    def step(rays, node, t_cap):
        kids, hit, near = _quad_children(origin, inv, metas4, qnodes, rays,
                                         node, t_cap)
        pushes = [(kids[:, c], hit[:, c] & (near != c)) for c in range(4)]
        pushes.append((kids.gather(1, near[:, None])[:, 0],
                       hit.gather(1, near[:, None])[:, 0]))
        return pushes

    return step


def _pair_any(flags):
    """Per ray, flags[ray] | flags[partner], rays 2j and 2j+1 being
    partners (an odd last ray has none)."""
    n = flags.shape[0]
    padded = torch.cat([flags, flags.new_zeros(n % 2)])
    return padded.view(-1, 2).any(1).repeat_interleave(2)[:n]


def queued_walk(origin, direction, t_max, root, ptris, step,
                leaf_test=_serial_leaf, drain_at=DRAIN_AT, descent=False,
                drop_leaves=False, paired=False, counts=None):
    """Closest hit of every ray by the deferred-leaf walk from `root` (an
    internal node, or a leaf block ~root when < 0). `step` is binary_step
    or quad_step; `leaf_test` the leaf hook, called as _serial_leaf;
    `descent` keeps the near internal child in `cur`; `drop_leaves` drops
    leaf children at push time (L4 `nocond`); `paired` makes rays 2j and
    2j+1 take one step kind, a leaf step if either's drain condition holds
    (L5 `shared`), a ray with nothing of that kind sitting the step out;
    `counts` (nit, nleaf), i32[N] each, adds up each ray's steps and leaf
    steps. Returns (t f32[N], tri i32[N], u f32[N], v f32[N])."""
    n = origin.shape[0]
    i32 = dict(dtype=torch.int32, device=origin.device)
    best = _init_best(t_max)
    walked = (t_max > T_MIN).to(torch.int32)
    stack = torch.zeros((n, CAP), **i32)
    lq = torch.zeros((n, LQ), **i32)
    sp = torch.zeros((n,), **i32)
    ln = torch.zeros((n,), **i32)
    cur = torch.full((n,), -1, **i32)
    if root < 0:
        lq[:, 0] = ~root
        ln = walked
    elif descent:
        cur = torch.where(walked > 0, root, -1).to(torch.int32)
    else:
        stack[:, 0] = root
        sp = walked
    while True:
        has_node = (cur >= 0) | (sp > 0)
        alive = has_node | (ln > 0)
        if not bool(alive.any()):
            break
        leaf_kind = (ln >= drain_at) | (~has_node & (ln > 0))
        if paired:
            leaf_kind = _pair_any(leaf_kind)
        leaf_rays = torch.nonzero(leaf_kind & (ln > 0)).squeeze(1)
        node_rays = torch.nonzero(~leaf_kind & has_node).squeeze(1)
        if counts is not None:
            counts[0].add_(alive.to(torch.int32))
            counts[1].add_((leaf_kind & alive).to(torch.int32))

        if leaf_rays.numel():
            ln[leaf_rays] -= 1
            blk = lq[leaf_rays, ln[leaf_rays].long()]
            _closest_leaves(origin, direction, ptris, best, leaf_rays, ~blk,
                            T_MIN, leaf_test)

        if node_rays.numel():
            c = cur[node_rays]
            take_cur = c >= 0
            spr = sp[node_rays] - (~take_cur).to(torch.int32)
            sp[node_rays] = spr
            popped = stack[node_rays, torch.clamp_min(spr, 0).long()]
            node = torch.where(take_cur, c, popped)
            cur[node_rays] = -1
            pushes = step(node_rays, node.long(), best[0][node_rays])
            for j, (meta, hit) in enumerate(pushes):
                leaf = meta < 0
                if descent and j == len(pushes) - 1:
                    cur[node_rays] = torch.where(hit & ~leaf, meta, -1).to(
                        torch.int32)
                else:
                    _push(stack, sp, node_rays, meta, hit & ~leaf)
                if not drop_leaves:
                    _push(lq, ln, node_rays, ~meta, hit & leaf)
    return best


def check_binary(scene):
    """The binary queued walk's stack holds internal nodes only: at most one
    pending far child per level plus the two of the node expanded, so
    depth + 2 <= CAP."""
    if scene.bvh_max_depth + 2 > CAP:
        raise ValueError(
            f"BVH depth {scene.bvh_max_depth} exceeds the queued walk's "
            f"stack (CAP={CAP})")


def check_drain_at(drain_at):
    """drain_at in 1..LQ - 2: a binary internal step, taken while ln <
    drain_at, queues at most 2 leaves, so the queue never overflows."""
    if not 1 <= drain_at <= LQ - 2:
        raise ValueError(f"drain_at {drain_at} is not in 1..{LQ - 2} "
                         f"(LQ={LQ})")


# --------------------------------------------------------------------------
# Launching csrc/lab2_traverse.cu.
# --------------------------------------------------------------------------

def hit_outputs(n, device, counters=False):
    """Empty (t f32, tri i32, u f32, v f32[, nit i32, nleaf i32]) of n
    rays."""
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    out = (torch.empty((n,), **f32), torch.empty((n,), **i32),
           torch.empty((n,), **f32), torch.empty((n,), **f32))
    if counters:
        out += (torch.empty((n,), **i32), torch.empty((n,), **i32))
    return out


def launch(entry, device, *args):
    """Call csrc/lab2_traverse.cu's `entry` with `args` on `device`'s
    current stream (appended); raise if the launch failed."""
    from raytracer_tpu_torch.ops import _build
    from raytracer_tpu_torch.ops.quad_traverse import _stream

    lib = _build.lab2_traverse_lib()
    with torch.cuda.device(device):
        rc = getattr(lib, entry)(*args, _stream(device))
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError {rc}")
