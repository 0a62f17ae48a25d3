"""The deferred-leaf ("queued") walk in plain torch: the walk of the
production sub-packet kernel K1 (raytracer_tpu/ops/pallas_subpacket.py:329)
that the traversal lab's L4 (tools/v3_kernel_lab.py), L5
(tools/v4_interleave_lab.py), L6 (tools/r3_kernel_lab.py) and L7
(tools/r3_oct_lab.py) vary, run per ray and vectorised over rays, and its
any-hit form (K2, :423, and L8, tools/r3_occl3_lab.py).
csrc/lab2_traverse.cu is its CUDA version; the two are equal bit for bit.
The last section launches the persistent lab kernels (L1, L2 and L9 of
csrc/lab_traverse.cu, L3-L8) and reads their launch shapes.

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
smaller t_near), the 4-wide one (qnodes/qmeta, the near child the TPU
kernel's 2-bit argmin, or no near child: child order) and the 8-wide one
(onodes/ometa of lab/r3_oct_lab.collapse_bvh8, the near child a 3-bit
tournament). The any-hit walk tests leaves against t_max and ends a ray at
its first occluder. A ray whose t_max <= 1e-3 is not walked, as in K1-K4.
The slab test, Möller–Trumbore and the leaf loops are
ops/quad_traverse.py's, so every term keeps its order.
"""

from __future__ import annotations

import torch

from raytracer_tpu_torch.ops.binary_traverse import _binary_children
from raytracer_tpu_torch.ops.quad_traverse import (
    BIG,
    T_MIN,
    _any_leaf,
    _closest_leaves,
    _init_best,
    _push,
    _quad_children,
    _serial_leaf,
    _slab_children,
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


def _near_last(kids, hit, near):
    """The pushes of a node step: the hit children in child order but the
    near one, then the near one (if hit) last."""
    pushes = [(kids[:, c], hit[:, c] & (near != c))
              for c in range(kids.shape[1])]
    pushes.append((kids.gather(1, near[:, None])[:, 0],
                   hit.gather(1, near[:, None])[:, 0]))
    return pushes


def quad_step(origin, inv, qmeta, qnodes, ordered=True):
    """The 4-wide internal step: the hit children in child order but the
    near one, then the near one last (`ordered`); or all of them in child
    order (the production any-hit kernel's order,
    pallas_subpacket.py:486-490)."""
    metas4 = qmeta.view(-1, 4)

    def step(rays, node, t_cap):
        kids, hit, near = _quad_children(origin, inv, metas4, qnodes, rays,
                                         node, t_cap)
        if ordered:
            return _near_last(kids, hit, near)
        return [(kids[:, c], hit[:, c]) for c in range(4)]

    return step


def oct_near(tn):
    """tools/r3_oct_lab.py:182-198: the near child of t_near f32[M,8] (BIG
    for a missed child) by a 3-bit tournament; every level compares with a
    strict <, so a tie goes to the lower index."""
    m = tn.unbind(1)
    b = [(m[2 * j + 1] < m[2 * j]).to(torch.int64) for j in range(4)]
    m2 = [torch.minimum(m[2 * j], m[2 * j + 1]) for j in range(4)]
    lo_hi = m2[1] < m2[0]
    hi_hi = m2[3] < m2[2]
    use_hi = torch.minimum(m2[2], m2[3]) < torch.minimum(m2[0], m2[1])
    near_lo = torch.where(lo_hi, 2 + b[1], b[0])
    near_hi = torch.where(hi_hi, 6 + b[3], 4 + b[2])
    return torch.where(use_hi, near_hi, near_lo)


def oct_step(origin, inv, ometa, onodes):
    """The 8-wide internal step (tools/r3_oct_lab.py:154-234 per ray):
    slab-test the 8 children of oct nodes `node` (onodes columns 0-47, NaN
    boxes for absent children) against [1e-3, t_cap] and push the hit ones
    in child order but the near one, then the near one last."""
    metas8 = ometa.view(-1, 8)

    def step(rays, node, t_cap):
        hit, tn = _slab_children(origin[rays], inv[rays], onodes[node, :48],
                                 t_cap, T_MIN)
        near = oct_near(torch.where(hit, tn, BIG))
        return _near_last(metas8[node], hit, near)

    return step


def _pair_any(flags):
    """Per ray, flags[ray] | flags[partner], rays 2j and 2j+1 being
    partners (an odd last ray has none)."""
    n = flags.shape[0]
    padded = torch.cat([flags, flags.new_zeros(n % 2)])
    return padded.view(-1, 2).any(1).repeat_interleave(2)[:n]


def _init_walk(t_max, root, descent):
    """(stack, sp, lq, ln, cur) of every ray before its first step: the
    root on the stack (in `cur` with descent), or its leaf block in the
    queue when root < 0; nothing for a ray whose t_max <= 1e-3."""
    n = t_max.shape[0]
    i32 = dict(dtype=torch.int32, device=t_max.device)
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
    return stack, sp, lq, ln, cur


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
    steps (a step sat out is none). Returns (t f32[N], tri i32[N], u
    f32[N], v f32[N])."""
    best = _init_best(t_max)
    stack, sp, lq, ln, cur = _init_walk(t_max, root, descent)
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
        _count(counts, leaf_rays, node_rays)

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


def _count(counts, leaf_rays, node_rays):
    """Add one step to the rays of this iteration and one leaf step to
    those of its leaf step."""
    if counts is not None:
        counts[0][leaf_rays] += 1
        counts[0][node_rays] += 1
        counts[1][leaf_rays] += 1


def queued_any_walk(origin, direction, t_max, skip_object, root, ptris, step,
                    drain_at=DRAIN_AT, counts=None, leaf_test=_any_leaf):
    """Any hit of every ray by the deferred-leaf walk from `root` (the
    any-hit kernels of tools/r3_occl3_lab.py:36 and
    pallas_subpacket.py:423, per ray): a leaf step tests its block against
    t_max with `leaf_test` (called as _any_leaf), a triangle of the ray's
    `skip_object` (i32[N], compared as f32) not counting, and an occluded
    ray stops (the row exit of r3_occl3_lab.py:68-78, per ray); an internal
    step slab-tests against [1e-3, t_max] and pushes as `step` (quad_step)
    says. `counts` as in queued_walk. Returns occ bool[N]."""
    skip_f = skip_object.to(torch.float32)
    occ = torch.zeros(t_max.shape, dtype=torch.bool, device=t_max.device)
    stack, sp, lq, ln, _ = _init_walk(t_max, root, False)
    while True:
        has_node = sp > 0
        if not bool((has_node | (ln > 0)).any()):
            break
        leaf_kind = (ln >= drain_at) | (~has_node & (ln > 0))
        leaf_rays = torch.nonzero(leaf_kind).squeeze(1)
        node_rays = torch.nonzero(~leaf_kind & has_node).squeeze(1)
        _count(counts, leaf_rays, node_rays)

        if leaf_rays.numel():
            ln[leaf_rays] -= 1
            blk = lq[leaf_rays, ln[leaf_rays].long()]
            found = leaf_test(origin[leaf_rays], direction[leaf_rays],
                              ptris[blk.long()], t_max[leaf_rays],
                              skip_f[leaf_rays], T_MIN)
            occ[leaf_rays] |= found
            done = leaf_rays[found]
            sp[done] = 0
            ln[done] = 0

        if node_rays.numel():
            spr = sp[node_rays] - 1
            sp[node_rays] = spr
            node = stack[node_rays, spr.long()]
            for meta, hit in step(node_rays, node.long(), t_max[node_rays]):
                leaf = meta < 0
                _push(stack, sp, node_rays, meta, hit & ~leaf)
                _push(lq, ln, node_rays, ~meta, hit & leaf)
    return occ


def step_stats(counts, t_max):
    """(mean, p90) steps per live ray (t_max > 1e-3) and leaf steps per
    live ray of a walk's counts (nit, nleaf)."""
    live = t_max > T_MIN
    nit = counts[0][live].to(torch.float32)
    if not nit.numel():
        return 0.0, 0.0, 0.0
    return (float(nit.mean()), float(torch.quantile(nit, 0.9)),
            float(counts[1][live].to(torch.float32).mean()))


def check_binary(scene):
    """The binary queued walk's stack holds internal nodes only: at most one
    pending far child per level plus the two of the node expanded, so
    depth + 2 <= CAP."""
    if scene.bvh_max_depth + 2 > CAP:
        raise ValueError(
            f"BVH depth {scene.bvh_max_depth} exceeds the queued walk's "
            f"stack (CAP={CAP})")


def check_need(need, what):
    """The persistent lab walks (L2, L6, L7, L8) place `need` stack entries
    a thread (and the queued walks the queue's LQ) in shared memory: a
    `what` tree's need must be in 1..CAP, the plain walks' stack."""
    if not 1 <= need <= CAP:
        raise ValueError(f"{what} stack need {need} is outside 1..{CAP} "
                         f"(the lab walks' stack, CAP={CAP})")


def check_quad_rows(scene, device):
    """What the persistent 4-wide lab walks (L2, L6, L8) read of `scene` on
    `device`: a stack need they take, the qnodes rows (their metas in
    float4 6; qmeta is not read) and ptris."""
    from raytracer_tpu_torch.ops.quad_traverse import _check_ptris, _require

    check_need(scene.q_stack_need, "quad-BVH")
    _require("qnodes", scene.qnodes, torch.float32,
             (scene.qnodes.shape[0], 32), device, vec=True)
    _check_ptris(scene.ptris, device)


def check_drain_at(drain_at, width=2):
    """drain_at in 1..LQ - width: an internal step of a `width`-wide tree,
    taken while ln < drain_at, queues at most `width` leaves, so the queue
    never overflows."""
    if not 1 <= drain_at <= LQ - width:
        raise ValueError(f"drain_at {drain_at} is not in 1..{LQ - width} "
                         f"(LQ={LQ}, a {width}-wide step)")


# --------------------------------------------------------------------------
# Launching the persistent lab kernels (csrc/lab2_traverse.cu, and L2 of
# csrc/lab_traverse.cu).
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


L6_LEAF_KINDS = ("serial", "divfree", "ilp")  # lab_closest4_queued's order
L4_VARIANTS = ("base", "nocond", "dblread")  # lab_closest_queued's order
L5_VARIANTS = ("shared", "switch")  # lab_closest_pair's shared = 1, 0


def l6_kernel(descent, leaf_kind):
    """The LAUNCH_KERNELS key of L6 with `descent` and leaf kind
    `leaf_kind` (an index of L6_LEAF_KINDS)."""
    return f"closest4_queued_{L6_LEAF_KINDS[leaf_kind]}_d{int(descent)}"


def l4_kernel(variant):
    """The LAUNCH_KERNELS key of L4's `variant` (L4_VARIANTS)."""
    return f"binary_queued_{variant}"


def l5_kernel(variant):
    """The LAUNCH_KERNELS key of L5's `variant` (L5_VARIANTS)."""
    return f"closest_pair_{variant}"


def l1_kernel(variant, leaf=None, block=128):
    """The LAUNCH_KERNELS key of L1's `variant` (lab/kernel_lab.VARIANTS;
    leafilp at leaf size `leaf`) at `block` threads a block (L1b)."""
    if variant in ("base", "nored"):
        return "lab_closest_base" if block == 128 else f"lab_closest_ts{block}"
    return f"lab_closest_{variant}{leaf if variant == 'leafilp' else ''}"


_L1_ILP = "closest_lab_persistent_kernelILi{}ELi{}EE"  # kIlpLeaf, kBlock

# kernel -> (library, its mangled name's distinctive part, the library's
# launch-info index). The lab_traverse library holds L2, L1 and L9,
# lab2_traverse L3-L8.
LAUNCH_KERNELS = {
    "closest4_ordered": ("lab_traverse", "closest4_persistent_kernelILb1E",
                         0),
    "closest4_noorder": ("lab_traverse", "closest4_persistent_kernelILb0E",
                         1),
    "lab_closest_base": ("lab_traverse", _L1_ILP.format(0, 128), 2),
    "lab_closest_leafilp8": ("lab_traverse", _L1_ILP.format(8, 128), 3),
    "lab_closest_leafilp16": ("lab_traverse", _L1_ILP.format(16, 128), 4),
    "lab_closest_pop2": ("lab_traverse", "closest_multipop_kernelILi2E", 5),
    "lab_closest_pop4": ("lab_traverse", "closest_multipop_kernelILi4E", 6),
    **{f"lab_closest_ts{block}": ("lab_traverse", _L1_ILP.format(0, block),
                                  index)
       for index, block in ((7, 64), (8, 256), (9, 512), (10, 1024))},
    "lab_occlusion_ordered": ("lab_traverse",
                              "occlusion_lab_persistent_kernelILb1E", 11),
    "lab_occlusion_noorder": ("lab_traverse",
                              "occlusion_lab_persistent_kernelILb0E", 12),
    "closest8": ("lab2_traverse", "closest8_queued_kernel", 0),
    "occlusion_ordered": ("lab2_traverse", "occlusion4_queued_kernelILb1E",
                          1),
    "occlusion_fixed": ("lab2_traverse", "occlusion4_queued_kernelILb0E", 2),
    **{l6_kernel(descent, kind): (
        "lab2_traverse",
        f"closest4_queued_persistent_kernelILb{descent}ELi{kind}EE",
        3 + 2 * kind + descent)
       for kind in range(len(L6_LEAF_KINDS)) for descent in (0, 1)},
    "closest_cm": ("lab2_traverse", "closest_cm_persistent_kernel", 9),
    **{l4_kernel(variant): ("lab2_traverse",
                            f"binary_queued_kernelILi{code}E", 10 + code)
       for code, variant in enumerate(L4_VARIANTS)},
    **{l5_kernel(variant): ("lab2_traverse",
                            f"pair_queued_kernelILb{int(variant == 'shared')}E",
                            13 + code)
       for code, variant in enumerate(L5_VARIANTS)},
}
_INFO_ENTRY = {"lab_traverse": "lab_launch_info",
               "lab2_traverse": "lab2_launch_info"}


def launch_info(kernel, need, device):
    """What a launch of a persistent lab kernel (a key of LAUNCH_KERNELS:
    L2 "closest4_ordered" or "closest4_noorder", L1 l1_kernel(...), L9
    "lab_occlusion_ordered" or "lab_occlusion_noorder", L3 "closest_cm", L4
    l4_kernel(...), L5 l5_kernel(...), L6 l6_kernel(...), L7 "closest8",
    L8 "occlusion_ordered" or "occlusion_fixed") at stack need `need`
    looks like on `device`: quad_traverse.launch_info's keys (the queued
    walks' shared memory holds the leaf queue too, L5's two stacks and two
    queues), and "spills",
    the ptxas spill stores and loads in bytes ("?" when the library was
    loaded from the build directory's cache)."""
    import ctypes

    from raytracer_tpu_torch.ops import _build
    from raytracer_tpu_torch.ops.quad_traverse import LAUNCH_INFO_KEYS

    library, name, index = LAUNCH_KERNELS[kernel]
    entry = _INFO_ENTRY[library]
    out = (ctypes.c_int * len(LAUNCH_INFO_KEYS))()
    with torch.cuda.device(device):
        rc = getattr(getattr(_build, f"{library}_lib")(), entry)(index, need,
                                                               out)
    if rc != 0:
        raise RuntimeError(f"{entry} failed: cudaError {rc}")
    info = dict(zip(LAUNCH_INFO_KEYS, out))
    log = _build.build_info.get(f"lib{library}", {}).get("log", "")
    info["spills"] = _build.ptxas_spills(log, name)
    return info


def launch_line(label, kernel, need, device):
    """One line of launch_info(kernel, need, device), labelled `label`,
    with the rays in flight a SM (L5: two a thread)."""
    i = launch_info(kernel, need, device)
    st, ld = i["spills"]
    queued = (LAUNCH_KERNELS[kernel][0] == "lab2_traverse"
              and kernel != "closest_cm")
    queue = f" + LQ {LQ}" if queued else ""
    pair = kernel.startswith("closest_pair_")
    if pair:
        queue += ", twice"
    threads = i["threads"] * i["blocks_per_sm"]
    return (f"{label} launch: {i['registers']} registers, spill stores {st} "
            f"B, spill loads {ld} B, local {i['local_bytes']} B a thread, "
            f"dynamic shared {i['smem_bytes']} B a block (stack need {need}"
            f"{queue}), {i['blocks_per_sm']} blocks of {i['threads']} a SM "
            f"({threads // 32} warps, {threads * (2 if pair else 1)} rays in "
            f"flight), grid {i['grid']} blocks on "
            f"{i['sms']} SMs; G = {i['group']}, refill at {i['refill_at']} "
            "idle lanes")


def launch(entry, device, *args, library="lab2_traverse"):
    """Call `entry` of csrc/<library>.cu (lab2_traverse or lab_traverse)
    with `args` on `device`'s current stream (appended); raise if the
    launch failed."""
    from raytracer_tpu_torch.ops import _build
    from raytracer_tpu_torch.ops.quad_traverse import _stream

    lib = getattr(_build, f"{library}_lib")()
    with torch.cuda.device(device):
        rc = getattr(lib, entry)(*args, _stream(device))
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError {rc}")
