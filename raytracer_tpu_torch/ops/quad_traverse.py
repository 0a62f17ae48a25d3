"""Closest-hit and any-hit traversal of the 4-wide collapsed BVH: the
port's counterpart of raytracer_tpu/ops/pallas_subpacket.py.

`intersect_quad` and `occlusion_quad` compute what the JAX package's
`intersect_bvh_subpacket` and `occlusion_bvh_subpacket` compute, on the
same arrays (scene/device_scene.py): for each ray the closest hit (t, tri,
u, v) with t in (1e-3, t_max), or whether any triangle not of the ray's
`skip_object` blocks (1e-3, t_max).

On CUDA tensors they launch the hand-written kernels of
csrc/quad_traverse.cu (built by ops/_build.py); on CPU tensors they run the
kernels' plain torch versions below. A CUDA tensor never takes the plain
version: the launch succeeds or the wrapper raises. The kernels run
persistent warps that take rays from a counter (one int32 allocated with
each launch), stop each leaf at its last real triangle (`leaf_counts`,
cached per ptris tensor) and read the child metas from the node rows
(qnodes lanes 24-27), not from qmeta; see the source's head comment.

The rule that keeps the cached leaf counts right: a ptris tensor is never
written in place. Every bake uploads a new one, a refit
(scene/device_scene.bake_scene(reuse_bvh=...)) included, and
update_materials keeps the old one, whose triangles it does not change. So
a count cached for a ptris tensor holds for as long as that tensor lives,
and a triangle that a refit makes real again (an object scaled back from
nothing) is always counted. ops/binary_traverse.py shares the counts and
the rule.

The algorithm, shared by kernel and plain version (the TPU kernel's 8-row
sub-packets, SMEM stacks and leaf queues exist because Mosaic has no
per-lane gathers, and do not carry over):

  - one depth-first traversal per ray with its own stack of CAP entries
    holding quad-node ids (>= 0) and leaf blocks (~block < 0); qroot < 0
    means the root itself is a leaf;
  - a leaf tests its block's triangles in order k = 0..leaf-1 with
    Möller–Trumbore (|det| > 1e-10) and, for closest hits, a strictly
    smaller t;
  - an internal node slab-tests its 4 children against [1e-3, best t]
    (t_max for any-hit) with NaN-propagating min/max, so the NaN boxes of
    absent children never hit. Closest hit pushes the hit children in
    child order 0..3 except the nearest, which goes last (popped first);
    the nearest is the TPU kernel's 2-bit argmin. Any-hit pushes in fixed
    order and stops at the first accepted hit;
  - a ray whose t_max <= 1e-3 (inactive lanes get exactly that) cannot
    accept a hit and is not traversed: t stays t_max, tri -1, u = v = 0.

Every float operation is written in the same order in both versions, and
the kernel is built with -fmad=false, so on the card the kernel equals its
plain version bit for bit. Against the JAX kernels, which visit leaves in
another order, only hits at exactly equal t may name another triangle.
"""

from __future__ import annotations

import ctypes
import weakref

import torch

from raytracer_tpu_torch.ops.intersect import HitRecord
from raytracer_tpu_torch.utils import profiling

CAP = 64  # per-ray stack entries (quad nodes and leaf blocks)
T_MIN = 1e-3  # the reference's traceRayEXT t_min, fixed in the kernels
BIG = 3.0e38
TRI_STRIDE = 12
MAX_RAYS = 1 << 30  # the kernels' int32 ray counter

# Kernel launches, counted where the CUDA wrappers launch (never by the
# plain versions), so a caller can show that a run went through them.
closest_launches = 0
occlusion_launches = 0
# id(ptris) -> (a weak reference to that ptris, its leaf counts)
_leaf_counts = {}


def reset_launch_counts():
    global closest_launches, occlusion_launches
    closest_launches = 0
    occlusion_launches = 0


def _check_scene(scene):
    if scene.q_stack_need > CAP:
        raise ValueError(
            f"quad-BVH stack need {scene.q_stack_need} exceeds the traversal "
            f"stack (CAP={CAP})")


def _check_t_min(t_min):
    if abs(t_min - T_MIN) > 1e-9:
        raise ValueError(
            f"the traversal kernels fix t_min at {T_MIN}, got {t_min}")


def _ray_inputs(origin, direction, t_max, active_mask, t_min=T_MIN):
    r = origin.shape[0]
    t = torch.as_tensor(t_max, dtype=torch.float32, device=origin.device)
    t = t.expand(r)
    if active_mask is not None:
        t = torch.where(active_mask, t, t_min)
    return (origin.to(torch.float32).contiguous(),
            direction.to(torch.float32).contiguous(),
            t.to(torch.float32).contiguous())


def intersect_quad(origin, direction, scene, t_min, t_max,
                   active_mask=None) -> HitRecord:
    """Closest hit of rays f32[N,3] against `scene` (a DeviceScene);
    `t_max` scalar or f32[N]; inactive lanes get t_max = 1e-3. A multi-part
    scene takes one pass per part (closest_passes). The `rt.trace` span."""
    _check_t_min(t_min)
    _check_scene(scene)
    with profiling.span("rt.trace", lanes=origin.shape[0]):
        o, d, tm = _ray_inputs(origin, direction, t_max, active_mask)

        def trace(t_cap, part):
            if o.is_cuda:
                return _intersect_quad_cuda(o, d, t_cap, part)
            return _intersect_quad_plain(o, d, t_cap, part.root, part.qmeta,
                                         part.qnodes, part.ptris)

        t, tri, u, v = closest_passes(o, tm, scene, trace)
        return HitRecord(t=t, tri=tri, u=u, v=v, hit=tri >= 0)


def occlusion_quad(origin, direction, t_min, t_max, scene, skip_object,
                   active_mask=None):
    """Any hit in (1e-3, t_max) by a triangle whose object is not the
    ray's `skip_object` (i32[N]); returns bool[N]. A multi-part scene takes
    one pass per part (any_passes). The `rt.occlusion` span."""
    _check_t_min(t_min)
    _check_scene(scene)
    with profiling.span("rt.occlusion", lanes=origin.shape[0]):
        o, d, tm = _ray_inputs(origin, direction, t_max, active_mask)
        skip = torch.as_tensor(skip_object, device=o.device).to(
            torch.int32).expand(o.shape[0]).contiguous()

        def trace(t_cap, part):
            if o.is_cuda:
                return _occlusion_quad_cuda(o, d, t_cap, skip, part)
            return _occlusion_quad_plain(o, d, t_cap, skip, part.root,
                                         part.qmeta, part.qnodes, part.ptris)

        return any_passes(o, tm, T_MIN, scene, trace)


# --------------------------------------------------------------------------
# Multi-part scenes (scene/device_scene.py): one pass per part, the JAX
# package's `_scene_parts` and per-part loops (ops/pallas_subpacket.py).
# --------------------------------------------------------------------------

def scene_parts(scene, origin):
    """The tables to trace `scene` with, one entry per pass: `scene`
    itself for a single-part scene; else its parts (DeviceScene.parts),
    near to far from the rays' centroid (the JAX order: distance from the
    centroid to each part root's box). The order cannot change a hit
    record, as each pass's cap only tightens; it makes early hits prune
    later parts. It costs one read of the order to the host a trace (an
    `rt.sync` span)."""
    if getattr(scene, "num_parts", 1) <= 1:
        return [scene]
    aabb = scene.part_aabb
    centroid = origin.mean(dim=0)
    clamped = torch.clamp(centroid[None, :], aabb[:, 0:3], aabb[:, 3:6])
    d2 = ((centroid[None, :] - clamped) ** 2).sum(dim=1)
    with profiling.span("rt.sync", site="scene_parts"):
        order = torch.argsort(d2, stable=True).tolist()
    return [scene.parts[k] for k in order]


def closest_passes(origin, t_max, scene, trace):
    """Closest hits over every part of `scene`: `trace(t_cap, part)`
    returns (t, tri, u, v) of one part's walk with per-ray cap `t_cap`;
    each pass's best t caps the next, and a pass's hit (tri >= 0), being
    strictly nearer than its cap, replaces the record."""
    best = None
    for part in scene_parts(scene, origin):
        out = trace(t_max if best is None else best[0], part)
        if best is None:
            best = out
        else:
            take = out[1] >= 0
            best = tuple(torch.where(take, a, b) for a, b in zip(out, best))
    return best


def any_passes(origin, t_max, t_min, scene, trace):
    """Any-hit over every part of `scene`: `trace(t_cap, part)` returns
    one part's bool[N]; a ray occluded in a pass gets t_cap = t_min in the
    next ones, which ends it before its first node."""
    occ = None
    for part in scene_parts(scene, origin):
        cap = t_max if occ is None else torch.where(occ, t_min, t_max)
        found = trace(cap.contiguous(), part)
        occ = found if occ is None else occ | found
    return occ


# --------------------------------------------------------------------------
# Plain torch versions: the same per-ray DFS, run in lockstep over all rays.
# The walks and leaf tests below are shared with ops/binary_traverse.py,
# whose trees differ only in how an internal node pushes its children.
# --------------------------------------------------------------------------

def _inv_dir(d):
    return 1.0 / torch.where(torch.abs(d) < 1e-20,
                             torch.where(d >= 0, 1e-20, -1e-20), d)


def _moller(ox, oy, oz, dx, dy, dz, tri, t_cap, t_min):
    """Möller–Trumbore for one triangle per ray; `tri` is [M,12] (v0, e1,
    e2, tri_f, obj_f, pad). The operation order is the kernel's."""
    v0x, v0y, v0z = tri[:, 0], tri[:, 1], tri[:, 2]
    e1x, e1y, e1z = tri[:, 3], tri[:, 4], tri[:, 5]
    e2x, e2y, e2z = tri[:, 6], tri[:, 7], tri[:, 8]
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    ok_det = torch.abs(det) > 1e-10
    inv_det = torch.where(ok_det, 1.0 / det, 0.0)
    tx = ox - v0x
    ty = oy - v0y
    tz = oz - v0z
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    valid = (ok_det & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
             & (t > t_min) & (t < t_cap))
    return t, u, v, valid


def _slab_children(o, inv, box, t_cap, t_min):
    """Slab tests of k child boxes per ray. box [M,6k] (k x min.xyz,
    max.xyz); returns (hit bool[M,k], t_near f32[M,k])."""
    box = box.view(box.shape[0], -1, 6)
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    ix, iy, iz = inv[:, 0:1], inv[:, 1:2], inv[:, 2:3]
    t0x = (box[:, :, 0] - ox) * ix
    t1x = (box[:, :, 3] - ox) * ix
    t0y = (box[:, :, 1] - oy) * iy
    t1y = (box[:, :, 4] - oy) * iy
    t0z = (box[:, :, 2] - oz) * iz
    t1z = (box[:, :, 5] - oz) * iz
    t_near = torch.maximum(
        torch.maximum(torch.minimum(t0x, t1x), torch.minimum(t0y, t1y)),
        torch.clamp_min(torch.minimum(t0z, t1z), t_min),
    )
    t_far = torch.minimum(
        torch.minimum(torch.maximum(t0x, t1x), torch.maximum(t0y, t1y)),
        torch.minimum(torch.maximum(t0z, t1z), t_cap[:, None]),
    )
    return t_near <= t_far, t_near


def _pop(stack, sp, counts=None):
    """Pop one entry for every ray with a non-empty stack: (ray ids, metas);
    both are empty once every stack is. `counts` (nvisit, nleaf), i32[N]
    each, counts every pop and every leaf pop of the rays popped."""
    live = torch.nonzero(sp > 0).squeeze(1)
    if live.numel() == 0:
        return live, live
    sp[live] -= 1
    meta = stack[live, sp[live].long()]
    if counts is not None:
        nvisit, nleaf = counts
        nvisit[live] += 1
        nleaf[live] += (meta < 0).to(nleaf.dtype)
    return live, meta


def _push(stack, sp, rays, meta, mask):
    """Write-then-advance push of meta[m] for rays[m] where mask[m]: the
    slot at sp is free, so the unconditional write clobbers nothing."""
    spr = sp[rays]
    stack[rays, torch.clamp_max(spr, stack.shape[1] - 1).long()] = meta
    sp[rays] = spr + mask.to(sp.dtype)


def _init_stack(n, root, t_max, cap, t_min):
    stack = torch.zeros((n, cap), dtype=torch.int32, device=t_max.device)
    stack[:, 0] = root
    sp = (t_max > t_min).to(torch.int32)
    return stack, sp


def _serial_leaf(origin, direction, rows, bt, btri, bu, bv, t_min):
    """Closest-hit leaf test: the triangles of leaf rows [M, leaf*12] in
    order k = 0..leaf-1, each kept when its t is strictly smaller than the
    best so far. Returns the updated (t, tri, u, v)."""
    ox, oy, oz = origin.unbind(1)
    dx, dy, dz = direction.unbind(1)
    for k in range(rows.shape[1] // TRI_STRIDE):
        tri = rows[:, k * TRI_STRIDE:(k + 1) * TRI_STRIDE]
        t, u, v, valid = _moller(ox, oy, oz, dx, dy, dz, tri, bt, t_min)
        bt = torch.where(valid, t, bt)
        btri = torch.where(valid, tri[:, 9].to(torch.int32), btri)
        bu = torch.where(valid, u, bu)
        bv = torch.where(valid, v, bv)
    return bt, btri, bu, bv


def _init_best(t_max):
    """The closest-hit record before any hit: (t = t_max, tri = -1, u = v =
    0)."""
    best_t = t_max.clone()
    best_tri = torch.full(t_max.shape, -1, dtype=torch.int32,
                          device=t_max.device)
    return best_t, best_tri, torch.zeros_like(best_t), torch.zeros_like(best_t)


def _closest_leaves(origin, direction, ptris, best, rays, meta, t_min,
                   leaf_test=_serial_leaf):
    """Test leaf blocks ~meta for `rays` with `leaf_test` and store the
    results in `best` (t, tri, u, v)."""
    rows = ptris[(~meta).long()]
    out = leaf_test(origin[rays], direction[rays], rows,
                    *(b[rays] for b in best), t_min)
    for b, o in zip(best, out):
        b[rays] = o


def _closest_walk(origin, direction, t_max, root, ptris, visit_node, cap,
                  t_min, leaf_test=_serial_leaf, counts=None):
    """Closest-hit DFS of every ray with a stack of `cap` metas: a meta < 0
    is leaf block ~meta (tested by `leaf_test`, by default in order with a
    strictly smaller t kept); an internal meta goes to `visit_node(stack,
    sp, rays, nodes, t_cap)`, which pushes the children that the rays' best
    t does not prune. `counts` (nvisit, nleaf) adds up the pops of each
    ray. Returns (t f32[N], tri i32[N], u f32[N], v f32[N])."""
    n = origin.shape[0]
    best = _init_best(t_max)
    stack, sp = _init_stack(n, root, t_max, cap, t_min)
    while True:
        live, meta = _pop(stack, sp, counts)
        if live.numel() == 0:
            break
        is_leaf = meta < 0
        if is_leaf.any():
            _closest_leaves(origin, direction, ptris, best, live[is_leaf],
                           meta[is_leaf], t_min, leaf_test)
        ii = live[~is_leaf]
        if ii.numel():
            visit_node(stack, sp, ii, meta[~is_leaf].long(), best[0][ii])
    return best


def _any_leaf(origin, direction, rows, t_max, skip_f, t_min):
    """Any-hit leaf test: whether a triangle of leaf rows [M, leaf*12] hits
    in (t_min, t_max) and is not of object skip_f (f32[M]). Returns
    bool[M]."""
    ox, oy, oz = origin.unbind(1)
    dx, dy, dz = direction.unbind(1)
    found = torch.zeros_like(t_max, dtype=torch.bool)
    for k in range(rows.shape[1] // TRI_STRIDE):
        tri = rows[:, k * TRI_STRIDE:(k + 1) * TRI_STRIDE]
        _, _, _, valid = _moller(ox, oy, oz, dx, dy, dz, tri, t_max, t_min)
        found |= valid & (tri[:, 10] != skip_f)
    return found


def _any_walk(origin, direction, t_max, skip_object, root, ptris,
              visit_node, cap, t_min, counts=None, leaf_test=_any_leaf):
    """Any-hit DFS of every ray, as `_closest_walk` with t_max as the
    pruning bound; a ray stops at its first accepted hit by a triangle not
    of its `skip_object` (`leaf_test`, by default any slot of the row).
    Returns bool[N]."""
    n = origin.shape[0]
    skip_f = skip_object.to(torch.float32)
    occ = torch.zeros((n,), dtype=torch.bool, device=origin.device)
    stack, sp = _init_stack(n, root, t_max, cap, t_min)
    while True:
        live, meta = _pop(stack, sp, counts)
        if live.numel() == 0:
            break
        is_leaf = meta < 0

        li = live[is_leaf]
        if li.numel():
            found = leaf_test(origin[li], direction[li],
                              ptris[(~meta[is_leaf]).long()], t_max[li],
                              skip_f[li], t_min)
            occ[li] |= found
            sp[li[found]] = 0  # the first accepted hit ends the ray

        ii = live[~is_leaf]
        if ii.numel():
            visit_node(stack, sp, ii, meta[~is_leaf].long(), t_max[ii])
    return occ


def _quad_children(origin, inv, metas4, qnodes, rays, node, t_cap):
    """The closest-hit node step's tests: slab-test the 4 children of quad
    nodes `node` for `rays` against [1e-3, t_cap]. Returns (kids i32[M,4],
    hit bool[M,4], near i64[M]), near being the TPU kernel's 2-bit argmin
    of t_near."""
    hit, tn = _slab_children(origin[rays], inv[rays], qnodes[node, :24],
                             t_cap, T_MIN)
    tn = torch.where(hit, tn, BIG)
    b0 = (tn[:, 1] < tn[:, 0]).to(torch.int64)
    b1 = (tn[:, 3] < tn[:, 2]).to(torch.int64)
    use_hi = (torch.minimum(tn[:, 2], tn[:, 3])
              < torch.minimum(tn[:, 0], tn[:, 1]))
    return metas4[node], hit, torch.where(use_hi, 2 + b1, b0)


def _quad_near_last_visit(origin, inv, qmeta, qnodes):
    """The closest-hit node step: slab-test the 4 children against [1e-3,
    t_cap] and push the hit ones in child order, except the nearest (the
    TPU kernel's 2-bit argmin of t_near), which goes last."""
    metas4 = qmeta.view(-1, 4)

    def visit(stack, sp, rays, node, t_cap):
        kids, hit, near = _quad_children(origin, inv, metas4, qnodes, rays,
                                         node, t_cap)
        for c in range(4):
            _push(stack, sp, rays, kids[:, c], hit[:, c] & (near != c))
        _push(stack, sp, rays, kids.gather(1, near[:, None])[:, 0],
              hit.gather(1, near[:, None])[:, 0])

    return visit


def _quad_fixed_visit(origin, inv, qmeta, qnodes):
    """The any-hit node step: push the hit children in child order 0..3."""
    metas4 = qmeta.view(-1, 4)

    def visit(stack, sp, rays, node, t_cap):
        hit, _ = _slab_children(origin[rays], inv[rays], qnodes[node, :24],
                                t_cap, T_MIN)
        kids = metas4[node]
        for c in range(4):
            _push(stack, sp, rays, kids[:, c], hit[:, c])

    return visit


def _intersect_quad_plain(origin, direction, t_max, root, qmeta, qnodes,
                          ptris, counts=None):
    """Plain torch version of the closest-hit kernel. Returns (t f32[N],
    tri i32[N], u f32[N], v f32[N]). `counts` (nvisit, nleaf), i32[N] each,
    adds up each ray's pops: the kernel has no counters, but pops the same
    entries."""
    visit = _quad_near_last_visit(origin, _inv_dir(direction), qmeta, qnodes)
    return _closest_walk(origin, direction, t_max, root, ptris, visit, CAP,
                         T_MIN, counts=counts)


def _occlusion_quad_plain(origin, direction, t_max, skip_object, root, qmeta,
                          qnodes, ptris, counts=None):
    """Plain torch version of the any-hit kernel. Returns bool[N]; `counts`
    as in _intersect_quad_plain."""
    visit = _quad_fixed_visit(origin, _inv_dir(direction), qmeta, qnodes)
    return _any_walk(origin, direction, t_max, skip_object, root, ptris,
                     visit, CAP, T_MIN, counts=counts)


# --------------------------------------------------------------------------
# CUDA wrappers (csrc/quad_traverse.cu).
# --------------------------------------------------------------------------

def _require(name, t, dtype, shape, device, vec=False):
    """`t` on `device` with this dtype and shape, contiguous, and 16-byte
    aligned when the kernels read it as float4/int4 vectors (`vec`)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")
    if vec and t.data_ptr() % 16:
        raise ValueError(f"{name} is not 16-byte aligned")


def _check_ptris(ptris, device):
    nb, width = ptris.shape
    if width % TRI_STRIDE:
        raise ValueError(f"ptris width {width} is not a multiple of "
                         f"{TRI_STRIDE}")
    _require("ptris", ptris, torch.float32, (nb, width), device, vec=True)


def _check_scene_arrays(scene, device):
    n4 = scene.qnodes.shape[0]
    _require("qnodes", scene.qnodes, torch.float32, (n4, 32), device,
             vec=True)
    _require("qmeta", scene.qmeta, torch.int32, (4 * n4,), device, vec=True)
    _check_ptris(scene.ptris, device)


def _check_rays(origin, direction, t_max):
    dev = origin.device
    n = origin.shape[0]
    _require("origin", origin, torch.float32, (n, 3), dev)
    _require("direction", direction, torch.float32, (n, 3), dev)
    _require("t_max", t_max, torch.float32, (n,), dev)
    return n, dev


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _stream(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def row_counts(rows):
    """i32[M]: for each leaf row of `rows` (f32[M, leaf*12]), the index of
    its last slot whose edges are not all zero, plus one (0 for a row
    without one)."""
    rows = rows.view(rows.shape[0], -1, TRI_STRIDE)
    real = (rows[:, :, 3:9] != 0).any(dim=2).to(torch.int32)
    slot = torch.arange(1, rows.shape[1] + 1, dtype=torch.int32,
                        device=rows.device)
    return (real * slot).amax(dim=1).to(torch.int32).contiguous()


def leaf_counts(scene):
    """`row_counts` of `scene.ptris` (ptris_leaf_counts)."""
    return ptris_leaf_counts(scene.ptris)


def ptris_leaf_counts(ptris):
    """`row_counts` of `ptris`: the kernels test a row's triangles below
    its count only, as the slots past it are zero triangles (e1 = e2 = 0,
    so det = 0), which are never valid. Computed on ptris's device at first
    use and cached per ptris tensor, for as long as it lives: no ptris
    tensor is written in place (see the module docstring)."""
    key = id(ptris)
    cached = _leaf_counts.get(key)
    if cached is not None and cached[0]() is ptris:
        return cached[1]
    counts = row_counts(ptris)
    _leaf_counts[key] = (
        weakref.ref(ptris, lambda _: _leaf_counts.pop(key, None)), counts)
    return counts


def _walk_args(ptris, dev, root, nodes, need):
    """The scene and launch arguments the persistent walks
    (csrc/persistent_walk.cuh) take after the rays: root, node rows, the
    leaf rows `ptris`, their leaf counts, leaf size, stack need and the ray
    counter, one int32 for this launch (the C entry zeroes it on the
    launch's stream, and the caching allocator hands it to no other
    stream's work before this launch ends). Returns (the arguments, the
    counter)."""
    counts = ptris_leaf_counts(ptris)  # on ptris's device, i32[NB]
    counter = torch.empty((1,), dtype=torch.int32, device=dev)
    return ((root, _ptr(nodes), _ptr(ptris), _ptr(counts),
             ptris.shape[1] // TRI_STRIDE, need, _ptr(counter)), counter)


def _launch_args(scene, dev):
    """K1's and K2's `_walk_args`: the 4-wide tree's root and node rows,
    and its stack need."""
    _check_scene_arrays(scene, dev)
    return _walk_args(scene.ptris, dev, scene.root, scene.qnodes,
                      scene.q_stack_need)


def _check_n(n):
    if n > MAX_RAYS:
        raise ValueError(f"{n} rays exceed the kernels' {MAX_RAYS}")


def _intersect_quad_cuda(origin, direction, t_max, scene, lib=None):
    """K1 on the card; `lib` another build of csrc/quad_traverse.cu (the
    variant lab's), else the render path's."""
    global closest_launches
    from raytracer_tpu_torch.ops import _build

    n, dev = _check_rays(origin, direction, t_max)
    _check_n(n)
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    tri = torch.empty((n,), dtype=torch.int32, device=dev)
    u = torch.empty((n,), dtype=torch.float32, device=dev)
    v = torch.empty((n,), dtype=torch.float32, device=dev)
    if n == 0:
        return t, tri, u, v
    args, _counter = _launch_args(scene, dev)
    lib = lib or _build.quad_traverse_lib()
    with torch.cuda.device(dev):
        rc = lib.quad_closest(
            _ptr(origin), _ptr(direction), _ptr(t_max), n, *args,
            _ptr(t), _ptr(tri), _ptr(u), _ptr(v), _stream(dev),
        )
    if rc != 0:
        raise RuntimeError(f"quad_closest launch failed: cudaError {rc}")
    closest_launches += 1
    return t, tri, u, v


def _occlusion_quad_cuda(origin, direction, t_max, skip_object, scene,
                         lib=None):
    """K2 on the card; `lib` as in _intersect_quad_cuda."""
    global occlusion_launches
    from raytracer_tpu_torch.ops import _build

    n, dev = _check_rays(origin, direction, t_max)
    _check_n(n)
    _require("skip_object", skip_object, torch.int32, (n,), dev)
    occ = torch.empty((n,), dtype=torch.bool, device=dev)
    if n == 0:
        return occ
    args, _counter = _launch_args(scene, dev)
    lib = lib or _build.quad_traverse_lib()
    with torch.cuda.device(dev):
        rc = lib.quad_occlusion(
            _ptr(origin), _ptr(direction), _ptr(t_max), _ptr(skip_object),
            n, *args, _ptr(occ), _stream(dev),
        )
    if rc != 0:
        raise RuntimeError(f"quad_occlusion launch failed: cudaError {rc}")
    occlusion_launches += 1
    return occ


LAUNCH_INFO_KEYS = ("registers", "local_bytes", "smem_bytes",
                    "blocks_per_sm", "sms", "grid", "group", "refill_at",
                    "threads")


def _launch_info(entry, kernel, need, dev):
    """Call a library's `*_launch_info` entry point `entry` for `kernel`
    ("closest" or "occlusion") at stack need `need` on `dev`."""
    out = (ctypes.c_int * len(LAUNCH_INFO_KEYS))()
    with torch.cuda.device(dev):
        rc = entry(int(kernel == "occlusion"), need, out)
    if rc != 0:
        raise RuntimeError(f"{entry.__name__} failed: cudaError {rc}")
    return dict(zip(LAUNCH_INFO_KEYS, out))


def launch_info(kernel, scene, lib=None):
    """What a launch of `kernel` ("closest" or "occlusion") on `scene`'s
    device looks like: {"registers", "local_bytes" (a thread), "smem_bytes"
    (dynamic, a block), "blocks_per_sm", "sms", "grid" (the persistent
    grid), "group" (the triangles of a leaf loaded together), "refill_at"
    (the idle lanes at which a warp fetches rays), "threads" (a block)};
    `lib` as in _intersect_quad_cuda."""
    from raytracer_tpu_torch.ops import _build

    lib = lib or _build.quad_traverse_lib()
    return _launch_info(lib.quad_launch_info, kernel, scene.q_stack_need,
                        scene.qnodes.device)
