"""The stackless skip-link BVH walk: the port of
raytracer_tpu/ops/traverse.py, the JAX package's accel="bvh" traversal.

The renderer takes this walk for a binary tree too deep for K3/K4's stack
(binary_traverse.stack_fits fails; api.py logs a warning), the one tree
the JAX package renders and K3/K4 cannot. The JAX walk is XLA array code,
not a Pallas kernel, so plain torch is its port, as for the shading code;
it runs on whichever device the rays are on.

It reads the bake's skip-link tables (scene/device_scene.py
`_pack_traversal_arrays`): nodes_packed f32[NN,8] (min.xyz, max.xyz,
bitcast skip link, bitcast meta: ~leaf block for a leaf, right child for an
internal node) and tris_packed f32[NB,LEAF,12] (leaf-blocked v0, e1, e2,
bitcast triangle index and object). Each ray keeps a cursor into the
preorder node array: a box hit on an internal node descends to cur + 1,
anything else follows the skip link; the walk ends at cur >= NN. A leaf's
whole block is tested at once, the closest hit by the first-index argmin
over the block, strictly nearer than the best so far.

The walk is a lockstep loop over the wavefront that runs while any lane
has cur < NN, UNROLL micro-steps an iteration, as the JAX while_loop; each
iteration gathers the live lanes first (a finished lane only idles in the
JAX loop), which changes no lane's result. `steps` counts the micro-steps
of every walk since `reset_counts()`.
"""

from __future__ import annotations

import torch

from raytracer_tpu_torch.ops.intersect import HitRecord
from raytracer_tpu_torch.ops.math3d import cross, dot

UNROLL = 4

# Micro-steps (UNROLL an iteration) of the walks since reset_counts().
steps = 0


def reset_counts():
    global steps
    steps = 0


def _safe_inv(direction):
    """1/d with a sign-preserving clamp, so the slab test has no 0 * inf."""
    d = torch.where(torch.abs(direction) < 1e-20,
                    torch.where(direction >= 0, 1e-20, -1e-20), direction)
    return 1.0 / d


def _node_step(nodes_packed, cur, origin, inv_d, t_min, best_t, nn):
    """One micro-step: fetch each lane's node, slab-test it against
    [t_min, best_t], move the cursor. Returns (next cursor, the leaf block
    to test or -1)."""
    node = nodes_packed[torch.clamp_max(cur, nn - 1).long()]
    skip = node[:, 6].view(torch.int32)
    meta = node[:, 7].view(torch.int32)
    t0 = (node[:, 0:3] - origin) * inv_d
    t1 = (node[:, 3:6] - origin) * inv_d
    t_near = torch.clamp_min(torch.minimum(t0, t1).amax(dim=-1), t_min)
    t_far = torch.minimum(torch.maximum(t0, t1).amin(dim=-1), best_t)
    active = cur < nn
    hit_box = (t_near <= t_far) & active
    is_leaf = meta < 0
    nxt = torch.where(hit_box & ~is_leaf, cur + 1, skip)
    cur = torch.where(active, nxt, cur)
    leaf = torch.where(hit_box & is_leaf, ~meta, -1)
    return cur, leaf


def _block_test(tris_packed, leaf, origin, direction, t_min, t_cap):
    """Möller–Trumbore of every triangle of each lane's leaf block (lanes
    with leaf < 0 test none). Returns (t, u, v, valid) [N,LEAF] and the
    block [N,LEAF,12]."""
    nb = tris_packed.shape[0]
    block = tris_packed[torch.clamp(leaf, 0, nb - 1).long()]
    v0 = block[:, :, 0:3]
    e1 = block[:, :, 3:6]
    e2 = block[:, :, 6:9]
    o = origin[:, None, :]
    d = direction[:, None, :].expand_as(e2)
    pvec = cross(d, e2)
    det = dot(e1, pvec)
    inv_det = torch.where(torch.abs(det) > 1e-10, 1.0 / det, 0.0)
    tvec = o - v0
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    v = dot(d, qvec) * inv_det
    t = dot(e2, qvec) * inv_det
    valid = ((torch.abs(det) > 1e-10)
             & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
             & (t > t_min) & (t < t_cap[:, None])
             & (leaf >= 0)[:, None])
    return t, u, v, valid, block


def _leaf_test(tris_packed, leaf, origin, direction, t_min, best):
    """The closest hit of each lane's leaf block against best = (t, tri,
    u, v); lanes with leaf < 0 keep theirs."""
    best_t, best_tri, best_u, best_v = best
    t, u, v, valid, block = _block_test(tris_packed, leaf, origin, direction,
                                        t_min, best_t)
    t = torch.where(valid, t, torch.inf)
    k = torch.argmin(t, dim=1, keepdim=True)
    tk = t.gather(1, k)[:, 0]
    improved = tk < best_t
    tri = block[:, :, 9].view(torch.int32).gather(1, k)[:, 0]
    return (torch.where(improved, tk, best_t),
            torch.where(improved, tri, best_tri),
            torch.where(improved, u.gather(1, k)[:, 0], best_u),
            torch.where(improved, v.gather(1, k)[:, 0], best_v))


def _walk(scene, origin, active_mask, state, advance):
    """The lockstep loop: `state` is a tuple of per-lane tensors whose
    first is the cursor; `advance(rays, sub_state)` runs UNROLL micro-steps
    for the live lanes `rays` and returns their new state. Runs while any
    lane has cur < NN."""
    global steps
    nn = scene.nodes_packed.shape[0]
    cur = torch.zeros(origin.shape[0], dtype=torch.int32,
                      device=origin.device)
    if active_mask is not None:
        cur = torch.where(active_mask, cur, nn).to(torch.int32)
    state = (cur, *state)
    while True:
        rays = torch.nonzero(state[0] < nn).squeeze(1)
        if rays.numel() == 0:
            return state
        new = advance(rays, tuple(s[rays] for s in state))
        for s, x in zip(state, new):
            s[rays] = x
        steps += UNROLL


def _check_tables(scene):
    if scene.nodes_packed is None:
        raise ValueError("the scene was baked without the skip-link walk's "
                         "tables: its binary tree fits K3/K4's stack")


def intersect_bvh(origin, direction, scene, t_min: float, t_max,
                  active_mask=None) -> HitRecord:
    """Closest hit of rays f32[R,3] with t in (t_min, t_max) (`t_max`
    scalar or f32[R]); lanes outside `active_mask` (bool[R]) are not
    traced: t stays t_max, tri -1."""
    _check_tables(scene)
    nn = scene.nodes_packed.shape[0]
    r = origin.shape[0]
    dev = origin.device
    inv_d = _safe_inv(direction)
    best_t = torch.as_tensor(t_max, dtype=torch.float32,
                             device=dev).expand(r).clone()

    def advance(rays, st):
        cur, best = st[0], st[1:]
        o, d, inv = origin[rays], direction[rays], inv_d[rays]
        for _ in range(UNROLL):
            cur, leaf = _node_step(scene.nodes_packed, cur, o, inv, t_min,
                                   best[0], nn)
            best = _leaf_test(scene.tris_packed, leaf, o, d, t_min, best)
        return (cur, *best)

    init = (best_t, torch.full((r,), -1, dtype=torch.int32, device=dev),
            torch.zeros((r,), dtype=torch.float32, device=dev),
            torch.zeros((r,), dtype=torch.float32, device=dev))
    _, t, tri, u, v = _walk(scene, origin, active_mask, init, advance)
    return HitRecord(t=t, tri=tri, u=u, v=v, hit=tri >= 0)


def occlusion_bvh(origin, direction, t_min, t_max, scene, skip_object,
                  active_mask=None):
    """Any hit in (t_min, t_max) by a triangle whose object is not the
    ray's `skip_object` (i32[R]); a lane ends at its first such hit.
    Returns bool[R]."""
    _check_tables(scene)
    nn = scene.nodes_packed.shape[0]
    r = origin.shape[0]
    dev = origin.device
    inv_d = _safe_inv(direction)
    t_cap = torch.as_tensor(t_max, dtype=torch.float32, device=dev).expand(r)
    skip = torch.as_tensor(skip_object, device=dev).to(torch.int32).expand(r)

    def advance(rays, st):
        cur, occluded = st
        o, d, inv = origin[rays], direction[rays], inv_d[rays]
        tc, sk = t_cap[rays], skip[rays]
        for _ in range(UNROLL):
            cur, leaf = _node_step(scene.nodes_packed, cur, o, inv, t_min,
                                   tc, nn)
            _, _, _, valid, block = _block_test(scene.tris_packed, leaf, o,
                                                d, t_min, tc)
            obj = block[:, :, 10].view(torch.int32)
            found = (valid & (obj != sk[:, None])).any(dim=1)
            occluded = occluded | found
            cur = torch.where(found, nn, cur).to(torch.int32)
        return cur, occluded

    init = (torch.zeros((r,), dtype=torch.bool, device=dev),)
    _, occluded = _walk(scene, origin, active_mask, init, advance)
    return occluded
