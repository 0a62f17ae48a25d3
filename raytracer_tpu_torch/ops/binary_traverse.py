"""Closest-hit and any-hit traversal of the binary BVH: the port's
counterpart of raytracer_tpu/ops/pallas_traverse.py, and the traversal of
accel="bvh".

`intersect_bvh_binary` and `occlusion_bvh_binary` compute what the JAX
package's `intersect_bvh_pallas` / `occlusion_bvh_pallas` and its skip-link
walk `intersect_bvh` / `occlusion_bvh` compute: for each ray the closest
hit (t, tri, u, v) with t in (t_min, t_max), or whether any triangle not of
the ray's `skip_object` blocks (t_min, t_max). They read the binary tree's
arrays of scene/device_scene.py: pnodes f32[NI,16] (both child boxes and
both child metas per internal node), root_meta (held on the host as
`scene.binary_root`) and the leaf blocks ptris, shared with the 4-wide tree.

On CUDA tensors they launch the hand-written kernels of
csrc/binary_traverse.cu (built by ops/_build.py); on CPU tensors they run
the kernels' plain torch versions below. A CUDA tensor never takes the
plain version: the launch succeeds or the wrapper raises. The kernels run
K1/K2's persistent walk (csrc/persistent_walk.cuh): warps that take rays
from a counter (one int32 allocated with each launch), leaves that stop at
their last real triangle (the leaf counts of ops/quad_traverse.py, cached
per ptris tensor, which is never written in place, and shared with K1/K2)
and a shared-memory stack of
`stack_need(scene)` = bvh_max_depth + 2 entries a thread below the entry
kept in a register; see the source's head comment.

The algorithm, shared by kernel and plain version (the TPU kernels' 4096-
ray packets, SMEM stack and packet-wide child order exist because Mosaic
has no per-lane gathers, and do not carry over):

  - one depth-first traversal per ray with its own stack of STACK_CAP
    metas, starting from root_meta; a meta < 0 is leaf block ~meta;
  - an internal node slab-tests both children against [t_min, best t]
    (t_max for any-hit) and pushes the hit ones, far first and near last,
    near being the smaller t_near, a tie keeping left: the ray's own order
    where the TPU kernel takes the packet's;
  - a leaf tests its block's triangles in order with Möller–Trumbore
    (|det| > 1e-10) and, for closest hits, a strictly smaller t; any-hit
    stops at the first accepted hit;
  - a ray whose t_max <= t_min (inactive lanes get exactly that) cannot
    accept a hit and is not traversed: t stays t_max, tri -1, u = v = 0.

t_min is an argument here, where the TPU kernels fix it at 1e-3: the walk
that accel="bvh" stands for takes any t_min, and the renderer falls back
to accel="bvh" for a t_min other than 1e-3. Every float operation is
written in the same order in both versions, and the kernel is built with
-fmad=false, so on the card the kernel equals its plain version bit for
bit. Against the JAX kernels and walk, which visit leaves in another
order, only hits at exactly equal t may name another triangle.
"""

from __future__ import annotations

import torch

from raytracer_tpu_torch.ops.intersect import HitRecord
from raytracer_tpu_torch.ops.quad_traverse import (
    BIG,
    _any_walk,
    _check_n,
    _check_ptris,
    _check_rays,
    _closest_walk,
    _inv_dir,
    _launch_info,
    _ptr,
    _push,
    _ray_inputs,
    _require,
    _slab_children,
    _stream,
    _walk_args,
    any_passes,
    closest_passes,
)
from raytracer_tpu_torch.utils import profiling

STACK_CAP = 128  # per-ray stack entries, as the TPU kernels' SMEM stack

# Kernel launches, counted where the CUDA wrappers launch (never by the
# plain versions), so a caller can show that a run went through them.
closest_launches = 0
occlusion_launches = 0


def reset_launch_counts():
    global closest_launches, occlusion_launches
    closest_launches = 0
    occlusion_launches = 0


def stack_fits(max_depth: int) -> bool:
    """Whether a tree of this depth traverses within STACK_CAP. The DFS
    holds at most one pending far child per level plus the two pushes of
    the node being expanded, so occupancy <= depth + 2."""
    return max_depth + 2 <= STACK_CAP


def stack_need(scene) -> int:
    """The kernels' stack entries a thread: bvh_max_depth + 2, at most
    STACK_CAP for a tree that `stack_fits`. The walk's stack holds at most
    bvh_max_depth + 1 entries (a far child for each level above the deepest
    internal node and that node's two children), the one visited next in a
    register and the rest in shared memory."""
    return scene.bvh_max_depth + 2


def _check_stack(scene):
    if not stack_fits(scene.bvh_max_depth):
        raise ValueError(
            f"BVH depth {scene.bvh_max_depth} exceeds the binary traversal "
            f"stack (STACK_CAP={STACK_CAP}); the renderer traces such trees "
            "with the skip-link walk (ops/traverse.py)")


def intersect_bvh_binary(origin, direction, scene, t_min, t_max,
                         active_mask=None) -> HitRecord:
    """Closest hit of rays f32[N,3] against `scene` (a DeviceScene);
    `t_max` scalar or f32[N]; inactive lanes get t_max = t_min. A
    multi-part scene takes one pass per part, as K1's
    (quad_traverse.closest_passes). The `rt.trace` span."""
    _check_stack(scene)
    with profiling.span("rt.trace", lanes=origin.shape[0]):
        o, d, tm = _ray_inputs(origin, direction, t_max, active_mask, t_min)

        def trace(t_cap, part):
            if o.is_cuda:
                return _intersect_binary_cuda(o, d, t_cap, t_min, part)
            return _intersect_binary_plain(o, d, t_cap, t_min,
                                           part.binary_root, part.pnodes,
                                           part.ptris)

        t, tri, u, v = closest_passes(o, tm, scene, trace)
        return HitRecord(t=t, tri=tri, u=u, v=v, hit=tri >= 0)


def occlusion_bvh_binary(origin, direction, t_min, t_max, scene,
                         skip_object, active_mask=None):
    """Any hit in (t_min, t_max) by a triangle whose object is not the
    ray's `skip_object` (i32[N]); returns bool[N]. A multi-part scene takes
    one pass per part (quad_traverse.any_passes). The `rt.occlusion`
    span."""
    _check_stack(scene)
    with profiling.span("rt.occlusion", lanes=origin.shape[0]):
        o, d, tm = _ray_inputs(origin, direction, t_max, active_mask, t_min)
        skip = torch.as_tensor(skip_object, device=o.device).to(
            torch.int32).expand(o.shape[0]).contiguous()

        def trace(t_cap, part):
            if o.is_cuda:
                return _occlusion_binary_cuda(o, d, t_cap, skip, t_min, part)
            return _occlusion_binary_plain(o, d, t_cap, skip, t_min,
                                           part.binary_root, part.pnodes,
                                           part.ptris)

        return any_passes(o, tm, t_min, scene, trace)


# --------------------------------------------------------------------------
# Plain torch versions: the same per-ray DFS, run in lockstep over all rays
# (the walks of ops/quad_traverse.py with the binary node visit).
# --------------------------------------------------------------------------

def _binary_children(origin, inv, pnodes, t_min, rays, node, t_cap,
                     ordered=True):
    """The tests of the internal-node step: slab-test the two children of
    pnodes rows `node` for `rays` against [t_min, t_cap]. Returns ((far
    meta, far hit), (near meta, near hit)), i32[M] and bool[M]: near is the
    child of the smaller t_near, a tie keeping left (`ordered`), or left."""
    row = pnodes[node]
    hit, tn = _slab_children(origin[rays], inv[rays], row[:, :12], t_cap,
                             t_min)
    near = torch.where(hit, tn, BIG)
    swap = (near[:, 1] < near[:, 0]) & ordered
    kids = row[:, 12:14].to(torch.int32)
    return ((torch.where(swap, kids[:, 0], kids[:, 1]),
             torch.where(swap, hit[:, 0], hit[:, 1])),
            (torch.where(swap, kids[:, 1], kids[:, 0]),
             torch.where(swap, hit[:, 1], hit[:, 0])))


def _binary_visit(origin, inv, pnodes, t_min, ordered=True):
    """The internal-node step of both walks: slab-test the two children of
    pnodes rows `node` for `rays` against [t_min, t_cap], push the hit
    ones far first, near last (`ordered`), or right first, left last."""

    def visit(stack, sp, rays, node, t_cap):
        for meta, hit in _binary_children(origin, inv, pnodes, t_min, rays,
                                          node, t_cap, ordered):
            _push(stack, sp, rays, meta, hit)

    return visit


def _intersect_binary_plain(origin, direction, t_max, t_min, root, pnodes,
                            ptris, counts=None):
    """Plain torch version of the closest-hit kernel. Returns (t f32[N],
    tri i32[N], u f32[N], v f32[N]). `counts` (nvisit, nleaf), i32[N] each,
    adds up each ray's pops: the kernel has no counters, but pops the same
    entries."""
    visit = _binary_visit(origin, _inv_dir(direction), pnodes, t_min)
    return _closest_walk(origin, direction, t_max, root, ptris, visit,
                         STACK_CAP, t_min, counts=counts)


def _occlusion_binary_plain(origin, direction, t_max, skip_object, t_min,
                            root, pnodes, ptris, counts=None):
    """Plain torch version of the any-hit kernel. Returns bool[N]; `counts`
    as in _intersect_binary_plain."""
    visit = _binary_visit(origin, _inv_dir(direction), pnodes, t_min)
    return _any_walk(origin, direction, t_max, skip_object, root, ptris,
                     visit, STACK_CAP, t_min, counts=counts)


# --------------------------------------------------------------------------
# CUDA wrappers (csrc/binary_traverse.cu).
# --------------------------------------------------------------------------

def _check_scene_arrays(scene, device):
    _require("pnodes", scene.pnodes, torch.float32,
             (scene.pnodes.shape[0], 16), device, vec=True)
    _check_ptris(scene.ptris, device)


def _launch_args(scene, dev, need=None):
    """K3's and K4's scene and launch arguments after the rays and t_min
    (quad_traverse._walk_args): the binary root and node rows, and `need`
    stack entries a thread (default `stack_need(scene)`, 1..STACK_CAP).
    Returns (the arguments, the ray counter)."""
    need = stack_need(scene) if need is None else need
    if not 1 <= need <= STACK_CAP:
        raise ValueError(f"stack need {need} is outside 1..{STACK_CAP}")
    _check_scene_arrays(scene, dev)
    return _walk_args(scene.ptris, dev, scene.binary_root, scene.pnodes,
                      need)


def _intersect_binary_cuda(origin, direction, t_max, t_min, scene,
                           need=None):
    """K3 on the card; `need` the stack entries a thread, as in
    _launch_args."""
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
    args, _counter = _launch_args(scene, dev, need)
    lib = _build.binary_traverse_lib()
    with torch.cuda.device(dev):
        rc = lib.binary_closest(
            _ptr(origin), _ptr(direction), _ptr(t_max), n, t_min, *args,
            _ptr(t), _ptr(tri), _ptr(u), _ptr(v), _stream(dev),
        )
    if rc != 0:
        raise RuntimeError(f"binary_closest launch failed: cudaError {rc}")
    closest_launches += 1
    return t, tri, u, v


def _occlusion_binary_cuda(origin, direction, t_max, skip_object, t_min,
                           scene, need=None):
    """K4 on the card; `need` as in _intersect_binary_cuda."""
    global occlusion_launches
    from raytracer_tpu_torch.ops import _build

    n, dev = _check_rays(origin, direction, t_max)
    _check_n(n)
    _require("skip_object", skip_object, torch.int32, (n,), dev)
    occ = torch.empty((n,), dtype=torch.bool, device=dev)
    if n == 0:
        return occ
    args, _counter = _launch_args(scene, dev, need)
    lib = _build.binary_traverse_lib()
    with torch.cuda.device(dev):
        rc = lib.binary_occlusion(
            _ptr(origin), _ptr(direction), _ptr(t_max), _ptr(skip_object),
            n, t_min, *args, _ptr(occ), _stream(dev),
        )
    if rc != 0:
        raise RuntimeError(f"binary_occlusion launch failed: cudaError {rc}")
    occlusion_launches += 1
    return occ


def launch_info(kernel, scene, need=None):
    """What a launch of K3 or K4 (`kernel` "closest" or "occlusion") on
    `scene`'s device looks like, at `need` stack entries a thread (default
    `stack_need(scene)`): quad_traverse.launch_info's keys."""
    from raytracer_tpu_torch.ops import _build

    return _launch_info(_build.binary_traverse_lib().binary_launch_info,
                        kernel, stack_need(scene) if need is None else need,
                        scene.pnodes.device)
