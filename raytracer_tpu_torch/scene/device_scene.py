"""DeviceScene: the baked scene as torch tensors on one device (port of
raytracer_tpu/scene/device_scene.py, restricted to what the render path
reads).

The bake is the JAX package's `bake_scene` for a single part with exact
shapes, array for array:

  - triangles in world space, in BVH leaf order, padded to a multiple of
    128 with degenerate triangles: tri_v0/e1/e2 f32[T,3], tri_object i32[T]
    (-1 for padding) for the brute oracle; tri_shade f32[T,24] (v0 e1 e2
    n0 n1 n2 obj_f mat_f light_index_f light_num_tris_f pad) for shading;
  - materials: mat_packed f32[M,16] (albedo, emission rgb, emission power,
    roughness, metallic, transmission, ior, dispersion, pad);
  - lights from emissive objects: light_object i32[L], light_power f32[L],
    light_center f32[L,3], light_meta_packed f32[L,8] (first_tri_f,
    num_tris_f, emission rgb, object_f, power, pad), light_tri_packed
    f32[LT,16] in the original (pre-BVH) triangle order, and each light
    triangle's object light_tri_object i32[LT] (ReSTIR's shadow rays skip
    it; column 9 of light_tri_packed holds it as f32);
  - the traversal kernels' arrays: the leaf blocks ptris f32[NB, leaf*12]
    (v0, e1, e2, tri_f, obj_f, pad per triangle), shared by both trees;
    the 4-wide collapsed tree (ops/quad_traverse.py) qnodes f32[N4,32] (4
    child boxes, then 4 metas as f32; absent children are NaN boxes),
    qmeta i32[4*N4], qroot i32[1], with the DFS stack bound q_stack_need;
    and the binary tree (ops/binary_traverse.py) pnodes f32[NI,16] (per
    internal node the left and right child boxes, then the two child metas
    as f32) and root_meta i32[1], with the tree depth bvh_max_depth. A meta
    >= 0 is a node row, a meta < 0 is leaf block ~meta; both trees number
    leaf blocks in the binary tree's preorder, so their metas name the same
    ptris rows. The binary arrays are always baked (64 B per internal
    node), so a renderer can fall back to them without a second bake.

Scene edits have two fast paths, the JAX package's: a refit
(`bake_scene(reuse_bvh=...)`) keeps the tree's topology and repacks only
its node boxes, and `update_materials` rewrites the material and light
tables and keeps every geometry tensor.

Three options of the JAX bake are ported as well:
  - multi-part bakes (`pallas_budget_bytes`): a tree whose 4-wide node
    rows and leaf blocks exceed the budget is cut into subtree parts
    (`_cut_parts`, `_slice_bvh`, `_pack_parts`); qnodes, qmeta, qroot,
    ptris, pnodes and root_meta then carry a leading [P] axis, part_aabb
    holds each part root's box, and the traversal wrappers run one pass per
    part (ops/quad_traverse.py, ops/binary_traverse.py). The renderer's
    budget is None on the card (api.PALLAS_VMEM_BUDGET): the JAX budget is
    the TPU kernel's VMEM, which a GPU does not have;
  - stable-shape bakes (`stable_shapes`): every table padded to a capacity
    bucket (`_bucket`), so a small topology edit re-bakes into the same
    tensor shapes; padded rows cannot be reached or selected, so the image
    is the exact bake's; the exact counts ride in `true_counts`;
  - the skip-link walk's nodes_packed f32[NN,8] and tris_packed
    f32[NB,LEAF,12] (`_pack_traversal_arrays`; ops/traverse.py), packed
    only when the binary tree is too deep for K3/K4's stack
    (binary_traverse.stack_fits): every other tree renders on K3/K4, and
    the walk's tables would double the leaf blocks' memory and the bake's
    time for nothing.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
from typing import Dict, Tuple

import numpy as np
import torch

from raytracer_tpu_torch.accel.bvh import (
    BVH,
    build_bvh,
    collapse_bvh4_slots,
    quad_boxes,
)
from raytracer_tpu_torch.scene.model import Scene
from raytracer_tpu_torch.utils import profiling

log = logging.getLogger(__name__)

_PAD = 128  # pad triangle count to a multiple of this (as the JAX bake)


@dataclasses.dataclass(frozen=True)
class DeviceScene:
    tri_v0: torch.Tensor  # f32[T,3]
    tri_e1: torch.Tensor  # f32[T,3]
    tri_e2: torch.Tensor  # f32[T,3]
    tri_object: torch.Tensor  # i32[T]
    tri_shade: torch.Tensor  # f32[T,24]
    mat_packed: torch.Tensor  # f32[M,16]
    light_object: torch.Tensor  # i32[L]
    light_power: torch.Tensor  # f32[L]
    light_center: torch.Tensor  # f32[L,3]
    light_meta_packed: torch.Tensor  # f32[L,8]
    light_tri_packed: torch.Tensor  # f32[LT,16]
    light_tri_object: torch.Tensor  # i32[LT]
    scene_min: torch.Tensor  # f32[3]
    scene_max: torch.Tensor  # f32[3]
    qnodes: torch.Tensor  # f32[N4,32] ([P,N4,32] with parts)
    qmeta: torch.Tensor  # i32[4*N4] ([P,4*N4])
    qroot: torch.Tensor  # i32[1] ([P,1])
    ptris: torch.Tensor  # f32[NB, leaf*12] ([P,NB,leaf*12])
    pnodes: torch.Tensor  # f32[NI,16] ([P,NI,16])
    root_meta: torch.Tensor  # i32[1] ([P,1])
    num_triangles: int
    num_lights: int
    q_stack_need: int
    bvh_max_depth: int  # deepest binary node (root = 0)
    # qroot and root_meta as host ints, so a kernel launch needs no device
    # readback (part 0's with parts; ScenePart holds each part's).
    root: int
    binary_root: int
    # The skip-link walk's tables (ops/traverse.py), or None (see the
    # module docstring).
    nodes_packed: torch.Tensor = None  # f32[NN,8]
    tris_packed: torch.Tensor = None  # f32[NB,LEAF,12]
    num_parts: int = 1
    part_max_depth: int = -1  # deepest binary node of a part; -1: no parts
    part_aabb: torch.Tensor = None  # f32[P,6] part root boxes (parts only)
    # Stable-shape bakes only: i32[4] [true_tris, true_lights,
    # true_objects, true_refs]; num_triangles and num_lights then hold the
    # padded table sizes.
    true_counts: torch.Tensor = None
    # Whether some material has transmission > 0 (mat_packed column 9), so
    # the integrator shades dielectric lanes; False skips that branch,
    # which then changes no lane.
    transmissive: bool = True

    @property
    def device(self) -> torch.device:
        return self.qnodes.device

    @property
    def pallas_vmem_bytes(self) -> int:
        """The JAX kernel's VMEM footprint of one pass's scene arrays (rows
        padded to 128 lanes), the quantity `pallas_budget_bytes` bounds."""
        qn_lanes = -(-self.qnodes.shape[-1] // 128) * 128
        pt_lanes = -(-self.ptris.shape[-1] // 128) * 128
        return (self.qnodes.shape[-2] * qn_lanes
                + self.ptris.shape[-2] * pt_lanes) * 4

    @functools.cached_property
    def parts(self) -> Tuple["ScenePart", ...]:
        """Each part's tables as a ScenePart, in bake order (one part for
        a single-part bake). Made once per DeviceScene, so the kernels'
        leaf counts, cached per ptris tensor, are computed once per part
        (ops/quad_traverse.leaf_counts)."""
        if self.num_parts == 1:
            return (ScenePart(self.qnodes, self.qmeta, self.ptris,
                              self.pnodes, self.root, self.binary_root,
                              self.q_stack_need, self.bvh_max_depth),)
        qroot = self.qroot.reshape(-1).tolist()
        broot = self.root_meta.reshape(-1).tolist()
        return tuple(
            ScenePart(self.qnodes[k], self.qmeta[k], self.ptris[k],
                      self.pnodes[k], int(qroot[k]), int(broot[k]),
                      self.q_stack_need, self.part_max_depth)
            for k in range(self.num_parts))


@dataclasses.dataclass(frozen=True)
class ScenePart:
    """One part's traversal tables, with the DeviceScene names the kernel
    wrappers read: K1/K2 take qnodes, qmeta, ptris, root and q_stack_need,
    K3/K4 pnodes, ptris, binary_root and bvh_max_depth (the deepest part's
    depth, which bounds their stack)."""
    qnodes: torch.Tensor
    qmeta: torch.Tensor
    ptris: torch.Tensor
    pnodes: torch.Tensor
    root: int
    binary_root: int
    q_stack_need: int
    bvh_max_depth: int


# Array fields shared with the JAX SceneOnDevice, by name.
ARRAY_FIELDS = (
    "tri_v0", "tri_e1", "tri_e2", "tri_object", "tri_shade", "mat_packed",
    "light_object", "light_power", "light_center", "light_meta_packed",
    "light_tri_packed", "light_tri_object", "scene_min", "scene_max",
    "qnodes", "qmeta", "qroot",
    "ptris", "pnodes", "root_meta",
)
# Array fields of some bakes only (None otherwise), also by the JAX name.
OPTIONAL_FIELDS = ("nodes_packed", "tris_packed", "part_aabb", "true_counts")


def _pad_rows(a: np.ndarray, total: int, fill=0.0) -> np.ndarray:
    if len(a) == total:
        return a
    pad_shape = (total - len(a),) + a.shape[1:]
    return np.concatenate([a, np.full(pad_shape, fill, a.dtype)])


def _bucket(n: int, align: int) -> int:
    """Geometric capacity bucket (the JAX `_bucket`): `n` rounded up to a
    multiple of max(align, floor_pow2(n) / 8), at most +12.5% rows, and
    its own bucket, so re-bakes of an edited scene keep their shapes."""
    n = max(int(n), align)
    step = max(align, (1 << (n.bit_length() - 1)) // 8)
    return -(-n // step) * step


def _pack_traversal_arrays(bvh, v0, e1, e2, tri_object, leaf_size):
    """The skip-link walk's tables (the JAX `_pack_traversal_arrays`):
    nodes_packed f32[NN,8] = min.xyz, max.xyz, bitcast(skip), bitcast(meta)
    (meta = ~leaf block for a leaf, the right child for an internal node);
    tris_packed f32[NB,LEAF,12] = leaf-blocked v0, e1, e2, then the global
    triangle index and the object bitcast into slots 9 and 10; padding rows
    are zero triangles (never hit) of object -1."""
    nn = bvh.num_nodes
    is_leaf = bvh.nodes_count > 0
    leaf_ids = np.cumsum(is_leaf) - 1
    nb = max(1, int(is_leaf.sum()))
    right_child = np.zeros(nn, np.int32)
    if nn > 1:
        right_child[:-1] = bvh.nodes_skip[1:]
    meta = np.where(is_leaf, ~leaf_ids, right_child).astype(np.int32)
    nodes_packed = np.zeros((nn, 8), np.float32)
    nodes_packed[:, 0:3] = bvh.nodes_min
    nodes_packed[:, 3:6] = bvh.nodes_max
    nodes_packed[:, 6] = bvh.nodes_skip.astype(np.int32).view(np.float32)
    nodes_packed[:, 7] = meta.view(np.float32)

    tris_packed = np.zeros((nb, leaf_size, 12), np.float32)
    if is_leaf.any():
        lf = bvh.nodes_first[is_leaf].astype(np.int64)
        lc = np.minimum(bvh.nodes_count[is_leaf], leaf_size).astype(np.int64)
        idx = lf[:, None] + np.arange(leaf_size)
        valid = np.arange(leaf_size)[None, :] < lc[:, None]
        idxc = np.clip(idx, 0, len(v0) - 1)
        vm = valid[..., None]
        tris_packed[:, :, 0:3] = np.where(vm, v0[idxc], 0.0)
        tris_packed[:, :, 3:6] = np.where(vm, e1[idxc], 0.0)
        tris_packed[:, :, 6:9] = np.where(vm, e2[idxc], 0.0)
        tri_idx = np.where(valid, idxc, 0).astype(np.int32)
        obj_pad = np.where(valid, tri_object[idxc], -1).astype(np.int32)
        tris_packed[:, :, 9] = tri_idx.view(np.float32)
        tris_packed[:, :, 10] = obj_pad.view(np.float32)
    return nodes_packed, tris_packed


def _leaf_row_units(leaf_size):
    """512-byte VMEM units of one leaf-block row (leaf*12 floats padded up
    to a multiple of 128 lanes), the JAX budget's unit."""
    return -(-(leaf_size * 12) // 128)


def _cut_parts(bvh, budget_bytes: int, leaf_row_units: int = 1):
    """The JAX `_cut_parts`: the shallowest set of subtrees whose packed
    tables each fit `budget_bytes` (a node row 512 B, a leaf row
    `leaf_row_units` x 512 B), as [(i, j)] preorder node ranges in preorder
    that cover every leaf once."""
    is_leaf = bvh.nodes_count > 0
    leaf_psum = np.concatenate([[0], np.cumsum(is_leaf)])
    budget_rows = budget_bytes // 512
    parts = []
    stack = [0]
    while stack:
        i = stack.pop()
        j = int(bvh.nodes_skip[i])
        nb = int(leaf_psum[j] - leaf_psum[i])
        ni = (j - i) - nb
        # Quad rows: n4 <= 2*ni/3 + 1 (roots and absorbed nodes alternate).
        if (max(nb, 1) * leaf_row_units + (2 * max(ni, 1)) // 3 + 2
                <= budget_rows or is_leaf[i]):
            parts.append((i, j))
        else:
            left = i + 1
            right = int(bvh.nodes_skip[left])
            stack.append(right)
            stack.append(left)
    parts.sort()
    covered = sum(int(leaf_psum[j] - leaf_psum[i]) for i, j in parts)
    assert covered == int(leaf_psum[-1]), (covered, int(leaf_psum[-1]))
    for (_, b), (c, _) in zip(parts, parts[1:]):
        assert b <= c, "overlapping parts"
    return parts


def _slice_bvh(bvh, i: int, j: int) -> BVH:
    """The subtree [i, j) of the preorder arrays as a BVH of its own (the
    JAX `_slice_bvh`): skip links rebased and clamped to the slice's end;
    nodes_first keeps indexing the global permuted triangles, so the leaf
    blocks carry global triangle ids."""
    size = j - i
    parent = (bvh.parent[i:j] - i).copy()
    parent[0] = -1
    return BVH(
        nodes_min=bvh.nodes_min[i:j],
        nodes_max=bvh.nodes_max[i:j],
        nodes_skip=np.minimum(bvh.nodes_skip[i:j] - i, size).astype(np.int32),
        nodes_first=bvh.nodes_first[i:j],
        nodes_count=bvh.nodes_count[i:j],
        tri_order=bvh.tri_order,
        parent=parent,
    )


def _pack_parts(bvh, v0p, e1p, e2p, tri_object_p, leaf_size, budget_bytes):
    """Each part's binary and 4-wide tables and leaf blocks (the JAX
    `_pack_pallas_parts`), padded to the largest part and stacked with a
    leading [P] axis: dict(qnodes, qmeta, qroot, q_stack_need, pnodes,
    root_meta, ptris, part_max_depth, part_aabb). Padding node rows are
    zero (pnodes) or NaN boxes (qnodes), and no meta names them."""
    units = _leaf_row_units(leaf_size)
    packs = []
    for (i, j) in _cut_parts(bvh, budget_bytes, units):
        sb = _slice_bvh(bvh, i, j)
        pn, rm, _ = _pack_binary_nodes(sb)
        pt = _pack_leaf_blocks(sb, v0p, e1p, e2p, tri_object_p, leaf_size)
        qn, qm, qr, need, _ = collapse_bvh4_slots(sb)
        assert (qn.shape[0] + pt.shape[0] * units) * 512 <= budget_bytes, (
            "part exceeds the budget after collapse: the n4 bound in "
            "_cut_parts is violated")
        box = np.concatenate([sb.nodes_min[0], sb.nodes_max[0]])
        packs.append((pn, rm, pt, qn, qm, qr, int(need), sb.max_depth(), box))
    p = len(packs)
    ni = max(pk[0].shape[0] for pk in packs)
    nb = max(pk[2].shape[0] for pk in packs)
    n4 = max(pk[3].shape[0] for pk in packs)
    out = dict(
        pnodes=np.zeros((p, ni, 16), np.float32),
        root_meta=np.zeros((p, 1), np.int32),
        ptris=np.zeros((p, nb, packs[0][2].shape[1]), np.float32),
        qnodes=np.full((p, n4, 32), np.nan, np.float32),
        qmeta=np.zeros((p, 4 * n4), np.int32),
        qroot=np.zeros((p, 1), np.int32),
    )
    out["qnodes"][:, :, 28:32] = 0.0
    for k, (pn, rm, pt, qn, qm, qr, _, _, _) in enumerate(packs):
        out["pnodes"][k, :pn.shape[0]] = pn
        out["root_meta"][k] = rm
        out["ptris"][k, :pt.shape[0]] = pt
        out["qnodes"][k, :qn.shape[0]] = qn
        out["qmeta"][k, :qm.shape[0]] = qm
        out["qroot"][k] = qr
    out["q_stack_need"] = max(pk[6] for pk in packs)
    out["part_max_depth"] = max(pk[7] for pk in packs)
    out["part_aabb"] = np.stack([pk[8] for pk in packs]).astype(np.float32)
    return out


def _pack_tri_shade(v0, e1, e2, n0, n1, n2, obj, mat,
                    obj_light_index, obj_light_num):
    t = len(v0)
    out = np.zeros((t, 24), np.float32)
    out[:, 0:3] = v0
    out[:, 3:6] = e1
    out[:, 6:9] = e2
    out[:, 9:12] = n0
    out[:, 12:15] = n1
    out[:, 15:18] = n2
    out[:, 18] = obj.astype(np.float32)
    out[:, 19] = mat.astype(np.float32)
    # Owning object's light index (-1 if none) and that light's triangle
    # count, for the emissive-hit MIS path.
    oc = np.clip(obj, 0, len(obj_light_index) - 1)
    out[:, 20] = np.where(obj >= 0, obj_light_index[oc], -1).astype(
        np.float32)
    out[:, 21] = np.where(obj >= 0, obj_light_num[oc], 0).astype(np.float32)
    return out


def _pack_materials(materials):
    out = np.zeros((len(materials), 16), np.float32)
    for i, mt in enumerate(materials):
        out[i, 0:3] = mt.albedo
        out[i, 3:6] = mt.emission_color
        out[i, 6] = mt.emission_power
        out[i, 7] = mt.roughness
        out[i, 8] = mt.metallic
        out[i, 9] = mt.transmission
        out[i, 10] = mt.ior
        out[i, 11] = mt.dispersion
    return out


def _pack_leaf_blocks(bvh, v0, e1, e2, tri_object, leaf_size):
    """ptris f32[NB, leaf*12]: one row per leaf block, leaf_size x (v0, e1,
    e2, tri_f, obj_f, pad); rows past a leaf's count are degenerate (zero
    edges never hit) with object -1. Integers are exact small f32."""
    is_leaf = bvh.nodes_count > 0
    nb = max(1, int(is_leaf.sum()))
    assert nb < (1 << 24) and len(v0) < (1 << 24)
    ptris = np.zeros((nb, leaf_size * 12), np.float32)
    if is_leaf.any():
        lf = bvh.nodes_first[is_leaf].astype(np.int64)
        lc = np.minimum(bvh.nodes_count[is_leaf], leaf_size).astype(np.int64)
        idx = lf[:, None] + np.arange(leaf_size)
        valid = np.arange(leaf_size)[None, :] < lc[:, None]
        idxc = np.clip(idx, 0, len(v0) - 1)
        vm = valid[..., None]
        blocks = np.zeros((nb, leaf_size, 12), np.float32)
        blocks[:, :, 0:3] = np.where(vm, v0[idxc], 0.0)
        blocks[:, :, 3:6] = np.where(vm, e1[idxc], 0.0)
        blocks[:, :, 6:9] = np.where(vm, e2[idxc], 0.0)
        blocks[:, :, 9] = np.where(valid, idxc, 0).astype(np.float32)
        blocks[:, :, 10] = np.where(valid, tri_object[idxc], -1).astype(
            np.float32)
        ptris = blocks.reshape(nb, leaf_size * 12)
    return ptris


def _pack_binary_nodes(bvh):
    """pnodes f32[NI,16] and root_meta i32[1] of the binary tree: one row
    per internal node in preorder, left.min/max xyz, right.min/max xyz,
    then the left and right child metas as exact f32 (an internal child's
    row, or ~its leaf block). The JAX `_pack_pallas_arrays` layout. Also
    returns the (left, right) child nodes of the rows, i64[NI',2] (NI' = 0
    for a tree that is one leaf), for binary_boxes."""
    is_leaf = bvh.nodes_count > 0
    leaf_ids = (np.cumsum(is_leaf) - 1).astype(np.int64)
    internal_ids = (np.cumsum(~is_leaf) - 1).astype(np.int64)
    ni = max(1, int((~is_leaf).sum()))
    assert bvh.num_nodes < (1 << 24)
    pnodes = np.zeros((ni, 16), np.float32)
    internal = np.nonzero(~is_leaf)[0]
    left = internal + 1
    right = bvh.nodes_skip[left].astype(np.int64)  # end of the left subtree
    children = np.stack([left, right], axis=1)
    if len(internal):
        pnodes[:len(internal), 0:12] = binary_boxes(bvh, children)
        for col, child in ((12, left), (13, right)):
            pnodes[internal_ids[internal], col] = np.where(
                is_leaf[child], ~leaf_ids[child], internal_ids[child])
    root = ~leaf_ids[0] if is_leaf[0] else internal_ids[0]
    return pnodes, np.asarray([root], np.int32), children


def binary_boxes(bvh, children):
    """f32[NI',12]: lanes 0:12 of the pnodes rows whose (left, right)
    child nodes are `children`, from the tree's current node boxes."""
    left, right = children[:, 0], children[:, 1]
    return np.concatenate([bvh.nodes_min[left], bvh.nodes_max[left],
                           bvh.nodes_min[right], bvh.nodes_max[right]],
                          axis=1).astype(np.float32)


@dataclasses.dataclass
class TreeLayout:
    """What a bake packs from a tree's topology, kept on its BVH
    (`BVH.layout`) so that a refit repacks the node boxes by gathers and
    keeps the rest: the metas of qnodes lanes 24:28 and pnodes lanes
    12:14, the stack need and the depth, which a refit cannot change."""
    leaf_size: int
    quad_slots: np.ndarray  # i64[N4,4]: binary node of each qnodes slot
    quad_tail: np.ndarray  # f32[N4,8]: qnodes lanes 24:32 (metas, pad)
    qmeta: np.ndarray
    qroot: np.ndarray
    q_stack_need: int
    binary_children: np.ndarray  # i64[NI',2]: (left, right) of pnodes rows
    pnodes_tail: np.ndarray  # f32[NI,4]: pnodes lanes 12:16 (metas, pad)
    root_meta: np.ndarray
    max_depth: int


def _pack_tree(bvh, leaf_size):
    """Store the TreeLayout of a freshly built tree on `bvh` and return
    its node arrays (_repack_tree)."""
    qnodes, qmeta, qroot, q_stack_need, slots = collapse_bvh4_slots(bvh)
    pnodes, root_meta, children = _pack_binary_nodes(bvh)
    bvh.layout = TreeLayout(
        leaf_size=leaf_size, quad_slots=slots,
        quad_tail=qnodes[:, 24:32].copy(), qmeta=qmeta, qroot=qroot,
        q_stack_need=int(q_stack_need), binary_children=children,
        pnodes_tail=pnodes[:, 12:16].copy(), root_meta=root_meta,
        max_depth=bvh.max_depth())
    return _repack_tree(bvh)


def _repack_tree(bvh):
    """The node arrays of a tree from its TreeLayout and its current node
    boxes, the same after a bake and after a refit (the same topology, new
    boxes): dict(qnodes, qmeta, qroot, q_stack_need, pnodes, root_meta,
    bvh_max_depth). The box lanes come by gathers; every meta, pad lane,
    count and depth is the bake's."""
    lay = bvh.layout
    qnodes = np.concatenate([quad_boxes(bvh, lay.quad_slots), lay.quad_tail],
                            axis=1)
    pnodes = np.zeros((len(lay.pnodes_tail), 16), np.float32)
    pnodes[:len(lay.binary_children), 0:12] = binary_boxes(
        bvh, lay.binary_children)
    pnodes[:, 12:16] = lay.pnodes_tail
    return dict(qnodes=qnodes, qmeta=lay.qmeta, qroot=lay.qroot,
                q_stack_need=lay.q_stack_need, pnodes=pnodes,
                root_meta=lay.root_meta, bvh_max_depth=lay.max_depth)


def _bake_arrays(scene: Scene, leaf_size: int = 16, reuse_bvh: BVH = None,
                 pallas_budget_bytes: int = None, stable_shapes: bool = False
                 ) -> Tuple[Dict[str, np.ndarray], BVH]:
    """The bake on the host: (numpy arrays by DeviceScene field name, with
    the int fields as ints, and the host BVH). With `reuse_bvh` (a BVH of
    this module's bake) the tree is refit to the scene's triangles, not
    built; the other options are bake_scene's."""
    if not scene.objects:
        raise ValueError("cannot bake an empty scene")

    v0s, e1s, e2s, n0s, n1s, n2s, tri_obj = [], [], [], [], [], [], []
    obj_first_tri = []
    tri_cursor = 0
    for oi, obj in enumerate(scene.objects):
        mesh = scene.meshes[obj.mesh_index]
        m = obj.transform.model_matrix
        nmat = obj.transform.normal_matrix
        wpos = mesh.positions @ m[:3, :3].T + m[:3, 3]
        wnrm = mesh.normals @ nmat[:3, :3].T  # unnormalized, as the JAX bake
        tris = mesh.indices.reshape(-1, 3).astype(np.int64)
        a, b, c = wpos[tris[:, 0]], wpos[tris[:, 1]], wpos[tris[:, 2]]
        v0s.append(a)
        e1s.append(b - a)
        e2s.append(c - a)
        n0s.append(wnrm[tris[:, 0]])
        n1s.append(wnrm[tris[:, 1]])
        n2s.append(wnrm[tris[:, 2]])
        tri_obj.append(np.full(len(tris), oi, np.int32))
        obj_first_tri.append(tri_cursor)
        tri_cursor += len(tris)

    v0 = np.concatenate(v0s).astype(np.float32)
    e1 = np.concatenate(e1s).astype(np.float32)
    e2 = np.concatenate(e2s).astype(np.float32)
    n0 = np.concatenate(n0s).astype(np.float32)
    n1 = np.concatenate(n1s).astype(np.float32)
    n2 = np.concatenate(n2s).astype(np.float32)
    tri_object = np.concatenate(tri_obj)
    num_tris = len(v0)
    obj_material = np.asarray(
        [o.material_index for o in scene.objects], np.int32)

    # --- lights from emissive objects (gpu_scene.odin:603-623) ---
    light_object, light_first, light_count = [], [], []
    light_center, light_emission, light_power = [], [], []
    obj_light_index = np.full(len(scene.objects), -1, np.int32)
    for oi, obj in enumerate(scene.objects):
        mat = scene.materials[obj.material_index]
        if mat.emission_power > 0:
            obj_light_index[oi] = len(light_object)
            light_object.append(oi)
            light_first.append(obj_first_tri[oi])
            light_count.append(scene.meshes[obj.mesh_index].num_triangles)
            light_center.append(obj.transform.model_matrix[:3, 3])
            light_emission.append(
                np.asarray(mat.emission_color, np.float32)
                * mat.emission_power)
            light_power.append(mat.emission_power)
    num_lights = len(light_object)

    # --- BVH over world triangles, then permute triangle arrays ---
    if reuse_bvh is not None:
        basis = (reuse_bvh.input_tris if reuse_bvh.input_tris >= 0
                 else len(reuse_bvh.tri_order))
        if basis != num_tris:
            raise ValueError("refit requires an unchanged triangle count "
                             f"({basis} baked, {num_tris} now)")
        if reuse_bvh.layout is None or reuse_bvh.layout.leaf_size != \
                leaf_size:
            raise ValueError("refit requires a BVH of a bake_scene with "
                             f"leaf_size={leaf_size}")
        bvh = reuse_bvh
        perm = bvh.tri_order
        bvh.refit(v0[perm], e1[perm], e2[perm])
    else:
        bvh = build_bvh(v0, e1, e2, leaf_size=leaf_size)
        bvh.input_tris = num_tris
        perm = bvh.tri_order
    num_refs = len(perm)
    v0p, e1p, e2p = v0[perm], e1[perm], e2[perm]
    n0p, n1p, n2p = n0[perm], n1[perm], n2[perm]
    tri_object_p = tri_object[perm]
    tri_material_p = obj_material[tri_object_p]

    ptris = _pack_leaf_blocks(bvh, v0p, e1p, e2p, tri_object_p, leaf_size)
    tree = (_repack_tree(bvh) if reuse_bvh is not None
            else _pack_tree(bvh, leaf_size))
    tree["ptris"] = ptris
    num_parts = 1
    units = _leaf_row_units(leaf_size)
    if (pallas_budget_bytes is not None
            # A degenerate budget bakes one part, as the JAX bake does.
            and pallas_budget_bytes >= (1 << 16)
            and (tree["qnodes"].shape[0] + ptris.shape[0] * units) * 512
            > pallas_budget_bytes):
        tree.update(_pack_parts(bvh, v0p, e1p, e2p, tri_object_p, leaf_size,
                                pallas_budget_bytes))
        num_parts = tree["ptris"].shape[0]

    stable = bool(stable_shapes) and num_parts == 1
    if stable and pallas_budget_bytes is not None:
        padded_rows = (_bucket(tree["qnodes"].shape[0], 64)
                       + _bucket(ptris.shape[0], 64) * units)
        if padded_rows * 512 > pallas_budget_bytes:
            log.info("stable_shapes disabled: capacity padding would exceed "
                     "the budget")
            stable = False
    if stable_shapes and num_parts > 1:
        log.info("stable_shapes disabled: multi-part bake (%d parts)",
                 num_parts)

    t_pad = (_bucket(num_refs, _PAD) if stable
             else max(_PAD, ((num_refs + _PAD - 1) // _PAD) * _PAD))
    depth_tab = tree["bvh_max_depth"]
    if stable:
        depth_tab = -(-depth_tab // 8) * 8
    # The walk serves exactly the trees K3/K4 cannot (api._install).
    from raytracer_tpu_torch.ops.binary_traverse import stack_fits
    walk = {}
    if not stack_fits(depth_tab):
        walk = dict(zip(("nodes_packed", "tris_packed"),
                        _pack_traversal_arrays(bvh, v0p, e1p, e2p,
                                               tri_object_p, leaf_size)))
    if stable:
        # Padded node rows are unreachable: every exit past the tree (a
        # skip link equal to the node count) is rewritten past the padding,
        # and padding rows of the 4-wide and binary tables are NaN boxes
        # that no meta names.
        tree.update(_pad_tree(tree, bvh.num_nodes, walk))

    light_emission_arr = np.asarray(light_emission, np.float32).reshape(
        num_lights, 3)
    light_meta = np.zeros((num_lights, 8), np.float32)
    if num_lights:
        assert max(light_first) < (1 << 24) and max(light_count) < (1 << 24)
        light_meta[:, 0] = np.asarray(light_first, np.float32)
        light_meta[:, 1] = np.asarray(light_count, np.float32)
        light_meta[:, 2:5] = light_emission_arr
        light_meta[:, 5] = np.asarray(light_object, np.float32)
        light_meta[:, 6] = np.asarray(light_power, np.float32)
    obj_light_num = np.zeros(len(scene.objects), np.int32)
    if num_lights:
        obj_light_num[np.asarray(light_object, np.int64)] = np.asarray(
            light_count, np.int32)
    light_tri_packed = np.zeros((num_tris, 16), np.float32)
    light_tri_packed[:, 0:3] = v0
    light_tri_packed[:, 3:6] = e1
    light_tri_packed[:, 6:9] = e2
    light_tri_packed[:, 9] = tri_object.astype(np.float32)
    light_tri_packed[:, 10] = obj_light_index[tri_object].astype(np.float32)
    light_tri_packed[:, 11] = obj_light_num[tri_object].astype(np.float32)
    if num_lights:
        own = obj_light_index[tri_object]
        light_tri_packed[:, 12:15] = np.where(
            (own >= 0)[:, None],
            light_emission_arr[np.clip(own, 0, num_lights - 1)], 0.0)

    tri_object_pad = _pad_rows(tri_object_p, t_pad, fill=-1)
    arrays = dict(
        tri_v0=_pad_rows(v0p, t_pad),
        tri_e1=_pad_rows(e1p, t_pad),
        tri_e2=_pad_rows(e2p, t_pad),
        tri_object=tri_object_pad,
        tri_shade=_pack_tri_shade(
            _pad_rows(v0p, t_pad), _pad_rows(e1p, t_pad),
            _pad_rows(e2p, t_pad), _pad_rows(n0p, t_pad),
            _pad_rows(n1p, t_pad), _pad_rows(n2p, t_pad),
            tri_object_pad, _pad_rows(tri_material_p, t_pad, fill=0),
            obj_light_index, obj_light_num,
        ),
        mat_packed=_pack_materials(scene.materials),
        light_object=np.asarray(light_object, np.int32).reshape(num_lights),
        light_power=np.asarray(light_power, np.float32).reshape(num_lights),
        light_center=np.asarray(light_center, np.float32).reshape(
            num_lights, 3),
        light_meta_packed=light_meta,
        light_tri_packed=light_tri_packed,
        light_tri_object=np.ascontiguousarray(tri_object, np.int32),
        scene_min=np.minimum.reduce(
            [v0.min(0), (v0 + e1).min(0), (v0 + e2).min(0)]
        ).astype(np.float32),
        scene_max=np.maximum.reduce(
            [v0.max(0), (v0 + e1).max(0), (v0 + e2).max(0)]
        ).astype(np.float32),
        num_triangles=num_tris,
        num_lights=num_lights,
        num_parts=num_parts,
        **walk,
        **tree,
    )
    arrays["bvh_max_depth"] = depth_tab
    if stable:
        _pad_tables(arrays, len(scene.objects), len(scene.materials),
                    num_refs)
    return arrays, bvh


def _pad_tree(tree, nn_real, walk):
    """The stable bake's tree tables (JAX `bake_scene(stable_shapes=True)`):
    each padded to its capacity bucket, the stack need rounded up to a
    multiple of 8; `walk`'s tables are padded in place."""
    out = {}
    if walk:
        nn_cap = _bucket(nn_real, 64)
        npk = walk["nodes_packed"]
        skip = npk[:, 6].view(np.int32)
        skip_rw = np.where(skip >= nn_real, nn_cap, skip).astype(np.int32)
        npk = npk.copy()
        npk[:, 6] = skip_rw.view(np.float32)
        np_pad = np.zeros((nn_cap - nn_real, 8), np.float32)
        np_pad[:, 0:3] = np.inf
        np_pad[:, 3:6] = -np.inf
        np_pad[:, 6] = np.asarray([nn_cap], np.int32).view(np.float32)[0]
        walk["nodes_packed"] = np.concatenate([npk, np_pad])
        walk["tris_packed"] = _pad_rows(
            walk["tris_packed"], _bucket(walk["tris_packed"].shape[0], 64))
    pnodes = tree["pnodes"]
    pn_pad = np.full((_bucket(pnodes.shape[0], 64) - pnodes.shape[0], 16),
                     np.nan, np.float32)
    pn_pad[:, 12:16] = 0.0
    out["pnodes"] = np.concatenate([pnodes, pn_pad])
    out["ptris"] = _pad_rows(tree["ptris"], _bucket(tree["ptris"].shape[0],
                                                    64))
    qnodes = tree["qnodes"]
    n4_cap = _bucket(qnodes.shape[0], 64)
    q_pad = np.full((n4_cap - qnodes.shape[0], 32), np.nan, np.float32)
    q_pad[:, 28:32] = 0.0
    out["qnodes"] = np.concatenate([qnodes, q_pad])
    out["qmeta"] = _pad_rows(tree["qmeta"], 4 * n4_cap)
    out["q_stack_need"] = -(-tree["q_stack_need"] // 8) * 8
    return out


def _pad_tables(arrays, num_objects, num_materials, num_refs):
    """Pad the light, light-triangle and material tables of `arrays` to
    their capacity buckets in place (JAX `bake_scene(stable_shapes=True)`):
    padded lights have zero power and triangles and light_object -1, so no
    draw selects them; padded light triangles belong to no light; padded
    materials have ior 1. num_triangles and num_lights become the table
    sizes, and true_counts holds the exact ones."""
    num_tris, num_lights = arrays["num_triangles"], arrays["num_lights"]
    l_tab = _bucket(num_lights, 4) if num_lights else 0
    t_tab = _bucket(num_tris, _PAD)
    m_tab = _bucket(num_materials, 8)
    for k in ("light_power", "light_center", "light_meta_packed"):
        arrays[k] = _pad_rows(arrays[k], l_tab)
    arrays["light_object"] = _pad_rows(arrays["light_object"], l_tab, fill=-1)
    ltp = arrays["light_tri_packed"]
    ltp_pad = np.zeros((t_tab - len(ltp), 16), np.float32)
    ltp_pad[:, 10] = -1.0  # no owning light
    arrays["light_tri_packed"] = np.concatenate([ltp, ltp_pad])
    arrays["light_tri_object"] = _pad_rows(arrays["light_tri_object"], t_tab,
                                           fill=-1)
    mat = _pad_rows(arrays["mat_packed"], m_tab)
    mat[num_materials:, 10] = 1.0  # a padded material's ior: vacuum
    arrays["mat_packed"] = mat
    arrays["true_counts"] = np.asarray(
        [num_tris, num_lights, num_objects, num_refs], np.int32)
    arrays["num_triangles"] = t_tab
    arrays["num_lights"] = l_tab


def _to_device(arrays, device) -> DeviceScene:
    dev = torch.device(device)

    def upload(a):
        return torch.from_numpy(np.array(a, copy=True)).to(dev)

    tensors = {k: upload(arrays[k]) for k in ARRAY_FIELDS}
    tensors.update({k: upload(arrays[k]) for k in OPTIONAL_FIELDS
                    if arrays.get(k) is not None})
    return DeviceScene(
        **tensors,
        num_triangles=int(arrays["num_triangles"]),
        num_lights=int(arrays["num_lights"]),
        q_stack_need=int(arrays["q_stack_need"]),
        bvh_max_depth=int(arrays["bvh_max_depth"]),
        root=int(np.asarray(arrays["qroot"]).reshape(-1)[0]),
        binary_root=int(np.asarray(arrays["root_meta"]).reshape(-1)[0]),
        num_parts=int(arrays.get("num_parts", 1)),
        part_max_depth=int(arrays.get("part_max_depth", -1)),
        transmissive=_transmissive(arrays["mat_packed"]),
    )


def _transmissive(mat_packed) -> bool:
    return bool((np.asarray(mat_packed)[..., 9] > 0.0).any())


def bake_scene(scene: Scene, leaf_size: int = 16, device="cuda",
               reuse_bvh: BVH = None, pallas_budget_bytes: int = None,
               stable_shapes: bool = False) -> Tuple[DeviceScene, BVH]:
    """Flatten + world-transform + BVH-build a host Scene and upload it:
    (DeviceScene on `device`, host BVH). The arrays equal the JAX
    `bake_scene(scene, leaf_size, reuse_bvh=..., pallas_budget_bytes=...,
    stable_shapes=...)` fields of the same names.

    `reuse_bvh` is the TLAS UPDATE-mode path (gpu_scene.odin:457-482): the
    tree of an earlier bake of this module keeps its topology (tri_order,
    skip links, leaf ranges, the 4-wide and binary metas, the stack need)
    and is refit in place to the scene's re-transformed triangles
    (BVH.refit); the node rows get their new boxes by gathers
    (_repack_tree). The triangle count must not have changed (transform
    edits). Every tensor is uploaded anew, ptris included, so the kernels'
    leaf counts, cached per ptris tensor, are never stale
    (ops/quad_traverse.leaf_counts).

    `pallas_budget_bytes` cuts a tree whose tables exceed it into parts;
    `stable_shapes` pads every table to a capacity bucket (not under
    parts). A binary tree too deep for K3/K4's stack also gets the
    skip-link walk's tables. See the module docstring. The bake is the
    `rt.bake` span (attributes: triangles, refit)."""
    with profiling.span("rt.bake", refit=reuse_bvh is not None) as attrs:
        arrays, bvh = _bake_arrays(scene, leaf_size, reuse_bvh,
                                   pallas_budget_bytes, stable_shapes)
        ds = _to_device(arrays, device)
        if attrs is not None:
            attrs["triangles"] = ds.num_triangles
    log.info(
        "bake%s: %d triangles, %d lights, %d part(s), qnodes %s f32 (%d "
        "bytes), ptris %s f32 (%d bytes), stack need %d; pnodes %s f32 (%d "
        "bytes), depth %d%s%s", " (refit)" if reuse_bvh is not None else "",
        ds.num_triangles, ds.num_lights, ds.num_parts,
        tuple(ds.qnodes.shape), ds.qnodes.numel() * 4, tuple(ds.ptris.shape),
        ds.ptris.numel() * 4, ds.q_stack_need, tuple(ds.pnodes.shape),
        ds.pnodes.numel() * 4, ds.bvh_max_depth,
        ", stable shapes" if ds.true_counts is not None else "",
        ", skip-link tables" if ds.nodes_packed is not None else "",
    )
    return ds, bvh


def _light_rows(scene: Scene, emissive):
    """(light_emission f32[L,3], light_power f32[L]) of the emissive
    objects `emissive`, as the bake computes them."""
    mats = [scene.materials[scene.objects[oi].material_index]
            for oi in emissive]
    emission = np.asarray(
        [np.asarray(m.emission_color, np.float32) * m.emission_power
         for m in mats], np.float32).reshape(len(mats), 3)
    power = np.asarray([m.emission_power for m in mats],
                       np.float32).reshape(len(mats))
    return emission, power


def update_materials(ds: DeviceScene, scene: Scene,
                     **bake_kwargs) -> DeviceScene:
    """The material-only update (gpu_scene_update_material,
    gpu_scene.odin:560-601; the JAX `update_materials`): rewrite the
    material and light tables without touching geometry or the trees.
    Returns a `dataclasses.replace` of `ds` whose geometry tensors are the
    same objects; mat_packed, light_power, light_meta_packed (emission
    columns 2:5 and power column 6) and light_tri_packed (emission columns
    12:15) are new, each of the baked shape (a stable bake's padded rows
    stay padding). Falls back to a full bake, with `bake_kwargs`
    (bake_scene's), when the set of emissive objects changed or the scene
    has more materials than mat_packed has rows."""
    mats = scene.materials
    emissive = [oi for oi, o in enumerate(scene.objects)
                if mats[o.material_index].emission_power > 0]
    baked = ds.light_object.tolist()
    if (emissive != [oi for oi in baked if oi >= 0]
            or len(mats) > ds.mat_packed.shape[0]):
        return bake_scene(scene, **bake_kwargs)[0]
    dev = ds.device
    emission, power = _light_rows(scene, emissive)
    l_tab = ds.light_power.shape[0]
    emission_t = torch.from_numpy(emission).to(dev)
    power_t = torch.from_numpy(_pad_rows(power, l_tab)).to(dev)
    mat_packed = _pad_rows(_pack_materials(mats), ds.mat_packed.shape[0])
    mat_packed[len(mats):, 10] = 1.0  # a padded row's ior: vacuum
    return dataclasses.replace(
        ds,
        mat_packed=torch.from_numpy(mat_packed).to(dev),
        light_power=power_t,
        light_meta_packed=_refresh_light_meta(ds.light_meta_packed,
                                              emission_t, power_t),
        light_tri_packed=_refresh_light_tri_emission(ds.light_tri_packed,
                                                     emission_t),
        transmissive=_transmissive(mat_packed),
    )


def _refresh_light_tri_emission(light_tri_packed, light_emission):
    """light_tri_packed with its owning light's emission (columns 12:15)
    rewritten on its device: each row's light index is column 10 (-1 for a
    row of no light, which gets 0)."""
    if light_emission.shape[0] == 0:
        return light_tri_packed
    li = light_tri_packed[:, 10].to(torch.int64)
    em = light_emission[li.clamp(0, light_emission.shape[0] - 1)]
    out = light_tri_packed.clone()
    out[:, 12:15] = torch.where((li >= 0)[:, None], em,
                                torch.zeros_like(em))
    return out


def _refresh_light_meta(meta, light_emission, light_power):
    """light_meta_packed with the emission (columns 2:5) and power (column
    6) of its lights rewritten; the other columns, and a stable bake's
    padded rows, are the bake's (`light_power` has the table's rows, their
    padding zero)."""
    meta = meta.clone()
    meta[:light_emission.shape[0], 2:5] = light_emission
    meta[:, 6] = light_power
    return meta


def from_jax_arrays(d: Dict[str, np.ndarray], device) -> DeviceScene:
    """Build a DeviceScene from a JAX SceneOnDevice's fields after
    `np.asarray` (with the static ints: bvh_max_depth, num_parts,
    part_max_depth), so both packages trace one tree: a single-part or a
    multi-part bake, exact or stable, with the skip-link walk's tables."""
    return _to_device(d, device)
