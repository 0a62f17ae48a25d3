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

Not ported here: multi-part bakes (they exist for the TPU kernel's VMEM
ceiling) and capacity-padded "stable" bakes; ROADMAP.md lists each.
"""

from __future__ import annotations

import dataclasses
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
    qnodes: torch.Tensor  # f32[N4,32]
    qmeta: torch.Tensor  # i32[4*N4]
    qroot: torch.Tensor  # i32[1]
    ptris: torch.Tensor  # f32[NB, leaf*12]
    pnodes: torch.Tensor  # f32[NI,16]
    root_meta: torch.Tensor  # i32[1]
    num_triangles: int
    num_lights: int
    q_stack_need: int
    bvh_max_depth: int  # deepest binary node (root = 0)
    # qroot and root_meta as host ints, so a kernel launch needs no device
    # readback.
    root: int
    binary_root: int

    @property
    def device(self) -> torch.device:
        return self.qnodes.device


# Array fields shared with the JAX SceneOnDevice, by name.
ARRAY_FIELDS = (
    "tri_v0", "tri_e1", "tri_e2", "tri_object", "tri_shade", "mat_packed",
    "light_object", "light_power", "light_center", "light_meta_packed",
    "light_tri_packed", "light_tri_object", "scene_min", "scene_max",
    "qnodes", "qmeta", "qroot",
    "ptris", "pnodes", "root_meta",
)


def _pad_rows(a: np.ndarray, total: int, fill=0.0) -> np.ndarray:
    if len(a) == total:
        return a
    pad_shape = (total - len(a),) + a.shape[1:]
    return np.concatenate([a, np.full(pad_shape, fill, a.dtype)])


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


def _bake_arrays(scene: Scene, leaf_size: int = 16, reuse_bvh: BVH = None
                ) -> Tuple[Dict[str, np.ndarray], BVH]:
    """The bake on the host: (numpy arrays by DeviceScene field name, with
    the int fields as ints, and the host BVH). With `reuse_bvh` (a BVH of
    this module's bake) the tree is refit to the scene's triangles, not
    built (bake_scene)."""
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

    t_pad = max(_PAD, ((num_refs + _PAD - 1) // _PAD) * _PAD)

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
        ptris=ptris,
        num_triangles=num_tris,
        num_lights=num_lights,
        **tree,
    )
    return arrays, bvh


def _to_device(arrays, device) -> DeviceScene:
    dev = torch.device(device)
    tensors = {k: torch.from_numpy(np.array(arrays[k], copy=True)).to(dev)
               for k in ARRAY_FIELDS}
    return DeviceScene(
        **tensors,
        num_triangles=int(arrays["num_triangles"]),
        num_lights=int(arrays["num_lights"]),
        q_stack_need=int(arrays["q_stack_need"]),
        bvh_max_depth=int(arrays["bvh_max_depth"]),
        root=int(np.asarray(arrays["qroot"]).reshape(-1)[0]),
        binary_root=int(np.asarray(arrays["root_meta"]).reshape(-1)[0]),
    )


def bake_scene(scene: Scene, leaf_size: int = 16, device="cuda",
               reuse_bvh: BVH = None) -> Tuple[DeviceScene, BVH]:
    """Flatten + world-transform + BVH-build a host Scene and upload it:
    (DeviceScene on `device`, host BVH). The arrays equal the JAX
    `bake_scene(scene, leaf_size, reuse_bvh=..., stable_shapes=False)`
    fields of the same names.

    `reuse_bvh` is the TLAS UPDATE-mode path (gpu_scene.odin:457-482): the
    tree of an earlier bake of this module keeps its topology (tri_order,
    skip links, leaf ranges, the 4-wide and binary metas, the stack need)
    and is refit in place to the scene's re-transformed triangles
    (BVH.refit); the node rows get their new boxes by gathers
    (_repack_tree). The triangle count must not have changed (transform
    edits). Every tensor is uploaded anew, ptris included, so the kernels'
    leaf counts, cached per ptris tensor, are never stale
    (ops/quad_traverse.leaf_counts)."""
    arrays, bvh = _bake_arrays(scene, leaf_size, reuse_bvh)
    ds = _to_device(arrays, device)
    log.info(
        "bake%s: %d triangles, %d lights, qnodes %d x 32 f32 (%d bytes), "
        "ptris %d x %d f32 (%d bytes), stack need %d; pnodes %d x 16 f32 "
        "(%d bytes), depth %d", " (refit)" if reuse_bvh is not None else "",
        ds.num_triangles, ds.num_lights, ds.qnodes.shape[0],
        ds.qnodes.numel() * 4, ds.ptris.shape[0], ds.ptris.shape[1],
        ds.ptris.numel() * 4, ds.q_stack_need, ds.pnodes.shape[0],
        ds.pnodes.numel() * 4, ds.bvh_max_depth,
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
    12:15) are new. Falls back to a full bake, with `bake_kwargs`
    (leaf_size, device), when the set of emissive objects changed or the
    scene has more materials than mat_packed has rows."""
    mats = scene.materials
    emissive = [oi for oi, o in enumerate(scene.objects)
                if mats[o.material_index].emission_power > 0]
    if (emissive != ds.light_object.tolist()
            or len(mats) > ds.mat_packed.shape[0]):
        return bake_scene(scene, **bake_kwargs)[0]
    dev = ds.device
    emission, power = _light_rows(scene, emissive)
    emission_t = torch.from_numpy(emission).to(dev)
    power_t = torch.from_numpy(power).to(dev)
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
    6) of its lights rewritten; the other columns are the bake's."""
    meta = meta.clone()
    meta[:, 2:5] = light_emission
    meta[:, 6] = light_power
    return meta


def from_jax_arrays(d: Dict[str, np.ndarray], device) -> DeviceScene:
    """Build a DeviceScene from a JAX SceneOnDevice's fields after
    `np.asarray` (a single-part bake, including pnodes, root_meta and
    bvh_max_depth), so both packages trace one tree."""
    if int(np.asarray(d.get("num_parts", 1))) != 1:
        raise ValueError("multi-part bakes are not ported "
                         "(ROADMAP.md port queue item P4)")
    return _to_device(d, device)
