"""Minimal glTF 2.0 / GLB parser (hand-rolled: json + numpy, no deps).

Covers what the reference's cgltf-based loader consumes
(`src/raytracer/scene_loader.odin:37-190`):
  - .gltf with external or data-URI buffers, and .glb binary containers
  - accessors for POSITION/NORMAL (f32 vec3) and indices (u8/u16/u32 scalar),
    including bufferView byteStride
  - per-node LOCAL transforms only (the reference calls
    cgltf.node_transform_local, deliberately ignoring parent hierarchy —
    scene_loader.odin:107-108; we reproduce that behavior)
  - materials from pbr_metallic_roughness (base_color_factor.rgb,
    roughness_factor, metallic_factor) + emissive_factor +
    KHR_materials_emissive_strength (scene_loader.odin:80-99)

Beyond the reference (which declares-but-ignores transmission/ior,
SURVEY.md §2.5 key behavioral fact): we also read
KHR_materials_transmission / KHR_materials_ior so that
scenes/multi-dispersion.gltf actually renders glass (BASELINE config 3).
"""

from __future__ import annotations

import base64
import json
import os
import struct
from typing import Dict, List, Optional

import numpy as np

from raytracer_tpu_torch.scene.model import Material, Mesh, Object, Scene, Transform

_COMPONENT_DTYPES = {
    5120: np.int8,
    5121: np.uint8,
    5122: np.int16,
    5123: np.uint16,
    5125: np.uint32,
    5126: np.float32,
}
_TYPE_COUNTS = {
    "SCALAR": 1,
    "VEC2": 2,
    "VEC3": 3,
    "VEC4": 4,
    "MAT2": 4,
    "MAT3": 9,
    "MAT4": 16,
}

_GLB_MAGIC = 0x46546C67
_CHUNK_JSON = 0x4E4F534A
_CHUNK_BIN = 0x004E4942


class GltfError(ValueError):
    pass


def _read_glb(path: str):
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 12:
        raise GltfError(f"{path}: truncated GLB header")
    magic, version, _length = struct.unpack_from("<III", data, 0)
    if magic != _GLB_MAGIC:
        raise GltfError(f"{path}: bad GLB magic {magic:#x}")
    if version != 2:
        raise GltfError(f"{path}: unsupported GLB version {version}")
    offset = 12
    doc = None
    bin_chunk = None
    while offset + 8 <= len(data):
        chunk_len, chunk_type = struct.unpack_from("<II", data, offset)
        offset += 8
        chunk = data[offset : offset + chunk_len]
        offset += chunk_len + ((4 - chunk_len % 4) % 4) * 0  # chunks are padded to 4
        # glTF spec: chunkLength already includes padding, so no extra skip.
        if chunk_type == _CHUNK_JSON:
            doc = json.loads(chunk.decode("utf-8"))
        elif chunk_type == _CHUNK_BIN:
            bin_chunk = chunk
    if doc is None:
        raise GltfError(f"{path}: GLB missing JSON chunk")
    return doc, bin_chunk


def _load_buffer(buf: dict, base_dir: str, bin_chunk: Optional[bytes]) -> bytes:
    uri = buf.get("uri")
    if uri is None:
        if bin_chunk is None:
            raise GltfError("buffer has no uri and no GLB BIN chunk")
        return bin_chunk
    if uri.startswith("data:"):
        _, b64 = uri.split(",", 1)
        return base64.b64decode(b64)
    path = os.path.join(base_dir, uri)
    if not os.path.exists(path):
        raise GltfError(
            f"external buffer {uri!r} not found next to the glTF file "
            f"(looked at {path})"
        )
    with open(path, "rb") as f:
        return f.read()


class _GltfDoc:
    def __init__(self, doc: dict, buffers: List[bytes]):
        self.doc = doc
        self.buffers = buffers

    def read_accessor(self, accessor_index: int) -> np.ndarray:
        acc = self.doc["accessors"][accessor_index]
        if "sparse" in acc:
            raise GltfError("sparse accessors are not supported")
        count = acc["count"]
        n_comp = _TYPE_COUNTS[acc["type"]]
        dtype = _COMPONENT_DTYPES[acc["componentType"]]
        itemsize = np.dtype(dtype).itemsize
        if "bufferView" not in acc:
            return np.zeros((count, n_comp), dtype)
        view = self.doc["bufferViews"][acc["bufferView"]]
        buf = self.buffers[view["buffer"]]
        base = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
        stride = view.get("byteStride", n_comp * itemsize)
        if stride == n_comp * itemsize:
            out = np.frombuffer(
                buf, dtype=dtype, count=count * n_comp, offset=base
            ).reshape(count, n_comp)
        else:
            raw = np.frombuffer(buf, dtype=np.uint8)
            rows = np.lib.stride_tricks.as_strided(
                raw[base:], shape=(count, n_comp * itemsize), strides=(stride, 1)
            )
            out = rows.copy().view(dtype).reshape(count, n_comp)
        return np.ascontiguousarray(out)


def _node_local_matrix(node: dict) -> np.ndarray:
    """Local node transform (matrix, or TRS composed as T*R*S), matching
    cgltf.node_transform_local semantics (scene_loader.odin:107-108)."""
    if "matrix" in node:
        # glTF matrices are column-major.
        return np.asarray(node["matrix"], np.float32).reshape(4, 4).T
    m = np.eye(4, dtype=np.float32)
    if "translation" in node:
        m[:3, 3] = node["translation"]
    if "rotation" in node:
        x, y, z, w = node["rotation"]
        r = np.asarray(
            [
                [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
            ],
            np.float32,
        )
        m[:3, :3] = m[:3, :3] @ r
    if "scale" in node:
        m[:3, :3] = m[:3, :3] @ np.diag(np.asarray(node["scale"], np.float32))
    return m


def _decompose_trs(world: np.ndarray):
    """Decompose a shear-free 4x4 into (position, Euler-XYZ degrees, scale)
    under the Transform contract M = T·Rx·Ry·Rz·S (scene.odin:213-224), so a
    later edit that calls update_matrices rebuilds the same matrix instead of
    reinterpreting raw quaternion components as degrees. Negative-determinant
    matrices fold the reflection into scale.x. glTF TRS nodes are always
    shear-free; for a (rare) sheared `matrix` node this is the closest
    TRS approximation."""
    import math

    pos = world[:3, 3].astype(np.float64)
    m = world[:3, :3].astype(np.float64)
    scale = np.linalg.norm(m, axis=0)
    scale = np.where(scale < 1e-12, 1e-12, scale)
    if np.linalg.det(m) < 0:
        scale[0] = -scale[0]
    r = m / scale[None, :]
    # R = Rx(a)·Ry(b)·Rz(c):  R[0,2]=sin b, R[1,2]=-sin a·cos b,
    # R[2,2]=cos a·cos b, R[0,1]=-cos b·sin c, R[0,0]=cos b·cos c.
    sb = float(np.clip(r[0, 2], -1.0, 1.0))
    b = math.asin(sb)
    if abs(sb) < 1.0 - 1e-9:
        a = math.atan2(-r[1, 2], r[2, 2])
        c = math.atan2(-r[0, 1], r[0, 0])
    else:
        # Gimbal lock (|cos b| = 0): only a±c is determined; pin c = 0.
        # Row 1 becomes [sin(a±c), cos(a±c), 0] with + for b=+90°.
        a = math.atan2(r[1, 0], r[1, 1]) * (1.0 if sb > 0 else -1.0)
        c = 0.0
    rot = tuple(math.degrees(v) for v in (a, b, c))
    return tuple(float(x) for x in pos), rot, tuple(float(x) for x in scale)


def _material_from_gltf(mat: dict) -> Material:
    """scene_loader.odin:80-99 + transmission/ior extensions."""
    albedo = (1.0, 1.0, 1.0)
    roughness = 1.0
    metallic = 1.0
    pbr = mat.get("pbrMetallicRoughness")
    if pbr is not None:
        base = pbr.get("baseColorFactor", [1.0, 1.0, 1.0, 1.0])
        albedo = tuple(base[:3])
        roughness = pbr.get("roughnessFactor", 1.0)
        metallic = pbr.get("metallicFactor", 1.0)
    emission_color = tuple(mat.get("emissiveFactor", [0.0, 0.0, 0.0]))
    ext = mat.get("extensions", {})
    emission_power = ext.get("KHR_materials_emissive_strength", {}).get(
        "emissiveStrength", 0.0
    )
    transmission = ext.get("KHR_materials_transmission", {}).get(
        "transmissionFactor", 0.0
    )
    ior = ext.get("KHR_materials_ior", {}).get("ior", 1.5 if transmission > 0 else 1.0)
    dispersion = ext.get("KHR_materials_dispersion", {}).get("dispersion", 0.0)
    return Material(
        name=mat.get("name", ""),
        albedo=albedo,
        emission_color=emission_color,
        emission_power=float(emission_power),
        roughness=float(roughness),
        metallic=float(metallic),
        transmission=float(transmission),
        ior=float(ior),
        dispersion=float(dispersion),
    )


def load_scene_from_gltf(path: str) -> Scene:
    """Build a Scene from a .gltf or .glb file.

    One Mesh + one Object per (node, primitive) pair, local node transform as
    the model matrix — reproducing scene_loader.odin:102-187."""
    ext = os.path.splitext(path)[1].lower()
    bin_chunk = None
    if ext == ".glb":
        doc, bin_chunk = _read_glb(path)
    elif ext == ".gltf":
        with open(path, "r") as f:
            doc = json.load(f)
    else:
        raise GltfError(f"unsupported scene extension {ext!r}")

    base_dir = os.path.dirname(os.path.abspath(path))
    buffers = [
        _load_buffer(b, base_dir, bin_chunk) for b in doc.get("buffers", [])
    ]
    g = _GltfDoc(doc, buffers)

    scene = Scene()
    for mat in doc.get("materials", []):
        scene.materials.append(_material_from_gltf(mat))

    if not scene.materials:
        # A primitive without materials still needs index 0 to resolve.
        scene.materials.append(Material(name="default", albedo=(0.8, 0.8, 0.8),
                                        roughness=1.0))

    meshes = doc.get("meshes", [])
    for node in doc.get("nodes", []):
        if "mesh" not in node:
            continue
        world = _node_local_matrix(node)
        normal_matrix = np.linalg.inv(world).T.astype(np.float32)
        gmesh = meshes[node["mesh"]]
        for prim in gmesh.get("primitives", []):
            if prim.get("mode", 4) != 4:  # TRIANGLES only
                continue
            attrs = prim.get("attributes", {})
            if "POSITION" not in attrs:
                raise GltfError("primitive missing POSITION")
            pos = g.read_accessor(attrs["POSITION"]).astype(np.float32)
            if "NORMAL" in attrs:
                nrm = g.read_accessor(attrs["NORMAL"]).astype(np.float32)
            else:
                nrm = np.zeros_like(pos)
            if "indices" in prim:
                idx = g.read_accessor(prim["indices"]).reshape(-1).astype(np.uint32)
            else:
                idx = np.arange(len(pos), dtype=np.uint32)
            if "NORMAL" not in attrs:
                nrm = _face_normals_as_vertex_normals(pos, idx)

            mesh_index = scene.add_mesh(
                Mesh(
                    name=gmesh.get("name", f"mesh{node['mesh']}"),
                    positions=pos,
                    normals=nrm,
                    indices=idx,
                )
            )
            pos_t, rot_t, scale_t = _decompose_trs(world)
            transform = Transform(
                position=pos_t,
                rotation=rot_t,
                scale=scale_t,
                model_matrix=world,
                normal_matrix=normal_matrix,
            )
            scene.objects.append(
                Object(
                    name=node.get("name", ""),
                    transform=transform,
                    mesh_index=mesh_index,
                    material_index=prim.get("material", 0),
                )
            )
    return scene


def _face_normals_as_vertex_normals(pos: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals for primitives that ship none."""
    tris = idx.reshape(-1, 3)
    e1 = pos[tris[:, 1]] - pos[tris[:, 0]]
    e2 = pos[tris[:, 2]] - pos[tris[:, 0]]
    fn = np.cross(e1, e2)
    out = np.zeros_like(pos)
    for k in range(3):
        np.add.at(out, tris[:, k], fn)
    norm = np.linalg.norm(out, axis=1, keepdims=True)
    return (out / np.maximum(norm, 1e-20)).astype(np.float32)
