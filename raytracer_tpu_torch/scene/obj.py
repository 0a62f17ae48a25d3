"""Minimal Wavefront OBJ loader.

The reference vendors tinyobjloader (external/odin-tinyobjloader/wrapper.odin)
and ships objects/quad.obj, though src/ never imports it (SURVEY.md §2.6) —
provided here so OBJ assets are loadable. Supports v / vn / o groups and
polygonal f entries (v, v/vt, v//vn, v/vt/vn; negative indices), fan-
triangulated. Each `o` group becomes one Mesh+Object with the default
material; normals fall back to area-weighted face normals.
"""

from __future__ import annotations

from typing import List

import numpy as np

from raytracer_tpu_torch.scene.gltf import _face_normals_as_vertex_normals
from raytracer_tpu_torch.scene.model import Material, Mesh, Scene


def load_scene_from_obj(path: str) -> Scene:
    positions: List[List[float]] = []
    normals: List[List[float]] = []
    groups: List[tuple] = []  # (name, faces) with faces = list of index lists
    current_name = "default"
    current_faces: List[List[int]] = []

    def flush():
        nonlocal current_faces
        if current_faces:
            groups.append((current_name, current_faces))
            current_faces = []

    with open(path, "r") as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            tag = parts[0]
            if tag == "v":
                positions.append([float(x) for x in parts[1:4]])
            elif tag == "vn":
                normals.append([float(x) for x in parts[1:4]])
            elif tag in ("o", "g"):
                flush()
                current_name = parts[1] if len(parts) > 1 else "group"
            elif tag == "f":
                idx = []
                for token in parts[1:]:
                    vi = token.split("/")[0]
                    i = int(vi)
                    idx.append(i - 1 if i > 0 else len(positions) + i)
                # Fan triangulation of polygons.
                for k in range(1, len(idx) - 1):
                    current_faces.append([idx[0], idx[k], idx[k + 1]])
    flush()

    if not groups:
        raise ValueError(f"{path}: no faces found")

    scene = Scene()
    default = scene.add_material(
        Material(name="default", albedo=(0.8, 0.8, 0.8), roughness=1.0)
    )
    pos = np.asarray(positions, np.float32)
    for name, faces in groups:
        tris = np.asarray(faces, np.int64)
        used = np.unique(tris)
        remap = {int(g): i for i, g in enumerate(used)}
        local_pos = pos[used]
        local_idx = np.vectorize(remap.get)(tris).astype(np.uint32).reshape(-1)
        nrm = _face_normals_as_vertex_normals(local_pos, local_idx)
        mesh_idx = scene.add_mesh(
            Mesh(name=name, positions=local_pos, normals=nrm,
                 indices=local_idx)
        )
        scene.add_object(name, mesh_idx, default)
    return scene
