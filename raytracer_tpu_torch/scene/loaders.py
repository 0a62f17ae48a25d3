"""Scene file loading: JSON scene format + glTF/GLB dispatch.

JSON schema matches the reference's (`scenes/cornell_box.json`,
`src/raytracer/scene_loader.odin:14-34,193-253`):

  {"materials": {name: {albedo, roughness?, metallic?, emission_color?,
                        emission_power?, transmission?, ior?}},
   "objects":   {name: {"transform": {position?, rotation?, scale?},
                        "mesh": "Plane"|"Sphere", "material": name}}}
"""

from __future__ import annotations

import json
import logging
import os
import time

from raytracer_tpu_torch.scene.gltf import load_scene_from_gltf
from raytracer_tpu_torch.scene.model import (
    Material,
    Scene,
    create_plane,
    create_sphere,
)

log = logging.getLogger(__name__)


class SceneLoadError(ValueError):
    pass


def load_scene_from_json(path: str) -> Scene:
    """load_scene_from_file (scene_loader.odin:193-253)."""
    with open(path, "r") as f:
        data = json.load(f)

    scene = Scene()
    for name, m in data.get("materials", {}).items():
        scene.add_material(
            Material(
                name=name,
                albedo=tuple(m.get("albedo", (0.0, 0.0, 0.0))),
                emission_color=tuple(m.get("emission_color", (0.0, 0.0, 0.0))),
                emission_power=float(m.get("emission_power", 0.0)),
                roughness=float(m.get("roughness", 0.0)),
                metallic=float(m.get("metallic", 0.0)),
                transmission=float(m.get("transmission", 0.0)),
                ior=float(m.get("ior", 1.0)),
            )
        )

    mesh_indices = {
        "Plane": scene.add_mesh(create_plane()),
        "Sphere": scene.add_mesh(create_sphere()),
    }
    material_by_name = {m.name: i for i, m in enumerate(scene.materials)}

    for name, obj in data.get("objects", {}).items():
        mat_name = obj.get("material")
        if mat_name not in material_by_name:
            raise SceneLoadError(
                f"Object '{name}' has material '{mat_name}' that was not defined"
            )
        mesh_name = obj.get("mesh")
        if mesh_name not in mesh_indices:
            raise SceneLoadError(
                f"Object '{name}' has unknown mesh variant '{mesh_name}'"
            )
        tr = obj.get("transform", {})
        scene.add_object(
            name,
            mesh_indices[mesh_name],
            material_by_name[mat_name],
            position=tuple(tr.get("position", (0.0, 0.0, 0.0))),
            rotation=tuple(tr.get("rotation", (0.0, 0.0, 0.0))),
            scale=tuple(tr.get("scale", (1.0, 1.0, 1.0))),
        )
    return scene


def load_scene(path: str) -> Scene:
    """Dispatch on extension; logs load wall time like
    scene_loader.odin:38-41."""
    start = time.perf_counter()
    ext = os.path.splitext(path)[1].lower()
    if ext == ".json":
        scene = load_scene_from_json(path)
    elif ext in (".gltf", ".glb"):
        scene = load_scene_from_gltf(path)
    elif ext == ".obj":
        from raytracer_tpu_torch.scene.obj import load_scene_from_obj

        scene = load_scene_from_obj(path)
    else:
        raise SceneLoadError(f"unsupported scene file type: {path}")
    log.info(
        "Scene %s loaded in %.1f ms (%d objects, %d materials, %d triangles)",
        os.path.basename(path),
        (time.perf_counter() - start) * 1e3,
        len(scene.objects),
        len(scene.materials),
        scene.num_triangles,
    )
    return scene
