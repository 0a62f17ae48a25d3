"""The glass atrium: the procedural atrium (scenes/atrium.py, the same
geometry, walls and ceiling light) with the three materials that cycle
over its column spheres turned to smooth dielectrics, the glasses of a
dispersion scene: clear glass as glTF ships it (ior 1.5, no dispersion),
crown glass (BK7: nd 1.5168, Abbe 64.2) and dense flint (SF11: nd
1.7847, Abbe 25.8), with dispersion 20 / Abbe as
KHR_materials_dispersion defines it. A procedural stand-in for a glass
scene at the scale of the large published scenes."""

from __future__ import annotations

import dataclasses
import importlib.util
import os

from harness.scenedesc import SceneDesc

# column material -> (name, albedo, ior, dispersion)
GLASSES = {
    "column_diffuse": ("glass_clear", 0.98, 1.5, 0.0),
    "column_metal": ("glass_crown", 0.98, 1.5168, 20.0 / 64.2),
    "column_glossy": ("glass_flint", 0.97, 1.7847, 20.0 / 25.8),
}


def _atrium():
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "atrium.py")
    spec = importlib.util.spec_from_file_location("portbench_scene_atrium",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build(target_triangles: int = 300_000) -> SceneDesc:
    scene = _atrium().build(target_triangles)
    for i, m in enumerate(scene.materials):
        if m.name in GLASSES:
            name, albedo, ior, dispersion = GLASSES[m.name]
            scene.materials[i] = dataclasses.replace(
                m, name=name, albedo=(albedo,) * 3, roughness=0.0,
                metallic=0.0, transmission=1.0, ior=ior,
                dispersion=dispersion)
    return scene
