"""The procedural atrium: a colonnade of stacked UV spheres inside a walled
40 x 12 x 20 room lit by one emissive ceiling panel, its triangle count set
by the spheres (a frozen copy of the renderer's `create_benchmark_atrium`).
A procedural stand-in, no published scene: it has the triangle count of
the large published scenes, not their geometry."""

from __future__ import annotations

import math

from harness.scenedesc import Material, SceneDesc, plane, sphere


def build(target_triangles: int = 300_000) -> SceneDesc:
    scene = SceneDesc()
    floor_mat = scene.add_material(
        Material(name="floor", albedo=(0.7, 0.68, 0.65), roughness=0.9))
    wall_mat = scene.add_material(
        Material(name="wall", albedo=(0.75, 0.72, 0.6), roughness=1.0))
    col_mats = [
        scene.add_material(Material(name="column_diffuse",
                                    albedo=(0.8, 0.78, 0.7), roughness=0.8)),
        scene.add_material(Material(name="column_metal",
                                    albedo=(0.85, 0.83, 0.8), metallic=1.0,
                                    roughness=0.15)),
        scene.add_material(Material(name="column_glossy",
                                    albedo=(0.4, 0.5, 0.7), roughness=0.3)),
    ]
    light_mat = scene.add_material(
        Material(name="skylight", albedo=(1.0, 1.0, 1.0),
                 emission_color=(1.0, 0.95, 0.9), emission_power=20.0))

    pl = scene.add_mesh(plane())
    sp = scene.add_mesh(sphere(32, 32))
    sphere_tris = scene.meshes[sp].num_triangles

    w, h, d = 40.0, 12.0, 20.0
    scene.add_object("Floor", pl, floor_mat, (0, 0, 0), (-90, 0, 0),
                     (w, d, 1))
    scene.add_object("Ceiling", pl, wall_mat, (0, h, 0), (90, 0, 0),
                     (w, d, 1))
    scene.add_object("Back", pl, wall_mat, (0, h / 2, d / 2), (0, 180, 0),
                     (w, h, 1))
    scene.add_object("Front", pl, wall_mat, (0, h / 2, -d / 2), (0, 0, 0),
                     (w, h, 1))
    scene.add_object("Left", pl, wall_mat, (-w / 2, h / 2, 0), (0, 90, 0),
                     (d, h, 1))
    scene.add_object("Right", pl, wall_mat, (w / 2, h / 2, 0), (0, -90, 0),
                     (d, h, 1))
    scene.add_object("Skylight", pl, light_mat, (0, h - 0.05, 0),
                     (90, 0, 0), (w * 0.4, d * 0.4, 1))

    n_spheres = max(1, (target_triangles - 14) // sphere_tris)
    per_column = 4
    n_columns = max(1, n_spheres // per_column)
    cols_x = max(1, int(math.sqrt(n_columns * w / d)))
    cols_z = max(1, (n_columns + cols_x - 1) // cols_x)
    placed = 0
    for ix in range(cols_x):
        for iz in range(cols_z):
            if placed >= n_spheres:
                break
            x = -w / 2 + (ix + 0.5) * w / cols_x
            z = -d / 2 + (iz + 0.5) * d / cols_z
            for k in range(per_column):
                if placed >= n_spheres:
                    break
                r = 1.0 - 0.12 * k
                scene.add_object(f"col_{ix}_{iz}_{k}", sp,
                                 col_mats[(ix + iz + k) % len(col_mats)],
                                 (x, 1.0 + k * 2.2, z), (0, 0, 0), (r, r, r))
                placed += 1
    return scene
