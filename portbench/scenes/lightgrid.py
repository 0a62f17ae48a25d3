"""The many-light room: an 8 x 8 grid of coloured emissive ceiling panels
(powers spanning 16:1) over a 6 x 6 field of occluder boxes and four
high-resolution spheres in a 24 x 6 x 24 room (a frozen copy of the
renderer's `create_benchmark_lightgrid`): dozens of lights competing at
every surface point. A procedural stand-in, no published scene: published
many-light scenes carry far more emissive triangles."""

from __future__ import annotations

import math

from harness.scenedesc import Material, SceneDesc, box, plane, sphere


def build(n_lights: int = 64, target_triangles: int = 20_000) -> SceneDesc:
    n_lights = min(n_lights, 256)
    scene = SceneDesc()
    wall = scene.add_material(
        Material(name="wall", albedo=(0.62, 0.60, 0.58), roughness=0.9))
    floor_mat = scene.add_material(
        Material(name="floor", albedo=(0.45, 0.45, 0.48), roughness=0.6))
    box_mats = [
        scene.add_material(Material(name="crate_warm",
                                    albedo=(0.55, 0.35, 0.18),
                                    roughness=0.8)),
        scene.add_material(Material(name="crate_cool",
                                    albedo=(0.20, 0.30, 0.45),
                                    roughness=0.7)),
        scene.add_material(Material(name="crate_metal",
                                    albedo=(0.85, 0.85, 0.88), metallic=1.0,
                                    roughness=0.25)),
    ]
    pl = scene.add_mesh(plane())
    bx = scene.add_mesh(box())

    W, H, D = 24.0, 6.0, 24.0
    scene.add_object("Floor", pl, floor_mat, (0, 0, 0), (-90, 0, 0),
                     (W, D, 1))
    scene.add_object("Ceiling", pl, wall, (0, H, 0), (90, 0, 0), (W, D, 1))
    scene.add_object("WallBack", pl, wall, (0, H / 2, D / 2), (0, 180, 0),
                     (W, H, 1))
    scene.add_object("WallFront", pl, wall, (0, H / 2, -D / 2), (0, 0, 0),
                     (W, H, 1))
    scene.add_object("WallLeft", pl, wall, (-W / 2, H / 2, 0), (0, 90, 0),
                     (D, H, 1))
    scene.add_object("WallRight", pl, wall, (W / 2, H / 2, 0), (0, -90, 0),
                     (D, H, 1))

    ng = max(int(math.sqrt(n_lights)), 1)
    palette = [(1.0, 0.85, 0.6), (0.6, 0.8, 1.0), (1.0, 0.5, 0.5),
               (0.6, 1.0, 0.6), (1.0, 1.0, 0.9), (0.9, 0.6, 1.0)]
    placed = 0
    for i in range(ng):
        for j in range(ng):
            if placed >= n_lights:
                break
            color = palette[(i * 7 + j * 3) % len(palette)]
            power = 2.0 * (1 + ((i * 5 + j) % 4)) * (
                8.0 if (i * ng + j) % 9 == 0 else 1.0)
            m = scene.add_material(Material(
                name=f"panel_{i}_{j}", albedo=(1, 1, 1),
                emission_color=color, emission_power=power))
            x = -W / 2 + (i + 0.5) * W / ng
            z = -D / 2 + (j + 0.5) * D / ng
            scene.add_object(f"Panel_{i}_{j}", pl, m, (x, H - 0.02, z),
                             (90, 0, 0), (0.45 * W / ng, 0.45 * D / ng, 1))
            placed += 1

    nb = 6
    for i in range(nb):
        for j in range(nb):
            h = 0.6 + 2.2 * (((i * 13 + j * 7) % 8) / 7.0)
            s = 0.8 + 0.9 * (((i * 3 + j * 11) % 5) / 4.0)
            x = -W / 2 + (i + 0.75) * W / (nb + 0.5)
            z = -D / 2 + (j + 0.75) * D / (nb + 0.5)
            scene.add_object(f"crate_{i}_{j}", bx,
                             box_mats[(i + 2 * j) % len(box_mats)],
                             (x, h / 2, z), (0, 0, 0), (s, h, s))
    fixed = scene.num_triangles
    n_spheres = 4
    per = max((target_triangles - fixed) // n_spheres, 8)
    stacks = max(int(math.sqrt(per / 2.0)), 4)
    sp = scene.add_mesh(sphere(stacks, stacks))
    for k in range(n_spheres):
        scene.add_object(f"orb_{k}", sp, box_mats[2 - (k % 3) % 3],
                         (-6.0 + 4.0 * k, 1.4, -8.5 + 1.5 * (k % 2)),
                         (0, 0, 0), (1.4, 1.4, 1.4))
    return scene
