"""A scene as plain data, independent of the program: meshes, materials and
objects with their transforms. The scene generators under `scenes/` build
it; `program.py` hands it to the port as the port's own Scene, and the
reference (`reference.py`) flattens it itself.

The mesh primitives and the transform (M = T * Rx * Ry * Rz * S in float32,
N = inverse-transpose of M) are frozen copies of the renderer's scene
model, so both sides see the same float32 vertices.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

import numpy as np


@dataclasses.dataclass
class Material:
    name: str = ""
    albedo: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    emission_color: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    emission_power: float = 0.0
    roughness: float = 0.0
    metallic: float = 0.0
    transmission: float = 0.0
    ior: float = 1.0
    dispersion: float = 0.0


@dataclasses.dataclass
class Mesh:
    name: str
    positions: np.ndarray  # f32[V,3]
    normals: np.ndarray  # f32[V,3]
    indices: np.ndarray  # u32[3T]

    @property
    def num_triangles(self) -> int:
        return len(self.indices) // 3


@dataclasses.dataclass
class Object:
    name: str
    mesh: int
    material: int
    position: Tuple[float, float, float]
    rotation: Tuple[float, float, float]
    scale: Tuple[float, float, float]

    def model_matrix(self) -> np.ndarray:
        t = np.eye(4, dtype=np.float32)
        t[:3, 3] = np.asarray(self.position, np.float32)
        s = np.diag(np.asarray(list(self.scale) + [1.0], np.float32))
        return (t @ _rotation(self.rotation) @ s).astype(np.float32)

    def normal_matrix(self) -> np.ndarray:
        return np.linalg.inv(self.model_matrix()).T.astype(np.float32)


def _rotation(degrees) -> np.ndarray:
    """Rx * Ry * Rz from Euler degrees."""
    rx, ry, rz = (math.radians(float(a)) for a in degrees)

    def rot(axis, angle):
        c, s = math.cos(angle), math.sin(angle)
        m = np.eye(4, dtype=np.float32)
        if axis == 0:
            m[1, 1], m[1, 2], m[2, 1], m[2, 2] = c, -s, s, c
        elif axis == 1:
            m[0, 0], m[0, 2], m[2, 0], m[2, 2] = c, s, -s, c
        else:
            m[0, 0], m[0, 1], m[1, 0], m[1, 1] = c, -s, s, c
        return m

    return rot(0, rx) @ rot(1, ry) @ rot(2, rz)


@dataclasses.dataclass
class SceneDesc:
    meshes: List[Mesh] = dataclasses.field(default_factory=list)
    materials: List[Material] = dataclasses.field(default_factory=list)
    objects: List[Object] = dataclasses.field(default_factory=list)

    def add_mesh(self, mesh: Mesh) -> int:
        self.meshes.append(mesh)
        return len(self.meshes) - 1

    def add_material(self, material: Material) -> int:
        self.materials.append(material)
        return len(self.materials) - 1

    def add_object(self, name, mesh, material, position=(0.0, 0.0, 0.0),
                   rotation=(0.0, 0.0, 0.0), scale=(1.0, 1.0, 1.0)) -> int:
        self.objects.append(Object(name, mesh, material,
                                   tuple(float(x) for x in position),
                                   tuple(float(x) for x in rotation),
                                   tuple(float(x) for x in scale)))
        return len(self.objects) - 1

    @property
    def num_triangles(self) -> int:
        return sum(self.meshes[o.mesh].num_triangles for o in self.objects)


def perturb_materials(desc: SceneDesc, seed: int, spec: dict) -> None:
    """Draw every material's values around the scene's own from `seed`
    (the run's data; geometry, camera and settings stay fixed). `spec`
    gives the ranges: albedo_scale [lo, hi] (each channel, clipped to 1),
    roughness_shift [lo, hi] (clipped to [0, 1]) and emission_scale [lo,
    hi]."""
    rng = np.random.default_rng(seed)
    a_lo, a_hi = spec["albedo_scale"]
    r_lo, r_hi = spec["roughness_shift"]
    e_lo, e_hi = spec["emission_scale"]
    for i, m in enumerate(desc.materials):
        albedo = np.clip(np.asarray(m.albedo, np.float64)
                         * rng.uniform(a_lo, a_hi, 3), 0.0, 1.0)
        desc.materials[i] = dataclasses.replace(
            m,
            albedo=tuple(float(x) for x in albedo),
            roughness=float(np.clip(m.roughness + rng.uniform(r_lo, r_hi),
                                    0.0, 1.0)),
            emission_power=float(m.emission_power * rng.uniform(e_lo, e_hi)),
        )


# ---------------------------------------------------------------------------
# Mesh primitives
# ---------------------------------------------------------------------------

def sphere(stacks: int = 32, slices: int = 32) -> Mesh:
    """UV sphere with poles, unit radius."""
    verts = [(0.0, 1.0, 0.0)]
    for i in range(stacks - 1):
        phi = math.pi * (i + 1) / stacks
        for j in range(slices):
            theta = 2.0 * math.pi * j / slices
            verts.append((math.sin(phi) * math.cos(theta), math.cos(phi),
                          math.sin(phi) * math.sin(theta)))
    verts.append((0.0, -1.0, 0.0))
    idx: List[int] = []
    n_verts = len(verts)
    for i in range(slices):
        i0 = i + 1
        i1 = (i + 1) % slices + 1
        idx += [0, i1, i0]
        i0 = i + slices * (stacks - 2) + 1
        i1 = (i + 1) % slices + slices * (stacks - 2) + 1
        idx += [n_verts - 1, i0, i1]
    for j in range(stacks - 2):
        j0 = j * slices + 1
        j1 = (j + 1) * slices + 1
        for i in range(slices):
            i0 = j0 + i
            i1 = j0 + (i + 1) % slices
            i2 = j1 + (i + 1) % slices
            i3 = j1 + i
            idx += [i0, i1, i2, i0, i2, i3]
    pos = np.asarray(verts, np.float32)
    return Mesh("Sphere", pos, pos.copy(), np.asarray(idx, np.uint32))


def plane() -> Mesh:
    """Unit XY plane facing +z."""
    pos = np.asarray([[-0.5, -0.5, 0.0], [0.5, -0.5, 0.0], [0.5, 0.5, 0.0],
                      [-0.5, 0.5, 0.0]], np.float32)
    nrm = np.tile(np.asarray([[0.0, 0.0, 1.0]], np.float32), (4, 1))
    return Mesh("Plane", pos, nrm, np.asarray([0, 1, 2, 0, 2, 3], np.uint32))


def box() -> Mesh:
    """Unit cube centred at the origin with per-face normals."""
    pos, nrm, idx = [], [], []
    for axis in range(3):
        for sign in (1.0, -1.0):
            u, v = (axis + 1) % 3, (axis + 2) % 3
            base = len(pos)
            for du, dv in ((-0.5, -0.5), (0.5, -0.5), (0.5, 0.5),
                           (-0.5, 0.5)):
                p = [0.0, 0.0, 0.0]
                p[axis] = 0.5 * sign
                p[u] = du
                p[v] = dv
                pos.append(p)
                n = [0.0, 0.0, 0.0]
                n[axis] = sign
                nrm.append(n)
            if sign > 0:
                idx += [base, base + 1, base + 2, base, base + 2, base + 3]
            else:
                idx += [base, base + 2, base + 1, base, base + 3, base + 2]
    return Mesh("Box", np.asarray(pos, np.float32),
                np.asarray(nrm, np.float32), np.asarray(idx, np.uint32))
