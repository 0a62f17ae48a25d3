"""CPU scene model: meshes, objects, materials, and the change journal.

Mirrors the data model and mutation API of `src/raytracer/scene.odin`:
  - Mesh {name, vertices[pos,normal], indices}          (scene.odin:10-13,56-60)
  - Object {name, Transform, mesh_index, material_index} (scene.odin:41-54)
  - Material {albedo, emission_color, emission_power, roughness, metallic,
    transmission, ior}                                   (scene.odin:66-70)
  - change journal with 8 change types                   (scene.odin:15-29)
  - model matrix = T * Rx * Ry * Rz * S, normal matrix = inverse-transpose
                                                         (scene.odin:213-224)
  - procedural UV-sphere 32x32 / unit plane / Cornell box
                                                         (scene.odin:242-478)

Every mutation appends to `changes`; the progressive renderer replays the
journal before each frame and decides between cheap updates (material array
write, BVH refit) and a full re-bake, exactly like the reference's
begin_frame replay (raytracing_renderer.odin:141-187 ->
gpu_scene_update_* at gpu_scene.odin:430-601).
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import List, Optional, Tuple

import numpy as np


class SceneChangeType(enum.Enum):
    """scene.odin:15-24."""

    MATERIAL_CHANGED = "material_changed"
    MATERIAL_ADDED = "material_added"
    MATERIAL_REMOVED = "material_removed"
    OBJECT_MATERIAL_CHANGED = "object_material_changed"
    OBJECT_ADDED = "object_added"
    OBJECT_REMOVED = "object_removed"
    OBJECT_TRANSFORM_CHANGED = "object_transform_changed"
    OBJECT_MESH_CHANGED = "object_mesh_changed"


@dataclasses.dataclass
class SceneChange:
    """scene.odin:26-29."""

    type: SceneChangeType
    index: int = -1


@dataclasses.dataclass
class Material:
    """scene.odin:66-70. transmission/ior are honored by the integrator here
    (the reference declares them but its shaders never read them).
    `dispersion` (KHR_materials_dispersion: 20/Abbe-number) extends the data
    model for BASELINE config 3's chromatic refraction."""

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
    """scene.odin:56-60: positions f32[V,3], normals f32[V,3], indices u32[3T]."""

    name: str
    positions: np.ndarray
    normals: np.ndarray
    indices: np.ndarray

    def __post_init__(self):
        self.positions = np.ascontiguousarray(self.positions, np.float32)
        self.normals = np.ascontiguousarray(self.normals, np.float32)
        self.indices = np.ascontiguousarray(self.indices, np.uint32)
        assert self.positions.shape == self.normals.shape
        assert self.indices.ndim == 1 and len(self.indices) % 3 == 0

    @property
    def num_triangles(self) -> int:
        return len(self.indices) // 3


def _rotation_matrix(rotation_degrees) -> np.ndarray:
    """Rx * Ry * Rz from Euler degrees (scene.odin:215-218)."""
    rx, ry, rz = (math.radians(float(a)) for a in rotation_degrees)

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
class Transform:
    """scene.odin:48-54."""

    position: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    rotation: Tuple[float, float, float] = (0.0, 0.0, 0.0)  # Euler degrees
    scale: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    model_matrix: Optional[np.ndarray] = None
    normal_matrix: Optional[np.ndarray] = None

    def update_matrices(self):
        """object_update_model_matrix (scene.odin:213-224):
        M = T * Rx * Ry * Rz * S; N = inverse_transpose(M)."""
        t = np.eye(4, dtype=np.float32)
        t[:3, 3] = np.asarray(self.position, np.float32)
        s = np.diag(
            np.asarray(list(self.scale) + [1.0], np.float32)
        )
        self.model_matrix = (t @ _rotation_matrix(self.rotation) @ s).astype(
            np.float32
        )
        self.normal_matrix = np.linalg.inv(self.model_matrix).T.astype(
            np.float32
        )
        return self


@dataclasses.dataclass
class Object:
    """scene.odin:41-46."""

    name: str
    transform: Transform
    mesh_index: int
    material_index: int


class Scene:
    """CPU scene + mutation API + change journal (scene.odin:31-39,95-196)."""

    def __init__(self):
        self.meshes: List[Mesh] = []
        self.objects: List[Object] = []
        self.materials: List[Material] = []
        self.changes: List[SceneChange] = []

    # -- materials -----------------------------------------------------
    def add_material(self, material: Material) -> int:
        """scene_add_material (scene.odin:95-98)."""
        self.materials.append(material)
        idx = len(self.materials) - 1
        self.changes.append(SceneChange(SceneChangeType.MATERIAL_ADDED, idx))
        return idx

    def update_material(self, material_idx: int, material: Material):
        """scene_update_material (scene.odin:118-121)."""
        self.materials[material_idx] = material
        self.changes.append(
            SceneChange(SceneChangeType.MATERIAL_CHANGED, material_idx)
        )

    def delete_material(self, material_idx: int):
        """scene_delete_material (scene.odin:104-116): swap-remove + objects
        referencing it fall back to material 0."""
        last = len(self.materials) - 1
        self.materials[material_idx] = self.materials[last]
        self.materials.pop()
        for i, obj in enumerate(self.objects):
            if obj.material_index == material_idx:
                self.update_object_material(i, 0)
            elif obj.material_index == last:
                obj.material_index = material_idx
        self.changes.append(
            SceneChange(SceneChangeType.MATERIAL_REMOVED, material_idx)
        )

    # -- meshes ----------------------------------------------------------
    def add_mesh(self, mesh: Mesh) -> int:
        """scene_add_mesh (scene.odin:128-131). No journal entry, as in the
        reference — meshes only matter once referenced by an object."""
        self.meshes.append(mesh)
        return len(self.meshes) - 1

    # -- objects ---------------------------------------------------------
    def add_object(
        self,
        name: str,
        mesh_index: int,
        material_index: int,
        position=(0.0, 0.0, 0.0),
        rotation=(0.0, 0.0, 0.0),
        scale=(1.0, 1.0, 1.0),
        transform: Optional[Transform] = None,
    ) -> int:
        """scene_add_object (scene.odin:165-196)."""
        assert 0 <= mesh_index < len(self.meshes), "Invalid mesh index"
        assert 0 <= material_index < len(self.materials), "Invalid material index"
        if transform is None:
            transform = Transform(
                position=tuple(position),
                rotation=tuple(rotation),
                scale=tuple(scale),
            ).update_matrices()
        elif transform.model_matrix is None:
            transform.update_matrices()
        self.objects.append(
            Object(
                name=name,
                transform=transform,
                mesh_index=mesh_index,
                material_index=material_index,
            )
        )
        self.changes.append(SceneChange(SceneChangeType.OBJECT_ADDED))
        return len(self.objects) - 1

    def delete_object(self, object_idx: int):
        """Swap-remove an object (BEYOND-REFERENCE: the journal reserves
        Object_Removed — scene.odin:21 — but the reference ships no object
        deleter; materials get the same swap-remove treatment at
        scene.odin:104-116, so this mirrors that convention). Meshes and
        materials are untouched: they only matter once referenced."""
        last = len(self.objects) - 1
        if not 0 <= object_idx <= last:
            raise IndexError(f"invalid object index {object_idx}")
        if last == 0:
            # An empty scene cannot be baked (bake_scene raises); refuse
            # here so an editor delete can't strand the renderer.
            raise ValueError("cannot delete the last object in a scene")
        self.objects[object_idx] = self.objects[last]
        self.objects.pop()
        self.changes.append(
            SceneChange(SceneChangeType.OBJECT_REMOVED, object_idx)
        )

    def update_object_position(self, object_idx: int, position):
        """scene_update_object_position (scene.odin:137-142)."""
        tr = self.objects[object_idx].transform
        tr.position = tuple(float(x) for x in position)
        tr.update_matrices()
        self.changes.append(
            SceneChange(SceneChangeType.OBJECT_TRANSFORM_CHANGED, object_idx)
        )

    def update_object_rotation(self, object_idx: int, rotation):
        """scene.odin:144-149."""
        tr = self.objects[object_idx].transform
        tr.rotation = tuple(float(x) for x in rotation)
        tr.update_matrices()
        self.changes.append(
            SceneChange(SceneChangeType.OBJECT_TRANSFORM_CHANGED, object_idx)
        )

    def update_object_scale(self, object_idx: int, scale):
        """scene.odin:151-156."""
        tr = self.objects[object_idx].transform
        tr.scale = tuple(float(x) for x in scale)
        tr.update_matrices()
        self.changes.append(
            SceneChange(SceneChangeType.OBJECT_TRANSFORM_CHANGED, object_idx)
        )

    def update_object_material(self, object_idx: int, material_idx: int):
        """scene_update_object_material (scene.odin:123-126)."""
        self.objects[object_idx].material_index = material_idx
        self.changes.append(
            SceneChange(SceneChangeType.OBJECT_MATERIAL_CHANGED, object_idx)
        )

    def update_object_mesh(self, object_idx: int, mesh_idx: int):
        """scene_update_object_mesh (scene.odin:158-163)."""
        self.objects[object_idx].mesh_index = mesh_idx
        self.changes.append(
            SceneChange(SceneChangeType.OBJECT_MESH_CHANGED, object_idx)
        )

    def drain_changes(self) -> List[SceneChange]:
        changes, self.changes = self.changes, []
        return changes

    # -- stats -------------------------------------------------------
    @property
    def num_triangles(self) -> int:
        return sum(
            self.meshes[o.mesh_index].num_triangles for o in self.objects
        )


# ---------------------------------------------------------------------------
# Procedural meshes (scene.odin:242-320)
# ---------------------------------------------------------------------------

def create_sphere(stacks: int = 32, slices: int = 32) -> Mesh:
    """UV sphere with poles, identical vertex/index order to
    create_sphere (scene.odin:242-297)."""
    verts = [(0.0, 1.0, 0.0)]
    for i in range(stacks - 1):
        phi = math.pi * (i + 1) / stacks
        for j in range(slices):
            theta = 2.0 * math.pi * j / slices
            x = math.sin(phi) * math.cos(theta)
            y = math.cos(phi)
            z = math.sin(phi) * math.sin(theta)
            verts.append((x, y, z))
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
    return Mesh(name="Sphere", positions=pos, normals=pos.copy(),
                indices=np.asarray(idx, np.uint32))


def create_plane(width: float = 1.0, height: float = 1.0) -> Mesh:
    """Unit XY plane facing +z (scene.odin:299-320). width/height are
    accepted-but-unused exactly like the reference's defaults."""
    del width, height
    pos = np.asarray(
        [[-0.5, -0.5, 0.0], [0.5, -0.5, 0.0], [0.5, 0.5, 0.0], [-0.5, 0.5, 0.0]],
        np.float32,
    )
    nrm = np.tile(np.asarray([[0.0, 0.0, 1.0]], np.float32), (4, 1))
    idx = np.asarray([0, 1, 2, 0, 2, 3], np.uint32)
    return Mesh(name="Plane", positions=pos, normals=nrm, indices=idx)


def create_cornell_box() -> Scene:
    """Built-in Cornell box (scene.odin:328-478): five planes, a near-floor
    area light, a metal sphere and a glossy sphere."""
    scene = Scene()
    white = scene.add_material(
        Material(name="white", albedo=(0.73, 0.73, 0.73), roughness=1.0)
    )
    red = scene.add_material(
        Material(name="red", albedo=(0.65, 0.05, 0.05), roughness=1.0)
    )
    green = scene.add_material(
        Material(name="green", albedo=(0.12, 0.45, 0.15), roughness=1.0)
    )
    light = scene.add_material(
        Material(
            name="light",
            albedo=(0.8, 0.8, 0.8),
            emission_color=(1.0, 1.0, 1.0),
            emission_power=10.0,
        )
    )
    plane = scene.add_mesh(create_plane())
    rs = 5.0
    scene.add_object("Floor", plane, white, position=(0, -rs / 2, 0),
                     scale=(rs, rs, rs), rotation=(-90, 0, 0))
    scene.add_object("Ceiling", plane, white, position=(0, rs / 2, 0),
                     scale=(rs, rs, rs), rotation=(90, 0, 0))
    scene.add_object("Back Wall", plane, green, position=(0, 0, rs / 2),
                     scale=(rs, rs, rs), rotation=(0, 180, 0))
    scene.add_object("Left Wall", plane, green, position=(-rs / 2, 0, 0),
                     scale=(rs, rs, rs), rotation=(0, -90, 0))
    scene.add_object("Right Wall", plane, red, position=(rs / 2, 0, 0),
                     scale=(rs, rs, rs), rotation=(0, 90, 0))
    sphere = scene.add_mesh(create_sphere())
    scene.add_object("Light Center", plane, light,
                     position=(0, -(rs / 2 - 0.1), 0),
                     scale=(1.0, 1.0, 1.0), rotation=(-90, 0, 0))
    metallic = scene.add_material(
        Material(name="metallic", albedo=(0.8, 0.8, 0.8), metallic=1.0,
                 roughness=0.1)
    )
    glossy = scene.add_material(
        Material(name="glossy", albedo=(0.3, 0.8, 0.3), metallic=0.0,
                 roughness=1.0)
    )
    scene.add_object("Metal Sphere", sphere, metallic,
                     position=(-1.0, rs / 2 - 1.0, -1.0))
    scene.add_object("Glossy Sphere", sphere, glossy,
                     position=(1.5, rs / 2 - 1.0, 0.5),
                     scale=(0.5, 0.5, 0.5))
    return scene
