"""The port's host-side copies (scene model, loaders, procedural scenes, BVH
build + 4-wide collapse, camera) give the JAX package's arrays exactly.
Both sides use the numpy BVH builder."""

import json

import numpy as np
import pytest

import raytracer_tpu.accel.bvh as jbvh
import raytracer_tpu.ops.camera as jcam
import raytracer_tpu.scene.benchmark as jbench
import raytracer_tpu.scene.loaders as jload
import raytracer_tpu.scene.model as jmodel
import raytracer_tpu_torch.accel.bvh as tbvh
import raytracer_tpu_torch.ops.camera as tcam
import raytracer_tpu_torch.scene.benchmark as tbench
import raytracer_tpu_torch.scene.loaders as tload
import raytracer_tpu_torch.scene.model as tmodel

SCENES = {
    "cornell": (jmodel.create_cornell_box, tmodel.create_cornell_box),
    "atrium20k": (lambda: jbench.create_benchmark_atrium(20_000),
                  lambda: tbench.create_benchmark_atrium(20_000)),
    "lightgrid": (jbench.create_benchmark_lightgrid,
                  tbench.create_benchmark_lightgrid),
}

BVH_FIELDS = ("nodes_min", "nodes_max", "nodes_skip", "nodes_first",
              "nodes_count", "tri_order", "parent")


def _world_tris(scene):
    v0, e1, e2 = [], [], []
    for obj in scene.objects:
        mesh = scene.meshes[obj.mesh_index]
        m = obj.transform.model_matrix
        w = mesh.positions @ m[:3, :3].T + m[:3, 3]
        t = mesh.indices.reshape(-1, 3).astype(np.int64)
        v0.append(w[t[:, 0]])
        e1.append(w[t[:, 1]] - w[t[:, 0]])
        e2.append(w[t[:, 2]] - w[t[:, 0]])
    return [np.concatenate(x).astype(np.float32) for x in (v0, e1, e2)]


def _assert_scenes_equal(js, ts):
    assert len(js.objects) == len(ts.objects)
    assert len(js.meshes) == len(ts.meshes)
    for jm, tm in zip(js.meshes, ts.meshes):
        for k in ("positions", "normals", "indices"):
            np.testing.assert_array_equal(getattr(tm, k), getattr(jm, k))
    for jo, to in zip(js.objects, ts.objects):
        assert (jo.name, jo.mesh_index, jo.material_index) == (
            to.name, to.mesh_index, to.material_index)
        np.testing.assert_array_equal(to.transform.model_matrix,
                                      jo.transform.model_matrix)
        np.testing.assert_array_equal(to.transform.normal_matrix,
                                      jo.transform.normal_matrix)
    for jm, tm in zip(js.materials, ts.materials):
        assert jm.__dict__ == tm.__dict__


@pytest.mark.parametrize("name", sorted(SCENES))
def test_scene_and_bvh_match(name):
    jmake, tmake = SCENES[name]
    js, ts = jmake(), tmake()
    _assert_scenes_equal(js, ts)
    jt, tt = _world_tris(js), _world_tris(ts)
    jb = jbvh.build_bvh_numpy(*jt, leaf_size=16)
    tb = tbvh.build_bvh_numpy(*tt, leaf_size=16)
    for k in BVH_FIELDS:
        np.testing.assert_array_equal(getattr(tb, k), getattr(jb, k), k)
    assert tb.max_depth() == jb.max_depth()
    for jx, tx in zip(jbvh.collapse_bvh4(jb), tbvh.collapse_bvh4(tb)):
        np.testing.assert_array_equal(np.asarray(tx), np.asarray(jx))


def test_native_builder_matches_numpy_tree():
    """The port compiles native/bvh_builder.cpp itself; its tree has the
    numpy builder's nodes, and each leaf holds the same triangles."""
    from raytracer_tpu_torch.accel import native_builder

    if not native_builder.available():
        pytest.skip("no C++ compiler for the native BVH builder")
    tris = _world_tris(tbench.create_benchmark_atrium(20_000))
    nat = native_builder.build_bvh_native(*tris, leaf_size=16)
    ref = tbvh.build_bvh_numpy(*tris, leaf_size=16)
    for k in BVH_FIELDS:
        if k != "tri_order":
            np.testing.assert_array_equal(getattr(nat, k), getattr(ref, k))
    for first, count in zip(ref.nodes_first, ref.nodes_count):
        if count:
            sl = slice(first, first + count)
            assert sorted(nat.tri_order[sl]) == sorted(ref.tri_order[sl])


def test_json_loader_matches(tmp_path):
    doc = {
        "materials": {
            "white": {"albedo": [0.8, 0.8, 0.8], "roughness": 0.7},
            "glass": {"albedo": [1, 1, 1], "transmission": 1.0, "ior": 1.5},
            "lamp": {"albedo": [1, 1, 1], "emission_color": [1, 0.9, 0.8],
                     "emission_power": 5.0},
        },
        "objects": {
            "floor": {"mesh": "Plane", "material": "white",
                      "transform": {"position": [0, -1, 0],
                                    "rotation": [-90, 0, 0],
                                    "scale": [4, 4, 1]}},
            "ball": {"mesh": "Sphere", "material": "glass",
                     "transform": {"position": [0.3, -0.5, 0.2],
                                   "scale": [0.5, 0.5, 0.5]}},
            "light": {"mesh": "Plane", "material": "lamp",
                      "transform": {"position": [0, 1, 0],
                                    "rotation": [90, 0, 0]}},
        },
    }
    path = tmp_path / "scene.json"
    path.write_text(json.dumps(doc))
    _assert_scenes_equal(jload.load_scene(str(path)),
                         tload.load_scene(str(path)))


@pytest.mark.parametrize("pose", [((0, 0, -3), (0, 0, 0), 1.0),
                                  ((-16, 6.5, -7.5), (8, 3, 4), 16 / 9)])
def test_camera_matrices_match(pose):
    pos, target, aspect = pose
    jm = jcam.Camera.create(position=pos, aspect=aspect,
                            target=target).matrices()
    tm = tcam.Camera.create(position=pos, aspect=aspect,
                            target=target).matrices()
    for k in ("proj", "view", "inverse_view", "inverse_proj"):
        np.testing.assert_array_equal(tm[k], jm[k])
