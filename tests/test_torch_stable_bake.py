"""Stable-shape (capacity-padded) bakes (scene/device_scene.py
`bake_scene(stable_shapes=True)`, `_bucket`) against the JAX package's.

Tolerances: the stable bake equals JAX `bake_scene(stable_shapes=True)`
field for field; renders on the stable bake equal the exact bake's bit for
bit (plain NEE on accel "cuda" and "bvh", and ReSTIR); a topology edit
inside the capacity buckets keeps every DeviceScene tensor's shape and
every int (the JAX `_sig`, its jit signature); update_materials keeps the
padded shapes and equals a fresh stable bake of the edited scene. Both
packages use the numpy BVH builder.
"""

import dataclasses

import numpy as np
import pytest
import torch

import raytracer_tpu.accel.native_builder as jnative
import raytracer_tpu.scene.benchmark as jbench
import raytracer_tpu.scene.model as jmodel
import raytracer_tpu_torch.accel.native_builder as tnative
import raytracer_tpu_torch.scene.benchmark as tbench
import raytracer_tpu_torch.scene.model as tmodel
from raytracer_tpu.scene.device_scene import bake_scene as jbake
from raytracer_tpu_torch.api import ProgressiveRenderer
from raytracer_tpu_torch.scene.device_scene import (
    ARRAY_FIELDS,
    OPTIONAL_FIELDS,
    _bucket,
    bake_scene as tbake,
    update_materials,
)
from raytracer_tpu_torch.utils.config import RenderConfig

torch.set_num_threads(1)  # see test_torch_ops.py

SCENES = {
    "cornell": (jmodel.create_cornell_box, tmodel.create_cornell_box),
    "atrium20k": (lambda: jbench.create_benchmark_atrium(20_000),
                  lambda: tbench.create_benchmark_atrium(20_000)),
    "lightgrid": (jbench.create_benchmark_lightgrid,
                  tbench.create_benchmark_lightgrid),
}


@pytest.fixture(autouse=True)
def numpy_builders(monkeypatch):
    monkeypatch.setattr(jnative, "available", lambda: False)
    monkeypatch.setattr(tnative, "available", lambda: False)


def _sig(ds):
    """The JAX `_sig` of a DeviceScene: every field's shape and dtype, and
    every int field."""
    out = []
    for f in dataclasses.fields(ds):
        v = getattr(ds, f.name)
        out.append((f.name, (tuple(v.shape), v.dtype)
                    if isinstance(v, torch.Tensor) else v))
    return out


@pytest.mark.parametrize("leaf_size", [8, 16])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_stable_bake_matches_jax(name, leaf_size):
    jmake, tmake = SCENES[name]
    jds, _ = jbake(jmake(), leaf_size=leaf_size, stable_shapes=True)
    tds, _ = tbake(tmake(), leaf_size=leaf_size, device="cpu",
                   stable_shapes=True)
    for k in ARRAY_FIELDS + OPTIONAL_FIELDS:
        if k in ("nodes_packed", "tris_packed"):
            continue  # test_torch_traverse_skiplink.py
        if getattr(jds, k) is None:
            assert getattr(tds, k) is None, k
            continue
        want = np.asarray(getattr(jds, k))
        got = getattr(tds, k).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, k
        np.testing.assert_array_equal(got, want, err_msg=k)
    for k in ("num_triangles", "num_lights", "q_stack_need",
              "bvh_max_depth"):
        assert getattr(tds, k) == getattr(jds, k), k
    exact, _ = tbake(tmake(), leaf_size=leaf_size, device="cpu")
    assert tds.qnodes.shape[0] >= exact.qnodes.shape[0]
    assert tds.bvh_max_depth % 8 == 0 and tds.q_stack_need % 8 == 0


def _render(scene, stable, frames=2, **cfg):
    return ProgressiveRenderer(scene, None, RenderConfig(
        stable_bake=stable, **cfg), device="cpu").render(frames)


@pytest.mark.parametrize("case", [
    ("cornell", dict(accel="cuda")),
    ("cornell", dict(accel="bvh")),
    ("cornell", dict(accel="cuda", use_restir=True,
                     restir_initial_candidates=2,
                     restir_spatial_neighbors=1)),
    ("atrium20k", dict(accel="cuda")),
    ("lightgrid", dict(accel="bvh")),
])
def test_stable_bake_renders_bit_identical(case):
    """Padded lights are never selected, padded triangles and node rows
    never reached, padded materials never fetched: the image is the exact
    bake's."""
    name, cfg = case
    make = SCENES[name][1]
    size = dict(width=16, height=16)
    exact = _render(make(), False, **size, **cfg)
    stable = _render(make(), True, **size, **cfg)
    np.testing.assert_array_equal(stable, exact)


def test_padding_really_happens():
    """The Cornell box's stable bake is padded (otherwise the image test is
    vacuous): more node rows, 4 light rows for 1 light, true_counts."""
    scene = tmodel.create_cornell_box()
    exact, _ = tbake(scene, device="cpu")
    pad, _ = tbake(scene, device="cpu", stable_shapes=True)
    assert pad.qnodes.shape[0] > exact.qnodes.shape[0]
    assert pad.pnodes.shape[0] > exact.pnodes.shape[0]
    assert pad.num_lights == 4 > exact.num_lights == 1
    assert pad.light_object.tolist()[1:] == [-1, -1, -1]
    assert (pad.light_power[1:] == 0).all()
    assert (pad.mat_packed[len(scene.materials):, 10] == 1.0).all()
    tc = pad.true_counts.tolist()
    assert tc[:2] == [exact.light_tri_object.shape[0], 1]
    assert torch.isnan(pad.qnodes[exact.qnodes.shape[0]:, :24]).all()
    assert torch.isnan(pad.pnodes[exact.pnodes.shape[0]:, :12]).all()


@pytest.mark.parametrize("edit", ["add", "delete"])
def test_topology_edit_keeps_every_shape(edit):
    """An object added or deleted inside the buckets re-bakes into the
    same tensor shapes and ints (the renderer bakes anew), and the
    geometry really changed."""
    scene = tmodel.create_cornell_box()
    mesh = scene.add_mesh(tmodel.create_sphere(stacks=4, slices=4))
    extra = None
    if edit == "delete":
        extra = scene.add_object("doomed", mesh, 0, position=(0.2, 0, 0),
                                 scale=(0.1, 0.1, 0.1))
    r = ProgressiveRenderer(scene, None, RenderConfig(width=16, height=16),
                            device="cpu")
    assert r.step()
    sig0, tris0 = _sig(r.device_scene), r.device_scene.true_counts[0]
    if edit == "add":
        scene.add_object("extra", mesh, material_index=0,
                         position=(0.2, 0.1, 0.0), scale=(0.1, 0.1, 0.1))
    else:
        scene.delete_object(extra)
    assert r.step()
    assert r.last_replay == "bake"
    assert _sig(r.device_scene) == sig0
    tris1 = r.device_scene.true_counts[0]
    assert (tris1 > tris0) if edit == "add" else (tris1 < tris0)


def test_update_materials_keeps_padded_shapes():
    """A material edit on a stable bake rewrites the padded tables in
    their shapes, padded rows staying padding, and equals a fresh stable
    bake of the edited scene."""
    scene = tmodel.create_cornell_box()
    ds, _ = tbake(scene, device="cpu", stable_shapes=True)
    light_mat = scene.objects[int(ds.light_object[0])].material_index
    for i, change in ((0, dict(albedo=(0.9, 0.1, 0.1), roughness=0.3)),
                      (light_mat, dict(emission_power=7.5))):
        scene.update_material(i, dataclasses.replace(scene.materials[i],
                                                     **change))
    new = update_materials(ds, scene, device="cpu", stable_shapes=True)
    assert new.ptris is ds.ptris
    assert _sig(new) == _sig(ds)
    fresh, _ = tbake(scene, device="cpu", stable_shapes=True)
    for k in ("mat_packed", "light_power", "light_meta_packed",
              "light_tri_packed"):
        assert torch.equal(getattr(new, k), getattr(fresh, k)), k
    assert new.mat_packed[-1, 10] == 1.0


def test_bucket_slack_bound():
    """The JAX guarantee: at most +12.5% slack (plus the align floor), and
    a bucket is its own bucket (JAX test_bucket_slack_bound)."""
    ns = list(range(1, 3000, 7)) + [
        (1 << k) + d for k in range(8, 22) for d in (-1, 0, 1, 5)]
    for align in (4, 8, 16, 64, 128):
        for n in ns:
            b = _bucket(n, align)
            assert b >= max(n, align) and b % align == 0
            assert b <= max(n * 9 // 8 + 1, n + align), (n, align, b)
            assert _bucket(b, align) == b
