"""The port's bake against the JAX package's `bake_scene(stable_shapes=
False)`, field for field on the fields the render path reads (both trees'
arrays: qnodes/qmeta/qroot, pnodes/root_meta/bvh_max_depth and the shared
leaf blocks ptris), and the conversion of a JAX bake into the port's
DeviceScene. Both sides use the numpy BVH builder."""

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
from raytracer_tpu_torch.scene.device_scene import (
    ARRAY_FIELDS,
    bake_scene as tbake,
    from_jax_arrays,
)

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


def _jax_fields(ds):
    return {f.name: np.asarray(getattr(ds, f.name))
            for f in dataclasses.fields(ds)
            if getattr(ds, f.name) is not None}


def _assert_same(port, want):
    for k in ARRAY_FIELDS:
        got = getattr(port, k).cpu().numpy()
        assert got.dtype == want[k].dtype, k
        np.testing.assert_array_equal(got, want[k], err_msg=k)
    for k in ("num_triangles", "num_lights", "q_stack_need",
              "bvh_max_depth"):
        assert getattr(port, k) == int(want[k]), k
    assert port.root == int(want["qroot"][0])
    assert port.binary_root == int(want["root_meta"][0])


@pytest.mark.parametrize("name", sorted(SCENES))
@pytest.mark.parametrize("leaf_size", [8, 16])
def test_bake_matches_jax(name, leaf_size):
    jmake, tmake = SCENES[name]
    jds, _ = jbake(jmake(), leaf_size=leaf_size, stable_shapes=False)
    tds, _ = tbake(tmake(), leaf_size=leaf_size, device="cpu")
    _assert_same(tds, _jax_fields(jds))


def test_from_jax_arrays_round_trip():
    jds, _ = jbake(jmodel.create_cornell_box(), stable_shapes=False)
    fields = _jax_fields(jds)
    conv = from_jax_arrays(fields, torch.device("cpu"))
    _assert_same(conv, fields)
    tds, _ = tbake(tmodel.create_cornell_box(), device="cpu")
    for k in ARRAY_FIELDS:  # qnodes holds NaN boxes: NaN == NaN here
        np.testing.assert_array_equal(getattr(conv, k).numpy(),
                                      getattr(tds, k).numpy(), err_msg=k)


def test_from_jax_arrays_loads_multi_part():
    """A multi-part JAX bake loads with every part table, its part boxes
    and its part count and depth (it was refused before multi-part bakes
    were ported)."""
    jds, _ = jbake(jmodel.create_cornell_box(), stable_shapes=False,
                   pallas_budget_bytes=96 * 1024)
    assert jds.num_parts > 1
    fields = _jax_fields(jds)
    conv = from_jax_arrays(fields, "cpu")
    _assert_same(conv, fields)
    assert conv.num_parts == jds.num_parts
    assert conv.part_max_depth == jds.part_max_depth
    np.testing.assert_array_equal(conv.part_aabb.numpy(), fields["part_aabb"])
    assert len(conv.parts) == jds.num_parts
    assert [p.root for p in conv.parts] == fields["qroot"][:, 0].tolist()


@pytest.mark.parametrize("name", sorted(SCENES))
def test_both_trees_name_the_same_leaf_blocks(name):
    """The binary tree's metas (pnodes) and the 4-wide tree's (qmeta) refer
    to the one ptris baked: each names every leaf block once, and a leaf
    block's box is the same in both trees."""
    tds, _ = tbake(SCENES[name][1](), leaf_size=16, device="cpu")
    nb = tds.ptris.shape[0]
    pn = tds.pnodes.numpy()
    pmeta = pn[:, 12:14].astype(np.int64).ravel()
    pbox = pn[:, :12].reshape(-1, 6)
    qm = tds.qmeta.numpy().astype(np.int64)
    qbox = tds.qnodes.numpy()[:, :24].reshape(-1, 6)

    def leaf_boxes(metas, box):
        leaves = metas < 0
        ids = ~metas[leaves]
        np.testing.assert_array_equal(np.sort(ids), np.arange(nb))
        return box[leaves][np.argsort(ids)]

    np.testing.assert_array_equal(leaf_boxes(pmeta, pbox),
                                  leaf_boxes(qm, qbox))
