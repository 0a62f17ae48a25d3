"""Multi-part bakes (scene/device_scene.py `_cut_parts`, `_slice_bvh`,
`_pack_parts`) and the traversal wrappers' per-part passes
(ops/quad_traverse.py `scene_parts`, `closest_passes`, `any_passes`)
against the JAX package's multi-part bakes.

Tolerances: the bake equals JAX `bake_scene(pallas_budget_bytes=...)`
field for field; per-part K1-K4 plain walks give hit records and masks
equal to the one-part bake's on every ray; a multi-part render equals the
one-part render bit for bit under accel "cuda" and "bvh". (The sharded
multi-part render is in test_torch_sharding.py, whose world of 2 is
spawned once.) Both packages use the numpy BVH builder.
"""

import dataclasses

import numpy as np
import pytest
import torch

import raytracer_tpu.accel.native_builder as jnative
import raytracer_tpu.scene.benchmark as jbench
import raytracer_tpu.scene.model as jmodel
import raytracer_tpu_torch.accel.native_builder as tnative
import raytracer_tpu_torch.api as tapi
import raytracer_tpu_torch.scene.benchmark as tbench
import raytracer_tpu_torch.scene.model as tmodel
from raytracer_tpu.scene.device_scene import bake_scene as jbake
from raytracer_tpu_torch.api import ProgressiveRenderer
from raytracer_tpu_torch.integrator import wavefront as twave
from raytracer_tpu_torch.ops import binary_traverse as bt
from raytracer_tpu_torch.ops import quad_traverse as qt
from raytracer_tpu_torch.scene.device_scene import (
    ARRAY_FIELDS,
    OPTIONAL_FIELDS,
    bake_scene as tbake,
    from_jax_arrays,
)
from raytracer_tpu_torch.utils.config import RenderConfig

torch.set_num_threads(1)  # see test_torch_ops.py

SCENES = {
    "cornell": (jmodel.create_cornell_box, tmodel.create_cornell_box),
    "atrium20k": (lambda: jbench.create_benchmark_atrium(20_000),
                  lambda: tbench.create_benchmark_atrium(20_000)),
}
BUDGETS = [96 * 1024, 256 * 1024]


@pytest.fixture(autouse=True)
def numpy_builders(monkeypatch):
    monkeypatch.setattr(jnative, "available", lambda: False)
    monkeypatch.setattr(tnative, "available", lambda: False)


def _fields(ds):
    return {f.name: np.asarray(getattr(ds, f.name))
            for f in dataclasses.fields(ds)
            if getattr(ds, f.name) is not None}


def _assert_fields(port, want):
    for k in ARRAY_FIELDS + OPTIONAL_FIELDS:
        if k not in want or k in ("nodes_packed", "tris_packed"):
            continue
        got = getattr(port, k).cpu().numpy()
        assert got.dtype == want[k].dtype and got.shape == want[k].shape, k
        np.testing.assert_array_equal(got, want[k], err_msg=k)
    for k in ("num_triangles", "num_lights", "q_stack_need", "bvh_max_depth",
              "num_parts", "part_max_depth"):
        assert getattr(port, k) == int(want[k]), k


@pytest.mark.parametrize("budget", BUDGETS)
@pytest.mark.parametrize("name", sorted(SCENES))
def test_multi_part_bake_matches_jax(name, budget):
    jmake, tmake = SCENES[name]
    jds, _ = jbake(jmake(), stable_shapes=False, pallas_budget_bytes=budget)
    tds, _ = tbake(tmake(), device="cpu", pallas_budget_bytes=budget)
    assert tds.num_parts == jds.num_parts > 1
    want = _fields(jds)
    _assert_fields(tds, want)
    # The JAX arrays load into the same scene.
    conv = from_jax_arrays(want, "cpu")
    for k in ARRAY_FIELDS + ("part_aabb",):
        assert torch.equal(getattr(conv, k).nan_to_num(7.0),
                           getattr(tds, k).nan_to_num(7.0)), k
    assert tds.pallas_vmem_bytes <= budget


def test_stable_shapes_skip_multi_part(caplog):
    """A stable bake that the budget cuts into parts is not padded, as in
    the JAX bake."""
    with caplog.at_level("INFO"):
        tds, _ = tbake(tmodel.create_cornell_box(), device="cpu",
                       pallas_budget_bytes=BUDGETS[0], stable_shapes=True)
    assert tds.num_parts > 1 and tds.true_counts is None
    assert "multi-part bake" in caplog.text


def _rays(ds, n, seed):
    rng = np.random.default_rng(seed)
    lo, hi = ds.scene_min.numpy(), ds.scene_max.numpy()
    o = (lo + (hi - lo) * rng.random((n, 3))).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = (rng.random(n) * np.linalg.norm(hi - lo)).astype(np.float32)
    skip = rng.integers(-1, 8, n).astype(np.int32)
    active = rng.random(n) > 0.25
    return [torch.from_numpy(a) for a in (o, d, t_max, skip, active)]


@pytest.mark.parametrize("budget", BUDGETS)
@pytest.mark.parametrize("name", sorted(SCENES))
def test_part_passes_match_one_part(name, budget):
    """K1/K2 (4-wide) and K3/K4 (binary) plain walks, one pass per part
    near to far, give the one-part bake's hit records and masks."""
    one, _ = tbake(SCENES[name][1](), device="cpu")
    parts, _ = tbake(SCENES[name][1](), device="cpu",
                     pallas_budget_bytes=budget)
    o, d, t_max, skip, active = _rays(one, 1024, seed=budget % 97)
    for t_min, closest, anyhit in (
            (1e-3, qt.intersect_quad, qt.occlusion_quad),
            (1e-3, bt.intersect_bvh_binary, bt.occlusion_bvh_binary),
            (0.01, bt.intersect_bvh_binary, bt.occlusion_bvh_binary)):
        want = (closest(o, d, one, t_min, t_max, active),
                anyhit(o, d, t_min, t_max, one, skip, active))
        got = (closest(o, d, parts, t_min, t_max, active),
               anyhit(o, d, t_min, t_max, parts, skip, active))
        for a, b in zip(got[0], want[0]):
            assert torch.equal(a, b), closest.__name__
        assert torch.equal(got[1], want[1]), anyhit.__name__
        assert 0 < int(want[0].hit.sum()) < 1024
        assert 0 < int(want[1].sum())


def test_parts_trace_near_to_far():
    """The passes go near to far from the rays' centroid (the JAX order),
    each part once."""
    ds, _ = tbake(tmodel.create_cornell_box(), device="cpu",
                  pallas_budget_bytes=BUDGETS[0])
    box = ds.part_aabb
    centre = (box[2, 0:3] + box[2, 3:6]) / 2
    order = qt.scene_parts(ds, centre.expand(16, 3).contiguous())
    assert order[0] is ds.parts[2]
    assert sorted(map(id, order)) == sorted(map(id, ds.parts))


def _render(accel, budget, monkeypatch, **cfg):
    monkeypatch.setattr(tapi, "PALLAS_VMEM_BUDGET", budget)
    r = ProgressiveRenderer(tmodel.create_cornell_box(), None,
                            RenderConfig(**{"width": 16, "height": 16,
                                            **cfg}),
                            device="cpu")
    if accel == "bvh":
        # The budget cuts the bakes of accel="cuda" only (as the JAX
        # package's pallas bakes); render the same bake on K3/K4.
        r.config = r.config.replace(accel="bvh")
    return r.device_scene.num_parts, r.render(2)


@pytest.mark.parametrize("accel", ["cuda", "bvh"])
@pytest.mark.parametrize("depth", [3, 6])
def test_multi_part_render_matches_one_part(accel, depth, monkeypatch):
    """The whole render on a multi-part bake, bit for bit the one-part
    render: accel "cuda" (K1/K2 per part; at depth 6 with the sort's
    part-affinity key and compaction, 64x64) and "bvh" (K3/K4 per part)."""
    size = 64 if depth > 3 else 16
    kw = dict(max_depth=depth, width=size, height=size)
    p1, want = _render(accel, None, monkeypatch, **kw)
    p, got = _render(accel, BUDGETS[0], monkeypatch, **kw)
    assert p1 == 1 and p > 1
    np.testing.assert_array_equal(got, want)


def test_compaction_sorts_by_part(monkeypatch):
    """On a multi-part bake the deep bounces' sort takes the part-affinity
    key (3 bits for the Cornell box's 10 parts)."""
    keys = []
    affinity = twave._part_affinity

    def spy(scene, origin, direction, num_bits):
        out = affinity(scene, origin, direction, num_bits)
        keys.append(num_bits)
        return out

    monkeypatch.setattr(twave, "_part_affinity", spy)
    _render("cuda", BUDGETS[0], monkeypatch, width=64, height=64,
            max_depth=5)
    assert keys and all(k == 3 for k in keys)
