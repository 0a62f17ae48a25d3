"""The port's binary BVH traversal (ops/binary_traverse.py, accel="bvh")
against the JAX package's packet kernels K3/K4 (ops/pallas_traverse.py, in
interpret mode on CPU) and its skip-link walk (ops/traverse.py), on the
same baked arrays. On CPU tensors the port runs the kernels' plain torch
versions; chip_smoke.py compares the CUDA kernels with those on the card.

Gate: hit and tri identical, |dt| <= 1e-5 (the JAX terms are rounded by
XLA, the port's op by op). Only camera rays through the Cornell box's
shared edges may differ, and those are counted and bounded."""

import dataclasses
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.ops.pallas_traverse import (
    intersect_bvh_pallas,
    occlusion_bvh_pallas,
)
from raytracer_tpu.ops.traverse import intersect_bvh, occlusion_bvh
from raytracer_tpu_torch.ops import binary_traverse as bt
from tests.conftest import make_traversal_scene

torch.set_num_threads(1)  # see test_torch_ops.py

DT = 1e-5


def _port_scene(js):
    """The port's view of a conftest traversal scene (the binary kernels'
    arrays only)."""
    return SimpleNamespace(
        pnodes=torch.from_numpy(np.array(js.pnodes)),
        ptris=torch.from_numpy(np.array(js.ptris)),
        bvh_max_depth=int(js.bvh_max_depth),
        binary_root=int(np.asarray(js.root_meta)[0]),
    )


def _scene_and_rays(rng, t=160, r=1300, leaf_size=8):
    v0 = rng.uniform(-3, 3, (t, 3)).astype(np.float32)
    e1 = rng.uniform(-1, 1, (t, 3)).astype(np.float32)
    e2 = rng.uniform(-1, 1, (t, 3)).astype(np.float32)
    obj = rng.integers(0, 12, t).astype(np.int32)
    js = make_traversal_scene(v0, e1, e2, tri_object=obj,
                              leaf_size=leaf_size)
    o = rng.uniform(-4, 4, (r, 3)).astype(np.float32)
    d = rng.normal(size=(r, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    active = rng.uniform(size=r) < 0.8
    t_max = rng.uniform(0.5, 9.0, r).astype(np.float32)
    skip = rng.integers(-1, 12, r).astype(np.int32)
    return js, _port_scene(js), o, d, active, t_max, skip


def _check_closest(want, got):
    hit = np.asarray(want.hit)
    np.testing.assert_array_equal(got.hit.numpy(), hit)
    np.testing.assert_array_equal(got.tri.numpy(), np.asarray(want.tri))
    assert np.abs(got.t.numpy() - np.asarray(want.t)).max() <= DT
    np.testing.assert_allclose(got.u.numpy()[hit], np.asarray(want.u)[hit],
                               atol=1e-4)
    np.testing.assert_allclose(got.v.numpy()[hit], np.asarray(want.v)[hit],
                               atol=1e-4)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("leaf_size", [8, 16])
@pytest.mark.parametrize("against", ["walk", "k3"])
def test_closest_matches_jax(against, leaf_size, rng_np):
    js, ps, o, d, active, t_max, _ = _scene_and_rays(rng_np,
                                                     leaf_size=leaf_size)
    jo, jd = jnp.asarray(o), jnp.asarray(d)
    ja, jt = jnp.asarray(active), jnp.asarray(t_max)
    if against == "walk":
        # The walk leaves inactive lanes at the input t_max; the kernels
        # fold them to t_max = t_min first. Give the walk the folded t_max.
        want = intersect_bvh(jo, jd, js, 1e-3, jnp.where(ja, jt, 1e-3),
                             active_mask=ja)
    else:
        want = intersect_bvh_pallas(jo, jd, js, 1e-3, jt, active_mask=ja,
                                    interpret=True)
    got = bt.intersect_bvh_binary(_t(o), _t(d), ps, 1e-3, _t(t_max),
                                  active_mask=_t(active))
    assert 100 < int(got.hit.sum()) < len(o)
    _check_closest(want, got)


@pytest.mark.parametrize("leaf_size", [8, 16])
@pytest.mark.parametrize("against", ["walk", "k4"])
def test_occlusion_matches_jax(against, leaf_size, rng_np):
    js, ps, o, d, active, t_max, skip = _scene_and_rays(rng_np,
                                                        leaf_size=leaf_size)
    args = (jnp.asarray(o), jnp.asarray(d), 1e-3, jnp.asarray(t_max), js,
            jnp.asarray(skip))
    if against == "walk":
        want = occlusion_bvh(*args, active_mask=jnp.asarray(active))
    else:
        want = occlusion_bvh_pallas(*args, active_mask=jnp.asarray(active),
                                    interpret=True)
    got = bt.occlusion_bvh_binary(_t(o), _t(d), 1e-3, _t(t_max), ps,
                                  _t(skip), active_mask=_t(active))
    assert 50 < int(got.sum()) < len(o)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("leaf_size", [8, 16])
def test_other_t_min_matches_walk(leaf_size, rng_np):
    """K3/K4 fix t_min at 1e-3; the walk, and the port, take any t_min.
    Each ray starts 0.02 before a random point of a triangle, so t_min =
    0.05 skips that triangle where 1e-3 would hit it."""
    js, ps, o, d, active, t_max, skip = _scene_and_rays(rng_np,
                                                        leaf_size=leaf_size)
    tv0 = np.asarray(js.tri_v0)
    te1, te2 = np.asarray(js.tri_e1), np.asarray(js.tri_e2)
    pick = rng_np.integers(0, len(tv0), len(o))
    a, b = rng_np.uniform(0, 0.5, (2, len(o), 1)).astype(np.float32)
    o = (tv0[pick] + a * te1[pick] + b * te2[pick] - 0.02 * d).astype(
        np.float32)
    t_min = 0.05
    jo, jd, ja = jnp.asarray(o), jnp.asarray(d), jnp.asarray(active)
    jt = jnp.where(ja, jnp.asarray(t_max), t_min)
    want = intersect_bvh(jo, jd, js, t_min, jt, active_mask=ja)
    got = bt.intersect_bvh_binary(_t(o), _t(d), ps, t_min, _t(t_max),
                                  active_mask=_t(active))
    assert 100 < int(got.hit.sum()) < len(o)
    _check_closest(want, got)
    near = bt.intersect_bvh_binary(_t(o), _t(d), ps, 1e-3, _t(t_max),
                                   active_mask=_t(active))
    assert int((near.t < t_min).sum()) > len(o) // 2
    want_occ = occlusion_bvh(jo, jd, t_min, jnp.asarray(t_max), js,
                             jnp.asarray(skip), active_mask=ja)
    got_occ = bt.occlusion_bvh_binary(_t(o), _t(d), t_min, _t(t_max), ps,
                                      _t(skip), active_mask=_t(active))
    np.testing.assert_array_equal(got_occ.numpy(), np.asarray(want_occ))


def test_single_triangle_scene():
    v0 = np.asarray([[-1.0, -1.0, 2.0]], np.float32)
    e1 = np.asarray([[2.0, 0.0, 0.0]], np.float32)
    e2 = np.asarray([[0.0, 2.0, 0.0]], np.float32)
    ps = _port_scene(make_traversal_scene(v0, e1, e2, leaf_size=8))
    assert ps.binary_root < 0  # the root is a leaf block
    o = torch.tensor([[0.0, 0.0, 0.0], [0.0, 0.0, 5.0]])
    d = torch.tensor([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]])
    rec = bt.intersect_bvh_binary(o, d, ps, 1e-3, 1e4)
    assert rec.hit.tolist() == [True, False]
    assert abs(float(rec.t[0]) - 2.0) < 1e-5


def test_occlusion_skip_object_and_tmax():
    """Lane 0: the occluder counts; lane 1: skipped by object id; lane 2:
    t_max stops short of the plane at z=1; lane 3: inactive."""
    js = make_traversal_scene(
        np.asarray([[-1.0, -1.0, 1.0]], np.float32),
        np.asarray([[2.0, 0.0, 0.0]], np.float32),
        np.asarray([[0.0, 2.0, 0.0]], np.float32),
        tri_object=np.asarray([7], np.int32))
    o = torch.zeros((4, 3))
    d = torch.tensor([[0.0, 0.0, 1.0]] * 4)
    occ = bt.occlusion_bvh_binary(
        o, d, 1e-3, torch.tensor([10.0, 10.0, 0.5, 10.0]), _port_scene(js),
        torch.tensor([-1, 7, -1, -1], dtype=torch.int32),
        active_mask=torch.tensor([True] * 3 + [False]))
    assert occ.tolist() == [True, False, False, False]


def test_active_mask_kills_lanes(rng_np):
    """Inactive lanes are not walked: no hit, t folded to t_min, u = v = 0
    (what K3 returns for them)."""
    js, ps, o, d, _, _, _ = _scene_and_rays(rng_np, r=64)
    mask = np.zeros(64, bool)
    mask[::2] = True
    want = intersect_bvh_pallas(jnp.asarray(o), jnp.asarray(d), js, 1e-3,
                                1e4, active_mask=jnp.asarray(mask),
                                interpret=True)
    rec = bt.intersect_bvh_binary(_t(o), _t(d), ps, 1e-3, 1e4,
                                  active_mask=_t(mask))
    assert not rec.hit.numpy()[~mask].any()
    assert rec.hit.numpy()[mask].any()
    assert (rec.t.numpy()[~mask] == np.float32(1e-3)).all()
    assert (rec.u.numpy()[~mask] == 0).all()
    assert (rec.v.numpy()[~mask] == 0).all()
    _check_closest(want, rec)


def test_stack_guard_rejects_overdeep_tree(rng_np):
    """A tree deeper than STACK_CAP - 2 is refused, as the JAX packet
    kernels refuse it (tests/test_bvh.py), not silently mis-traversed."""
    assert bt.stack_fits(bt.STACK_CAP - 2)
    assert not bt.stack_fits(bt.STACK_CAP - 1)
    _, ps, o, d, _, _, skip = _scene_and_rays(rng_np, r=8)
    deep = SimpleNamespace(**{**vars(ps), "bvh_max_depth": bt.STACK_CAP + 10})
    with pytest.raises(ValueError, match="stack"):
        bt.intersect_bvh_binary(_t(o), _t(d), deep, 1e-3, 1e4)
    with pytest.raises(ValueError, match="stack"):
        bt.occlusion_bvh_binary(_t(o), _t(d), 1e-3, 1e4, deep, _t(skip))


def test_cpu_tensors_take_the_plain_version(rng_np, monkeypatch):
    """CPU tensors run the plain versions and count no kernel launch; the
    CUDA wrappers are never reached."""
    _, ps, o, d, _, _, skip = _scene_and_rays(rng_np, r=64)

    def refuse(*a, **k):
        raise AssertionError("CUDA wrapper called for CPU tensors")

    monkeypatch.setattr(bt, "_intersect_binary_cuda", refuse)
    monkeypatch.setattr(bt, "_occlusion_binary_cuda", refuse)
    bt.reset_launch_counts()
    bt.intersect_bvh_binary(_t(o), _t(d), ps, 1e-3, 1e4)
    bt.occlusion_bvh_binary(_t(o), _t(d), 1e-3, 1e4, ps, _t(skip))
    assert (bt.closest_launches, bt.occlusion_launches) == (0, 0)


@pytest.mark.parametrize("against", ["walk", "k3"])
def test_shared_edge_ties_are_counted_and_bounded(against):
    """Camera rays into the Cornell box, whose quads share diagonal edges.
    The port orders children by each ray's own t_near, K3 by its packet's,
    and the walk in tree order, so at exactly equal t the port may name the
    other triangle, and rays on an edge may hit in one package and slip
    through in the other (f32 rounding). At frame 0 on a square image the
    back wall's diagonal runs through pixel centers, so such rays exist.
    Count both kinds; each must be a ray whose hit lies on a triangle edge
    (barycentric distance <= 1e-5), every triangle difference must be at
    equal t, and together they stay under 2% of the rays."""
    import raytracer_tpu.accel.native_builder as jnative
    from raytracer_tpu.integrator.wavefront import _camera_rays
    from raytracer_tpu.ops.camera import Camera
    from raytracer_tpu.scene.device_scene import bake_scene
    from raytracer_tpu.scene.model import create_cornell_box
    from raytracer_tpu_torch.scene.device_scene import from_jax_arrays

    orig = jnative.available
    jnative.available = lambda: False
    try:
        jds, _ = bake_scene(create_cornell_box(), stable_shapes=False)
    finally:
        jnative.available = orig
    ps = from_jax_arrays({f.name: np.asarray(getattr(jds, f.name))
                          for f in dataclasses.fields(jds)
                          if getattr(jds, f.name) is not None}, "cpu")
    w = h = 32
    m = Camera.create(position=(0.0, 0.0, -3.0), aspect=1.0).matrices()
    o, d = _camera_rays(jnp.asarray(m["inverse_view"]),
                        jnp.asarray(m["inverse_proj"]), w, h,
                        jnp.full((w * h, 2), 0.5, jnp.float32),
                        jnp.arange(w * h, dtype=jnp.uint32))
    if against == "walk":
        want = intersect_bvh(o, d, jds, 1e-3, 1e4)
    else:
        want = intersect_bvh_pallas(o, d, jds, 1e-3, 1e4, interpret=True)
    got = bt.intersect_bvh_binary(_t(o), _t(d), ps, 1e-3, 1e4)
    jhit, thit = np.asarray(want.hit), got.hit.numpy()
    both = jhit & thit
    flips = jhit != thit
    tri_diff = both & (np.asarray(want.tri) != got.tri.numpy())
    dt = np.abs(np.asarray(want.t) - got.t.numpy())
    print(f"cornell {w}x{h} primary rays vs {against}: {int(flips.sum())} "
          f"hit/miss flips, {int(tri_diff.sum())} equal-t triangle "
          f"differences, of {w * h}")
    assert (dt[both] <= DT).all()
    u = np.where(thit, got.u.numpy(), np.asarray(want.u))
    v = np.where(thit, got.v.numpy(), np.asarray(want.v))
    on_edge = np.minimum(np.minimum(u, v), 1.0 - u - v) <= 1e-5
    assert on_edge[flips | tri_diff].all()
    assert (flips | tri_diff).mean() <= 0.02
