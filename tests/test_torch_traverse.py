"""The port's 4-wide BVH traversal (ops/quad_traverse.py) against the JAX
package's skip-link walk and its sub-packet Pallas kernels (interpret mode
on CPU), on the same baked arrays. On CPU tensors the port runs the
kernels' plain torch versions; chip_smoke.py compares the CUDA kernels
with those on the card.

Gate: hit and tri identical, |dt| <= 1e-5 (the JAX kernels' f32 terms are
rounded by XLA, the port's op by op)."""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.ops.pallas_subpacket import (
    intersect_bvh_subpacket,
    occlusion_bvh_subpacket,
)
from raytracer_tpu.ops.traverse import intersect_bvh, occlusion_bvh
from raytracer_tpu_torch.ops import quad_traverse as qt
from tests.conftest import make_traversal_scene

torch.set_num_threads(1)  # see test_torch_ops.py

DT = 1e-5


def _port_scene(js):
    """The port's view of a conftest traversal scene (the kernels' arrays
    only)."""
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    return SimpleNamespace(
        qnodes=t(js.qnodes), qmeta=t(js.qmeta), qroot=t(js.qroot),
        ptris=t(js.ptris), q_stack_need=int(js.q_stack_need),
        root=int(np.asarray(js.qroot)[0]),
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


@pytest.mark.parametrize("against", ["walk", "subpacket"])
def test_closest_matches_jax(against, rng_np):
    js, ps, o, d, active, t_max, _ = _scene_and_rays(rng_np)
    jo, jd = jnp.asarray(o), jnp.asarray(d)
    ja, jt = jnp.asarray(active), jnp.asarray(t_max)
    if against == "walk":
        # The walk leaves inactive lanes at the input t_max; the kernels
        # fold them to t_max = 1e-3 first. Give the walk the folded t_max.
        want = intersect_bvh(jo, jd, js, 1e-3, jnp.where(ja, jt, 1e-3),
                             active_mask=ja)
    else:
        want = intersect_bvh_subpacket(jo, jd, js, 1e-3, jt, active_mask=ja,
                                       interpret=True)
    got = qt.intersect_quad(torch.from_numpy(o), torch.from_numpy(d), ps,
                            1e-3, torch.from_numpy(t_max),
                            active_mask=torch.from_numpy(active))
    assert 100 < int(got.hit.sum()) < len(o)
    _check_closest(want, got)


@pytest.mark.parametrize("against", ["walk", "subpacket"])
def test_occlusion_matches_jax(against, rng_np):
    js, ps, o, d, active, t_max, skip = _scene_and_rays(rng_np)
    args = (jnp.asarray(o), jnp.asarray(d), 1e-3, jnp.asarray(t_max), js,
            jnp.asarray(skip))
    if against == "walk":
        want = occlusion_bvh(*args, active_mask=jnp.asarray(active))
    else:
        want = occlusion_bvh_subpacket(*args, active_mask=jnp.asarray(active),
                                       interpret=True)
    got = qt.occlusion_quad(torch.from_numpy(o), torch.from_numpy(d), 1e-3,
                            torch.from_numpy(t_max), ps,
                            torch.from_numpy(skip),
                            active_mask=torch.from_numpy(active))
    assert 50 < int(got.sum()) < len(o)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


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
    occ = qt.occlusion_quad(o, d, 1e-3, torch.tensor([10.0, 10.0, 0.5, 10.0]),
                            _port_scene(js),
                            torch.tensor([-1, 7, -1, -1], dtype=torch.int32),
                            active_mask=torch.tensor([True] * 3 + [False]))
    assert occ.tolist() == [True, False, False, False]


def test_single_leaf_root(rng_np):
    """Few enough triangles that the root is a leaf block (qroot < 0)."""
    v0 = rng_np.uniform(-1, 1, (4, 3)).astype(np.float32)
    e1 = rng_np.uniform(-1, 1, (4, 3)).astype(np.float32)
    e2 = rng_np.uniform(-1, 1, (4, 3)).astype(np.float32)
    js = make_traversal_scene(v0, e1, e2, leaf_size=8)
    ps = _port_scene(js)
    assert ps.root < 0
    o = rng_np.uniform(-2, 2, (300, 3)).astype(np.float32)
    d = (rng_np.uniform(-0.5, 0.5, (300, 3)) - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    want = intersect_bvh_subpacket(jnp.asarray(o), jnp.asarray(d), js, 1e-3,
                                   1e4, interpret=True)
    got = qt.intersect_quad(torch.from_numpy(o), torch.from_numpy(d), ps,
                            1e-3, 1e4)
    assert int(got.hit.sum()) > 30
    _check_closest(want, got)
    skip = np.full(300, -1, np.int32)
    occ = qt.occlusion_quad(torch.from_numpy(o), torch.from_numpy(d), 1e-3,
                            1e4, ps, torch.from_numpy(skip))
    np.testing.assert_array_equal(occ.numpy(), got.hit.numpy())


def test_absent_child_slots(rng_np):
    """A root whose binary children are a leaf and an internal node has 3
    quad children: slot 3 is a NaN box with qmeta 0 and must never be
    entered (0 is the root, so entering it would loop)."""
    # A tight cluster of 8 triangles (one leaf) far from 40 spread ones.
    far = rng_np.uniform(-0.1, 0.1, (8, 3)).astype(np.float32) + 20.0
    near = rng_np.uniform(-3, 3, (40, 3)).astype(np.float32)
    v0 = np.concatenate([far, near])
    e1 = rng_np.uniform(-0.5, 0.5, (48, 3)).astype(np.float32)
    e2 = rng_np.uniform(-0.5, 0.5, (48, 3)).astype(np.float32)
    js = make_traversal_scene(v0, e1, e2, leaf_size=8)
    qn = np.asarray(js.qnodes)
    qm = np.asarray(js.qmeta).reshape(-1, 4)
    absent = np.isnan(qn[:, :24].reshape(-1, 4, 6)).all(axis=2)
    assert absent.any()
    assert (qm[absent] == 0).all()
    o = np.concatenate([
        rng_np.uniform(-4, 4, (400, 3)), rng_np.uniform(19, 21, (200, 3)),
    ]).astype(np.float32)
    d = rng_np.normal(size=(600, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    ps = _port_scene(js)
    want = intersect_bvh(jnp.asarray(o), jnp.asarray(d), js, 1e-3, 1e4)
    got = qt.intersect_quad(torch.from_numpy(o), torch.from_numpy(d), ps,
                            1e-3, 1e4)
    _check_closest(want, got)
    want_occ = occlusion_bvh(jnp.asarray(o), jnp.asarray(d), 1e-3,
                             jnp.full((600,), 1e4), js,
                             jnp.full((600,), -1, jnp.int32))
    got_occ = qt.occlusion_quad(torch.from_numpy(o), torch.from_numpy(d),
                                1e-3, 1e4, ps,
                                torch.full((600,), -1, dtype=torch.int32))
    np.testing.assert_array_equal(got_occ.numpy(), np.asarray(want_occ))


def test_stack_need_over_cap_raises(rng_np):
    js, ps, o, d, _, _, skip = _scene_and_rays(rng_np, r=10)
    ps.q_stack_need = qt.CAP + 1
    with pytest.raises(ValueError, match="stack"):
        qt.intersect_quad(torch.from_numpy(o), torch.from_numpy(d), ps,
                          1e-3, 1e4)
    with pytest.raises(ValueError, match="stack"):
        qt.occlusion_quad(torch.from_numpy(o), torch.from_numpy(d), 1e-3,
                          1e4, ps, torch.from_numpy(skip))


def test_t_min_is_fixed(rng_np):
    _, ps, o, d, _, _, _ = _scene_and_rays(rng_np, r=10)
    with pytest.raises(ValueError, match="t_min"):
        qt.intersect_quad(torch.from_numpy(o), torch.from_numpy(d), ps,
                          1e-2, 1e4)


def test_cpu_tensors_take_the_plain_version(rng_np, monkeypatch):
    """CPU tensors run the plain versions and count no kernel launch; the
    CUDA wrappers are never reached."""
    _, ps, o, d, _, _, skip = _scene_and_rays(rng_np, r=64)

    def refuse(*a, **k):
        raise AssertionError("CUDA wrapper called for CPU tensors")

    monkeypatch.setattr(qt, "_intersect_quad_cuda", refuse)
    monkeypatch.setattr(qt, "_occlusion_quad_cuda", refuse)
    qt.reset_launch_counts()
    qt.intersect_quad(torch.from_numpy(o), torch.from_numpy(d), ps, 1e-3, 1e4)
    qt.occlusion_quad(torch.from_numpy(o), torch.from_numpy(d), 1e-3, 1e4,
                      ps, torch.from_numpy(skip))
    assert (qt.closest_launches, qt.occlusion_launches) == (0, 0)


def test_shared_edge_ties_are_counted_and_bounded():
    """Camera rays into the Cornell box, whose quads share diagonal edges:
    a per-ray DFS visits leaves in another order than the JAX kernels, so
    at exactly equal t it may name the other triangle, and rays on an edge
    may hit in one package and slip through in the other (f32 rounding).
    At frame 0 on a square image the back wall's diagonal runs through
    pixel centers, so such rays exist. Count both kinds; each must be a ray
    whose hit lies on a triangle edge (barycentric distance <= 1e-5), and
    every triangle difference must be at equal t."""
    import dataclasses

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
    want = intersect_bvh_subpacket(o, d, jds, 1e-3, 1e4, interpret=True)
    got = qt.intersect_quad(torch.from_numpy(np.array(o)),
                            torch.from_numpy(np.array(d)), ps, 1e-3, 1e4)
    jhit, thit = np.asarray(want.hit), got.hit.numpy()
    both = jhit & thit
    flips = jhit != thit
    tri_diff = both & (np.asarray(want.tri) != got.tri.numpy())
    dt = np.abs(np.asarray(want.t) - got.t.numpy())
    print(f"cornell {w}x{h} primary rays: {int(flips.sum())} hit/miss "
          f"flips, {int(tri_diff.sum())} equal-t triangle differences, of "
          f"{w * h}")
    assert (dt[both] <= DT).all()
    # Barycentric distance to the nearest edge of the hit triangle, from
    # whichever side hit.
    u = np.where(thit, got.u.numpy(), np.asarray(want.u))
    v = np.where(thit, got.v.numpy(), np.asarray(want.v))
    on_edge = np.minimum(np.minimum(u, v), 1.0 - u - v) <= 1e-5
    assert on_edge[flips | tri_diff].all()
