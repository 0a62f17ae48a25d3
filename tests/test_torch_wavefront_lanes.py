"""The port's lane-general wavefront (integrator/wavefront.py): arbitrary
(a range, strided, repeated) pixel ids, a per-lane frame vector and an
active lane mask, and `accumulate` with a per-lane frame.

Within the port each lane is bit-equal to the same (pixel, frame) lane of
a full scalar launch. Against the JAX package's render_wavefront on the
same pixel ids and frames (accel="bvh" on both sides): every lane within
1e-4, except flipped lanes (a lottery or an edge hit that fell the other
way, see test_torch_render.py), at most 1% of them. Lane counts are
multiples of 64: torch's CPU kernels run the last few elements of a
contiguous tensor through scalar code, whose sin/cos may differ from the
vector code by an ulp. Both sides use the numpy BVH builder."""

import functools

import numpy as np
import pytest
import torch

import raytracer_tpu.accel.native_builder as jnative
import raytracer_tpu.scene.model as jmodel
import raytracer_tpu_torch.accel.native_builder as tnative
import raytracer_tpu_torch.scene.model as tmodel
from raytracer_tpu.api import ProgressiveRenderer as JaxRenderer
from raytracer_tpu.integrator import wavefront as jwave
from raytracer_tpu.utils.config import RenderConfig as JaxConfig
from raytracer_tpu_torch.api import ProgressiveRenderer
from raytracer_tpu_torch.integrator import wavefront as twave
from raytracer_tpu_torch.utils.config import RenderConfig

torch.set_num_threads(1)  # see test_torch_ops.py

W = H = 16
PIXEL_ATOL = 1e-4
MAX_FLIPPED = 0.01


@pytest.fixture(autouse=True)
def numpy_builders(monkeypatch):
    monkeypatch.setattr(jnative, "available", lambda: False)
    monkeypatch.setattr(tnative, "available", lambda: False)


@functools.cache
def _port_renderer(accel="auto"):
    r = ProgressiveRenderer(tmodel.create_cornell_box(), None,
                            RenderConfig(width=W, height=H, accel=accel),
                            device="cpu")
    r.begin_frame()
    return r


@functools.cache
def _full(frame, accel="auto"):
    """The full scalar launch at `frame`: radiance f32[W*H, 3]."""
    r = _port_renderer(accel)
    return twave.render_wavefront(r.device_scene, r._camera_ubo_dev, frame,
                                  r.config)


def _lanes(kind):
    """(pixel ids i64[N], per-lane frames i64[N]) from a seeded numpy rng:
    repeated ids at mixed frames, or a strided set at mixed frames."""
    rng = np.random.default_rng({"repeated": 11, "strided": 12}[kind])
    if kind == "repeated":
        pix = rng.integers(0, W * H, 48).repeat(4)[:192]
    else:
        pix = np.arange(3, W * H, 4)[:64].repeat(2)
    frames = rng.integers(0, 4, pix.size)
    return pix.astype(np.int64), frames.astype(np.int64)


@pytest.mark.parametrize("accel", ["auto", "bvh"])
@pytest.mark.parametrize("kind", ["repeated", "strided"])
def test_lanes_bit_equal_full_launch(kind, accel):
    r = _port_renderer(accel)
    pix, frames = _lanes(kind)
    got = twave.render_wavefront(
        r.device_scene, r._camera_ubo_dev, torch.from_numpy(frames),
        r.config, pixel_indices=torch.from_numpy(pix))
    want = torch.stack([_full(int(f), accel)[int(p)]
                        for p, f in zip(pix, frames)])
    assert torch.equal(got, want)


def test_pixel_range_bit_equal_full_launch():
    r = _port_renderer()
    got = twave.render_wavefront(r.device_scene, r._camera_ubo_dev, 2,
                                 r.config,
                                 pixel_indices=torch.arange(64, 192))
    assert torch.equal(got, _full(2)[64:192])


def test_active_mask_lanes_bit_equal_and_traced_nothing():
    """Active lanes equal the unmasked launch; inactive lanes trace no ray
    and return no radiance."""
    r = _port_renderer()
    active = torch.from_numpy(
        np.random.default_rng(5).uniform(size=W * H) < 0.6)
    frames = torch.from_numpy(
        np.random.default_rng(6).integers(0, 4, W * H).astype(np.int64))
    rad, stats = twave.render_wavefront(
        r.device_scene, r._camera_ubo_dev, frames, r.config, active=active,
        with_stats=True)
    full = twave.render_wavefront(r.device_scene, r._camera_ubo_dev, frames,
                                  r.config)
    assert torch.equal(rad[active], full[active])
    assert torch.equal(rad[~active], torch.zeros_like(rad[~active]))
    _, unmasked = twave.render_wavefront(
        r.device_scene, r._camera_ubo_dev, frames, r.config, with_stats=True)
    assert int(stats["rays_traced"]) < int(unmasked["rays_traced"])
    # Depth 0 traces exactly the active lanes.
    one = r.config.replace(max_depth=1)
    _, st1 = twave.render_wavefront(r.device_scene, r._camera_ubo_dev,
                                    frames, one, active=active,
                                    with_stats=True)
    assert int(st1["rays_traced"]) == int(active.sum())


@pytest.mark.parametrize("frames", [[0, 1, 2, 7], [3, 0, 1000, 65535],
                                    [2 ** 24 - 1, 2 ** 24 + 3, 5, 0]])
def test_accumulate_matches_numpy_f32(frames):
    """Per-lane and int frames both give, bit for bit, the running mean
    computed in numpy f32: frame 0 stores, frame f blends with the f32
    weight 1/(f+1)."""
    rng = np.random.default_rng(sum(frames) % 1000)
    accum = rng.uniform(0, 3, (4, 3)).astype(np.float32)
    rad = rng.uniform(0, 5, (4, 3)).astype(np.float32)
    one = np.float32(1.0)
    want = np.stack([
        rad[i] if f == 0
        else accum[i] + (rad[i] - accum[i]) * (one / (np.float32(f) + one))
        for i, f in enumerate(frames)])
    got = twave.accumulate(torch.from_numpy(accum), torch.from_numpy(rad),
                           torch.tensor(frames))
    assert np.array_equal(got.numpy(), want)
    for i, f in enumerate(frames):
        lane = twave.accumulate(torch.from_numpy(accum[i:i + 1]),
                                torch.from_numpy(rad[i:i + 1]), f)
        assert np.array_equal(lane.numpy()[0], want[i])


@functools.cache
def _jax_scene_ubo():
    jr = JaxRenderer(jmodel.create_cornell_box(), None, JaxConfig(
        width=W, height=H, accel="bvh", stable_bake=False))
    jr.begin_frame()
    return jr.device_scene, jr._camera_ubo_dev, jr.config


@pytest.mark.parametrize("kind", ["repeated", "strided"])
def test_lanes_match_jax(kind):
    import jax.numpy as jnp

    ds, ubo, cfg = _jax_scene_ubo()
    pix, frames = _lanes(kind)
    want = np.asarray(jwave.render_wavefront(
        ds, ubo, jnp.asarray(frames.astype(np.uint32)), cfg,
        pixel_indices=jnp.asarray(pix.astype(np.uint32))))
    r = _port_renderer()
    got = twave.render_wavefront(
        r.device_scene, r._camera_ubo_dev, torch.from_numpy(frames),
        r.config, pixel_indices=torch.from_numpy(pix)).numpy()
    flipped = np.abs(got - want).max(axis=-1) > PIXEL_ATOL
    print(f"{kind}: {int(flipped.sum())} flipped lanes of {flipped.size}")
    assert flipped.mean() <= MAX_FLIPPED


def test_active_lanes_match_jax():
    """A masked launch at per-lane frames against the JAX one: the active
    lanes within the render tolerance."""
    import jax.numpy as jnp

    ds, ubo, cfg = _jax_scene_ubo()
    active = np.random.default_rng(7).uniform(size=W * H) < 0.5
    frames = np.random.default_rng(8).integers(0, 4, W * H)
    want = np.asarray(jwave.render_wavefront(
        ds, ubo, jnp.asarray(frames.astype(np.uint32)), cfg,
        active=jnp.asarray(active)))
    r = _port_renderer()
    got = twave.render_wavefront(
        r.device_scene, r._camera_ubo_dev, torch.from_numpy(frames),
        r.config, active=torch.from_numpy(active)).numpy()
    flipped = np.abs(got - want)[active].max(axis=-1) > PIXEL_ATOL
    print(f"active lanes: {int(flipped.sum())} flipped of {flipped.size}")
    assert flipped.mean() <= MAX_FLIPPED
