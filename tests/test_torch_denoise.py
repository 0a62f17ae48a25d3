"""The port's denoiser, AOVs and preview (integrator/denoise.py, api.py)
against the JAX package's.

Tolerances:
  - atrous_denoise on the same numpy inputs (some miss pixels, some
    zero-albedo channels): rtol 1e-5, atol 1e-6. Not bit for bit: XLA on
    the CPU contracts `acc + w * s_t` into an FMA and its exp is not
    torch's.
  - upscale_bilinear: atol 1e-6.
  - gbuffer_pass and aovs(): normal, depth and albedo within 1e-5, except
    lanes whose hit flipped (an edge ray), at most 1%.
  - image(denoise=True) is JAX's atrous_denoise applied to the port's own
    accumulation and G-buffer, within the filter tolerance (one flipped
    input pixel spreads over 61x61 pixels after four iterations, so the
    two packages' denoised renders are not compared pixel by pixel).
  - preview_image at scale 2 without denoise or upscale: the render
    tolerance of test_torch_render.py (1e-4 per pixel, at most 1% flipped).
Both sides use the numpy BVH builder and accel="bvh" on the JAX side."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import raytracer_tpu.accel.native_builder as jnative
import raytracer_tpu.scene.model as jmodel
import raytracer_tpu_torch.accel.native_builder as tnative
import raytracer_tpu_torch.scene.model as tmodel
from raytracer_tpu.api import ProgressiveRenderer as JaxRenderer
from raytracer_tpu.integrator import denoise as jden
from raytracer_tpu.utils.config import RenderConfig as JaxConfig
from raytracer_tpu_torch.api import ProgressiveRenderer
from raytracer_tpu_torch.integrator import denoise as tden
from raytracer_tpu_torch.ops.camera import Camera
from raytracer_tpu_torch.utils.config import RenderConfig

torch.set_num_threads(1)  # see test_torch_ops.py

FILTER_RTOL, FILTER_ATOL = 1e-5, 1e-6
GBUF_ATOL = 1e-5
PIXEL_ATOL = 1e-4
MAX_FLIPPED = 0.01
W = H = 32


@pytest.fixture(autouse=True)
def numpy_builders(monkeypatch):
    monkeypatch.setattr(jnative, "available", lambda: False)
    monkeypatch.setattr(tnative, "available", lambda: False)


# A camera far enough back that the Cornell box's open front leaves
# background around it: G-buffers with hit and miss lanes.
FAR = dict(position=(0.3, 0.2, -9.0), aspect=1.0)


def _port(w=W, h=H, camera=None, **cfg):
    return ProgressiveRenderer(tmodel.create_cornell_box(), camera,
                               RenderConfig(width=w, height=h, **cfg),
                               device="cpu")


def _jax(w=W, h=H, camera=None, **cfg):
    return JaxRenderer(jmodel.create_cornell_box(), camera, JaxConfig(
        width=w, height=h, accel="bvh", stable_bake=False, **cfg))


def _filter_inputs(h, w, seed):
    """A noisy image over three planes, a quarter of the pixels missing,
    and a zero channel in a third of the albedos."""
    rng = np.random.default_rng(seed)
    n = h * w
    img = rng.gamma(1.0, 0.6, (n, 3)).astype(np.float32)
    plane = rng.integers(0, 3, n)
    nrm = np.eye(3, dtype=np.float32)[plane]
    nrm += rng.normal(0, 0.05, (n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    depth = (1.0 + plane + rng.uniform(0, 0.3, n)).astype(np.float32)
    albedo = rng.uniform(0.05, 1.0, (n, 3)).astype(np.float32)
    albedo[rng.uniform(size=n) < 1 / 3, rng.integers(0, 3)] = 0.0
    miss = rng.uniform(size=n) < 0.25
    nrm[miss] = 0.0
    depth[miss] = tden.MISS_DEPTH
    albedo[miss] = 1.0
    return img, nrm, depth, albedo


def _jax_filter(arrays, h, w, iterations):
    import jax.numpy as jnp

    return np.asarray(jden.atrous_denoise(
        *(jnp.asarray(a) for a in arrays), h, w, iterations=iterations))


@pytest.mark.parametrize("iterations", [1, 2, 3, 4])
def test_atrous_matches_jax(iterations):
    h, w = 24, 40
    arrays = _filter_inputs(h, w, iterations)
    want = _jax_filter(arrays, h, w, iterations)
    got = tden.atrous_denoise(*(torch.from_numpy(a) for a in arrays), h, w,
                              iterations=iterations).numpy()
    print(f"iterations {iterations}: max |diff| "
          f"{float(np.abs(got - want).max()):.3g}")
    np.testing.assert_allclose(got, want, rtol=FILTER_RTOL,
                               atol=FILTER_ATOL)


def test_atrous_keeps_background_sharp_and_black_albedo():
    """Surface-vs-background boundaries carry zero weight, and a flat image
    passes through unchanged in every channel whatever the albedo."""
    h = w = 16
    n = h * w
    surface = (np.arange(n) % w) < (w // 2)
    img = np.where(surface[:, None], 5.0, 0.25) * np.ones((1, 3))
    nrm = np.where(surface[:, None], [[0.0, 0.0, 1.0]], [[0.0, 0.0, 0.0]])
    depth = np.where(surface, 1.0, tden.MISS_DEPTH)
    albedo = np.tile([[1.0, 0.0, 0.0]], (n, 1))
    args = [torch.tensor(a, dtype=torch.float32)
            for a in (img, nrm, depth, albedo)]
    out = tden.atrous_denoise(*args, h, w, iterations=3).numpy()
    np.testing.assert_allclose(out[~surface], 0.25, rtol=1e-5)
    up = torch.tensor([[0.0, 0.0, 1.0]]).expand(n, 3)
    flat = tden.atrous_denoise(torch.full((n, 3), 2.0), up, torch.ones(n),
                               args[3], h, w, iterations=2).numpy()
    np.testing.assert_allclose(flat, 2.0, rtol=1e-4)


@pytest.mark.parametrize("shape", [(8, 8, 32, 32), (6, 10, 17, 23)])
def test_upscale_matches_jax(shape):
    """4x, and a non-integer ratio in each axis."""
    import jax.numpy as jnp

    h, w, oh, ow = shape
    img = np.random.default_rng(h * w).uniform(0, 4, (h * w, 3)).astype(
        np.float32)
    want = np.asarray(jden.upscale_bilinear(jnp.asarray(img), h, w, oh, ow))
    got = tden.upscale_bilinear(torch.from_numpy(img), h, w, oh, ow).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _gbuffer_flips(got, want):
    """Lanes whose hit/miss differs; asserts every other lane within
    GBUF_ATOL and returns the flipped share."""
    (gn, gd, ga), (wn, wd, wa) = got, want
    g_hit, w_hit = gd < tden.MISS_DEPTH, wd < jden.MISS_DEPTH
    flips = g_hit != w_hit
    same = ~flips
    for g, w_ in ((gn, wn), (gd, wd), (ga, wa)):
        np.testing.assert_allclose(g[same], w_[same], rtol=0,
                                   atol=GBUF_ATOL)
    print(f"{int(flips.sum())} hit flips of {flips.size}")
    return flips.mean()


@functools.cache
def _jax_renderer_with_gbuffer():
    from raytracer_tpu.ops.camera import Camera as JaxCamera

    jr = _jax(camera=JaxCamera.create(**FAR))
    jr.render(2)
    jr.aovs()
    return jr


@pytest.mark.parametrize("accel", ["auto", "bvh"])
def test_gbuffer_pass_matches_jax(accel):
    jr = _jax_renderer_with_gbuffer()
    r = _port(camera=Camera.create(**FAR), accel=accel)
    r.begin_frame()
    got = [a.numpy() for a in tden.gbuffer_pass(r.device_scene,
                                                r._camera_ubo_dev, r.config)]
    want = [np.asarray(a) for a in jr._gbuffer]
    assert _gbuffer_flips(got, want) <= MAX_FLIPPED
    hit = got[1] < tden.MISS_DEPTH
    assert hit.any() and (~hit).any()
    np.testing.assert_allclose(np.linalg.norm(got[0][hit], axis=-1), 1.0,
                               atol=1e-4)
    np.testing.assert_array_equal(got[0][~hit], 0.0)
    np.testing.assert_array_equal(got[2][~hit], 1.0)


def test_aovs_match_jax():
    jr = _jax_renderer_with_gbuffer()
    want = jr.aovs()
    r = _port(camera=Camera.create(**FAR))
    got = r.aovs()
    assert set(got) == {"normal", "depth", "albedo"}
    assert got["normal"].shape == (H, W, 3)
    assert got["depth"].shape == (H, W)
    assert got["albedo"].shape == (H, W, 3)
    assert (W, H) in r._gbuffers  # shared with the denoiser
    flips = _gbuffer_flips(
        [got[k].reshape(-1, *got[k].shape[2:]) for k in
         ("normal", "depth", "albedo")],
        [want[k].reshape(-1, *want[k].shape[2:]) for k in
         ("normal", "depth", "albedo")])
    assert flips <= MAX_FLIPPED


def test_image_denoise_is_the_jax_filter_of_the_ports_buffers():
    """image(denoise=True) equals JAX's filter applied to the port's own
    accumulation and G-buffer, and never modifies the accumulation; the
    config's denoise_preview is image()'s default."""
    r = _port(denoise_preview=True)
    r.render(2)
    accum = r.accum.clone()
    got = r.image()
    assert got.shape == (H, W, 3) and np.isfinite(got).all()
    assert torch.equal(r.accum, accum)
    raw = r.image(denoise=False)
    np.testing.assert_array_equal(raw, accum.numpy().reshape(H, W, 3))
    arrays = [a.numpy() for a in (r.accum, *r._gbuffers[(W, H)])]
    want = _jax_filter(arrays, H, W, r.config.denoise_iterations)
    np.testing.assert_allclose(got.reshape(-1, 3), want, rtol=FILTER_RTOL,
                               atol=FILTER_ATOL)
    # The filter smooths 2-spp noise.
    def hf(img):
        return np.abs(np.diff(img, axis=0)).mean()

    assert hf(got) < hf(raw)


def test_preview_leaves_state_untouched():
    r = _port(adaptive_tol=0.1)
    r.step()
    accum, frame = r.accum.clone(), r.frame
    adaptive = [t.clone() for t in r.adaptive]
    img = r.preview_image(scale=4, denoise=True)
    assert img.shape == (H, W, 3) and np.isfinite(img).all() and img.max() > 0
    assert r.frame == frame
    assert torch.equal(r.accum, accum)
    for before, after in zip(adaptive, r.adaptive):
        assert torch.equal(before, after)


def test_preview_deterministic_and_decorrelated():
    r = _port()
    r.step()
    a = r.preview_image(scale=2)
    np.testing.assert_array_equal(a, r.preview_image(scale=2))
    r.step()
    assert not np.array_equal(a, r.preview_image(scale=2))


def test_preview_scale_one_is_the_frames_radiance():
    """Scale 1 without denoise is frame 0's radiance, bit for bit: what the
    next step() accumulates."""
    r = _port(16, 16)
    img = r.preview_image(scale=1, denoise=False)
    assert img.shape == (16, 16, 3)
    r.step()
    np.testing.assert_array_equal(img, r.accum.numpy().reshape(16, 16, 3))


def test_preview_native_shape_and_upscale():
    r = _port()
    r.step()
    small = r.preview_image(scale=4, denoise=True, upscale=False)
    assert small.shape == (H // 4, W // 4, 3)
    assert np.isfinite(small).all() and small.max() > 0
    big = r.preview_image(scale=4, denoise=True, upscale=True)
    up = tden.upscale_bilinear(torch.from_numpy(small.reshape(-1, 3)),
                               H // 4, W // 4, H, W).numpy()
    np.testing.assert_array_equal(up.reshape(H, W, 3), big)


def test_preview_gbuffer_caches_dropped_on_edits():
    r = _port()
    r.preview_image(scale=2, denoise=True)
    r.image(denoise=True)
    assert set(r._gbuffers) == {(W // 2, H // 2), (W, H)}
    r.set_camera(Camera.create(position=(0.4, 0.2, -2.5), aspect=1.0))
    b = r.preview_image(scale=2, denoise=False)
    assert r._gbuffers == {}
    r.preview_image(scale=2, denoise=True)
    r.image(denoise=True)
    mat = dataclasses.replace(r.scene.materials[0], albedo=(0.9, 0.1, 0.1))
    r.scene.update_material(0, mat)
    r.step()
    assert r._gbuffers == {}
    li = next(i for i, m in enumerate(r.scene.materials)
              if m.emission_power > 0)
    m = r.scene.materials[li]
    r.scene.update_material(
        li, dataclasses.replace(m, emission_power=m.emission_power * 8))
    # The preview applies the pending edit itself.
    assert r.preview_image(scale=2, denoise=False).mean() > b.mean() * 1.5


def test_preview_matches_jax():
    jr = _jax()
    jr.step()
    want = jr.preview_image(scale=2, denoise=False, upscale=False)
    r = _port()
    r.step()
    got = r.preview_image(scale=2, denoise=False, upscale=False)
    assert got.shape == want.shape == (H // 2, W // 2, 3)
    flipped = np.abs(got - want).max(axis=-1) > PIXEL_ATOL
    print(f"preview: {int(flipped.sum())} flipped pixels of {flipped.size}")
    assert flipped.mean() <= MAX_FLIPPED
