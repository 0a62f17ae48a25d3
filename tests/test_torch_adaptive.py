"""Adaptive sampling in the port (integrator/adaptive.py, api.py).

Within the port, tol 0 is bit-equal to the plain accumulation (16x16: 256
lanes, a multiple of 64; see test_torch_wavefront_lanes.py). Against the
JAX package's adaptive_tol = 0.05 on a 16x16 Cornell box (accel="bvh" on
both sides): `count` equal on at least 99% of the pixels, and `mean`
within 1e-4 per pixel except flipped pixels, at most 1%
(test_torch_render.py's tolerance). Checkpoints with adaptive state move
between the packages with m2 and count loaded exactly. Both sides use the
numpy BVH builder."""

import functools
import logging

import numpy as np
import pytest
import torch

import raytracer_tpu.accel.native_builder as jnative
import raytracer_tpu.scene.model as jmodel
import raytracer_tpu_torch.accel.native_builder as tnative
import raytracer_tpu_torch.api as tapi
import raytracer_tpu_torch.scene.model as tmodel
from raytracer_tpu.api import ProgressiveRenderer as JaxRenderer
from raytracer_tpu.utils.config import RenderConfig as JaxConfig
from raytracer_tpu_torch.api import ProgressiveRenderer
from raytracer_tpu_torch.integrator.adaptive import (
    AdaptiveState,
    active_mask,
    render_frame_adaptive,
)
from raytracer_tpu_torch.integrator.wavefront import render_frame
from raytracer_tpu_torch.ops.camera import Camera
from raytracer_tpu_torch.utils.config import RenderConfig

torch.set_num_threads(1)  # see test_torch_ops.py

W = H = 16
PIXEL_ATOL = 1e-4
MAX_FLIPPED = 0.01
TOL_CFG = dict(adaptive_tol=0.05, adaptive_min_frames=4)
STEPS = 12


@pytest.fixture(autouse=True)
def numpy_builders(monkeypatch):
    monkeypatch.setattr(jnative, "available", lambda: False)
    monkeypatch.setattr(tnative, "available", lambda: False)


def _port(w=W, h=H, **cfg):
    return ProgressiveRenderer(tmodel.create_cornell_box(), None,
                               RenderConfig(width=w, height=h, **cfg),
                               device="cpu")


def _jax(w=W, h=H, **cfg):
    return JaxRenderer(jmodel.create_cornell_box(), None, JaxConfig(
        width=w, height=h, accel="bvh", stable_bake=False, **cfg))


def _scene_ubo(**cfg):
    r = _port(**cfg)
    r.begin_frame()
    return r.device_scene, r._camera_ubo_dev, r.config


def test_tol_zero_bit_equal_plain_accumulation():
    ds, ubo, cfg = _scene_ubo(adaptive_tol=0.0)
    accum = torch.zeros((cfg.num_pixels, 3))
    st = AdaptiveState.empty(cfg.num_pixels, "cpu")
    for f in range(4):
        accum = render_frame(ds, ubo, accum, f, cfg)
        st = render_frame_adaptive(ds, ubo, st, cfg)
    assert torch.equal(accum, st.mean)
    assert (st.count == 4).all()


def test_background_pixels_converge_and_freeze():
    """Miss-only pixels have zero variance: after adaptive_min_frames they
    retire and their mean and count stop changing, while noisy pixels keep
    counting."""
    ds, ubo, cfg = _scene_ubo(adaptive_tol=1e-4, adaptive_min_frames=2)
    st = AdaptiveState.empty(cfg.num_pixels, "cpu")
    for _ in range(3):
        st = render_frame_adaptive(ds, ubo, st, cfg)
    act = active_mask(st, cfg)
    frozen = ~act
    assert frozen.any(), "zero-variance pixels should have retired"
    assert act.any(), "noisy pixels should still be sampling"
    before = st
    st = render_frame_adaptive(ds, ubo, st, cfg)
    assert torch.equal(st.mean[frozen], before.mean[frozen])
    assert torch.equal(st.count[frozen], before.count[frozen])
    assert torch.equal(st.m2[frozen], before.m2[frozen])
    assert (st.count[act] == before.count[act] + 1).all()


@functools.cache
def _jax_adaptive():
    jr = _jax(**TOL_CFG)
    for _ in range(STEPS):
        jr.step()
    return jr


def test_adaptive_matches_jax():
    jr = _jax_adaptive()
    r = _port(**TOL_CFG)
    for _ in range(STEPS):
        r.step()
    want_count = np.asarray(jr.adaptive.count).astype(np.int64)
    got_count = r.adaptive.count.numpy()
    same = got_count == want_count
    flipped = (np.abs(r.adaptive.mean.numpy() - np.asarray(jr.adaptive.mean))
               .max(axis=-1) > PIXEL_ATOL)
    print(f"count differs on {int((~same).sum())} of {same.size} pixels; "
          f"{int(flipped.sum())} flipped means; converged "
          f"{r.adaptive_converged_fraction():.4f} (JAX "
          f"{jr.adaptive_converged_fraction():.4f})")
    assert same.mean() >= 0.99
    assert flipped.mean() <= MAX_FLIPPED
    assert r.adaptive_converged_fraction() > 0.0
    assert abs(r.adaptive_converged_fraction()
               - jr.adaptive_converged_fraction()) <= 0.01
    np.testing.assert_array_equal(r.image(), r.accum.numpy().reshape(H, W, 3))


def test_checkpoints_move_between_packages(tmp_path):
    """A JAX adaptive checkpoint resumes in the port and the port's resumes
    in JAX, with mean, m2 and count loaded exactly."""
    path = str(tmp_path / "a.npz")
    jr = _jax_adaptive()
    jr.save_checkpoint(path)
    r = _port(**TOL_CFG)
    r.load_checkpoint(path)
    assert r.frame == STEPS
    np.testing.assert_array_equal(r.adaptive.mean.numpy(),
                                  np.asarray(jr.adaptive.mean))
    np.testing.assert_array_equal(r.adaptive.m2.numpy(),
                                  np.asarray(jr.adaptive.m2))
    np.testing.assert_array_equal(r.adaptive.count.numpy(),
                                  np.asarray(jr.adaptive.count))
    assert r.adaptive.count.dtype == torch.int64
    assert r.adaptive_converged_fraction() == jr.adaptive_converged_fraction()
    r.step()
    r.save_checkpoint(path)
    data = np.load(path)
    assert data["adaptive_count"].dtype == np.uint32
    assert "adaptive_mean" not in data  # the mean is accum
    jr2 = _jax(**TOL_CFG)
    jr2.load_checkpoint(path)
    assert jr2.frame == STEPS + 1
    for field in ("mean", "m2", "count"):
        np.testing.assert_array_equal(
            np.asarray(getattr(jr2.adaptive, field)),
            getattr(r.adaptive, field).numpy(), err_msg=field)


def test_plain_checkpoint_into_adaptive_keeps_sampling(tmp_path, caplog):
    """A plain checkpoint has no variance history: m2 seeds to +inf, a
    warning is logged and nothing retires."""
    path = str(tmp_path / "plain.npz")
    rp = _port(8, 8)
    rp.render(9)  # past adaptive_min_frames
    rp.save_checkpoint(path)
    ra = _port(8, 8, adaptive_tol=0.5)
    with caplog.at_level(logging.WARNING, logger=tapi.__name__):
        ra.load_checkpoint(path)
    assert "no variance history" in caplog.text
    assert torch.isinf(ra.adaptive.m2).all()
    assert (ra.adaptive.count == 9).all()
    assert torch.equal(ra.adaptive.mean, rp.accum)
    assert ra.adaptive_converged_fraction() == 0.0
    ra.step()
    assert (ra.adaptive.count == 10).all()
    assert ra.adaptive_converged_fraction() == 0.0


def test_converged_fraction_and_reset_with_accumulation():
    """0.0 without adaptive sampling; a camera change restarts the Welford
    state with the accumulation."""
    assert _port(8, 8).adaptive_converged_fraction() == 0.0
    r = _port(8, 8, adaptive_tol=0.1)
    r.step()
    r.step()
    assert (r.adaptive.count == 2).all()
    assert r.frame == 2
    r.set_camera(Camera.create(position=(0.1, 0.0, -3.0), aspect=1.0))
    r.step()
    assert (r.adaptive.count == 1).all()
    assert r.frame == 1


def test_restir_and_adaptive_are_exclusive():
    with pytest.raises(ValueError, match="mutually exclusive"):
        _port(8, 8, adaptive_tol=0.1, use_restir=True)
