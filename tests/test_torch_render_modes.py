"""The port's integrator branches beyond the default configuration, each
against the JAX package's (accel="bvh") at 20x14 over 2 frames: dielectric
refraction with dispersion, the non-MIS and light-sampling-only
estimators, no direct lighting, Russian roulette (depth > 3), and a scene
without lights. Same tolerance as test_torch_render.py: 1e-4 per pixel,
at most 1% flipped pixels (printed). The image is not square, so no wall
diagonal runs through pixel centers (see test_torch_render.py). Both
sides use the numpy builder."""

import numpy as np
import pytest
import torch

import raytracer_tpu.accel.native_builder as jnative
import raytracer_tpu.scene.model as jmodel
import raytracer_tpu_torch.accel.native_builder as tnative
import raytracer_tpu_torch.scene.model as tmodel
from raytracer_tpu.api import ProgressiveRenderer as JaxRenderer
from raytracer_tpu.utils.config import RenderConfig as JaxConfig
from raytracer_tpu_torch.api import ProgressiveRenderer
from raytracer_tpu_torch.utils.config import RenderConfig

torch.set_num_threads(1)  # see test_torch_ops.py

WIDTH, HEIGHT, FRAMES = 20, 14, 2


@pytest.fixture(autouse=True)
def numpy_builders(monkeypatch):
    monkeypatch.setattr(jnative, "available", lambda: False)
    monkeypatch.setattr(tnative, "available", lambda: False)


def _glass_box(model):
    """The Cornell box with its metal sphere turned into dispersive glass."""
    s = model.create_cornell_box()
    i = next(k for k, m in enumerate(s.materials) if m.name == "metallic")
    s.materials[i] = model.Material(
        name="glass", albedo=(0.95, 0.95, 0.95), roughness=0.0,
        transmission=1.0, ior=1.5, dispersion=0.6)
    return s


def _dark_box(model):
    """The Cornell box with every emitter switched off: no lights."""
    s = model.create_cornell_box()
    for k, m in enumerate(s.materials):
        if m.emission_power > 0:
            s.materials[k] = model.Material(name=m.name, albedo=m.albedo,
                                            roughness=m.roughness)
    return s


CASES = {
    "glass_dispersion": (_glass_box, {}),
    "glass_no_transmission": (_glass_box, dict(enable_transmission=False)),
    "no_mis": (lambda m: m.create_cornell_box(), dict(use_mis=False)),
    "light_sampling_only": (lambda m: m.create_cornell_box(),
                            dict(use_light_sampling_only=True)),
    "no_direct_lighting": (lambda m: m.create_cornell_box(),
                           dict(use_direct_lighting=False)),
    "russian_roulette": (_glass_box, dict(max_depth=6)),
    "no_lights": (_dark_box, dict(background=(0.8, 0.6, 0.4))),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_mode_matches_jax(name):
    make, cfg = CASES[name]
    want = JaxRenderer(make(jmodel), None, JaxConfig(
        width=WIDTH, height=HEIGHT, accel="bvh", stable_bake=False,
        **cfg)).render(FRAMES)
    got = ProgressiveRenderer(make(tmodel), None, RenderConfig(
        width=WIDTH, height=HEIGHT, **cfg), device="cpu").render(FRAMES)
    assert np.isfinite(got).all() and got.mean() > 0
    flipped = np.abs(got - want).max(axis=-1) > 1e-4
    print(f"{name}: {int(flipped.sum())} flipped pixels of {flipped.size}")
    assert flipped.mean() <= 0.01
