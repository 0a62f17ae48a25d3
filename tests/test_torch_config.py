"""The port's accel values: every JAX value (auto, pallas, bvh, brute) is
accepted, plus the port's own "cuda"; "pallas" resolves to "cuda" (the
same 4-wide tree and kernels) in RenderConfig, in the CLI's parser, and in
a render, which equals the "cuda" render bit for bit."""

import numpy as np
import pytest
import torch

import raytracer_tpu.utils.config as jconfig
import raytracer_tpu_torch.accel.native_builder as tnative
import raytracer_tpu_torch.scene.model as tmodel
from raytracer_tpu_torch import cli
from raytracer_tpu_torch.api import render
from raytracer_tpu_torch.integrator import wavefront
from raytracer_tpu_torch.utils.config import RenderConfig

torch.set_num_threads(1)  # see test_torch_ops.py

JAX_ACCELS = ("auto", "pallas", "bvh", "brute")


def test_config_takes_every_jax_accel():
    for accel in JAX_ACCELS:
        jconfig.RenderConfig(accel=accel)  # the JAX package's own values
        RenderConfig(accel=accel)
    assert RenderConfig(accel="pallas").resolve_accel().accel == "cuda"
    assert RenderConfig(accel="auto").resolve_accel().accel == "cuda"
    assert RenderConfig(accel="bvh").resolve_accel().accel == "bvh"
    with pytest.raises(ValueError, match="accel"):
        RenderConfig(accel="tpu")


def test_cli_parses_every_jax_accel():
    parser = cli.build_parser()
    for accel in (*JAX_ACCELS, "cuda"):
        assert parser.parse_args(["scene.json", "--accel", accel]).accel \
            == accel
    with pytest.raises(SystemExit):
        parser.parse_args(["scene.json", "--accel", "tpu"])


def test_pallas_renders_as_cuda(monkeypatch):
    """16x16, 2 frames of the Cornell box on the CPU: accel="pallas" runs
    the 4-wide tree's walk (ops/quad_traverse.py, here its plain version),
    and its image equals accel="cuda"'s bit for bit."""
    monkeypatch.setattr(tnative, "available", lambda: False)
    calls = []
    quad = wavefront.intersect_quad
    monkeypatch.setattr(wavefront, "intersect_quad",
                        lambda *a, **k: calls.append(1) or quad(*a, **k))
    images = {}
    for accel in ("pallas", "cuda"):
        calls.clear()
        images[accel] = render(
            tmodel.create_cornell_box(),
            config=RenderConfig(width=16, height=16, accel=accel),
            num_frames=2, device="cpu")
        assert calls, f"accel={accel!r} did not take the 4-wide walk"
    assert np.isfinite(images["cuda"]).all() and images["cuda"].mean() > 0
    np.testing.assert_array_equal(images["pallas"], images["cuda"])
