"""spp batching (RenderConfig.spp_batch, integrator/wavefront.py
render_tile_spp_batched): S progressive samples of every pixel in one
wavefront, folded in order by the sequential formula.

Within the port, S = 2 and S = 4 are bit-equal to S sequential steps (the
image has 768 pixels, a multiple of 64; see test_torch_wavefront_lanes.py).
Against the JAX package's spp_batch = S (accel="bvh"): every pixel within
1e-4, except flipped pixels, at most 1% (test_torch_render.py's
tolerance). Both sides use the numpy BVH builder."""

import functools

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

W, H = 32, 24
PIXEL_ATOL = 1e-4
MAX_FLIPPED = 0.01


@pytest.fixture(autouse=True)
def numpy_builders(monkeypatch):
    monkeypatch.setattr(jnative, "available", lambda: False)
    monkeypatch.setattr(tnative, "available", lambda: False)


def _port(samples, **cfg):
    r = ProgressiveRenderer(tmodel.create_cornell_box(), None,
                            RenderConfig(width=W, height=H, **cfg),
                            device="cpu")
    return r.render(samples), r


@functools.cache
def _sequential():
    """Four 1-spp steps (the tests read, never write, the image)."""
    return _port(4)[0]


@pytest.mark.parametrize("s", [2, 4])
def test_spp_batch_bit_equal_sequential(s):
    seq = _sequential()
    bat, r = _port(4, spp_batch=s)
    assert r.frame == 4
    np.testing.assert_array_equal(bat, seq)
    # One launch traces the S samples' rays: S x the pixels at depth 0.
    assert int(r.last_stats["rays_traced"]) > s * W * H


@pytest.mark.parametrize("s", [2, 4])
def test_spp_batch_matches_jax(s):
    want = JaxRenderer(jmodel.create_cornell_box(), None, JaxConfig(
        width=W, height=H, accel="bvh", stable_bake=False,
        spp_batch=s)).render(4)
    got, _ = _port(4, spp_batch=s)
    flipped = np.abs(got - want).max(axis=-1) > PIXEL_ATOL
    print(f"spp_batch={s}: {int(flipped.sum())} flipped pixels of "
          f"{flipped.size}")
    assert flipped.mean() <= MAX_FLIPPED


def test_spp_batch_respects_accumulation_limit():
    r = ProgressiveRenderer(tmodel.create_cornell_box(), None, RenderConfig(
        width=16, height=16, spp_batch=2, accumulation_limit=4),
        device="cpu")
    assert r.step() and r.step()
    assert r.frame == 4
    assert not r.step()  # limit reached: frame skipped
    assert r.frame == 4


def test_render_overshoots_to_a_multiple_of_the_batch():
    """render(3) at S = 2 takes two steps and ends at frame 4, as the JAX
    renderer does, and equals 4 sequential samples."""
    img, r = _port(3, spp_batch=2)
    assert r.frame == 4
    np.testing.assert_array_equal(img, _sequential())


@pytest.mark.parametrize("extra", [["--spp", "9", "--spp-batch", "4"],
                                   ["--spp", "8", "--spp-batch", "4",
                                    "--adaptive", "0.1"],
                                   ["--spp", "8", "--spp-batch", "4",
                                    "--restir"]])
def test_cli_rejects_bad_spp_batch(tmp_path, extra, capsys):
    from raytracer_tpu_torch import cli

    with pytest.raises(SystemExit) as e:
        cli.main([str(tmp_path / "scene.json"), "--device", "cpu", "--out",
                  str(tmp_path / "x.png"), *extra])
    assert e.value.code == 2
    assert "--spp" in capsys.readouterr().err
