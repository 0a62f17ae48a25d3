"""The skip-link walk (ops/traverse.py), the port's accel="bvh" traversal
for trees too deep for K3/K4's stack, against the JAX package's
ops/traverse.py (the same walk) and its accel="bvh" renderer.

Tolerances: on the same bake, hit and tri identical on every ray except
rays whose hit sits on a triangle edge (u, v or 1 - u - v within 1e-5),
at most 2% of them; |Δt| <= 1e-5 where both hit; occlusion masks equal.
The port's walk tables equal the JAX bake's field for field (exact and
stable bakes). Renders: each pixel within 1e-4 of JAX accel="bvh" except
flipped pixels, at most 1%. Both packages use the numpy BVH builder.
No in-repo scene builds a binary tree deeper than 126 (binned SAH peels
groups off), so the renders lower binary_traverse.STACK_CAP instead.
"""

import dataclasses
import functools
import logging

import jax.numpy as jnp
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
from raytracer_tpu.api import ProgressiveRenderer as JaxRenderer
from raytracer_tpu.ops import traverse as jtrav
from raytracer_tpu.scene.device_scene import bake_scene as jbake
from raytracer_tpu.utils.config import RenderConfig as JaxConfig
from raytracer_tpu_torch.api import ProgressiveRenderer
from raytracer_tpu_torch.ops import binary_traverse
from raytracer_tpu_torch.ops import traverse as ttrav
from raytracer_tpu_torch.scene.device_scene import (
    bake_scene as tbake,
    from_jax_arrays,
)
from raytracer_tpu_torch.utils.config import RenderConfig

torch.set_num_threads(1)  # see test_torch_ops.py

DT = 1e-5
EDGE = 1e-5
MAX_EDGE_FLIPS = 0.02
PIXEL_ATOL = 1e-4
MAX_FLIPPED = 0.01

SCENES = {
    "cornell": (jmodel.create_cornell_box, tmodel.create_cornell_box),
    "atrium20k": (lambda: jbench.create_benchmark_atrium(20_000),
                  lambda: tbench.create_benchmark_atrium(20_000)),
}


@pytest.fixture(autouse=True)
def numpy_builders(monkeypatch):
    monkeypatch.setattr(jnative, "available", lambda: False)
    monkeypatch.setattr(tnative, "available", lambda: False)


def _fields(ds):
    return {f.name: np.asarray(getattr(ds, f.name))
            for f in dataclasses.fields(ds)
            if getattr(ds, f.name) is not None}


@functools.cache
def _bakes(name, stable=False):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "available", lambda: False)
        jds, _ = jbake(SCENES[name][0](), stable_shapes=stable)
    return jds, from_jax_arrays(_fields(jds), "cpu")


def _rays(jds, n, seed):
    """n rays made with numpy: origins in the scene's bounds, unit
    directions, per-ray t_max, a quarter of the lanes inactive, skip
    objects."""
    rng = np.random.default_rng(seed)
    lo, hi = np.asarray(jds.scene_min), np.asarray(jds.scene_max)
    o = (lo + (hi - lo) * rng.random((n, 3))).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = (rng.random(n) * np.linalg.norm(hi - lo)).astype(np.float32)
    active = rng.random(n) > 0.25
    skip = rng.integers(-1, 8, n).astype(np.int32)
    return o, d, t_max, active, skip


@pytest.mark.parametrize("name", sorted(SCENES))
@pytest.mark.parametrize("t_min", [1e-3, 0.01])
def test_closest_hits_match_jax(name, t_min):
    jds, tds = _bakes(name)
    o, d, t_max, active, _ = _rays(jds, 2048, seed=1)
    want = jtrav.intersect_bvh(jnp.asarray(o), jnp.asarray(d), jds, t_min,
                               jnp.asarray(t_max),
                               active_mask=jnp.asarray(active))
    got = ttrav.intersect_bvh(torch.from_numpy(o), torch.from_numpy(d), tds,
                              t_min, torch.from_numpy(t_max),
                              active_mask=torch.from_numpy(active))
    wt, wtri, wu, wv, whit = (np.asarray(a) for a in want)
    gt, gtri, gu, gv, ghit = (a.numpy() for a in got)
    differ = (ghit != whit) | (gtri != wtri)
    u, v = np.where(ghit, gu, wu), np.where(ghit, gv, wv)
    on_edge = np.minimum(np.minimum(u, v), 1.0 - u - v) <= EDGE
    both = ghit & whit
    print(f"{name} t_min={t_min}: {int(ghit.sum())} hits, "
          f"{int(differ.sum())} differ")
    assert ghit.sum() > 100
    assert not ghit[~active].any()
    assert on_edge[differ].all() and differ.mean() <= MAX_EDGE_FLIPS
    assert (np.abs(gt - wt)[both] <= DT).all()


@pytest.mark.parametrize("name", sorted(SCENES))
def test_occlusion_matches_jax(name):
    jds, tds = _bakes(name)
    o, d, t_max, active, skip = _rays(jds, 2048, seed=2)
    want = np.asarray(jtrav.occlusion_bvh(
        jnp.asarray(o), jnp.asarray(d), 1e-3, jnp.asarray(t_max), jds,
        jnp.asarray(skip), active_mask=jnp.asarray(active)))
    got = ttrav.occlusion_bvh(
        torch.from_numpy(o), torch.from_numpy(d), 1e-3,
        torch.from_numpy(t_max), tds, torch.from_numpy(skip),
        active_mask=torch.from_numpy(active)).numpy()
    assert 0 < got.sum() < active.sum()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("stable", [False, True])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_walk_tables_match_jax(name, stable, monkeypatch):
    """A tree too deep for K3/K4's stack gets the JAX nodes_packed and
    tris_packed (padded with the skip links rewritten past the padding on
    a stable bake); a tree that fits gets none."""
    jds, _ = _bakes(name, stable)
    plain, _ = tbake(SCENES[name][1](), device="cpu", stable_shapes=stable)
    assert plain.nodes_packed is None and plain.tris_packed is None
    monkeypatch.setattr(binary_traverse, "STACK_CAP", 3)
    tds, _ = tbake(SCENES[name][1](), device="cpu", stable_shapes=stable)
    for k in ("nodes_packed", "tris_packed"):
        np.testing.assert_array_equal(getattr(tds, k).numpy(),
                                      np.asarray(getattr(jds, k)), err_msg=k)


def test_padded_walk_terminates_everywhere():
    """Rays from outside (mostly misses) and from inside (all hits) give
    the exact bake's records on the stable bake's padded tables: no skip
    link lands in the padding (JAX test_padded_walk_terminates_everywhere).
    """
    _, exact = _bakes("cornell")
    _, padded = _bakes("cornell", stable=True)
    assert padded.nodes_packed.shape[0] > exact.nodes_packed.shape[0]
    rng = np.random.default_rng(3)
    d = rng.standard_normal((64, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    for o in (np.full((64, 3), 50.0, np.float32),
              np.zeros((64, 3), np.float32)):
        a = ttrav.intersect_bvh(torch.from_numpy(o), torch.from_numpy(d),
                                padded, 1e-3, 1e4)
        b = ttrav.intersect_bvh(torch.from_numpy(o), torch.from_numpy(d),
                                exact, 1e-3, 1e4)
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def test_walk_counts_its_steps():
    jds, tds = _bakes("cornell")
    o, d, t_max, _, _ = _rays(jds, 256, seed=4)
    ttrav.reset_counts()
    ttrav.intersect_bvh(torch.from_numpy(o), torch.from_numpy(d), tds,
                        1e-3, torch.from_numpy(t_max))
    assert ttrav.steps > 0 and ttrav.steps % ttrav.UNROLL == 0
    ttrav.reset_counts()
    assert ttrav.steps == 0


def test_refuses_a_bake_without_walk_tables():
    tds, _ = tbake(tmodel.create_cornell_box(), device="cpu")
    with pytest.raises(ValueError, match="fits K3/K4's stack"):
        ttrav.intersect_bvh(torch.zeros((64, 3)), torch.ones((64, 3)), tds,
                            1e-3, 1e4)


@functools.cache
def _jax_walk_image(w, h, frames):
    return JaxRenderer(_jax_atrium(), None, JaxConfig(
        width=w, height=h, accel="bvh", stable_bake=False)).render(frames)


def _jax_atrium():
    return jbench.create_benchmark_atrium(20_000)


@pytest.mark.parametrize("accel", ["bvh", "cuda"])
def test_deep_tree_renders_like_jax_walk(accel, monkeypatch, caplog):
    """accel="bvh", and accel="cuda" falling back to it (a 4-wide stack
    need past CAP), trace a tree that fails stack_fits with the walk, and
    match JAX accel="bvh" (the same walk) on the 20k atrium."""
    monkeypatch.setattr(binary_traverse, "STACK_CAP", 8)
    if accel == "cuda":
        monkeypatch.setattr(tapi, "CAP", 1)
    with caplog.at_level(logging.WARNING, logger=tapi.__name__):
        r = ProgressiveRenderer(tbench.create_benchmark_atrium(20_000), None,
                                RenderConfig(width=24, height=16,
                                             accel=accel),
                                device="cpu")
    assert r.config.accel == "bvh"
    assert not binary_traverse.stack_fits(r.device_scene.bvh_max_depth)
    assert "skip-link walk" in caplog.text
    ttrav.reset_counts()
    got = r.render(2)
    assert ttrav.steps > 0
    want = _jax_walk_image(24, 16, 2)
    flipped = np.abs(got - want).max(axis=-1) > PIXEL_ATOL
    print(f"atrium20k 24x16 x2 via the walk ({accel}): {int(flipped.sum())} "
          f"flipped of {flipped.size}")
    assert flipped.mean() <= MAX_FLIPPED
