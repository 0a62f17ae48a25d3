"""Deep-bounce compaction and the lane sorts of the port's integrator
(integrator/wavefront.py: `_compact_prefix`, `_sort_wavefront`,
`_part_affinity`, `_occluded_sorted` and render_wavefront's compacted loop)
against the JAX package's.

Tolerances: the prefix schedule, the sort permutations and the part
affinities equal JAX's exactly; the sorted shadow-ray masks equal JAX's
`_occluded_pallas_sorted` (interpret mode) on every lane; within the port,
compact_deep=True renders bit for bit the image of compact_deep=False
(plain, adaptive and spp-batched); against JAX's compacted pallas render
each pixel is within 1e-4 except flipped pixels (an edge hit that fell the
other way, test_torch_render.py), at most 1% of them. Lane counts are
multiples of 64 (test_torch_wavefront_lanes.py says why). Both packages
use the numpy BVH builder.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracer_tpu.accel.native_builder as jnative
import raytracer_tpu.scene.model as jmodel
import raytracer_tpu_torch.accel.native_builder as tnative
import raytracer_tpu_torch.scene.model as tmodel
from raytracer_tpu.api import ProgressiveRenderer as JaxRenderer
from raytracer_tpu.integrator import wavefront as jwave
from raytracer_tpu.scene.device_scene import bake_scene as jbake
from raytracer_tpu.utils.config import RenderConfig as JaxConfig
from raytracer_tpu_torch.api import ProgressiveRenderer
from raytracer_tpu_torch.integrator import wavefront as twave
from raytracer_tpu_torch.scene.device_scene import from_jax_arrays
from raytracer_tpu_torch.utils.config import RenderConfig

torch.set_num_threads(1)  # see test_torch_ops.py

PIXEL_ATOL = 1e-4
MAX_FLIPPED = 0.01
BUDGETS = {"one_part": None, "parts": 256 * 1024, "many_parts": 96 * 1024}


@pytest.fixture(autouse=True)
def numpy_builders(monkeypatch):
    monkeypatch.setattr(jnative, "available", lambda: False)
    monkeypatch.setattr(tnative, "available", lambda: False)


def _fields(ds):
    return {f.name: np.asarray(getattr(ds, f.name))
            for f in dataclasses.fields(ds)
            if getattr(ds, f.name) is not None}


@pytest.fixture(scope="module", params=sorted(BUDGETS))
def bakes(request):
    """(JAX bake, the port's DeviceScene of the same arrays) of the Cornell
    box, one part or cut at a budget."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "available", lambda: False)
        jds, _ = jbake(jmodel.create_cornell_box(), stable_shapes=False,
                       pallas_budget_bytes=BUDGETS[request.param])
    return jds, from_jax_arrays(_fields(jds), "cpu")


def _rays(jds, n, seed, outside=0):
    """n rays made with numpy: origins in the scene's bounds (the last
    `outside` far outside, pointing away), unit directions, a third of the
    lanes dead."""
    rng = np.random.default_rng(seed)
    lo, hi = np.asarray(jds.scene_min), np.asarray(jds.scene_max)
    o = (lo + (hi - lo) * rng.random((n, 3))).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    if outside:
        o[-outside:] = hi + 50.0
        d[-outside:] = np.abs(d[-outside:])
    alive = rng.random(n) > 1 / 3
    return o, d, alive


def _states(jds, n, seed):
    """The same wavefront as the JAX and the port's WavefrontState."""
    rng = np.random.default_rng(seed + 1)
    o, d, alive = _rays(jds, n, seed)
    f32 = {k: rng.random(shape).astype(np.float32) for k, shape in (
        ("color", (n, 3)), ("throughput", (n, 3)), ("prev_brdf_pdf", (n,)),
        ("prev_hit_pos", (n, 3)), ("p_sample_light", (n,)))}
    bits = {k: rng.random(n) > 0.5
            for k in ("first_bounce", "is_specular", "did_direct")}
    seeds = {k: rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
             for k in ("seed_rgen", "seed")}
    fields = dict(origin=o, direction=d, alive=alive,
                  channel=rng.integers(-1, 3, n).astype(np.int32),
                  pixel=np.arange(n, dtype=np.int32), **f32, **bits, **seeds)
    jstate = jwave.WavefrontState(**{k: jnp.asarray(v)
                                     for k, v in fields.items()})
    fields.update({k: v.astype(np.int64) for k, v in seeds.items()})
    tstate = twave.WavefrontState(**{k: torch.from_numpy(v)
                                     for k, v in fields.items()})
    return jstate, tstate


def test_compact_prefix_schedule():
    """The JAX schedule (tests/test_integrator.py), and the port's k equal
    to JAX's for every depth, decay and size."""
    cfg = RenderConfig(width=64, height=64, max_depth=8)
    n = 2_073_600
    assert twave._compact_prefix(n, 0, cfg) is None
    assert twave._compact_prefix(n, cfg.rr_start_depth, cfg) is None
    ks = [twave._compact_prefix(n, d, cfg) for d in range(4, 8)]
    assert all(k is not None and k % 1024 == 0 and k < n for k in ks)
    assert ks == sorted(ks, reverse=True)
    assert twave._compact_prefix(1024, 6, cfg) is None
    for decay in (0.25, 0.5, 0.75, 0.9):
        for size in (1024, 2048, 4096, 8192, 100_000, n):
            for depth in range(10):
                want = jwave._compact_prefix(
                    size, depth, JaxConfig(compact_decay=decay))
                got = twave._compact_prefix(
                    size, depth, RenderConfig(compact_decay=decay))
                assert got == want, (decay, size, depth)


def test_sort_wavefront_matches_jax(bakes):
    """The permutation (the JAX sort carries it in `pixel`) and every
    field, on one-part and multi-part bakes (the part-affinity key)."""
    jds, tds = bakes
    jstate, tstate = _states(jds, 2048, seed=11)
    want = jwave._sort_wavefront(jstate, jds)
    got, perm = twave._sort_wavefront(tstate, tds)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(want.pixel))
    for f in twave.WavefrontState._fields:
        np.testing.assert_array_equal(
            getattr(got, f).numpy(),
            np.asarray(getattr(want, f)).astype(
                getattr(got, f).numpy().dtype), err_msg=f)


@pytest.mark.parametrize("num_bits", [2, 3, 4])
def test_part_affinity_matches_jax(num_bits):
    """The part each ray enters first, the rays that miss every part in
    the top bucket, at each key width the sorts use."""
    jds, _ = jbake(jmodel.create_cornell_box(), stable_shapes=False,
                   pallas_budget_bytes=96 * 1024)
    tds = from_jax_arrays(_fields(jds), "cpu")
    o, d, _ = _rays(jds, 1024, seed=5, outside=128)
    want = np.asarray(jwave._part_affinity(jds, jnp.asarray(o),
                                           jnp.asarray(d), num_bits))
    got = twave._part_affinity(tds, torch.from_numpy(o), torch.from_numpy(d),
                               num_bits)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    top = (1 << num_bits) - 1
    assert (want[-128:] == top).all()
    assert len(np.unique(want)) > 2


def test_occluded_sorted_matches_jax(bakes):
    """The sorted shadow rays' mask against the JAX
    `_occluded_pallas_sorted` (its kernel in interpret mode), and against
    the unsorted `_occluded`: the sort is a pure permutation."""
    jds, tds = bakes
    n = 256
    o, d, active = _rays(jds, n, seed=7)
    rng = np.random.default_rng(8)
    t_max = (rng.random(n) * 2.0).astype(np.float32)
    skip = rng.integers(-1, jds.num_objects, n).astype(np.int32)
    jcfg = JaxConfig(accel="pallas")
    want = np.asarray(jwave._occluded_pallas_sorted(
        jds, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max),
        jnp.asarray(skip), jcfg, jnp.asarray(active)))
    cfg = RenderConfig().resolve_accel()
    args = (tds, torch.from_numpy(o), torch.from_numpy(d),
            torch.from_numpy(t_max), torch.from_numpy(skip), cfg,
            torch.from_numpy(active))
    got = twave._occluded_sorted(*args).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, twave._occluded(*args).numpy())
    assert 0 < got.sum() < active.sum()


def _render(cfg, frames, scene=None):
    """The port's image on the CPU (of the Cornell box by default), and each
    bounce's lane count."""
    sizes = []
    bounce = twave.path_bounce

    def counted(scene, state, depth, cfg, clear_color):
        sizes.append((depth, state.alive.shape[0]))
        return bounce(scene, state, depth, cfg, clear_color)

    twave.path_bounce = counted
    try:
        img = ProgressiveRenderer(scene or tmodel.create_cornell_box(), None,
                                  cfg, device="cpu").render(frames)
    finally:
        twave.path_bounce = bounce
    return img, sizes


@pytest.mark.parametrize("mode", [
    dict(),
    dict(adaptive_tol=0.5, adaptive_min_frames=1),
    dict(spp_batch=2),
])
def test_compaction_is_bit_exact(mode):
    """compact_deep=True runs the deep bounces on JAX's prefixes and
    renders bit for bit the image of compact_deep=False: plain, under an
    active mask (adaptive sampling, sorted from depth 0) and spp-batched."""
    base = RenderConfig(width=64, height=64, max_depth=6, **mode)
    frames = 4 if mode.get("adaptive_tol") else 2
    on, on_sizes = _render(base, frames)
    off, off_sizes = _render(base.replace(compact_deep=False), frames)
    full = 64 * 64 * base.spp_batch
    compacted = [(d, k) for d, k in on_sizes if k < full]
    print(f"{mode}: compacted bounces (depth, lanes) {compacted}")
    assert compacted and all(d > base.rr_start_depth for d, _ in compacted)
    assert all(k == full for _, k in off_sizes)
    np.testing.assert_array_equal(on, off)


def test_an_overflowing_bounce_runs_on_an_earlier_prefix():
    """Where more lanes are alive than a bounce's prefix holds, the bounce
    runs on the prefix of the latest earlier bounce that holds them, and
    full size only where none does (JAX runs it full size). The numbers
    are a 1080p frame of the glass atrium at depth 8 on the H100, whose
    686,313 live lanes at depth 7 overflow its 656,384-lane prefix."""
    cfg = RenderConfig(width=1920, height=1080, max_depth=8)
    n = 2_073_600
    ks = {d: twave._compact_prefix(n, d, cfg) for d in range(4, 8)}
    assert ks == {4: 1_555_456, 5: 1_167_360, 6: 875_520, 7: 656_384}
    assert twave._compact_prefix(n, 7, cfg, 656_384) == 656_384
    assert twave._compact_prefix(n, 7, cfg, 686_313) == 875_520
    assert twave._compact_prefix(n, 7, cfg, 1_167_361) == 1_555_456
    assert twave._compact_prefix(n, 7, cfg, 1_555_457) is None
    assert twave._compact_prefix(n, 4, cfg, 1_555_457) is None
    assert twave._compact_prefix(n, 3, cfg, 0) is None


def test_an_overflowing_bounce_is_bit_exact():
    """The Cornell box with its metal sphere as glass, whose paths live
    long: depth 3's live lanes overflow its 1024-lane prefix and run on
    depth 2's 2048, and the image is compact_deep=False's bit for bit."""
    scene = tmodel.create_cornell_box()
    i = next(k for k, m in enumerate(scene.materials)
             if m.name == "metallic")
    scene.materials[i] = tmodel.Material(
        name="flint", albedo=(0.97, 0.97, 0.97), transmission=1.0,
        ior=1.7847, dispersion=20.0 / 25.8)
    cfg = RenderConfig(width=128, height=64, max_depth=5, rr_start_depth=1,
                       compact_decay=0.2)
    assert twave._compact_prefix(128 * 64, 3, cfg) == 1024
    on, on_sizes = _render(cfg, 1, scene)
    off, _ = _render(cfg.replace(compact_deep=False), 1, scene)
    assert (3, 2048) in on_sizes
    np.testing.assert_array_equal(on, off)


def test_compaction_keeps_ray_counts():
    """with_stats' counts of the compacted loop equal the uncompacted
    loop's (excluded lanes are dead)."""
    cfg = RenderConfig(width=64, height=64, max_depth=6)
    r = ProgressiveRenderer(tmodel.create_cornell_box(), None, cfg,
                            device="cpu")
    r.begin_frame()
    out = {}
    for compact in (True, False):
        _, stats = twave.render_wavefront(
            r.device_scene, r._camera_ubo_dev, 1,
            cfg.replace(compact_deep=compact), with_stats=True)
        out[compact] = {k: int(v) for k, v in stats.items()}
    assert out[True] == out[False]


def test_default_depth_runs_no_sort(monkeypatch):
    """The default depth-3 path neither sorts nor compacts."""
    def refuse(*a, **k):
        raise AssertionError("the depth-3 path sorted its lanes")

    monkeypatch.setattr(twave, "_sort_wavefront", refuse)
    assert not twave.deep_compacts(RenderConfig())
    ProgressiveRenderer(tmodel.create_cornell_box(), None,
                        RenderConfig(width=16, height=16),
                        device="cpu").render(1)


def test_compacted_render_matches_jax_pallas():
    """The compacted render against JAX's compacted pallas render
    (interpret mode): 64x32 lanes, decay 0.25 so that bounce 4 runs on a
    1024-lane prefix."""
    kw = dict(width=64, height=32, max_depth=5, compact_decay=0.25)
    assert twave._compact_prefix(64 * 32, 4, RenderConfig(**kw)) == 1024
    want = JaxRenderer(jmodel.create_cornell_box(), None, JaxConfig(
        accel="pallas", stable_bake=False, **kw)).render(2)
    got, sizes = _render(RenderConfig(**kw), 2)
    assert (4, 1024) in sizes
    flipped = np.abs(got - want).max(axis=-1) > PIXEL_ATOL
    print(f"compacted cornell 64x32 x2: {int(flipped.sum())} flipped pixels "
          f"of {flipped.size}")
    assert flipped.mean() <= MAX_FLIPPED
