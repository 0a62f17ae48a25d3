"""The port's traversal lab (raytracer_tpu_torch/lab) against the JAX lab
kernels it ports, run in interpret mode on CPU: tools/kernel_lab.py (L1:
_closest_kernel_lab, _closest_kernel_multipop, make_lab_kernel),
tools/occl_lab.py (L9: _occl_kernel_lab) and tools/bvh4_lab.py (L2:
run_closest4), each wrapped in pl.pallas_call(..., interpret=True) with
the lab's own specs, as its run_* function does without `interpret`. On CPU
tensors the port runs the kernels' plain torch versions; chip_smoke.py
phase 6 holds the CUDA kernels to those on the card.

  (a) counts: in tiles in which every lane holds the same ray, a packet's
      counts are that ray's, so the port's per-ray nvisit/nleaf must equal
      them exactly;
  (b) hit records: a tile of random rays in the same call; tri and hit
      identical, |dt| <= 1e-5 (XLA and torch round a few terms apart). L2 on
      the Cornell box's camera rays, where shared edges make exact-t ties,
      which are counted and bounded;
  (c) the wavefront sort's permutation equals the JAX one;
  (d) the lab's NEE shadow batches equal occl_lab.shadow_rays_at's within
      1e-5, apart from lanes where a lottery or a shared edge fell the
      other way (bounded).
"""

import dataclasses
import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from raytracer_tpu.ops.pallas_traverse import STACK_CAP, TILE_L, TILE_S
from raytracer_tpu_torch.lab import bvh4_lab, kernel_lab, occl_lab
from raytracer_tpu_torch.lab import rays as lab_rays
from tests.conftest import make_traversal_scene
from tools import bvh4_lab as jbvh4
from tools import kernel_lab as jkl
from tools import occl_lab as jol

torch.set_num_threads(1)  # see test_torch_ops.py

DT = 1e-5
ONE_RAY_TILES = 10


def _port_scene(js):
    """The port's view of a conftest traversal scene."""
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    return SimpleNamespace(
        pnodes=t(js.pnodes), ptris=t(js.ptris), qnodes=t(js.qnodes),
        qmeta=t(js.qmeta), binary_root=int(np.asarray(js.root_meta)[0]),
        root=int(np.asarray(js.qroot)[0]), bvh_max_depth=int(js.bvh_max_depth),
        q_stack_need=int(js.q_stack_need), scene_min=t(js.scene_min),
        scene_max=t(js.scene_max))


def _scene(leaf_size, seed=3):
    rng = np.random.default_rng(seed)
    t = 160
    v0 = rng.uniform(-3, 3, (t, 3)).astype(np.float32)
    e1 = rng.uniform(-1, 1, (t, 3)).astype(np.float32)
    e2 = rng.uniform(-1, 1, (t, 3)).astype(np.float32)
    obj = rng.integers(0, 12, t).astype(np.int32)
    js = make_traversal_scene(v0, e1, e2, tri_object=obj, leaf_size=leaf_size)
    return js, _port_scene(js)


def _rays(tile, seed=4):
    """ONE_RAY_TILES rays aimed into the scene (t_max 1e4, each later given
    a tile of its own), then `tile` random rays (random t_max, a fifth
    inactive, random skip objects) that fill one tile. Returns (origin,
    direction, t_max, skip) over all rays."""
    rng = np.random.default_rng(seed)
    m = ONE_RAY_TILES + tile
    o = rng.uniform(-4, 4, (m, 3)).astype(np.float32)
    target = rng.uniform(-1.5, 1.5, (m, 3)).astype(np.float32)
    d = np.where(np.arange(m)[:, None] < ONE_RAY_TILES, target - o,
                 rng.normal(size=(m, 3))).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tm = rng.uniform(0.5, 9.0, m).astype(np.float32)
    tm[rng.uniform(size=m) < 0.2] = 1e-3
    tm[:ONE_RAY_TILES] = 1e4
    skip = rng.integers(-1, 12, m).astype(np.int32)
    return o, d, tm, skip


def _tiles(a, rows):
    """[ONE_RAY_TILES + 1, rows, TILE_L]: a tile per one-ray lane, each lane
    the same value, then the random rays in the last tile."""
    one = np.broadcast_to(a[:ONE_RAY_TILES, None, None],
                          (ONE_RAY_TILES, rows, TILE_L))
    rest = a[ONE_RAY_TILES:].reshape(1, rows, TILE_L)
    return jnp.asarray(np.concatenate([one, rest]))


def _lanes(a, rows):
    """Per-ray values back from tiles: lane 0 of each one-ray tile, then the
    random tile."""
    a = np.asarray(a)
    return np.concatenate([a[:ONE_RAY_TILES, 0, 0],
                           a[ONE_RAY_TILES].reshape(rows * TILE_L)])


def _outputs(outs, rows):
    """Per-ray outputs of a lab call (the random tile's counters are its
    packet's, so only the one-ray tiles' counts are kept)."""
    *ray_outs, nvisit, nleaf = outs
    return ([_lanes(a, rows) for a in ray_outs]
            + [np.asarray(c)[:ONE_RAY_TILES, 0, 0] for c in (nvisit, nleaf)])


def _jax_lab(kern, rows, ray_tiles, n_ray_outs, js):
    """A lab kernel body in pl.pallas_call(..., interpret=True) with the
    labs' specs: ray tiles of `rows` x TILE_L, the root in SMEM, the tree
    and leaves whole, per-packet counters of (8, TILE_L)."""
    n_tiles = ray_tiles[0].shape[0]
    spec = pl.BlockSpec((1, rows, TILE_L), lambda i: (i, 0, 0),
                        memory_space=pltpu.VMEM)
    # closest hit: t, tri, u, v; occlusion: occ
    dtypes = ([jnp.float32, jnp.int32, jnp.float32, jnp.float32]
              if n_ray_outs == 4 else [jnp.int32])
    out_shape = [jax.ShapeDtypeStruct((n_tiles, rows, TILE_L), dt)
                 for dt in dtypes]
    out_shape += [jax.ShapeDtypeStruct((n_tiles, 8, TILE_L), jnp.int32)] * 2
    return pl.pallas_call(
        kern, grid=(n_tiles,),
        in_specs=[spec] * len(ray_tiles) + [jkl._SMEM1, jkl._FULL, jkl._FULL],
        out_specs=[spec] * n_ray_outs + [jkl._CNT_SPEC] * 2,
        out_shape=out_shape,
        scratch_shapes=[pltpu.SMEM((STACK_CAP,), jnp.int32)],
        interpret=True,
    )(*ray_tiles, js.root_meta, js.pnodes, js.ptris)


def _check_counts(want_nv, want_nl, got_nv, got_nl):
    n = ONE_RAY_TILES
    print(f"one-ray tiles: JAX nvisit {want_nv[:n].tolist()} nleaf "
          f"{want_nl[:n].tolist()}")
    np.testing.assert_array_equal(got_nv[:n], want_nv[:n])
    np.testing.assert_array_equal(got_nl[:n], want_nl[:n])
    assert want_nv[:n].max() > 3 and want_nl[:n].max() > 0


@pytest.mark.parametrize("variant,leaf_size", [
    ("base", 16), ("nored", 8), ("leafilp", 16), ("pop2", 8), ("pop4", 16),
    ("ts8", 8)])
def test_closest_lab_matches_jax(variant, leaf_size):
    js, ps = _scene(leaf_size)
    rows = 8 if variant == "ts8" else TILE_S
    o, d, tm, _ = _rays(rows * TILE_L)
    tiles = ([_tiles(o[:, c], rows) for c in range(3)]
             + [_tiles(d[:, c], rows) for c in range(3)] + [_tiles(tm, rows)])
    if variant == "ts8":
        kern = jkl.make_lab_kernel(leaf_size, rows)
    elif variant.startswith("pop"):
        kern = functools.partial(jkl._closest_kernel_multipop, leaf_size,
                                 int(variant[3:]))
    else:
        kern = functools.partial(jkl._closest_kernel_lab, leaf_size, variant)
    want = _outputs(_jax_lab(kern, rows, tiles, 4, js), rows)
    args = (torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(tm),
            ps)
    if variant == "ts8":
        got = kernel_lab.run_closest_ts(*args, block=64)
    else:
        got = kernel_lab.run_closest_lab(*args, variant)
    got = [g.numpy() for g in got]
    _check_counts(want[4], want[5], got[4], got[5])
    np.testing.assert_array_equal(got[1], want[1])
    assert np.abs(got[0] - want[0]).max() <= DT
    hit = want[1] >= 0
    assert 100 < hit.sum() < len(hit)
    np.testing.assert_allclose(got[2][hit], want[2][hit], atol=1e-4)
    np.testing.assert_allclose(got[3][hit], want[3][hit], atol=1e-4)


@pytest.mark.parametrize("variant,leaf_size", [
    ("base", 8), ("lean", 16), ("noorder", 8)])
def test_occl_lab_matches_jax(variant, leaf_size):
    js, ps = _scene(leaf_size)
    o, d, tm, skip = _rays(TILE_S * TILE_L)
    tiles = ([_tiles(o[:, c], TILE_S) for c in range(3)]
             + [_tiles(d[:, c], TILE_S) for c in range(3)]
             + [_tiles(tm, TILE_S), _tiles(skip, TILE_S)])
    kern = functools.partial(jol._occl_kernel_lab, leaf_size, variant)
    want = _outputs(_jax_lab(kern, TILE_S, tiles, 1, js), TILE_S)
    got = [g.numpy() for g in occl_lab.run_occl_lab(
        torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(tm),
        torch.from_numpy(skip), ps, variant)]
    _check_counts(want[1], want[2], got[1], got[2])
    np.testing.assert_array_equal(got[0], want[0] > 0)
    assert 50 < got[0].sum() < len(o) - 50


@pytest.mark.parametrize("leaf_size", [8, 16])
def test_lab_variants_agree_per_ray(leaf_size):
    """Per ray, base and nored are one kernel, leafilp equals the serial
    leaf, L1b's result does not depend on the block, and resort equals
    lean: the outputs (counts included) are identical. The multi-pop
    variants find the same hits by another visit order."""
    _, ps = _scene(leaf_size)
    o, d, tm, skip = (torch.from_numpy(a) for a in _rays(2048, seed=9))
    base = kernel_lab.run_closest_lab(o, d, tm, ps, "base")
    for variant in ("nored", "leafilp"):
        for g, b in zip(kernel_lab.run_closest_lab(o, d, tm, ps, variant),
                        base):
            assert torch.equal(g, b), variant
    for block in kernel_lab.BLOCKS:
        for g, b in zip(kernel_lab.run_closest_ts(o, d, tm, ps, block), base):
            assert torch.equal(g, b), block
    for variant in ("pop2", "pop4"):
        got = kernel_lab.run_closest_lab(o, d, tm, ps, variant)
        assert torch.equal(got[1], base[1]) and torch.equal(got[0], base[0])
        assert int(got[4].sum()) != int(base[4].sum())
    lean = occl_lab.run_occl_lab(o, d, tm, skip, ps, "lean")
    resort = occl_lab.run_occl_lab(o, d, tm, skip, ps, "resort")
    for g, b in zip(resort, lean):
        assert torch.equal(g, b)
    perm = occl_lab.resort_perm(o, tm, ps)
    key = lab_rays.resort_key(o, tm > 1e-3, ps)[perm]
    assert not torch.equal(perm, torch.arange(len(perm)))
    assert bool((key[1:] >= key[:-1]).all())


def test_lab_refuses_what_its_kernels_do_not_take(monkeypatch):
    """leafilp's kernel exists for leaf 8 and 16; a multi-pop walk needs
    npop x (depth + 2) stack entries; unknown names and blocks are
    refused."""
    _, ps = _scene(8)
    o, d, tm, skip = (torch.from_numpy(a) for a in _rays(2048))
    with pytest.raises(ValueError, match="variant"):
        kernel_lab.run_closest_lab(o, d, tm, ps, "pop3")
    with pytest.raises(ValueError, match="variant"):
        occl_lab.run_occl_lab(o, d, tm, skip, ps, "ordered")
    with pytest.raises(ValueError, match="block"):
        kernel_lab.run_closest_ts(o, d, tm, ps, 96)
    deep = SimpleNamespace(**{**vars(ps), "bvh_max_depth": 40})
    kernel_lab.run_closest_lab(o[:8], d[:8], tm[:8], deep, "pop2")
    with pytest.raises(ValueError, match="stack"):
        kernel_lab.run_closest_lab(o, d, tm, deep, "pop4")
    monkeypatch.setattr(kernel_lab, "ILP_LEAVES", (16,))
    with pytest.raises(ValueError, match="leaf"):
        kernel_lab.run_closest_lab(o, d, tm, ps, "leafilp")


def test_cpu_tensors_take_the_plain_versions(monkeypatch):
    """CPU tensors run the plain versions and count no launch."""
    _, ps = _scene(8)
    o, d, tm, skip = (torch.from_numpy(a) for a in _rays(2048))

    def refuse(*a, **k):
        raise AssertionError("CUDA wrapper called for CPU tensors")

    for mod, name in ((kernel_lab, "_closest_lab_cuda"),
                      (occl_lab, "_occl_lab_cuda"),
                      (bvh4_lab, "_closest4_cuda")):
        monkeypatch.setattr(mod, name, refuse)
        mod.reset_launch_counts()
    kernel_lab.run_closest_lab(o, d, tm, ps, "pop2")
    kernel_lab.run_closest_ts(o, d, tm, ps, 128)
    occl_lab.run_occl_lab(o, d, tm, skip, ps, "resort")
    bvh4_lab.run_closest4(o, d, tm, ps, ordered=False)
    assert (kernel_lab.closest_launches, kernel_lab.closest_ts_launches,
            occl_lab.occlusion_launches, bvh4_lab.closest4_launches) == (
                0, 0, 0, 0)


# --------------------------------------------------------------------------
# The Cornell box: L2 on shared edges, the sort and the shadow batches.
# --------------------------------------------------------------------------

W = H = 16


@pytest.fixture(scope="module")
def cornell():
    """The JAX bake of the Cornell box, the port's DeviceScene of the same
    arrays, both packages' camera UBOs and configs."""
    import raytracer_tpu.accel.native_builder as jnative
    from raytracer_tpu.ops.camera import Camera as JaxCamera
    from raytracer_tpu.scene.device_scene import bake_scene
    from raytracer_tpu.scene.model import create_cornell_box
    from raytracer_tpu.utils.config import RenderConfig as JaxConfig
    from raytracer_tpu_torch.scene.device_scene import from_jax_arrays
    from raytracer_tpu_torch.utils.config import RenderConfig

    orig = jnative.available
    jnative.available = lambda: False
    try:
        jds, _ = bake_scene(create_cornell_box(), stable_shapes=False)
    finally:
        jnative.available = orig
    ps = from_jax_arrays({f.name: np.asarray(getattr(jds, f.name))
                          for f in dataclasses.fields(jds)
                          if getattr(jds, f.name) is not None}, "cpu")
    mats = JaxCamera.create(position=(0.0, 0.0, -3.0), aspect=1.0).matrices()
    return SimpleNamespace(
        jds=jds, ps=ps, mats=mats,
        jubo={k: jnp.asarray(mats[k]) for k in ("inverse_view",
                                                 "inverse_proj")},
        tubo={k: torch.from_numpy(np.ascontiguousarray(mats[k]))
              for k in ("inverse_view", "inverse_proj")},
        jcfg=JaxConfig(width=W, height=H, max_depth=3, accel="bvh"),
        tcfg=RenderConfig(width=W, height=H, max_depth=3, accel="bvh"))


@pytest.mark.parametrize("ordered", [True, False], ids=["ordered", "noorder"])
def test_closest4_matches_jax_up_to_shared_edge_ties(ordered, cornell,
                                                     monkeypatch):
    """L2 against tools/bvh4_lab.run_closest4 (interpret mode; its no-order
    form by setting ORDERED = False) on 32x32 Cornell camera rays, frame 0,
    whose centers run through the back wall's shared diagonal. The TPU
    kernel defers leaves to a queue and the port visits them from the ray's
    stack, so at exactly equal t they may name another triangle, and rays
    on an edge may hit in one and slip through in the other. Each such ray
    lies on a triangle edge; together they stay under 2% of the rays."""
    from raytracer_tpu.integrator.wavefront import _camera_rays
    from raytracer_tpu.ops.pallas_subpacket import LANES, ROWS

    monkeypatch.setattr(jbvh4, "ORDERED", ordered)
    w = h = 32
    mats = cornell.mats
    o, d = _camera_rays(jnp.asarray(mats["inverse_view"]),
                        jnp.asarray(mats["inverse_proj"]), w, h,
                        jnp.full((w * h, 2), 0.5, jnp.float32),
                        jnp.arange(w * h, dtype=jnp.uint32))
    o, d = np.array(o), np.array(d)
    tile = ROWS * LANES
    pad = (-len(o)) % tile
    comps = [jnp.asarray(np.concatenate([a[:, c], np.zeros(pad, np.float32)])
                         .reshape(-1, ROWS, LANES))
             for a in (o, d) for c in range(3)]
    tm = np.concatenate([np.full(len(o), 1e4, np.float32),
                         np.full(pad, 1e-3, np.float32)])
    comps.append(jnp.asarray(tm.reshape(-1, ROWS, LANES)))
    jds = cornell.jds
    out = jbvh4.run_closest4(*comps, jds.qroot, jds.qmeta, jds.qnodes,
                             jds.ptris, interpret=True)
    want_t, want_tri, want_u, want_v = (np.asarray(a).reshape(-1)[:len(o)]
                                        for a in out)
    got = bvh4_lab.run_closest4(torch.from_numpy(o), torch.from_numpy(d),
                                1e4, cornell.ps, ordered=ordered)
    gt, gtri, gu, gv = (g.numpy() for g in got)
    jhit, thit = want_tri >= 0, gtri >= 0
    both = jhit & thit
    flips = jhit != thit
    tri_diff = both & (want_tri != gtri)
    order = "ordered" if ordered else "noorder"
    print(f"cornell {w}x{h} primary rays, {order} vs JAX L2: "
          f"{int(flips.sum())} hit/miss flips, {int(tri_diff.sum())} equal-t "
          f"triangle differences, of {w * h}")
    assert both.sum() > w * h // 2
    assert (np.abs(gt - want_t)[both] <= DT).all()
    u = np.where(thit, gu, want_u)
    v = np.where(thit, gv, want_v)
    on_edge = np.minimum(np.minimum(u, v), 1.0 - u - v) <= 1e-5
    assert on_edge[flips | tri_diff].all()
    assert (flips | tri_diff).mean() <= 0.02


@pytest.fixture(scope="module")
def jax_state1(cornell):
    """tools/sort_lab.sl_make_state1 at 16x16: the bounce-1 wavefront."""
    from tools.sort_lab import sl_make_state1

    return sl_make_state1(cornell.jds, cornell.jubo, cornell.jcfg, W * H)


def _port_state(jstate):
    """The JAX state as the port's WavefrontState (uint32 seeds as int64;
    no `pixel` field)."""
    from raytracer_tpu_torch.integrator.wavefront import WavefrontState

    fields = {f: np.asarray(getattr(jstate, f))
              for f in WavefrontState._fields}
    for f in ("seed_rgen", "seed"):
        fields[f] = fields[f].astype(np.int64)
    return WavefrontState(**{f: torch.from_numpy(np.array(a))
                             for f, a in fields.items()})


def test_sort_wavefront_matches_jax(cornell, jax_state1):
    """The port's _sort_wavefront on the JAX bounce-1 state: the same
    permutation (the JAX sort carries it in `pixel`), the same lanes."""
    from raytracer_tpu.integrator.wavefront import _sort_wavefront as jsort
    from raytracer_tpu_torch.integrator.wavefront import _sort_wavefront

    # Every Cornell bounce-1 lane is alive; kill a third so that the
    # dead-last bit of the key is exercised too.
    jstate = jax_state1._replace(
        alive=jax_state1.alive & (jnp.arange(W * H) % 3 != 0))
    want = jsort(jstate, cornell.jds)
    state = _port_state(jstate)
    got, perm = _sort_wavefront(state, cornell.ps)
    assert 0 < int(state.alive.sum()) < W * H
    np.testing.assert_array_equal(perm.numpy(), np.asarray(want.pixel))
    np.testing.assert_array_equal(got.origin.numpy(), np.asarray(want.origin))
    np.testing.assert_array_equal(got.alive.numpy(), np.asarray(want.alive))


@pytest.mark.parametrize("bounce", [0, 1])
def test_shadow_batch_matches_jax(bounce, cornell):
    """lab.rays' bounce-1 NEE shadow batch, in the renderer's order
    (occl_lab's bounce 0) and sorted (its bounce 1), against
    tools/occl_lab.shadow_rays_at. Lanes agree within 1e-5 except where a
    GGX sample rounded across a lottery or an edge (at most 3%)."""
    want = [np.asarray(a) for a in jol.shadow_rays_at(
        cornell.jds, cornell.jubo, cornell.jcfg, W * H, bounce)]
    from raytracer_tpu_torch.integrator.wavefront import _sort_wavefront

    state = lab_rays.bounce1_state(
        cornell.ps, lab_rays.primary_state(cornell.tubo, cornell.tcfg, "cpu"),
        cornell.tcfg)
    if bounce:
        state, _ = _sort_wavefront(state, cornell.ps)
    got = [g.numpy() for g in lab_rays.shadow_rays(cornell.ps, state,
                                                   cornell.tcfg)]
    active = want[4]
    assert active.sum() > 10
    close = ((got[4] == active) & (got[3] == want[3])
             & (np.abs(got[0] - want[0]).max(1) <= DT)
             & (np.abs(got[1] - want[1]).max(1) <= DT)
             & (np.abs(got[2] - want[2]) <= DT))
    flipped = ~close & (active | got[4])
    print(f"cornell {W}x{H} shadow batch (occl_lab bounce {bounce}): "
          f"{int(active.sum())} active, {int(flipped.sum())} lanes differ")
    assert flipped.sum() <= 0.03 * active.sum() + 1
