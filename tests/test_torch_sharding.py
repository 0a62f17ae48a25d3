"""Pixel-tile rendering over torch.distributed (raytracer_tpu_torch/
parallel/sharding.py, ProgressiveRenderer(mesh=...)) on the CPU with gloo:
the port of tests/test_sharding.py (but its multi-part case: the port's
bake is one part), of tests/test_adaptive.py's sharded case and of
tests/test_preview_image.py's sharded previews.

Each world size (1, 2, 4 and 8 ranks) is spawned once for the module
(parallel/launch.spawn, a deadline on every rank); its ranks run every case
and return arrays, which the tests read. Every rank process imports this
module, so it imports no jax at its top: the JAX package is imported by the
tests that use it, in the pytest process.

What each case holds:
  - the sharded render against the port's single-device render of the same
    frames, bit for bit: plain, accel="bvh", spp_batch, adaptive (mean, m2,
    count), ReSTIR (image and reservoir; every tile at least one halo
    tall), image(denoise=True), aovs() and preview_image(); a tile's lane
    count is a multiple of 64 wherever bits are compared (32x32 over up to
    8 ranks: 128 lanes a tile), since torch's scalar tail on the CPU may
    move a sin or cos by an ulp;
  - the sharded render against the JAX package's single-device render
    within the slice tolerance: every pixel within PIXEL_ATOL but at most
    MAX_FLIPPED of them (plain, spp_batch, adaptive). ReSTIR is held by its
    light_index gate (equal on at least 1 - MAX_FLIPPED of the pixels),
    as tests/test_torch_restir.py holds the unaligned JAX renderer: the
    two packages' triangle tests part on a few pixel-centre rays of the
    Cornell box's back-wall diagonal, and reuse spreads them. The
    denoiser, the AOVs and the previews are held against JAX on one device
    by tests/test_torch_denoise.py; here they equal that single-device
    port;
  - checkpoints: a JAX checkpoint (accum, reservoir, adaptive state) loads
    into a world of 2 exactly and resumes as on one device; a world of 2's
    checkpoint loads into the JAX renderer exactly;
  - the halo exchange, scene edits under a world of 2 (a material edit, a
    transform refit and a prebaked add), the bake digest check, the tile
    and preview divisibility errors and the short-tile warning.
"""

import functools
import logging

import numpy as np
import pytest
import torch

import raytracer_tpu_torch.accel.native_builder as tnative

torch.set_num_threads(1)  # see test_torch_ops.py

PIXEL_ATOL = 1e-4
MAX_FLIPPED = 0.01
SIZE = 32
WORLDS = (1, 2, 4, 8)
TIMEOUT_S = 240.0
RESTIR = dict(use_restir=True, restir_spatial_radius=2.0,
              restir_spatial_neighbors=2, restir_initial_candidates=4)
ADAPTIVE = dict(adaptive_tol=0.1, adaptive_min_frames=2)
# name: (RenderConfig fields, frames). WORLD2_MODES run in the world of 2
# only: the binary tree, and ReSTIR with both bias fixes (the unbiased
# Z-count's taps read the surface rows the halo carries too).
MODES = {"plain": ({}, 2), "spp": (dict(spp_batch=2), 2),
         "adaptive": (ADAPTIVE, 3), "restir": (RESTIR, 3),
         "bvh": (dict(accel="bvh"), 2),
         "restir_unbiased": (dict(RESTIR, restir_unbiased_spatial=True,
                                  restir_final_visibility_feedback=True), 2)}
WORLD2_MODES = ("bvh", "restir_unbiased")
CHECKPOINTED = ("plain", "restir", "adaptive")
JAX_CK_FRAMES = 2
PREVIEW = (64, 2)  # renderer size, scale: a 32x32 preview
HALO_ROWS, HALO_H = 6, 4
MULTIPART_BUDGET = 256 * 1024


def _config(**kw):
    from raytracer_tpu_torch.utils.config import RenderConfig

    return RenderConfig(width=kw.pop("width", SIZE),
                        height=kw.pop("height", SIZE), **kw)


def _renderer(mesh, size=SIZE, sharded_front=False, scene=None, **kw):
    """A port renderer on the CPU: on `mesh`, or on one device (None)."""
    from raytracer_tpu_torch.api import ProgressiveRenderer
    from raytracer_tpu_torch.parallel.sharding import (
        ShardedProgressiveRenderer,
    )
    from raytracer_tpu_torch.scene.model import create_cornell_box

    scene = scene or create_cornell_box()
    cfg = _config(width=size, height=size, **kw)
    if sharded_front:  # the mesh defaults to the whole world
        return ShardedProgressiveRenderer(scene, None, cfg, device="cpu")
    return ProgressiveRenderer(scene, None, cfg, device="cpu", mesh=mesh)


def _modes(mesh, names):
    """Each mode of `names` rendered on `mesh` (None: one device): its image,
    the whole state arrays, and the readouts; on a mesh also the rows each
    rank holds and the phases its timer saw."""
    from raytracer_tpu_torch.utils.profiling import PhaseTimer

    out = {}
    for name in names:
        cfg, frames = MODES[name]
        r = _renderer(mesh, sharded_front=mesh is not None and name == "plain",
                      **cfg)
        r.timer = PhaseTimer()
        res = {"image": r.render(frames), "frame": r.frame,
               "rows": r.accum.shape[0], "phases": dict(r.timer.counts)}
        if r.reservoir is not None:
            res["reservoir"] = {k: r._whole(v)
                                for k, v in r.reservoir._asdict().items()}
            res["reservoir_rows"] = r.reservoir.m.shape[0]
        if r.adaptive is not None:
            res["adaptive"] = {k: r._whole(v)
                               for k, v in r.adaptive._asdict().items()}
            res["converged"] = r.adaptive_converged_fraction()
        if name == "plain":
            res["aovs"] = r.aovs()
            res["denoised"] = r.image(denoise=True)
        out[name] = res
    size, scale = PREVIEW
    r = _renderer(mesh, size=size)
    out["preview"] = {"denoised": r.preview_image(scale, denoise=True),
                      "raw": r.preview_image(scale, denoise=False,
                                             upscale=False)}
    return out


def _edits(mesh):
    """A material edit, a transform (refit) and an object added through
    prebake_async, one frame after each: (images, replay branches)."""
    import dataclasses

    from raytracer_tpu_torch.scene.model import Material, create_sphere

    r = _renderer(mesh)
    scene = r.scene
    images, branches = [r.render(1)], []

    def add():
        mesh_id = scene.add_mesh(create_sphere(6, 6))
        mat = scene.add_material(Material(albedo=(0.2, 0.4, 0.9)))
        scene.add_object("added_sphere", mesh_id, mat,
                         position=(0.0, -0.3, 0.2), scale=(0.25,) * 3)
        r.prebake_async()

    for edit in (
            lambda: scene.update_material(0, dataclasses.replace(
                scene.materials[0], albedo=(0.85, 0.15, 0.1))),
            lambda: scene.update_object_position(
                0, tuple(np.asarray(scene.objects[0].transform.position)
                         + [0.05, 0.0, 0.0])),
            add):
        edit()
        r.step()
        branches.append(r.last_replay)
        images.append(r.image())
    return images, branches


def _errors(fn):
    """The message of the exception fn() raises (None if it returns)."""
    try:
        fn()
    except (RuntimeError, ValueError) as e:
        return f"{type(e).__name__}: {e}"
    return None


def _rank_cases(rank, world, ck_dir):
    """Every case of the module in one rank of a world of `world`."""
    import torch.distributed as dist

    from raytracer_tpu_torch.integrator import restir
    from raytracer_tpu_torch.parallel import sharding

    torch.set_num_threads(1)
    tnative.available = lambda: False
    mesh = sharding.make_pixel_mesh("cpu")
    out = {"mesh_size": mesh.size(), "rank": dist.get_rank(),
           "device_type": mesh.device_type}

    # The placement helpers: this rank's rows, or the tensor whole.
    from raytracer_tpu_torch.integrator.adaptive import AdaptiveState

    full = torch.arange(SIZE * SIZE * 3, dtype=torch.float32).reshape(-1, 3)
    start, n_local = sharding.tile_of(_config(), mesh)
    state = AdaptiveState(full, full[:, 0], full[:, 1].long())
    out["placement"] = {
        "accum": torch.equal(sharding.shard_accum(full, mesh),
                             full[start:start + n_local]),
        "reservoir": all(torch.equal(a, b[start:start + n_local]) for a, b
                         in zip(sharding.shard_reservoir(
                             restir.Reservoir.empty(SIZE * SIZE), mesh),
                             restir.Reservoir.empty(SIZE * SIZE))),
        "adaptive": all(torch.equal(a, b[start:start + n_local]) for a, b
                        in zip(sharding.shard_adaptive(state, mesh), state)),
        "replicate": sharding.replicate(full, mesh) is full}

    # The halo exchange on its own: float, int and bool rows.
    n, h = HALO_ROWS, HALO_H
    rows = {"f": torch.arange(n * 3, dtype=torch.float32).reshape(n, 3)
            + 1000.0 * (rank + 1),
            "i": torch.arange(n, dtype=torch.int32) + 100 * (rank + 1),
            "b": torch.arange(n) % 2 == rank % 2}
    out["halo"] = {k: v.numpy() for k, v in restir._exchange_halo(
        rows, h, sharding.mesh_group(mesh), world).items()}

    names = [m for m in MODES if world == 2 or m not in WORLD2_MODES]
    out["modes"] = _modes(mesh, names)
    if world > 1:
        out["indivisible"] = _errors(lambda: _renderer(mesh, size=9))
        r = _renderer(mesh, size=24)
        out["preview_indivisible"] = _errors(lambda: r.preview_image(7))
    if world == 1:
        out["cuda_mesh"] = _errors(lambda: sharding.make_pixel_mesh("cuda"))
    if world == 8:
        # 32x32 over 8: 4-row tiles; radius 4 needs a 5-row halo.
        seen = []
        handler = logging.Handler()
        handler.emit = lambda record: seen.append(record.getMessage())
        logger = logging.getLogger("raytracer_tpu_torch.api")
        logger.addHandler(handler)
        try:
            _renderer(mesh, **dict(RESTIR, restir_spatial_radius=4.0))
        finally:
            logger.removeHandler(handler)
        out["short_tile_log"] = seen
    if world == 2:
        out.update(_world2_cases(rank, mesh, ck_dir))
    return out


def _world2_cases(rank, mesh, ck_dir):
    from raytracer_tpu_torch.ops.camera import Camera
    from raytracer_tpu_torch.scene.model import create_cornell_box

    out = {"edits": _edits(mesh)}
    # A camera move resets the accumulation and the reservoir to the tile.
    r = _renderer(mesh, **RESTIR)
    r.render(1)
    r.set_camera(Camera.create(position=(0.1, 0.0, -3.0), aspect=1.0))
    r.step()
    out["camera_reset"] = (r.frame, r.accum.shape[0],
                           r.reservoir.weight_sum.shape[0])
    # A rank whose scene differs: every rank's bake digest check raises.
    scene = create_cornell_box()
    if rank == 1:
        scene.update_object_position(0, (0.3, 0.0, 0.0))
    out["digest"] = _errors(lambda: _renderer(mesh, scene=scene))
    # The port's checkpoints, and the JAX package's resumed here.
    out["saved"], out["resumed"] = {}, {}
    for name in CHECKPOINTED:
        cfg, frames = MODES[name]
        r = _renderer(mesh, **cfg)
        r.render(frames)
        r.save_checkpoint(f"{ck_dir}/port_{name}.npz")
        r = _renderer(mesh, **cfg)
        r.load_checkpoint(f"{ck_dir}/jax_{name}.npz")
        loaded = {"accum": r._whole(r.accum), "image": r.image()}
        if r.reservoir is not None:
            loaded["reservoir"] = {k: r._whole(v) for k, v
                                   in r.reservoir._asdict().items()}
        if r.adaptive is not None:
            loaded["adaptive"] = {k: r._whole(v) for k, v
                                  in r.adaptive._asdict().items()}
        r.step()
        loaded["next"] = r.image()
        loaded["next_light_index"] = (None if r.reservoir is None else
                                      r._whole(r.reservoir.light_index))
        out["resumed"][name] = loaded
    out["multipart"] = _multipart(mesh)
    return out


def _multipart(mesh):
    """A multi-part bake's render (the budget as the JAX sharding test
    sets it): the part count and the image after one frame, on `mesh` or
    on one device (None)."""
    import raytracer_tpu_torch.api as tapi

    saved = tapi.PALLAS_VMEM_BUDGET
    tapi.PALLAS_VMEM_BUDGET = MULTIPART_BUDGET
    try:
        r = _renderer(mesh, size=16)
        return r.device_scene.num_parts, r.render(1)
    finally:
        tapi.PALLAS_VMEM_BUDGET = saved


# --- the pytest process ------------------------------------------------------

@pytest.fixture(autouse=True)
def numpy_builders(monkeypatch):
    import raytracer_tpu.accel.native_builder as jnative

    monkeypatch.setattr(jnative, "available", lambda: False)
    monkeypatch.setattr(tnative, "available", lambda: False)


def _jax_config(**kw):
    from raytracer_tpu.utils.config import RenderConfig as JaxConfig

    return JaxConfig(width=SIZE, height=SIZE, accel="bvh", stable_bake=False,
                     **kw)


def _jax_renderer(name):
    from raytracer_tpu.api import ProgressiveRenderer as JaxRenderer
    from raytracer_tpu.scene.model import create_cornell_box

    return JaxRenderer(create_cornell_box(), None,
                       _jax_config(**MODES[name][0]))


@functools.cache
def _jax_render(name, frames):
    """The JAX renderer of mode `name` after `frames` frames: (image,
    reservoir arrays or None, adaptive arrays or None)."""
    import jax

    r = _jax_renderer(name)
    img = r.render(frames)
    state = (None if r.reservoir is None else
             jax.tree_util.tree_map(np.asarray, r.reservoir._asdict()))
    ada = (None if r.adaptive is None else
           jax.tree_util.tree_map(np.asarray, r.adaptive._asdict()))
    return img, state, ada


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """world -> every rank's results, each world spawned once, on demand.
    The JAX checkpoints the world of 2 resumes are written first."""
    import raytracer_tpu.accel.native_builder as jnative

    from raytracer_tpu_torch.parallel.launch import spawn

    ck_dir = str(tmp_path_factory.mktemp("ck"))
    saved = jnative.available
    jnative.available = lambda: False
    try:
        for name in CHECKPOINTED:
            r = _jax_renderer(name)
            r.render(JAX_CK_FRAMES)
            r.save_checkpoint(f"{ck_dir}/jax_{name}.npz")
    finally:
        jnative.available = saved
    cache = {}

    def get(world):
        if world not in cache:
            cache[world] = spawn(_rank_cases, world, (ck_dir,),
                                 timeout_s=TIMEOUT_S)
        return cache[world]

    get.ck_dir = ck_dir
    return get


@functools.cache
def _single():
    """The same modes on one device (no process group)."""
    names = list(MODES)
    return _modes(None, names)


def _flipped(a, b):
    a = np.asarray(a).reshape(-1, 3)
    b = np.asarray(b).reshape(-1, 3)
    return np.abs(a - b).max(axis=-1) > PIXEL_ATOL


def _assert_tree_equal(got, want, what):
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _assert_tree_equal(got[k], want[k], f"{what}.{k}")
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                      err_msg=what)


def test_make_pixel_mesh_needs_a_process_group():
    from raytracer_tpu_torch.parallel.sharding import make_pixel_mesh

    with pytest.raises(RuntimeError, match="torchrun.*init_process_group"):
        make_pixel_mesh("cpu")


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_spans_the_world(worlds, world):
    runs = worlds(world)
    assert [o["rank"] for o in runs] == list(range(world))
    assert all(o["mesh_size"] == world and o["device_type"] == "cpu"
               for o in runs)
    assert all(all(o["placement"].values()) for o in runs)


@pytest.mark.parametrize("world", WORLDS)
def test_timer_phases_of_a_rank(worlds, world):
    """Each step is a tile_render phase, each ReSTIR step a halo phase,
    and each readout of a tile a gather phase."""
    for out in worlds(world):
        modes = out["modes"]
        assert modes["plain"]["phases"] == {
            "tile_render": MODES["plain"][1], "gather": 1}
        assert modes["restir"]["phases"] == {
            "tile_render": MODES["restir"][1],
            "halo": MODES["restir"][1], "gather": 1}


def test_cuda_mesh_without_a_card_raises(worlds):
    assert "is_available() is False" in worlds(1)[0]["cuda_mesh"]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("mode", ["plain", "spp", "adaptive", "restir"])
def test_sharded_matches_single(worlds, world, mode):
    """Every rank returns the whole image, equal to the single-device
    render bit for bit; accum (and the reservoir) hold the rank's rows."""
    want = _single()[mode]
    for out in worlds(world):
        got = out["modes"][mode]
        np.testing.assert_array_equal(got["image"], want["image"])
        assert got["frame"] == want["frame"]
        assert got["rows"] == SIZE * SIZE // world
        for key in ("reservoir", "adaptive", "converged"):
            if key in want:
                _assert_tree_equal(got[key], want[key], key)
        if "reservoir" in want:
            assert got["reservoir_rows"] == SIZE * SIZE // world


@pytest.mark.parametrize("mode", WORLD2_MODES)
def test_sharded_world2_modes_match_single(worlds, mode):
    want = _single()[mode]
    for out in worlds(2):
        got = out["modes"][mode]
        np.testing.assert_array_equal(got["image"], want["image"])
        if "reservoir" in want:
            _assert_tree_equal(got["reservoir"], want["reservoir"],
                               "reservoir")


def test_sharded_multipart_matches_single(worlds):
    """A multi-part bake composes with pixel tiles: every rank bakes the
    parts (their digest compared) and runs the per-part passes on its
    tile, bit for bit the one-device multi-part render (the JAX package's
    test_sharded_multipart_matches_single)."""
    parts, want = _multipart(None)
    assert parts > 1
    for out in worlds(2):
        got_parts, got = out["multipart"]
        assert got_parts == parts
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_denoised_image_and_aovs_match_single(worlds, world):
    want = _single()["plain"]
    for out in worlds(world):
        got = out["modes"]["plain"]
        np.testing.assert_array_equal(got["denoised"], want["denoised"])
        _assert_tree_equal(got["aovs"], want["aovs"], "aovs")


@pytest.mark.parametrize("world", WORLDS)
def test_preview_sharded_matches_across_meshes(worlds, world):
    want = _single()["preview"]
    for out in worlds(world):
        _assert_tree_equal(out["modes"]["preview"], want, "preview")


@pytest.mark.parametrize("world", WORLDS[1:])
def test_indivisible_raises(worlds, world):
    for out in worlds(world):
        assert out["indivisible"].startswith("ValueError")
        assert "do not tile" in out["indivisible"]
        assert out["preview_indivisible"].startswith("ValueError")
        assert "3x3 pixels do not tile" in out["preview_indivisible"]


def test_sharded_restir_short_tile_warns(worlds):
    for out in worlds(8):
        assert any("spatial halo" in m for m in out["short_tile_log"])


@pytest.mark.parametrize("world", WORLDS)
def test_exchange_halo(worlds, world):
    """Edge tiles get zero rows; interior rows are the neighbour's."""
    runs = worlds(world)
    n, h = HALO_ROWS, HALO_H
    for rank, out in enumerate(runs):
        ext = out["halo"]
        own = {k: v[h:h + n] for k, v in ext.items()}
        for k, v in ext.items():
            assert v.shape[0] == n + 2 * h
            prev, nxt = v[:h], v[h + n:]
            if rank == 0:
                assert not prev.any(), k
            else:
                np.testing.assert_array_equal(
                    prev, runs[rank - 1]["halo"][k][h + n - h:h + n])
            if rank == world - 1:
                assert not nxt.any(), k
            else:
                np.testing.assert_array_equal(
                    nxt, runs[rank + 1]["halo"][k][h:2 * h])
        assert own["f"][0, 0] == 1000.0 * (rank + 1)
        assert own["i"][0] == 100 * (rank + 1)


@pytest.mark.parametrize("world", [2, 8])
@pytest.mark.parametrize("mode", ["plain", "spp", "adaptive"])
def test_sharded_matches_jax(worlds, world, mode):
    cfg, frames = MODES[mode]
    want, _, want_ada = _jax_render(mode, frames)
    got = worlds(world)[0]["modes"][mode]
    flipped = _flipped(got["image"], want)
    print(f"{mode}, world {world}: {int(flipped.sum())} flipped pixels of "
          f"{flipped.size} against the JAX renderer")
    assert flipped.mean() <= MAX_FLIPPED
    if want_ada is not None:
        same = got["adaptive"]["count"] == want_ada["count"]
        assert same.mean() >= 1 - MAX_FLIPPED


@pytest.mark.parametrize("world", [2, 8])
def test_sharded_restir_light_index_matches_jax(worlds, world):
    _, frames = MODES["restir"]
    want, want_res, _ = _jax_render("restir", frames)
    got = worlds(world)[0]["modes"]["restir"]
    li = got["reservoir"]["light_index"] == want_res["light_index"]
    flipped = _flipped(got["image"], want)
    print(f"ReSTIR, world {world}: light_index differs on "
          f"{int((~li).sum())} of {li.size} pixels ({int(flipped.sum())} "
          "flipped pixels against the unaligned JAX renderer)")
    assert li.mean() >= 1 - MAX_FLIPPED


def test_sharded_edits_match_single(worlds):
    want, want_branches = _edits(None)
    for out in worlds(2):
        images, branches = out["edits"]
        assert branches == want_branches == ["materials", "refit", "prebake"]
        for got, ref in zip(images, want):
            np.testing.assert_array_equal(got, ref)


def test_camera_reset_keeps_the_tiles(worlds):
    for out in worlds(2):
        assert out["camera_reset"] == (1, SIZE * SIZE // 2,
                                       SIZE * SIZE // 2)


def test_differing_bake_raises_on_every_rank(worlds):
    for out in worlds(2):
        assert out["digest"].startswith("RuntimeError")
        assert "baked scene differs" in out["digest"]


@pytest.mark.parametrize("name", CHECKPOINTED)
def test_port_sharded_checkpoint_loads_in_jax(worlds, name):
    import jax

    got = worlds(2)[0]["modes"]
    path = f"{worlds.ck_dir}/port_{name}.npz"
    jr = _jax_renderer(name)
    jr.load_checkpoint(path)
    _, frames = MODES[name]
    assert jr.frame == frames
    np.testing.assert_array_equal(jr.image(), got[name]["image"])
    if jr.reservoir is not None:
        _assert_tree_equal(jax.tree_util.tree_map(
            np.asarray, jr.reservoir._asdict()), got[name]["reservoir"],
            "reservoir")
    if jr.adaptive is not None:
        _assert_tree_equal(
            jax.tree_util.tree_map(np.asarray, jr.adaptive._asdict()),
            got[name]["adaptive"], "adaptive")


@pytest.mark.parametrize("name", CHECKPOINTED)
def test_jax_checkpoint_resumes_in_port_sharded(worlds, name):
    """A JAX checkpoint loads into the world of 2 exactly and resumes bit
    for bit as on one device, and within the tolerance of JAX's own next
    frame (ReSTIR: its light_index)."""
    path = f"{worlds.ck_dir}/jax_{name}.npz"
    data = np.load(path)
    single = _renderer(None, **MODES[name][0])
    single.load_checkpoint(path)
    single.step()
    want, want_res, _ = _jax_render(name, JAX_CK_FRAMES + 1)
    for out in worlds(2):
        got = out["resumed"][name]
        np.testing.assert_array_equal(got["accum"], data["accum"])
        for key in ("reservoir", "adaptive"):
            for k, v in got.get(key, {}).items():
                stored = data["accum" if k == "mean" else f"{key}_{k}"]
                np.testing.assert_array_equal(v, stored, err_msg=k)
        np.testing.assert_array_equal(got["next"], single.image())
        if want_res is None:
            assert _flipped(got["next"], want).mean() <= MAX_FLIPPED
        else:
            li = got["next_light_index"] == want_res["light_index"]
            assert li.mean() >= 1 - MAX_FLIPPED
