"""The port's scene-edit paths (ROADMAP P3, P11) against the JAX package's:
the refit bake (`bake_scene(reuse_bvh=...)`) field for field, the
vectorized `BVH.refit` against the JAX node loop, `update_materials` and
its full-bake fallbacks, the branch each journal takes in
`_replay_changes`, the background prebake, the kernels' leaf counts after
a refit that collapses an object and restores it, a whole edit session
against the JAX renderer within the render gate of test_torch_render.py,
and the ported examples at a small size. Both sides use the numpy BVH
builder."""

import dataclasses

import numpy as np
import pytest
import torch

import raytracer_tpu.accel.native_builder as jnative
import raytracer_tpu.scene.benchmark as jbench
import raytracer_tpu.scene.model as jmodel
import raytracer_tpu_torch.accel.native_builder as tnative
import raytracer_tpu_torch.scene.benchmark as tbench
import raytracer_tpu_torch.scene.model as tmodel
from raytracer_tpu.accel.bvh import build_bvh_numpy as jbuild
from raytracer_tpu.api import ProgressiveRenderer as JaxRenderer
from raytracer_tpu.scene.device_scene import bake_scene as jbake
from raytracer_tpu.scene.device_scene import (
    update_materials as jupdate_materials,
)
from raytracer_tpu.utils.config import RenderConfig as JaxConfig
from raytracer_tpu_torch.accel.bvh import BVH
from raytracer_tpu_torch.api import ProgressiveRenderer
from raytracer_tpu_torch.ops import quad_traverse as qt
from raytracer_tpu_torch.scene.device_scene import (
    ARRAY_FIELDS,
    bake_scene as tbake,
    update_materials,
)
from raytracer_tpu_torch.utils.config import RenderConfig

torch.set_num_threads(1)  # see test_torch_ops.py

PIXEL_ATOL = 1e-4  # the render gate of test_torch_render.py
MAX_FLIPPED = 0.01

SCENES = {
    "cornell": (jmodel.create_cornell_box, tmodel.create_cornell_box),
    "atrium20k": (lambda: jbench.create_benchmark_atrium(20_000),
                  lambda: tbench.create_benchmark_atrium(20_000)),
    "lightgrid": (jbench.create_benchmark_lightgrid,
                  tbench.create_benchmark_lightgrid),
}
# Fields that update_materials rewrites.
MATERIAL_FIELDS = ("mat_packed", "light_power", "light_meta_packed",
                   "light_tri_packed")


@pytest.fixture(autouse=True)
def numpy_builders(monkeypatch):
    monkeypatch.setattr(jnative, "available", lambda: False)
    monkeypatch.setattr(tnative, "available", lambda: False)


def _flipped(a, b):
    return np.abs(a - b).max(axis=-1) > PIXEL_ATOL


def _assert_fields_equal(port, jds, fields=ARRAY_FIELDS):
    """Port fields equal the JAX SceneOnDevice's, bit for bit (NaN boxes
    equal each other)."""
    for k in fields:
        got = getattr(port, k).cpu().numpy()
        want = np.asarray(getattr(jds, k))
        assert got.dtype == want.dtype, k
        np.testing.assert_array_equal(got, want, err_msg=k)


def _move_two(scene):
    """Move the scene's first emissive object and scale its last ordinary
    one (the same edits on either package's scene)."""
    emissive = [i for i, o in enumerate(scene.objects)
                if scene.materials[o.material_index].emission_power > 0]
    ordinary = [i for i in range(len(scene.objects)) if i not in emissive]
    em = emissive[0]
    pos = np.asarray(scene.objects[em].transform.position) + [0.3, -0.2, 0.1]
    scene.update_object_position(em, tuple(pos))
    scene.update_object_scale(ordinary[-1], (0.5, 1.5, 0.7))


@pytest.mark.parametrize("name", sorted(SCENES))
@pytest.mark.parametrize("leaf_size", [8, 16])
def test_refit_bake_matches_jax(name, leaf_size):
    """After moving an emissive and an ordinary object, the port's refit
    bake equals the JAX refit bake on every ARRAY_FIELDS array, and the BVH
    object is the one refit in place."""
    jmake, tmake = SCENES[name]
    js, ts = jmake(), tmake()
    _, jbvh = jbake(js, leaf_size=leaf_size, stable_shapes=False)
    _, tbvh = tbake(ts, leaf_size=leaf_size, device="cpu")
    _move_two(js)
    _move_two(ts)
    jds, _ = jbake(js, leaf_size=leaf_size, reuse_bvh=jbvh,
                   stable_shapes=False)
    tds, bvh = tbake(ts, leaf_size=leaf_size, device="cpu", reuse_bvh=tbvh)
    assert bvh is tbvh
    _assert_fields_equal(tds, jds)
    assert (tds.q_stack_need, tds.bvh_max_depth) == (jds.q_stack_need,
                                                     jds.bvh_max_depth)
    assert tds.root == int(jds.qroot[0])
    assert tds.binary_root == int(jds.root_meta[0])


def test_refit_refuses_another_triangle_count():
    scene = tmodel.create_cornell_box()
    _, bvh = tbake(scene, device="cpu")
    scene.add_object("extra", scene.add_mesh(tmodel.create_sphere(4, 4)), 0)
    with pytest.raises(ValueError, match="unchanged triangle count"):
        tbake(scene, device="cpu", reuse_bvh=bvh)


def _random_tris(rng, t):
    v0 = rng.uniform(-5, 5, size=(t, 3)).astype(np.float32)
    e1 = rng.uniform(-1, 1, size=(t, 3)).astype(np.float32)
    e2 = rng.uniform(-1, 1, size=(t, 3)).astype(np.float32)
    return v0, e1, e2


@pytest.mark.parametrize("t,leaf_size,seed", [(200, 8, 0), (1000, 4, 1),
                                              (777, 16, 2), (5, 8, 3)])
def test_vectorized_refit_matches_jax_loop(t, leaf_size, seed):
    """The port's BVH.refit (reduceat over the leaves, then one level at a
    time) gives the JAX node loop's boxes bit for bit, on a tree whose
    triangles each moved by their own offset (tests/test_bvh.py:110 moves
    them all by one); a tree of one leaf included."""
    rng = np.random.default_rng(seed)
    v0, e1, e2 = _random_tris(rng, t)
    jb = jbuild(v0, e1, e2, leaf_size=leaf_size)
    tb = BVH(**{f.name: np.array(getattr(jb, f.name), copy=True)
                for f in dataclasses.fields(jb)})
    perm = jb.tri_order
    v0s = v0[perm] + rng.normal(0, 0.5, size=(t, 3)).astype(np.float32)
    e1s = e1[perm] * rng.uniform(0, 2, size=(t, 1)).astype(np.float32)
    e2s = e2[perm]
    jb.refit(v0s, e1s, e2s)
    tb.refit(v0s, e1s, e2s)
    np.testing.assert_array_equal(tb.nodes_min, jb.nodes_min)
    np.testing.assert_array_equal(tb.nodes_max, jb.nodes_max)
    assert tb.nodes_min.dtype == np.float32


def _paint(scene, albedo=(0.9, 0.1, 0.1), light_scale=3.0):
    """A material repaint and a light brighten (MATERIAL_CHANGED only)."""
    scene.update_material(0, dataclasses.replace(scene.materials[0],
                                                 albedo=albedo))
    li = next(i for i, m in enumerate(scene.materials)
              if m.emission_power > 0)
    m = scene.materials[li]
    scene.update_material(li, dataclasses.replace(
        m, emission_power=m.emission_power * light_scale,
        emission_color=(0.9, 0.8, 1.0)))


@pytest.mark.parametrize("name", sorted(SCENES))
def test_update_materials_matches_jax(name):
    """update_materials rewrites mat_packed, light_power, light_meta_packed
    and light_tri_packed as the JAX one does, and keeps every geometry
    tensor the same object (JAX tests/test_scene.py:162)."""
    jmake, tmake = SCENES[name]
    js, ts = jmake(), tmake()
    jds, _ = jbake(js, stable_shapes=False)
    tds, _ = tbake(ts, device="cpu")
    _paint(js)
    _paint(ts)
    jnew = jupdate_materials(jds, js, stable_shapes=False)
    tnew = update_materials(tds, ts, device="cpu")
    _assert_fields_equal(tnew, jnew)
    for k in ARRAY_FIELDS:
        if k in MATERIAL_FIELDS:
            assert getattr(tnew, k) is not getattr(tds, k), k
        else:
            assert getattr(tnew, k) is getattr(tds, k), k
    # And the tables equal a full bake of the edited scene.
    fresh, _ = tbake(ts, device="cpu")
    for k in MATERIAL_FIELDS:
        np.testing.assert_array_equal(getattr(tnew, k).numpy(),
                                      getattr(fresh, k).numpy(), err_msg=k)


@pytest.mark.parametrize("fallback", ["emissive_set", "more_materials"])
def test_update_materials_falls_back_to_a_bake(fallback):
    """A change of the emissive objects, or more materials than mat_packed
    has rows, bakes anew (JAX device_scene.py:930-931), as the JAX
    update_materials does."""
    js, ts = jmodel.create_cornell_box(), tmodel.create_cornell_box()
    jds, _ = jbake(js, stable_shapes=False)
    tds, _ = tbake(ts, device="cpu")
    for s in (js, ts):
        if fallback == "emissive_set":
            s.update_material(0, dataclasses.replace(
                s.materials[0], emission_color=(1.0, 1.0, 1.0),
                emission_power=2.0))
        else:
            s.add_material(type(s.materials[0])(albedo=(0.1, 0.2, 0.3)))
    jnew = jupdate_materials(jds, js, stable_shapes=False)
    tnew = update_materials(tds, ts, device="cpu")
    assert tnew.ptris is not tds.ptris
    _assert_fields_equal(tnew, jnew)


def _port_renderer(w=16, h=16, **cfg):
    return ProgressiveRenderer(tmodel.create_cornell_box(), None,
                               RenderConfig(width=w, height=h, **cfg),
                               device="cpu")


def _pre_add(scene):
    mesh = scene.add_mesh(tmodel.create_sphere(4, 4))
    mat = scene.add_material(tmodel.Material(albedo=(0.2, 0.4, 0.9)))
    scene.add_object("added", mesh, mat, position=(0.0, -0.3, 0.2),
                     scale=(0.25, 0.25, 0.25))


def _light_off(scene):
    li = next(i for i, m in enumerate(scene.materials)
              if m.emission_power > 0)
    scene.update_material(li, dataclasses.replace(scene.materials[li],
                                                  emission_power=0.0))


# case: (edit, branch, the held BVH object kept). A material edit that
# changes the emissive objects bakes inside update_materials and keeps the
# held BVH, as the JAX renderer does (its tree covers the same triangles).
BRANCH_CASES = {
    "nothing": (lambda s: None, None, True),
    "material": (lambda s: _paint(s), "materials", True),
    "emissive_set": (_light_off, "bake", True),
    "transform": (lambda s: s.update_object_position(6, (0.5, 1.5, -1.0)),
                  "refit", True),
    "transform_and_material": (
        lambda s: (s.update_object_scale(7, (0.4, 0.4, 0.4)), _paint(s)),
        "refit", True),
    "object_add": (_pre_add, "bake", False),
    "object_material": (lambda s: s.update_object_material(6, 0), "bake",
                        False),
    "object_remove": (lambda s: s.delete_object(7), "bake", False),
}


@pytest.mark.parametrize("case", sorted(BRANCH_CASES))
def test_replay_branch(case):
    """Each journal takes the JAX package's branch (api.py:293-332):
    material edits alone update the tables and keep the geometry tensors;
    transform edits, with or without material edits, refit the held BVH
    object; anything else bakes anew; an empty journal keeps the
    accumulation."""
    edit, branch, keeps_bvh = BRANCH_CASES[case]
    r = _port_renderer(8, 8)
    r.step()
    bvh, ds = r._host_bvh, r.device_scene
    edit(r.scene)
    r.step()
    assert r.last_replay == branch
    assert r.frame == (2 if branch is None else 1)
    assert (r._host_bvh is bvh) == keeps_bvh
    assert (r.device_scene.ptris is ds.ptris) == (branch in (None,
                                                             "materials"))
    if branch == "materials":
        for k in ARRAY_FIELDS:
            if k not in MATERIAL_FIELDS:
                assert getattr(r.device_scene, k) is getattr(ds, k), k


def test_transform_edit_uses_refit_and_changes_image():
    """JAX tests/test_integrator.py:208: the refit reuses the BVH object,
    resets the accumulation and the image shows the move."""
    r = _port_renderer(24, 24)
    bvh_before = r._host_bvh
    r.step()
    before = r.image().copy()
    r.scene.update_object_position(6, (0.5, 1.5, -1.0))
    r.step()
    assert r.frame == 1
    assert r._host_bvh is bvh_before
    assert np.abs(r.image() - before).max() > 1e-3


@pytest.mark.parametrize("accel", ["cuda", "bvh"])
def test_refit_render_matches_fresh_build(accel):
    """JAX tests/test_integrator.py:229: a refit tree and a fresh build of
    the same scene state give the same image (different trees, the same
    hits), on both trees' walks."""
    scene = tmodel.create_cornell_box()
    _, bvh = tbake(scene, device="cpu")
    scene.update_object_position(6, (0.4, 1.2, -0.8))
    scene.update_object_scale(7, (0.7, 0.3, 0.7))
    cfg = RenderConfig(width=24, height=24, accel=accel)
    images = []
    for reuse in (bvh, None):
        r = ProgressiveRenderer(scene, None, cfg, device="cpu")
        r._install(*tbake(scene, device="cpu", reuse_bvh=reuse))
        images.append(r.render(1))
    flipped = _flipped(*images)
    print(f"refit vs fresh build, accel={accel}: {int(flipped.sum())} "
          f"flipped pixels of {flipped.size}")
    assert flipped.mean() <= MAX_FLIPPED


def test_refit_after_collapse_keeps_leaf_counts():
    """The kernels' leaf counts after a refit that collapses an object to
    its position (scale 1e-30: its triangles' edges round to exactly 0 in
    f32; the scene model inverts the model matrix, so a scale of 0 cannot
    be set) and one that restores it: every refit uploads a new ptris, so
    leaf_counts equals the row counts of the ptris it is given, and the
    restored triangles are counted again."""
    scene = tmodel.create_cornell_box()
    ds0, bvh = tbake(scene, device="cpu")
    counts0 = qt.leaf_counts(ds0)
    scene.update_object_scale(6, (1e-30, 1e-30, 1e-30))
    ds1, _ = tbake(scene, device="cpu", reuse_bvh=bvh)
    assert ds1.ptris is not ds0.ptris
    np.testing.assert_array_equal(qt.leaf_counts(ds1).numpy(),
                                  qt.row_counts(ds1.ptris).numpy())
    assert int(qt.leaf_counts(ds1).sum()) < int(counts0.sum())
    scene.update_object_scale(6, (1.0, 1.0, 1.0))
    ds2, _ = tbake(scene, device="cpu", reuse_bvh=bvh)
    np.testing.assert_array_equal(qt.leaf_counts(ds2).numpy(),
                                  qt.row_counts(ds2.ptris).numpy())
    np.testing.assert_array_equal(qt.leaf_counts(ds2).numpy(),
                                  counts0.numpy())


def test_prebake_async_matches_sync_object_add():
    """JAX tests/test_preview_image.py:201: the prebaked scene renders the
    synchronous replay's image bit for bit, and is consumed."""
    r_sync = _port_renderer()
    r_sync.step()
    _pre_add(r_sync.scene)
    r_sync.step()
    assert r_sync.last_replay == "bake"
    r_pre = _port_renderer()
    r_pre.step()
    _pre_add(r_pre.scene)
    r_pre.prebake_async()
    r_pre.step()
    assert r_pre.last_replay == "prebake"
    assert r_pre._prebake is None
    np.testing.assert_array_equal(r_pre.accum.numpy(), r_sync.accum.numpy())


def test_prebake_stale_after_second_edit_falls_back():
    """JAX tests/test_preview_image.py:229: an edit after prebake_async
    makes it stale; the replay bakes synchronously and shows both edits."""
    r = _port_renderer()
    r.step()
    _pre_add(r.scene)
    r.prebake_async()
    r.scene.update_material(0, dataclasses.replace(r.scene.materials[0],
                                                   albedo=(0.9, 0.1, 0.1)))
    r.step()
    assert r.last_replay == "bake"
    r2 = _port_renderer()
    r2.step()
    _pre_add(r2.scene)
    r2.scene.update_material(0, dataclasses.replace(r2.scene.materials[0],
                                                    albedo=(0.9, 0.1, 0.1)))
    r2.step()
    np.testing.assert_array_equal(r.accum.numpy(), r2.accum.numpy())


def test_prebake_with_no_pending_edits_is_discarded():
    """JAX tests/test_preview_image.py:262."""
    r = _port_renderer()
    r.step()
    r.prebake_async()
    before = r.accum.numpy().copy()
    r.step()
    assert r._prebake is None
    assert r.frame == 2
    assert not np.array_equal(r.accum.numpy(), before)


def test_failed_prebake_is_logged_and_baked_again(monkeypatch, caplog):
    """A prebake whose worker raised is dropped with a warning, and the
    replay bakes synchronously."""
    import raytracer_tpu_torch.api as tapi

    r = _port_renderer(8, 8)
    r.step()
    _pre_add(r.scene)
    real = tapi.bake_scene

    def failing(*a, **kw):
        raise RuntimeError("worker failed")

    monkeypatch.setattr(tapi, "bake_scene", failing)
    r.prebake_async()
    worker = r._prebake[1]
    worker.join(timeout=60)
    assert not worker.is_alive()
    monkeypatch.setattr(tapi, "bake_scene", real)
    with caplog.at_level("WARNING", logger=tapi.__name__):
        r.step()
    assert "background prebake failed (worker failed)" in caplog.text
    assert r.last_replay == "bake"


def _session(r, scene, mod):
    """The interactive session's edits, one frame after each: camera move,
    transform drag, material paint, light brighten, object add (with a
    prebake where the renderer has one). Returns the image after each
    edit's frame and after two more frames."""
    images = []
    cam = mod.Camera.create(position=(0.25, 0.1, -2.8), aspect=1.0)

    def after(edit, prebake=False):
        edit()
        if prebake:
            r.prebake_async()
        r.step()
        images.append(np.asarray(r.image()).copy())

    r.step()
    after(lambda: r.set_camera(cam))
    tr = scene.objects[0].transform
    after(lambda: scene.update_object_position(
        0, tuple(np.asarray(tr.position) + [0.05, 0.0, 0.0])))
    after(lambda: scene.update_material(0, dataclasses.replace(
        scene.materials[0], albedo=(0.85, 0.15, 0.1))))
    li = next(i for i, m in enumerate(scene.materials)
              if m.emission_power > 0)
    after(lambda: scene.update_material(li, dataclasses.replace(
        scene.materials[li],
        emission_power=scene.materials[li].emission_power * 2)))

    def add():
        mesh = scene.add_mesh(mod.create_sphere(6, 6))
        mat = scene.add_material(mod.Material(albedo=(0.2, 0.4, 0.9)))
        scene.add_object("added_sphere", mesh, mat,
                         position=(0.0, -0.3, 0.2), scale=(0.25, 0.25, 0.25))
    after(add, prebake=True)
    r.step()
    r.step()
    images.append(np.asarray(r.image()).copy())
    return images


def test_edit_session_matches_jax():
    """The interactive session's edits on the Cornell box at 32x32, port
    against the JAX renderer (accel="bvh"), image for image within the
    render gate; the port takes the refit, material and prebake branches."""
    from raytracer_tpu.ops import camera as jcam
    from raytracer_tpu_torch.ops import camera as tcam

    class J:
        Camera, Material = jcam.Camera, jmodel.Material
        create_sphere = staticmethod(jmodel.create_sphere)

    class T:
        Camera, Material = tcam.Camera, tmodel.Material
        create_sphere = staticmethod(tmodel.create_sphere)

    js, ts = jmodel.create_cornell_box(), tmodel.create_cornell_box()
    jr = JaxRenderer(js, None, JaxConfig(width=32, height=32, accel="bvh",
                                         stable_bake=False))
    tr = ProgressiveRenderer(ts, None, RenderConfig(width=32, height=32),
                             device="cpu")
    branches = []
    step = tr.step

    def step_and_note():
        out = step()
        branches.append(tr.last_replay)
        return out

    tr.step = step_and_note
    want = _session(jr, js, J)
    got = _session(tr, ts, T)
    assert [b for b in branches if b] == ["refit", "materials", "materials",
                                          "prebake"]
    for i, (g, w) in enumerate(zip(got, want)):
        assert np.isfinite(g).all() and g.mean() > 0
        flipped = _flipped(g, w)
        print(f"edit session image {i}: {int(flipped.sum())} flipped pixels "
              f"of {flipped.size}")
        assert flipped.mean() <= MAX_FLIPPED


def test_interactive_session_example_runs_on_cpu(capsys):
    from raytracer_tpu_torch.examples import interactive_session

    out = interactive_session.run(interactive_session.build_parser(
    ).parse_args(["--device", "cpu", "--size", "16x12"]))
    assert list(out["latency_ms"]) == list(interactive_session.EDITS)
    assert out["branch"] == {"camera_move": None, "transform_drag": "refit",
                             "material_paint": "materials",
                             "light_brighten": "materials",
                             "object_add": "prebake"}
    assert out["same_bvh"]["transform_drag"]
    assert out["same_geometry"]["material_paint"]
    assert out["same_geometry"]["light_brighten"]
    assert "worst edit latency" in capsys.readouterr().out


def test_interactive_session_example_1080p_mode_on_cpu():
    """The --1080p loop (edits shown on the denoised preview, full-res
    resume after each) at a small size."""
    from raytracer_tpu_torch.examples import interactive_session

    out = interactive_session.run(interactive_session.build_parser(
    ).parse_args(["--1080p", "--device", "cpu", "--size", "16x12",
                  "--preview-scale", "2"]))
    assert list(out["resume_ms"]) == list(interactive_session.EDITS)
    assert out["branch"]["object_add"] == "prebake"


def test_live_edit_example_runs_on_cpu(tmp_path, capsys):
    from raytracer_tpu_torch.examples import live_edit
    from raytracer_tpu_torch.utils.image import read_png

    prefix = str(tmp_path / "le")
    assert live_edit.main([prefix, "--size", "12x10", "--frames", "2",
                           "--device", "cpu"]) == 0
    before, after = read_png(prefix + "_before.png"), read_png(
        prefix + "_after.png")
    assert before.shape == after.shape == (10, 12, 3)
    assert not np.array_equal(before, after)
    assert "(materials replay)" in capsys.readouterr().out


def test_turntable_example_runs_on_cpu(tmp_path):
    from raytracer_tpu_torch.examples import turntable
    from raytracer_tpu_torch.utils.image import read_png

    assert turntable.main(["--frames", "2", "--spp", "1", "--size", "12x10",
                           "--outdir", str(tmp_path), "--device",
                           "cpu"]) == 0
    a = read_png(str(tmp_path / "turntable_000.png"))
    b = read_png(str(tmp_path / "turntable_001.png"))
    assert a.shape == (10, 12, 3) and not np.array_equal(a, b)
