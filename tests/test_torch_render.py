"""The port's whole render path (ProgressiveRenderer on CPU tensors, so the
traversal kernels run as their plain torch versions) against the JAX
package's, plus checkpoints across packages, the port's CLI, and the rule
that the port never imports jax.

Tolerance: every pixel within 1e-4 of the reference, except "flipped"
pixels, where a Russian-roulette, lobe or light lottery, or a hit on a
shared mesh edge, fell the other way because the two packages round a few
f32 terms differently. Flipped pixels may be at most 1% of the image; each
test prints its count. Both sides use the numpy BVH builder."""

import functools
import logging
import os
import subprocess
import sys

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
from raytracer_tpu.utils.config import RenderConfig as JaxConfig
from raytracer_tpu_torch.api import ProgressiveRenderer
from raytracer_tpu_torch.ops import binary_traverse
from raytracer_tpu_torch.utils.config import RenderConfig

torch.set_num_threads(1)  # see test_torch_ops.py

PIXEL_ATOL = 1e-4
MAX_FLIPPED = 0.01
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def numpy_builders(monkeypatch):
    monkeypatch.setattr(jnative, "available", lambda: False)
    monkeypatch.setattr(tnative, "available", lambda: False)


def _flipped(a, b):
    return np.abs(a - b).max(axis=-1) > PIXEL_ATOL


def _port(scene, w, h, frames, **cfg):
    return ProgressiveRenderer(scene, None, RenderConfig(width=w, height=h,
                                                         **cfg),
                               device="cpu").render(frames)


@functools.cache
def _jax(jmake, w, h, frames, accel, **cfg):
    """The JAX package's image of the scene `jmake()` (kept per module: the
    tests read, never write, it)."""
    return JaxRenderer(jmake(), None, JaxConfig(
        width=w, height=h, accel=accel, stable_bake=False,
        **cfg)).render(frames)


RENDER_CASES = [
    ("cornell", jmodel.create_cornell_box, tmodel.create_cornell_box, 32, 3),
    ("lightgrid", jbench.create_benchmark_lightgrid,
     tbench.create_benchmark_lightgrid, 24, 2),
]


@pytest.mark.parametrize("case", RENDER_CASES)
def test_render_matches_jax_walk(case):
    name, jmake, tmake, size, frames = case
    want = _jax(jmake, size, size, frames, "bvh")
    got = _port(tmake(), size, size, frames)
    assert np.isfinite(got).all() and got.mean() > 0
    flipped = _flipped(got, want)
    print(f"{name} {size}x{size} x{frames} frames: {int(flipped.sum())} "
          f"flipped pixels of {flipped.size}")
    assert flipped.mean() <= MAX_FLIPPED


@pytest.mark.parametrize("case", RENDER_CASES)
def test_bvh_render_matches_jax_walk(case):
    """accel="bvh" (the binary tree's traversal) against JAX accel="bvh"."""
    name, jmake, tmake, size, frames = case
    want = _jax(jmake, size, size, frames, "bvh")
    got = _port(tmake(), size, size, frames, accel="bvh")
    assert np.isfinite(got).all() and got.mean() > 0
    flipped = _flipped(got, want)
    print(f"{name} {size}x{size} x{frames} frames, accel=bvh: "
          f"{int(flipped.sum())} flipped pixels of {flipped.size}")
    assert flipped.mean() <= MAX_FLIPPED


@pytest.mark.parametrize("accel", ["cuda", "auto"])
def test_t_min_falls_back_to_bvh(accel, caplog):
    """The 4-wide kernels fix t_min at 1e-3: another t_min warns, renders
    on accel="bvh", and matches the JAX package, which falls back too."""
    with caplog.at_level(logging.WARNING, logger=tapi.__name__):
        r = ProgressiveRenderer(tmodel.create_cornell_box(), None,
                                RenderConfig(width=20, height=14, t_min=0.01,
                                             accel=accel), device="cpu")
    assert r.config.accel == "bvh"
    assert "t_min=0.01 unsupported by accel='cuda'" in caplog.text
    assert "falling back to accel='bvh'" in caplog.text
    got = r.render(2)
    want = _jax(jmodel.create_cornell_box, 20, 14, 2, "pallas", t_min=0.01)
    flipped = _flipped(got, want)
    print(f"t_min=0.01 cornell 20x14 x2 frames: {int(flipped.sum())} "
          f"flipped pixels of {flipped.size}")
    assert flipped.mean() <= MAX_FLIPPED


def test_stack_need_falls_back_to_bvh(monkeypatch, caplog):
    """A 4-wide tree whose stack need exceeds the kernels' stack warns and
    renders on accel="bvh" from the same bake."""
    monkeypatch.setattr(tapi, "CAP", 1)
    with caplog.at_level(logging.WARNING, logger=tapi.__name__):
        r = ProgressiveRenderer(tmodel.create_cornell_box(), None,
                                RenderConfig(width=12, height=10),
                                device="cpu")
    assert r.config.accel == "bvh"
    assert "exceeds the quad traversal kernel's stack" in caplog.text
    got = r.render(1)
    want = _port(tmodel.create_cornell_box(), 12, 10, 1, accel="bvh")
    np.testing.assert_array_equal(got, want)


def test_bvh_walks_a_tree_deeper_than_its_stack(monkeypatch, caplog):
    """A tree deeper than STACK_CAP - 2, which K3/K4 refuse, renders with
    the skip-link walk (a warning says so), against JAX accel="bvh" (the
    same walk) within tolerance; it was refused before the walk was
    ported."""
    monkeypatch.setattr(binary_traverse, "STACK_CAP", 3)
    with caplog.at_level(logging.WARNING, logger=tapi.__name__):
        r = ProgressiveRenderer(tmodel.create_cornell_box(), None,
                                RenderConfig(width=16, height=16,
                                             accel="bvh"),
                                device="cpu")
    assert "skip-link walk" in caplog.text
    assert r.device_scene.nodes_packed is not None
    got = r.render(2)
    want = _jax(jmodel.create_cornell_box, 16, 16, 2, "bvh")
    flipped = _flipped(got, want)
    print(f"skip-link walk cornell 16x16 x2: {int(flipped.sum())} flipped "
          f"of {flipped.size}")
    assert flipped.mean() <= MAX_FLIPPED


def test_render_matches_jax_pallas_kernels():
    """Against the Pallas kernels (interpret mode). At 16x16 frame 0 the
    back wall's diagonal (an edge shared by two triangles) runs through
    pixel centers, and the JAX kernels themselves disagree there: the
    sub-packet kernel misses 6 of those edge rays that its skip-link walk
    hits, and the walk misses 2 others. The port hits all of them, so it
    differs from each JAX path on those pixels; the gate is that it
    agrees with one of the two JAX traversals at all but 1% of pixels."""
    pallas = _jax(jmodel.create_cornell_box, 16, 16, 1, "pallas")
    walk = _jax(jmodel.create_cornell_box, 16, 16, 1, "bvh")
    got = _port(tmodel.create_cornell_box(), 16, 16, 1)
    vs_pallas, vs_walk = _flipped(got, pallas), _flipped(got, walk)
    vs_both = vs_pallas & vs_walk
    print(f"cornell 16x16: {int(vs_pallas.sum())} pixels off the pallas "
          f"path, {int(vs_walk.sum())} off the walk, {int(vs_both.sum())} "
          f"off both, of {vs_both.size}")
    assert vs_both.mean() <= MAX_FLIPPED


def test_brute_oracle_matches_quad_traversal():
    a = _port(tmodel.create_cornell_box(), 16, 16, 1, accel="brute")
    b = _port(tmodel.create_cornell_box(), 16, 16, 1)
    assert _flipped(a, b).mean() <= MAX_FLIPPED


def test_jax_checkpoint_resumes_in_port(tmp_path):
    path = str(tmp_path / "ck.npz")
    jr = JaxRenderer(jmodel.create_cornell_box(), None, JaxConfig(
        width=16, height=12, accel="bvh", stable_bake=False))
    jr.render(2)
    jr.save_checkpoint(path)
    port = ProgressiveRenderer(tmodel.create_cornell_box(), None,
                               RenderConfig(width=16, height=12),
                               device="cpu")
    port.load_checkpoint(path)
    assert port.frame == 2
    np.testing.assert_array_equal(port.image(), jr.image())
    want = jr.render(1)
    got = port.render(1)
    assert port.frame == 3
    flipped = _flipped(got, want)
    print(f"resumed frame 2 -> 3: {int(flipped.sum())} flipped pixels")
    assert flipped.mean() <= MAX_FLIPPED
    # And back: the port's checkpoint loads into the JAX renderer.
    port.save_checkpoint(path)
    jr2 = JaxRenderer(jmodel.create_cornell_box(), None, JaxConfig(
        width=16, height=12, accel="bvh", stable_bake=False))
    jr2.load_checkpoint(path)
    assert jr2.frame == 3
    np.testing.assert_array_equal(jr2.image(), got)


CORNELL_JSON = """{
  "materials": {
    "white": {"albedo": [0.73, 0.73, 0.73], "roughness": 1.0},
    "red": {"albedo": [0.65, 0.05, 0.05], "roughness": 1.0},
    "green": {"albedo": [0.12, 0.45, 0.15], "roughness": 1.0},
    "metal": {"albedo": [0.9, 0.9, 0.9], "metallic": 1.0, "roughness": 0.2},
    "light": {"albedo": [1, 1, 1], "emission_color": [1, 0.9, 0.8],
              "emission_power": 10.0}
  },
  "objects": {
    "floor": {"mesh": "Plane", "material": "white",
              "transform": {"position": [0, -1, 0], "rotation": [-90, 0, 0],
                            "scale": [2, 2, 1]}},
    "ceiling": {"mesh": "Plane", "material": "white",
                "transform": {"position": [0, 1, 0], "rotation": [90, 0, 0],
                              "scale": [2, 2, 1]}},
    "back": {"mesh": "Plane", "material": "white",
             "transform": {"position": [0, 0, 1], "rotation": [0, 180, 0],
                           "scale": [2, 2, 1]}},
    "left": {"mesh": "Plane", "material": "red",
             "transform": {"position": [-1, 0, 0], "rotation": [0, 90, 0],
                           "scale": [2, 2, 1]}},
    "right": {"mesh": "Plane", "material": "green",
              "transform": {"position": [1, 0, 0], "rotation": [0, -90, 0],
                            "scale": [2, 2, 1]}},
    "ball": {"mesh": "Sphere", "material": "metal",
             "transform": {"position": [0.3, -0.6, 0.3],
                           "scale": [0.4, 0.4, 0.4]}},
    "lamp": {"mesh": "Plane", "material": "light",
             "transform": {"position": [0, 0.99, 0], "rotation": [90, 0, 0],
                           "scale": [0.6, 0.6, 1]}}
  }
}"""


def test_cli_writes_png(tmp_path):
    from raytracer_tpu_torch import cli
    from raytracer_tpu_torch.utils.image import read_png

    scene = tmp_path / "box.json"
    scene.write_text(CORNELL_JSON)
    out = tmp_path / "out.png"
    ck = tmp_path / "ck.npz"
    argv = [str(scene), "--width", "24", "--height", "16", "--spp", "2",
            "--device", "cpu", "--out", str(out), "--checkpoint", str(ck)]
    assert cli.main(argv) == 0
    img = read_png(str(out))
    assert img.shape == (16, 24, 3)
    assert img.std() > 0
    # Resume from the checkpoint to 3 samples.
    argv[argv.index("--spp") + 1] = "3"
    assert cli.main(argv) == 0
    assert int(np.load(str(ck))["frame"]) == 3


@pytest.mark.parametrize("accel", ["bvh", "brute"])
def test_cli_renders_with_accel(tmp_path, accel):
    from raytracer_tpu_torch import cli
    from raytracer_tpu_torch.utils.image import read_png

    scene = tmp_path / "box.json"
    scene.write_text(CORNELL_JSON)
    out = tmp_path / "out.png"
    assert cli.main([str(scene), "--width", "12", "--height", "10", "--spp",
                     "1", "--device", "cpu", "--out", str(out), "--accel",
                     accel]) == 0
    img = read_png(str(out))
    assert img.shape == (10, 12, 3)
    assert img.std() > 0


@pytest.mark.parametrize("flag", [["--restir", "--adaptive", "0.1"],
                                  ["--restir", "--spp-batch", "2"]])
def test_cli_refuses_unported_modes(tmp_path, flag):
    """Modes that cannot run together exit with a parser error."""
    from raytracer_tpu_torch import cli

    scene = tmp_path / "box.json"
    scene.write_text(CORNELL_JSON)
    argv = [str(scene), "--width", "8", "--height", "8", "--spp", "1",
            "--device", "cpu", "--out", str(tmp_path / "o.png"), *flag]
    with pytest.raises((SystemExit, NotImplementedError)):
        cli.main(argv)


@pytest.mark.parametrize("flag,files", [
    (["--adaptive", "0.1"], []),
    (["--denoise"], []),
    (["--spp-batch", "2"], []),
    (["--aovs", "AOV"], ["AOV_albedo.png", "AOV_normal.png",
                         "AOV_depth.png"]),
    (["--preview", "1", "--preview-scale", "2"], []),
    (["--restir", "--checkpoint", "CK"], []),
], ids=["adaptive", "denoise", "spp_batch", "aovs", "preview", "restir"])
def test_cli_runs_ported_modes(tmp_path, flag, files, capsys):
    """The modes of ROADMAP items P7-P10 run on the in-repo Cornell JSON,
    exit 0 and write the full-resolution image (and the AOV PNGs; with
    --restir the checkpoint carries the reservoir)."""
    from raytracer_tpu_torch import cli
    from raytracer_tpu_torch.utils.image import read_png

    scene = tmp_path / "box.json"
    scene.write_text(CORNELL_JSON)
    out = tmp_path / "o.png"
    names = {"AOV": "AOV", "CK": "ck.npz"}
    flag = [str(tmp_path / names[f]) if f in names else f for f in flag]
    assert cli.main([str(scene), "--width", "16", "--height", "12", "--spp",
                     "2", "--device", "cpu", "--out", str(out),
                     *flag]) == 0
    img = read_png(str(out))
    assert img.shape == (12, 16, 3) and img.std() > 0
    for name in files:
        aov = read_png(str(tmp_path / name))
        assert aov.shape == (12, 16, 3)
    if "--restir" in flag:
        ck = np.load(str(tmp_path / "ck.npz"))
        assert int(ck["frame"]) == 2 and ck["reservoir_m"].max() > 0
    if "--preview" in flag:
        # The preview cadence prints the stats table every frame.
        assert capsys.readouterr().out.count("ms/frame") == 2


@pytest.mark.parametrize("kw", [dict(mesh=object())], ids=["mesh"])
def test_renderer_refuses_unported_modes(kw):
    """A mesh outside any process group is refused, with the way to start
    one (the sharded renderer itself: tests/test_torch_sharding.py)."""
    with pytest.raises(RuntimeError, match="torchrun.*init_process_group"):
        ProgressiveRenderer(tmodel.create_cornell_box(), None,
                            RenderConfig(width=8, height=8), device="cpu",
                            **kw)


@pytest.mark.parametrize("field", [dict(adaptive_tol=0.1),
                                   dict(spp_batch=2),
                                   dict(denoise_preview=True),
                                   dict(use_restir=True)])
def test_renderer_runs_ported_modes(field):
    r = ProgressiveRenderer(tmodel.create_cornell_box(), None,
                            RenderConfig(width=8, height=8, **field),
                            device="cpu")
    img = r.render(2)
    assert r.frame == 2
    assert img.shape == (8, 8, 3) and np.isfinite(img).all()
    assert img.mean() > 0


def test_port_never_imports_jax():
    code = (
        "import sys\n"
        "import raytracer_tpu_torch.accel.native_builder as nb\n"
        "nb.available = lambda: False\n"
        "from raytracer_tpu_torch import cli\n"
        "from raytracer_tpu_torch.api import render\n"
        "from raytracer_tpu_torch.scene.model import create_cornell_box\n"
        "from raytracer_tpu_torch.utils.config import RenderConfig\n"
        "for accel in ('auto', 'bvh'):\n"
        "    img = render(create_cornell_box(), config=RenderConfig(width=8, "
        "height=8, accel=accel), device='cpu')\n"
        "    assert img.shape == (8, 8, 3)\n"
        "from raytracer_tpu_torch.lab import bvh4_lab, kernel_lab, occl_lab, "
        "rays\n"
        "from raytracer_tpu_torch.scene.device_scene import bake_scene\n"
        "ds, _ = bake_scene(create_cornell_box(), device='cpu')\n"
        "o, d, tm = rays.closest_sets(ds, 8, 8)['bounce1_sorted']\n"
        "assert kernel_lab.run_closest_lab(o, d, tm, ds, 'pop2')[4].sum() > 0\n"
        "o, d, tm, skip, _ = rays.shadow_sets(ds, 8, 8)['shadow_b0']\n"
        "occl_lab.run_occl_lab(o, d, tm, skip, ds, 'resort')\n"
        "bvh4_lab.run_closest4(o, d, tm, ds, ordered=False)\n"
        "from raytracer_tpu_torch.lab import r3_kernel_lab, v2_kernel_lab, "
        "v3_kernel_lab, v4_interleave_lab\n"
        "o, d, tm = rays.closest_sets(ds, 8, 8)['primary']\n"
        "v2_kernel_lab.run_closest_v2(o, d, tm, ds, "
        "v2_kernel_lab.to_component_major(ds.ptris))\n"
        "assert v3_kernel_lab.run_closest_v3(o, d, tm, ds, "
        "variant='dblread')[5].sum() > 0\n"
        "v4_interleave_lab.run_closest_v4(o, d, tm, ds, 'shared')\n"
        "r3_kernel_lab.run_closest_variant(o, d, tm, ds, True, True)\n"
        "from raytracer_tpu_torch.lab import r3_occl3_lab, r3_oct_lab\n"
        "ds8, bvh = bake_scene(create_cornell_box(), leaf_size=8, "
        "device='cpu')\n"
        "tree = r3_oct_lab.oct_tree(bvh, 'cpu')\n"
        "o, d, tm = rays.closest_sets(ds8, 8, 8)['bounce1']\n"
        "r3_oct_lab.run_closest8(o, d, tm, tree, ds8.ptris)\n"
        "o, d, tm, skip, _ = rays.shadow_sets(ds8, 8, 8)['shadow_b1']\n"
        "r3_occl3_lab.run_occl_ordered(o, d, tm, skip, ds8, ordered=True)\n"
        "from raytracer_tpu_torch.lab import bf16_lab, fixed_seq, smem_lab, "
        "visit_cost_lab\n"
        "o, d = fixed_seq.lab_rays_const(64, 'cpu')\n"
        "visit_cost_lab.run_visit(o, d, ds8.pnodes, 'full', 4)\n"
        "visit_cost_lab.run_leaf_visit(o, d, ds8.ptris, 'ilp', 4)\n"
        "smem_lab.run_smem(o, d, ds8.ptris, 'smem', 4)\n"
        "x, y = bf16_lab.inputs('f32_fma', 1)\n"
        "bf16_lab.run_bf16('f32_fma', x, y, 8)\n"
        "bf16_lab.run_bf16('bf16', *bf16_lab.inputs('bf16', 1), 8)\n"
        "from raytracer_tpu_torch.integrator import adaptive, denoise\n"
        "r = __import__('raytracer_tpu_torch.api', fromlist=['x'])."
        "ProgressiveRenderer(create_cornell_box(), None, RenderConfig("
        "width=8, height=8, adaptive_tol=0.1, denoise_preview=True), "
        "device='cpu')\n"
        "r.step(); r.image(); r.aovs(); r.preview_image(2)\n"
        "img = render(create_cornell_box(), config=RenderConfig(width=8, "
        "height=8, use_restir=True), device='cpu')\n"
        "assert img.shape == (8, 8, 3) and img.mean() > 0\n"
        "from raytracer_tpu_torch.ops import quad_traverse\n"
        "assert quad_traverse.leaf_counts(ds8).min() > 0\n"
        "from raytracer_tpu_torch.utils import profile_frame\n"
        "from raytracer_tpu_torch.lab import quad_variant_lab\n"
        "quad_variant_lab.variants(quad_variant_lab.source_values(open("
        "quad_variant_lab.SOURCE).read()))\n"
        "import dataclasses, tempfile\n"
        "from raytracer_tpu_torch.examples import interactive_session, "
        "live_edit, turntable\n"
        "tmp = tempfile.mkdtemp()\n"
        "live_edit.main([tmp + '/le', '--size', '8x8', '--frames', '1', "
        "'--device', 'cpu'])\n"
        "turntable.main(['--frames', '1', '--spp', '1', '--size', '8x8', "
        "'--outdir', tmp, '--device', 'cpu'])\n"
        "s = r.scene\n"
        "s.update_object_position(6, (0.5, 1.5, -1.0)); r.step()\n"
        "s.update_material(0, dataclasses.replace(s.materials[0], "
        "albedo=(0.9, 0.1, 0.1))); r.step()\n"
        "s.delete_object(7); r.prebake_async(); r.step()\n"
        "assert r.last_replay == 'prebake'\n"
        "from raytracer_tpu_torch import compare\n"
        "from raytracer_tpu_torch.parallel import sharding\n"
        "from raytracer_tpu_torch.utils import profiling\n"
        "from raytracer_tpu_torch.examples import multichip\n"
        "t = profiling.PhaseTimer()\n"
        "with t.phase('x', [r.accum]): pass\n"
        "assert 'x' in t.report()\n"
        "assert multichip.main(['--spawn', '2', '--device', 'cpu', "
        "'--size', '32x32', '--frames', '1', '--outdir', tmp]) == 0\n"
        "from raytracer_tpu_torch.ops import traverse\n"
        "from raytracer_tpu_torch.utils import compile_cache\n"
        "assert compile_cache.build_dir()\n"
        "from raytracer_tpu_torch.ops import binary_traverse\n"
        "binary_traverse.STACK_CAP = 3\n"
        "ds, _ = bake_scene(create_cornell_box(), device='cpu', "
        "stable_shapes=True)\n"
        "binary_traverse.STACK_CAP = 128\n"
        "o, d, tm = rays.closest_sets(ds, 8, 8)['primary']\n"
        "assert traverse.intersect_bvh(o, d, ds, 1e-3, tm).hit.any()\n"
        "ds, _ = bake_scene(create_cornell_box(), device='cpu', "
        "pallas_budget_bytes=96 * 1024)\n"
        "assert ds.num_parts > 1\n"
        "img = render(create_cornell_box(), config=RenderConfig(width=8, "
        "height=8, max_depth=5), device='cpu')\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "assert 'raytracer_tpu' not in sys.modules\n"
        "print('NO_JAX_OK')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "NO_JAX_OK" in proc.stdout
