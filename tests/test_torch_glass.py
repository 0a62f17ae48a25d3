"""The benchmark's glass deployment and its spp-batched cell on the CPU, at
the harness's tiny size (portbench/test_portbench_harness.py's `tiny`:
16 x 12 pixels on a scene of a few thousand triangles):

- `glassatrium300k-nee-d8`, the atrium with its column spheres turned to
  clear, crown and flint glass (portbench/scenes/glassatrium.py), at depth
  8 with deep compaction, and `atrium300k-spp4-d3`, four samples a pixel a
  launch, each equal to the plain reference (portbench/harness/
  reference.py) bit for bit on three seeds;
- the control, the reference in bfloat16 in the program's place, fails
  the cells' limits;
- a fault planted in the program's scene alone (the flint's dispersion
  dropped) reads `correct` false;
- the glass scene is the atrium at the same size but for the three
  column materials.
"""

import copy
import dataclasses
import os
import sys
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "portbench")
sys.path[:0] = [BENCH, ROOT]

from harness import cell as cells  # noqa: E402
from harness import check, program, spec  # noqa: E402
from test_portbench_harness import tiny  # noqa: E402

GLASS = "glassatrium300k-nee-d8"
SPP4 = "atrium300k-spp4-d3"


def _run(name, seed, control=False):
    import torch

    torch.manual_seed(0)
    return cells.run_cell(tiny(name), seed, 0.5, False, "cpu",
                          time.perf_counter(), control=control)


@pytest.mark.parametrize("seed", [20260, 7, 3300000019])
@pytest.mark.parametrize("name", [GLASS, SPP4])
def test_cell_equals_the_reference(name, seed):
    out = _run(name, seed)
    assert out["correct"], out["check"]
    assert all(row["value"] == 0.0 for row in out["check"].values()), \
        out["check"]


@pytest.mark.parametrize("name", [GLASS, SPP4])
def test_the_control_fails(name):
    out = _run(name, 20260, control=True)
    ok, _ = check.verdict(out["control"], spec.cell(name).traffic["limits"])
    assert not ok, out["control"]


def test_the_flint_without_dispersion_in_the_program_alone_is_not_correct(
        monkeypatch):
    """The program renders the flint without dispersion, so its paths lock
    no channel and draw one number fewer; the reference keeps it."""
    own = program.program_scene

    def planted(desc):
        desc = copy.deepcopy(desc)
        i = next(k for k, m in enumerate(desc.materials)
                 if m.name == "glass_flint")
        desc.materials[i] = dataclasses.replace(desc.materials[i],
                                                dispersion=0.0)
        return own(desc)

    monkeypatch.setattr(program, "program_scene", planted)
    out = _run(GLASS, 20260)
    assert not out["correct"], out["check"]


def test_the_glass_scene_is_the_atrium_with_glass_columns():
    glass, atrium = spec.cell(GLASS), spec.cell("atrium300k-nee-d8")
    assert glass.config["scene"]["args"] == atrium.config["scene"]["args"]
    for key in ("width", "height", "camera", "render", "seed_varies"):
        assert glass.config[key] == atrium.config[key], key
    g, a = glass.build_scene(6000), atrium.build_scene(6000)
    assert g.num_triangles == a.num_triangles
    assert [(o.name, o.mesh, o.material, o.position, o.rotation, o.scale)
            for o in g.objects] == [
        (o.name, o.mesh, o.material, o.position, o.rotation, o.scale)
        for o in a.objects]
    for mg, ma in zip(g.meshes, a.meshes):
        assert (mg.positions == ma.positions).all()
        assert (mg.indices == ma.indices).all()
    spheres = {o.material for o in g.objects if o.name.startswith("col_")}
    want = {"glass_clear": (0.98, 1.5, 0.0),
            "glass_crown": (0.98, 1.5168, 20.0 / 64.2),
            "glass_flint": (0.97, 1.7847, 20.0 / 25.8)}
    assert {g.materials[i].name for i in spheres} == set(want)
    for i in spheres:
        m = g.materials[i]
        albedo, ior, dispersion = want[m.name]
        assert m.albedo == (albedo,) * 3
        assert (m.transmission, m.roughness, m.metallic) == (1.0, 0.0, 0.0)
        assert (m.ior, m.dispersion) == (ior, pytest.approx(dispersion))
    rest = [i for i in range(len(a.materials)) if i not in spheres]
    assert [g.materials[i] for i in rest] == [a.materials[i] for i in rest]
    assert not any(g.materials[i].transmission for i in rest)
