"""CPU tests of the benchmark harness (portbench/), at tiny sizes, without
a card:

    python -m pytest portbench/test_portbench_harness.py -q

They show that every name in BENCHMARK.json resolves to its file, that a
configuration, traffic mix or metric added as a new file is found without
an edit to an existing one, that the measurement path refuses to run
without a card, that a run loads neither JAX nor the JAX package and the
reference nothing of the program, that the reference agrees with the
program bit for bit on the CPU, and that the check fails the control
(the reference in bfloat16 in the program's place) and a run whose timed
path is broken. The one test that needs a card skips here.
"""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [HERE, ROOT]

from harness import cell as cells  # noqa: E402
from harness import spec  # noqa: E402

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


def tiny(name):
    """The cell `name` at 16 x 12 pixels on a scene of a few thousand
    triangles."""
    c = spec.cell(name)
    c.config["width"], c.config["height"] = 16, 12
    args = c.config["scene"]["args"]
    if "target_triangles" in args:
        args["target_triangles"] = 6000
    if c.traffic["check"]["mode"] == "step":
        c.traffic["check"]["pixels"] = 48
    return c


def run(c, seed=20260, control=False, seconds=0.5):
    import torch

    torch.manual_seed(0)
    return cells.run_cell(c, seed, seconds, False, "cpu",
                          time.perf_counter(), control=control)


@pytest.mark.parametrize("name", CELLS)
def test_every_name_resolves(name):
    c = spec.cell(name)
    assert c.config and c.traffic and callable(c.build_scene)
    readers = spec.readers(c.per_layer)
    assert set(readers) == {m["name"] for m in c.per_layer}
    assert {m["name"] for m in c.end_to_end} <= set(cells.E2E)


def test_added_files_are_found(tmp_path):
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    before = {p: (tmp_path / p).read_bytes()
              for p in ["BENCHMARK.json"] + [
                  os.path.relpath(os.path.join(d, f), tmp_path)
                  for d, _, fs in os.walk(tmp_path / "portbench")
                  for f in fs]}
    pb = tmp_path / "portbench"
    (pb / "scenes" / "onebox.py").write_text(
        "from harness.scenedesc import Material, SceneDesc, box\n"
        "def build():\n"
        "    s = SceneDesc()\n"
        "    m = s.add_material(Material(albedo=(0.5, 0.5, 0.5)))\n"
        "    s.add_object('b', s.add_mesh(box()), m)\n"
        "    return s\n")
    cfg = json.loads((pb / "configs" / "atrium300k-1080p.json").read_text())
    cfg["scene"] = {"generator": "onebox", "args": {}}
    (pb / "configs" / "onebox-64.json").write_text(json.dumps(cfg))
    mix = json.loads((pb / "traffic" / "nee-d3.json").read_text())
    mix["render"]["max_depth"] = 2
    (pb / "traffic" / "nee-d2.json").write_text(json.dumps(mix))
    (pb / "metrics" / "frames_seen.py").write_text(
        "def read(run):\n    return float(len(run.enqueue_ms))\n")
    # The new entries: BENCHMARK.json gains lines, no file is edited.
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="onebox-64",
                                 file="portbench/configs/onebox-64.json"))
    bench["workloads"].append({"name": "onebox-nee-d2", "config": "onebox-64",
                               "traffic": "nee-d2", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "frames_seen", "unit": "frames",
                               "better": "higher", "source": "host_clock",
                               "layer": "renderer", "moves": "frame_ms",
                               "workloads": ["onebox-nee-d2"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    c = spec.cell("onebox-nee-d2", root=str(tmp_path))
    assert c.config["scene"]["generator"] == "onebox"
    assert c.traffic["render"]["max_depth"] == 2
    assert c.build_scene().num_triangles == 12
    readers = spec.readers(c.per_layer, root=str(tmp_path))
    assert set(readers) == {"frames_seen"}
    for p, data in before.items():
        if p != "BENCHMARK.json":
            assert (tmp_path / p).read_bytes() == data, p


def test_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, os.path.join(HERE, "run.py"), "--workload",
         CELLS[0], "--seed", "7", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "no CUDA device" in proc.stderr


_MODULES = """
import sys, time
sys.path[:0] = [{here!r}, {root!r}]
from harness import spec, cell as cells
c = spec.cell({name!r})
c.config["width"], c.config["height"] = 8, 6
c.config["scene"]["args"]["target_triangles"] = 3000
cells.run_cell(c, 5, 0.2, True, "cpu", time.perf_counter())
print(" ".join(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

_REFERENCE = """
import sys
sys.path[:0] = [{here!r}, {root!r}]
import harness.check, harness.reference, harness.refrestir
print(" ".join(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_names(code):
    proc = subprocess.run(
        [sys.executable, "-c", code.format(here=HERE, root=ROOT,
                                           name=CELLS[0])],
        capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return set(proc.stdout.split())


def test_a_run_loads_no_jax():
    names = _top_names(_MODULES)
    assert "raytracer_tpu_torch" in names  # the port ran
    assert not names & {"jax", "jaxlib", "flax", "raytracer_tpu"}


def test_the_reference_imports_nothing_of_the_program():
    names = _top_names(_REFERENCE)
    assert "torch" in names
    assert not names & {"raytracer_tpu_torch", "raytracer_tpu", "jax"}


@pytest.mark.parametrize("name", ["atrium300k-nee-d3",
                                  "lightgrid64-restir-d3"])
def test_program_equals_reference_and_the_control_fails(name):
    from harness import check

    out = run(tiny(name), control=True)
    assert out["correct"], out["check"]
    assert all(row["value"] == 0.0 for row in out["check"].values())
    limits = spec.cell(name).traffic["limits"]
    ok, _ = check.verdict(out["control"], limits)
    assert not ok, out["control"]


def _broken(kind, restir):
    """A wrapper of the renderer's frame function that breaks it."""
    import torch

    def wrap(own):
        def frame(scene, ubo, accum, *args, **kwargs):
            out = own(scene, ubo, accum, *args, **kwargs)
            new = out[0]
            if kind == "unchanged":
                # The step hands its state back as it came.
                return ((accum, args[0], *out[2:]) if restir
                        else (accum, *out[1:]))
            if kind == "half":
                # Every other pixel left out of the frame.
                keep = torch.arange(new.shape[0]) % 2 == 0
                new = torch.where(keep[:, None], new, accum)
            elif kind == "altered":
                new = new.flip(-1)  # channels swapped where produced
            return (new, *out[1:])
        return frame

    return wrap


@pytest.mark.parametrize("name,restir", [("atrium300k-nee-d3", False),
                                         ("lightgrid64-restir-d3", True)])
@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, name, restir, kind):
    from raytracer_tpu_torch import api

    attr = "render_frame_restir" if restir else "render_frame"
    monkeypatch.setattr(api, attr, _broken(kind, restir)(getattr(api, attr)))
    out = run(tiny(name))
    assert not out["correct"], out["check"]


@pytest.mark.parametrize("field,factor", [("m", 2.0), ("w", 1.25)])
def test_a_drift_in_an_early_frame_is_not_correct(monkeypatch, field,
                                                   factor):
    """Frame 1 alone hands on a reservoir with M doubled, or with W raised
    by a quarter; every later frame is sound, so only the chain from
    empty reservoirs sees it."""
    from raytracer_tpu_torch import api

    own = api.render_frame_restir

    def frame(scene, ubo, accum, reservoir, number, *args, **kwargs):
        out = own(scene, ubo, accum, reservoir, number, *args, **kwargs)
        if number == 1:
            res = out[1]._replace(**{field: getattr(out[1], field) * factor})
            out = (out[0], res, *out[2:])
        return out

    monkeypatch.setattr(api, "render_frame_restir", frame)
    out = run(tiny("lightgrid64-restir-d3"))
    assert not out["correct"], out["check"]
    late = ("frame_mean_gap", "reservoir_mismatch", "start_mean_gap")
    assert all(out["check"][k]["value"] <= out["check"][k]["limit"]
               for k in late), out["check"]


class _Event:
    """A kineto event as harness/trace.py reads it."""

    def __init__(self, name, t0, t1, on_device, corr=0, linked=0):
        self._v = (name, t0, t1, on_device, corr, linked)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def end_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[2] - self._v[1]

    def device_type(self):
        from torch.autograd import DeviceType

        return DeviceType.CUDA if self._v[3] else DeviceType.CPU

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]


def test_the_trace_splits_busy_time_by_layer():
    from harness import trace

    E = _Event
    events = [
        # Host: two launches, a ReSTIR range around the second, a third.
        E("aten::mul", 0, 10, False, corr=1),
        E("portbench.restir_direct", 15, 60, False, corr=2),
        E("aten::add", 20, 30, False, corr=3),
        E("cudaLaunchKernel", 40, 45, False, corr=4),
        # Device: the range's span, a shading kernel, a ReSTIR kernel,
        # a traversal kernel under the range, a shading kernel after it.
        E("portbench.restir_direct", 25, 90, True),
        E("mul_kernel", 12, 22, True, linked=1),
        E("add_kernel", 30, 50, True, linked=3),
        E("occlusion_kernel", 55, 65, True, linked=2),
        E("copy_kernel", 100, 140, True, linked=4),
    ]
    s = trace.summarize(events, 2, 1e-6, "portbench.restir_direct")
    assert s.restir_spans == 1
    assert s.busy_s == pytest.approx(80e-9)
    assert s.trace_s == pytest.approx(10e-9)
    assert s.restir_s == pytest.approx(20e-9)
    assert s.shade_s == pytest.approx(50e-9)
    # Gaps: 22..30 waits on aten::add, 50..55 on the range, 65..100 on the
    # launch that issued copy_kernel.
    assert dict(s.idle_gaps) == pytest.approx(
        {"aten::add": 8e-9, "portbench.restir_direct": 5e-9,
         "cudaLaunchKernel": 35e-9})


@pytest.mark.card
def test_a_cell_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = subprocess.run(
        [sys.executable, os.path.join(HERE, "run.py"), "--workload",
         CELLS[0], "--seed", "11", "--seconds", "2", "--trace", "1"],
        capture_output=True, text=True, cwd=ROOT, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
