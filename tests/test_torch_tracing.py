"""The port's tracer (raytracer_tpu_torch/utils/profiling.py) on the CPU:
off, it is one shared no-op that reads no clock and opens no profiler
range; on, a render is bit for bit the render without it, its spans form
the tree the integrator's layers make (one `rt.step` a step, its bounces,
`rt.shade` with `rt.fetch_surface` and `rt.light_select` under it, and
`rt.dielectric` only where the scene has glass, `rt.sync` only where deep
compaction reads the live count), its traversal
counters are the renderer's ray statistics, the light selection's
count its lanes and draws, the dielectric counters the glass lanes
counted by hand, and `compact.full_size` the bounces whose live lanes
overflow their prefix, its times sit on the
profiler's host clock, and PhaseTimer's phase view is intact; export()
keeps nothing behind. utils/attribution.py on synthetic kineto-like
events: each device activity goes to the span holding its runtime launch,
each idle gap to the activity after it. Also the stats table's Mrays/s,
which reads the renderer's ray count. The test marked `card` skips without
a CUDA card; on the card:

    python -m pytest --noconftest -m card tests/test_torch_tracing.py -q -s
"""

from __future__ import annotations

import json
import os
import threading

import pytest
import torch

from raytracer_tpu_torch.api import ProgressiveRenderer
from raytracer_tpu_torch.integrator import wavefront
from raytracer_tpu_torch.ops import _build
from raytracer_tpu_torch.ops.math3d import dot
from raytracer_tpu_torch.scene.device_scene import bake_scene
from raytracer_tpu_torch.scene.model import Material, create_cornell_box
from raytracer_tpu_torch.utils import profiling
from raytracer_tpu_torch.utils.config import RenderConfig
from raytracer_tpu_torch.utils.stats import RenderStats

STEPS = 2
# name -> RenderConfig keywords. "deep" compacts its bounces past the
# roulette onset: a prefix of 1024 of its 2048 lanes at compact_decay 0.25
# (no prefix is shorter than 1024 lanes, hence the larger image).
# "glass" renders the glass box (below) on prefixes of 2048, 1024 and 1024
# of its 8192 lanes at depths 2 to 4: more are alive at depth 2 than any
# prefix holds, so it runs full size; depth 3's overflow its prefix and run
# on depth 2's; depth 4's fit.
CONFIGS = {
    "nee": dict(width=16, height=12, max_depth=3),
    "restir": dict(width=16, height=12, max_depth=3, use_restir=True),
    "deep": dict(width=64, height=32, max_depth=4, rr_start_depth=1,
                 compact_decay=0.25),
    "glass": dict(width=128, height=64, max_depth=5, rr_start_depth=1,
                  compact_decay=0.2),
}


def _glass_box():
    """The Cornell box with its metal sphere turned into dense flint
    glass (ior 1.7847, dispersion 20/25.8), so some paths inside it meet
    total internal reflection."""
    s = create_cornell_box()
    i = next(k for k, m in enumerate(s.materials) if m.name == "metallic")
    s.materials[i] = Material(name="flint", albedo=(0.97, 0.97, 0.97),
                              transmission=1.0, ior=1.7847,
                              dispersion=20.0 / 25.8)
    return s


def _render(name, tracer=None):
    scene = _glass_box() if name == "glass" else create_cornell_box()
    r = ProgressiveRenderer(scene, None, RenderConfig(**CONFIGS[name]),
                            device="cpu")
    r.timer = tracer
    stats = []
    for _ in range(STEPS):
        r.step()
        stats.append({k: int(v) for k, v in r.last_stats.items()})
    return r, stats


@pytest.fixture(scope="module")
def traced():
    """Each config rendered with and without a tracer: name -> (untraced
    renderer, traced renderer, the tracer's export, per-step stats)."""
    out = {}
    for name in CONFIGS:
        plain, _ = _render(name)
        tracer = profiling.PhaseTimer(record=True)
        r, stats = _render(name, tracer)
        out[name] = (plain, r, tracer.export(), stats)
    return out


def test_off_span_is_the_shared_noop():
    assert profiling._active is None
    a = profiling.span("rt.a", depth=1)
    assert a is profiling.span("rt.b") is profiling.activated(None)
    with a as attrs:
        assert attrs is None
    profiling.count("trace.live", torch.tensor(3))  # nowhere to go


def test_off_and_on_read_no_profiler_range(monkeypatch):
    """Tracing off, a render reads no clock of the tracer's; off or on, it
    opens no record_function range."""
    def refuse(*a, **kw):
        raise AssertionError("called while no profiler runs")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(profiling, "_now", refuse)
    _render("nee")
    monkeypatch.undo()
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    tracer = profiling.PhaseTimer(record=True)
    _render("nee", tracer)
    assert tracer.spans and profiling._active is None


@pytest.mark.parametrize("name", list(CONFIGS))
def test_traced_render_is_bit_equal(traced, name):
    plain, r, _, _ = traced[name]
    assert torch.equal(plain.accum, r.accum)
    if r.reservoir is not None:
        for a, b in zip(plain.reservoir, r.reservoir):
            assert torch.equal(a, b)


def _tree(exported):
    spans = exported["spans"]
    names = [s["name"] for s in spans]
    parent = [names[s["parent"]] if s["parent"] >= 0 else None
              for s in spans]
    return spans, names, parent


@pytest.mark.parametrize("name", list(CONFIGS))
def test_span_tree(traced, name):
    _, r, exported, _ = traced[name]
    spans, names, parent = _tree(exported)
    depth = r.config.max_depth
    steps = [s for s in spans if s["name"] == "rt.step"]
    assert [s["frame"] for s in steps] == list(range(STEPS))
    assert all(s["parent"] == -1 for s in steps)
    for i, s in enumerate(spans):
        assert s["end_ns"] is not None and s["end_ns"] >= s["start_ns"]
        if s["parent"] >= 0:
            up = spans[s["parent"]]
            assert s["frame"] == up["frame"]
            assert up["start_ns"] <= s["start_ns"] <= s["end_ns"] \
                <= up["end_ns"]
    bounces = [(s["frame"], s["attrs"]["depth"]) for s, p in
               zip(spans, parent) if s["name"] == "rt.bounce"
               and p == "rt.step"]
    assert bounces == [(f, d) for f in range(STEPS) for d in range(depth)]
    assert set(names) >= {"rt.bounce", "rt.trace", "rt.occlusion",
                          "rt.shade", "rt.fetch_surface", "rt.light_select"}
    assert {p for n, p in zip(names, parent)
            if n == "rt.light_select"} == {"rt.shade"}
    # One selection a shade, counted: its lanes, and the lanes that drew.
    selects = [s for s in spans if s["name"] == "rt.light_select"]
    assert len(selects) == len([n for n in names if n == "rt.shade"])
    assert all(s["attrs"]["columns"] == r.device_scene.num_lights
               for s in selects)
    counters = exported["counters"]
    assert set(counters["light_select.lanes"]) == set(range(STEPS))
    assert all(0 < counters["light_select.drawn"][f]
               < counters["light_select.lanes"][f] for f in range(STEPS))
    assert {p for n, p in zip(names, parent)
            if n == "rt.shade"} == {"rt.bounce"}
    fetch_parents = {p for n, p in zip(names, parent)
                     if n == "rt.fetch_surface"}
    # ReSTIR's primary bounce fetches the G-buffer's surface itself.
    assert fetch_parents == ({"rt.shade", "rt.bounce"} if name == "restir"
                             else {"rt.shade"})
    assert ("rt.restir_direct" in names) == (name == "restir")
    # The dielectric branch, where the scene has glass alone: one a shade.
    dielectric = [p for n, p in zip(names, parent) if n == "rt.dielectric"]
    if name == "glass":
        assert dielectric == ["rt.shade"] * names.count("rt.shade")
    else:
        assert not dielectric
    syncs = [(s, p) for s, p in zip(spans, parent) if s["name"] == "rt.sync"]
    if "compact_decay" in CONFIGS[name]:
        # Each bounce past the roulette onset (depth 1) may run on a
        # prefix: one read of the count each.
        assert all(p == "rt.step" and s["attrs"]["site"] == "compact"
                   for s, p in syncs)
        depths = list(range(2, CONFIGS[name]["max_depth"]))
        assert [s["attrs"]["depth"] for s, _ in syncs] == depths * STEPS
    else:
        assert not syncs


@pytest.mark.parametrize("name", ["deep", "glass"])
def test_compact_full_size_counts_the_overflowing_bounces(traced, name):
    """Each `rt.sync` span of the compaction gives the bounce's `prefix`,
    its `live` lanes and the `lanes` it ran on: its prefix where that holds
    them, else the prefix of the latest earlier bounce that does, else all
    of them. `compact.full_size` counts, a frame, the bounces that ran on
    all: in the glass box depth 2, while depth 3 runs on depth 2's prefix
    and depth 4 on its own; in the plain box none."""
    _, _, exported, _ = traced[name]
    n = CONFIGS[name]["width"] * CONFIGS[name]["height"]
    syncs = [s["attrs"] for s in exported["spans"] if s["name"] == "rt.sync"]
    full = {f: sum(s["attrs"]["lanes"] == n for s in exported["spans"]
                   if s["name"] == "rt.sync" and s["frame"] == f)
            for f in range(STEPS)}
    counted = exported["counters"].get("compact.full_size", {})
    assert {f: counted.get(f, 0) for f in range(STEPS)} == full
    prefixes = {a["depth"]: a["prefix"] for a in syncs}
    ran = {(a["depth"], a["live"] > a["prefix"], a["lanes"]) for a in syncs}
    assert all(a["live"] <= a["lanes"] for a in syncs)
    if name == "glass":
        assert prefixes == {2: 2048, 3: 1024, 4: 1024}
        assert ran == {(2, True, n), (3, True, 2048), (4, False, 1024)}
    else:
        assert ran == {(2, False, 1024), (3, False, 1024)}
        assert not counted


def test_a_material_edit_to_glass_turns_the_dielectric_branch_on():
    """`DeviceScene.transmissive` follows the materials through a material
    edit: a box without glass shades no dielectric lane, and once an edit
    turns its metal sphere to glass the next frame enters `rt.dielectric`
    and renders as a renderer made on the glass box does."""
    scene = create_cornell_box()
    tracer = profiling.PhaseTimer(record=True)
    r = ProgressiveRenderer(scene, None, RenderConfig(**CONFIGS["nee"]),
                            device="cpu")
    r.timer = tracer
    r.step()
    assert not r.device_scene.transmissive
    glass = _glass_box()
    i = next(k for k, m in enumerate(glass.materials) if m.name == "flint")
    scene.update_material(i, glass.materials[i])
    r.step()
    assert r.last_replay == "materials" and r.device_scene.transmissive
    frames = {s["frame"] for s in tracer.export()["spans"]
              if s["name"] == "rt.dielectric"}
    assert frames == {1}
    # The edit restarts the accumulation: frame 0 of the glass box.
    fresh = ProgressiveRenderer(glass, None, RenderConfig(**CONFIGS["nee"]),
                                device="cpu")
    fresh.step()
    assert torch.equal(r.accum, fresh.accum)


def test_dielectric_counters_are_the_lanes_counted_by_hand(monkeypatch):
    """A frame of the glass box: each dielectric counter equals its lanes
    counted from `_sample_dielectric`'s inputs and outputs: the lanes
    given, those sent below the surface (refracted), those past the
    critical angle at their ior (total internal reflection), and those
    whose channel was unset and is set (locked)."""
    own = wavefront._sample_dielectric
    hand = dict.fromkeys(["dielectric.lanes", "dielectric.refracted",
                          "dielectric.tir", "dielectric.locked"], 0)

    def counted(ray_dir, normal, front_facing, albedo, ior, transmission,
                dispersion, channel, seed, active):
        out = own(ray_dir, normal, front_facing, albedo, ior, transmission,
                  dispersion, channel, seed, active)
        new_dir, new_channel = out[0], out[3]
        locked = active & (channel < 0) & (new_channel >= 0)
        spread = (ior - 1.0) * dispersion / 20.0
        offset = (new_channel.to(torch.float32) - 1.0) * 0.5
        lane_ior = torch.where((dispersion > 0.0) & (new_channel >= 0),
                               ior + offset * spread, ior)
        eta = torch.where(front_facing, 1.0 / lane_ior, lane_ior)
        cos_i = torch.clamp(dot(-ray_dir, normal), 0.0, 1.0)
        tir = eta * eta * (1.0 - cos_i * cos_i) > 1.0
        hand["dielectric.lanes"] += int(active.sum())
        hand["dielectric.refracted"] += int(
            (active & (dot(new_dir, normal) < 0.0)).sum())
        hand["dielectric.tir"] += int((active & tir).sum())
        hand["dielectric.locked"] += int(locked.sum())
        return out

    monkeypatch.setattr(wavefront, "_sample_dielectric", counted)
    tracer = profiling.PhaseTimer(record=True)
    r = ProgressiveRenderer(_glass_box(), None,
                            RenderConfig(**CONFIGS["glass"]), device="cpu")
    r.timer = tracer
    r.step()
    counters = tracer.export()["counters"]
    assert {k: counters[k][0] for k in hand} == hand
    assert all(v > 0 for v in hand.values()), hand
    assert hand["dielectric.refracted"] + hand["dielectric.tir"] \
        < hand["dielectric.lanes"] <= counters["shade.lanes"][0]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_trace_live_is_the_ray_stats(traced, name):
    _, _, exported, stats = traced[name]
    live = exported["counters"]["trace.live"]
    lanes = exported["counters"]["trace.lanes"]
    assert live == {f: s["rays_traced"] + s["shadow_rays"]
                    for f, s in enumerate(stats)}
    assert all(0 < live[f] <= lanes[f] for f in live)


def test_phase_view_reads_phases_alone():
    t = profiling.PhaseTimer(record=True)
    with profiling.activated(t):
        with t.phase("tile_render", [torch.ones(2)]):
            with profiling.span("rt.step", frame=0):
                pass
        with t.phase("gather"):
            pass
    assert t.counts == {"tile_render": 1, "gather": 1}
    assert set(t.totals) == {"tile_render", "gather"}
    assert all(v >= 0 for v in t.totals.values())
    assert "tile_render" in t.report() and "rt.step" not in t.report()
    names = [s["name"] for s in t.export()["spans"]]
    assert names == ["tile_render", "rt.step", "rt.sync", "gather"]


def test_renderer_timer_counts_no_span_as_a_phase(traced):
    _, r, exported, _ = traced["nee"]
    assert r.timer.counts == {} and r.timer.report() == ""
    assert any(s["name"] == "rt.step" for s in exported["spans"])


def test_export_hands_over_and_keeps_nothing(traced):
    """The renderer's tracer keeps nothing past its export(), and a timer
    of phases alone (the multi-device render's) is never made active, so
    neither grows with the frames rendered."""
    assert traced["nee"][1].timer.spans == []
    r, _ = _render("nee", profiling.PhaseTimer(record=True))
    r.timer.export()
    assert r.timer.spans == [] and r.timer.counters == {}
    assert r.timer.export() == {"spans": [], "counters": {}}
    r.step()
    assert r.timer.spans and r.timer.counters
    phases = profiling.PhaseTimer()
    r.timer = phases
    assert profiling.activated(phases) is profiling.activated(None)
    r.step()
    assert phases.spans == [] and phases.counters == {}
    t = profiling.PhaseTimer(record=True)
    with profiling.activated(t), profiling.span("rt.step", frame=0):
        with pytest.raises(RuntimeError):
            t.export()


def test_other_threads_record_nothing():
    t = profiling.PhaseTimer(record=True)
    with profiling.activated(t):
        worker = threading.Thread(
            target=lambda: profiling.span("rt.bake").__enter__())
        worker.start()
        worker.join(timeout=30)
        assert not worker.is_alive()
        with profiling.span("rt.step", frame=0):
            pass
    assert [s[0] for s in t.spans] == ["rt.step"]


def test_bake_and_library_load_spans():
    t = profiling.PhaseTimer(record=True)
    with profiling.activated(t):
        bake_scene(create_cornell_box(), device="cpu")
        with _build.library_load("libexample"):
            pass
    spans = t.export()["spans"]
    bake = next(s for s in spans if s["name"] == "rt.bake")
    assert bake["attrs"]["refit"] is False
    assert bake["attrs"]["triangles"] > 0
    load = spans[-1]
    assert load["name"] == "rt.kernel_load" and load["parent"] == -1
    assert load["attrs"] == {"library": "libexample", "built": False}


def test_spans_share_the_profilers_clock():
    """A record_function range opened inside a span lies inside it on the
    profiler's clock (within the clocks' conversion, some microseconds)."""
    from torch.profiler import ProfilerActivity, profile

    t = profiling.PhaseTimer(record=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.activated(t):
            for i in range(3):
                with profiling.span("rt.step", frame=i):
                    with torch.profiler.record_function(f"inner{i}"):
                        torch.ones(64).sum()
    ranges = {e.name(): e for e in prof.profiler.kineto_results.events()}
    slack = 50_000  # ns
    for s in t.export()["spans"]:
        e = ranges[f"inner{s['frame']}"]
        assert s["start_ns"] - slack <= e.start_ns() <= e.end_ns() \
            <= s["end_ns"] + slack


def test_device_trace_shows_the_spans(tmp_path):
    with profiling.device_trace(str(tmp_path)) as tracer:
        _render("nee")
    assert profiling._active is None
    assert any(s[0] == "rt.step" for s in tracer.spans)
    names = [f for f in os.listdir(tmp_path) if f.endswith(".json")]
    with open(tmp_path / names[0]) as f:
        events = json.load(f)["traceEvents"]
    assert {"rt.step", "rt.shade", "rt.light_select"} <= {
        e.get("name") for e in events}


def test_stats_table_shows_mrays_after_two_steps():
    r = ProgressiveRenderer(create_cornell_box(), None,
                            RenderConfig(width=16, height=12, max_depth=3),
                            device="cpu")
    stats = RenderStats()
    for _ in range(2):
        stats.frame_begin()
        r.step()
        stats.frame_end(r.last_stats["total_rays"])
    assert all(isinstance(v, torch.Tensor) for v in stats.rays_per_frame)
    row = next(line for line in stats.format_table().splitlines()
               if line.startswith("Mrays/s"))
    assert float(row.split()[-1]) > 0
    rays = sum(int(v) for v in stats.rays_per_frame)
    assert stats.mrays_per_sec == pytest.approx(
        rays / sum(stats.frame_times) / 1e6)


class _Event:
    """A kineto event as utils/attribution.py reads it."""

    def __init__(self, name, t0, t1, on_device=False, corr=0,
                 annotation=False):
        self._v = (name, t0, t1, on_device, corr, annotation)

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

    def is_user_annotation(self):
        return self._v[5]


def _span(name, t0, t1, parent=-1, frame=0, **attrs):
    return {"name": name, "start_ns": t0, "end_ns": t1, "parent": parent,
            "frame": frame, "attrs": attrs}


EXPORTED = {
    "spans": [
        _span("rt.step", 0, 100),
        _span("rt.bounce", 10, 90, parent=0, depth=0),
        _span("rt.shade", 15, 70, parent=1),
        _span("rt.light_select", 20, 40, parent=2),
        _span("rt.fetch_surface", 50, 60, parent=2),
        _span("rt.sync", 92, 98, parent=0, site="compact"),
    ],
    "counters": {"trace.lanes": {0: 400}, "trace.live": {0: 300}},
}
SELECT = "rt.step/rt.bounce/rt.shade/rt.light_select"
FETCH = "rt.step/rt.bounce/rt.shade/rt.fetch_surface"


def _events():
    E = _Event
    return [
        # Host: a range opened before every span, and inside it an op
        # whose launch falls in rt.light_select; a native library's launch
        # (no op); a memset; the count's copy; a launch after every span.
        E("outer_range", 5, 99, corr=1),
        E("aten::cumsum", 18, 30, corr=2),
        E("cudaLaunchKernel", 25, 27, corr=11),
        E("cudaLaunchKernel", 55, 56, corr=12),
        E("cudaMemsetAsync", 57, 58, corr=13),
        E("cudaMemcpyAsync", 94, 95, corr=14),
        E("cudaLaunchKernel", 150, 151, corr=15),
        E("cudaStreamSynchronize", 95, 97, corr=16),
        # Device: a range on the device timeline (not an activity), the
        # scan, the traversal kernel and its memset, the count's copy, a
        # kernel whose launch the capture lacks, a late kernel.
        E("rt.shade", 0, 200, on_device=True, annotation=True),
        E("scan_kernel", 60, 70, on_device=True, corr=11),
        E("closest_kernel", 75, 80, on_device=True, corr=12),
        E("Memset (Device)", 81, 82, on_device=True, corr=13),
        E("Memcpy DtoH", 95, 96, on_device=True, corr=14),
        E("orphan_kernel", 100, 101, on_device=True, corr=99),
        E("late_kernel", 160, 170, on_device=True, corr=15),
    ]


def test_activities_go_to_the_span_of_their_launch():
    """By the runtime call of the activity's own correlation id, for a
    torch op's kernel under a range opened before the span, a native
    library's kernel and memset alike."""
    from raytracer_tpu_torch.utils import attribution as at

    a = at.attribute(_events(), EXPORTED, 2)
    assert a.busy_s == pytest.approx(28e-9)
    assert a.device_s == pytest.approx({
        SELECT: 10e-9, FETCH: 6e-9, "rt.step/rt.sync": 1e-9,
        at.NO_LAUNCH: 1e-9, at.NO_SPAN: 10e-9})
    assert a.attributed_s == pytest.approx(17e-9)
    assert a.under("rt.shade") == pytest.approx(16e-9)
    assert a.under("rt.step") == pytest.approx(17e-9)
    assert a.under("rt.light_select") == pytest.approx(10e-9)
    assert a.no_launch_s == pytest.approx({"orphan_kernel": 1e-9})


def test_idle_gaps_go_to_the_activity_after_them():
    from raytracer_tpu_torch.utils import attribution as at

    a = at.attribute(_events(), EXPORTED, 2)
    # 70..75 waits on the traversal kernel, 80..81 on its memset, 82..95
    # on the copy, 96..100 on the orphan, 101..160 on the late kernel.
    assert a.idle_s == pytest.approx({
        FETCH: 6e-9, "rt.step/rt.sync": 13e-9, at.NO_LAUNCH: 4e-9,
        at.NO_SPAN: 59e-9})
    assert a.idle_spans(2) == [[at.NO_SPAN, pytest.approx(59e-9)],
                               ["rt.step/rt.sync", pytest.approx(13e-9)]]


def test_host_time_and_counters_of_the_spans():
    from raytracer_tpu_torch.utils import attribution as at

    a = at.attribute([], EXPORTED, 2)
    assert a.busy_s == 0 and a.device_s == {} and a.spans == 6
    assert a.host_s["rt.sync"] == pytest.approx(6e-9)
    assert a.host_s["rt.step"] == pytest.approx(100e-9)
    assert a.counters == {"trace.lanes": 400, "trace.live": 300}


def test_a_cpu_profile_attributes_nothing():
    """On the CPU a render's profile has no device activity: nothing to
    put down, while the spans' host time and counters are read."""
    from torch.profiler import ProfilerActivity, profile

    from raytracer_tpu_torch.utils import attribution as at

    tracer = profiling.PhaseTimer(record=True)
    r = ProgressiveRenderer(create_cornell_box(), None,
                            RenderConfig(**CONFIGS["nee"]), device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.activated(tracer):
            r.step()
    a = at.attribute(prof.profiler.kineto_results.events(), tracer.export(),
                     1)
    assert a.busy_s == 0 and a.device_s == {}
    assert a.host_s["rt.step"] >= a.host_s["rt.bounce"] > 0
    assert 0 < a.counters["trace.live"] <= a.counters["trace.lanes"]


@pytest.mark.card
@pytest.mark.parametrize("name,depth", [("nee", 3), ("deep", 8)])
def test_spans_hold_every_launch_on_the_card(name, depth):
    """Three profiled frames of a 20k-triangle atrium at 480x270 on the
    card: every device activity's launch lies inside an `rt.step` span, so
    the time put down to spans is the profile's busy time (within 1%), the
    traversal kernels' time lies under `rt.trace` and `rt.occlusion`, and
    the light selection kernel's under `rt.light_select` in `rt.shade`,
    with its two counters.
    Run on the card with `--noconftest` (this directory's conftest.py
    loads JAX, which the card's machine lacks)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from torch.profiler import ProfilerActivity, profile

    from raytracer_tpu_torch.ops.camera import Camera
    from raytracer_tpu_torch.scene.benchmark import create_benchmark_atrium
    from raytracer_tpu_torch.utils import attribution as at

    cfg = RenderConfig(width=480, height=270, max_depth=depth)
    cam = Camera.create(position=(0.0, 1.0, -4.0), aspect=480 / 270,
                        target=(0.0, 0.5, 0.0))
    r = ProgressiveRenderer(create_benchmark_atrium(20_000), cam, cfg,
                            device="cuda")
    for _ in range(2):
        r.step()
    torch.cuda.synchronize()
    tracer = profiling.PhaseTimer(record=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with profiling.activated(tracer):
            for _ in range(3):
                r.step()
                torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    exported = tracer.export()
    a = at.attribute(events, exported, 3)
    kernels = [e for e in events if at._is_activity(e)]
    traversal = 1e-9 * sum(e.duration_ns() for e in kernels
                           if "closest_kernel" in e.name()
                           or "occlusion_kernel" in e.name())
    print(f"{name}: {len(kernels)} activities, busy "
          f"{1e3 * a.busy_s:.3f} ms, attributed {1e3 * a.attributed_s:.3f} "
          f"ms; by path {sorted(a.device_s.items(), key=lambda kv: -kv[1])}"
          f"; idle {a.idle_spans(5)}; no launch {a.no_launch_s}; host "
          f"rt.sync {1e3 * a.host_s.get('rt.sync', 0.0):.3f} ms")
    assert a.busy_s > 0 and traversal > 0
    assert a.busy_s == pytest.approx(
        1e-9 * sum(e.duration_ns() for e in kernels), rel=1e-9)
    assert all(p.split("/")[0] == "rt.step" for p in a.device_s), \
        sorted(a.device_s)
    assert a.attributed_s == pytest.approx(a.busy_s, rel=0.01)
    # K1/K2 and the few torch ops that prepare their rays.
    assert a.under("rt.trace") + a.under("rt.occlusion") >= traversal
    selects = [e for e in kernels if "select_kernel" in e.name()]
    select_s = 1e-9 * sum(e.duration_ns() for e in selects)
    assert len(selects) >= 3 and select_s > 0
    # Under the span: the kernel, and the fill that zeroes each traced
    # call's drawn counter, and nothing else.
    index = at._SpanIndex(exported["spans"])
    launched = {e.correlation_id(): e.start_ns() for e in events
                if e.name().startswith(at.LAUNCH_CALLS)}
    under = [e for e in kernels if e.correlation_id() in launched
             and "rt.light_select" in index.path(
                 launched[e.correlation_id()]).split("/")]
    fills = [e for e in under if "select_kernel" not in e.name()]
    assert all("Fill" in e.name() or "emset" in e.name() for e in fills), \
        sorted({e.name() for e in fills})
    assert len(fills) <= len(selects)
    fill_s = 1e-9 * sum(e.duration_ns() for e in fills)
    assert a.under("rt.light_select") == pytest.approx(select_s + fill_s,
                                                       rel=1e-9)
    assert all(p.endswith("rt.shade/rt.light_select")
               for p in a.device_s if "rt.light_select" in p)
    assert 0 < a.counters["light_select.drawn"] \
        < a.counters["light_select.lanes"]
    if name == "deep":
        assert a.host_s.get("rt.sync", 0) > 0
