"""Timed interactive editing session: the reference's editor workflow,
headless, with each edit's latency to its visible frame (port of the JAX
package's examples/interactive_session.py).

The reference's UX is its ImGui editor loop (src/raytracer/ui.odin:262-484):
drag the camera, drag an object transform, repaint a material, watch the
progressive render restart live. This drives the same edit pipeline
through the public API and measures every edit-to-visible-frame latency,
with the replay branch each edit took (ProgressiveRenderer.last_replay):

  - camera move        -> dirty-camera accumulation reset
  - transform drag     -> BVH refit ("refit": the same BVH object)
  - material repaint   -> material tables only ("materials": the geometry
                          tensors stay the same objects)
  - light brighten     -> the same, the packed light tables included
  - object add         -> a bake on a background thread (prebake_async),
                          which the next frame takes ("prebake")

What "visible frame" means depends on the resolution, as in a real editor:

  - at preview resolutions (default 512x288) the editor displays the
    accumulating render itself: edit -> full step + readback;
  - at 1080p (--1080p) the editor interacts against the denoised preview
    at 1/scale resolution (preview_image(scale, denoise=True,
    upscale=False)) and full-resolution accumulation resumes between
    edits: edit -> preview on the host, with the resume printed too.

--assert-interactive enforces a gate of under 1 s per edit.

    python -m raytracer_tpu_torch.examples.interactive_session [--1080p]
        [--size WxH] [--preview-scale S] [--device cuda|cpu]
        [--assert-interactive]
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

from raytracer_tpu_torch.api import ProgressiveRenderer
from raytracer_tpu_torch.ops.camera import Camera
from raytracer_tpu_torch.scene.model import (
    Material,
    create_cornell_box,
    create_sphere,
)
from raytracer_tpu_torch.utils.config import RenderConfig
from raytracer_tpu_torch.utils.stats import RenderStats

EDITS = ("camera_move", "transform_drag", "material_paint",
         "light_brighten", "object_add")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--1080p", dest="hd", action="store_true",
                   help="1920x1080, edits shown on the denoised preview")
    p.add_argument("--size", default=None,
                   help="WxH (default 512x288, or 1920x1080 with --1080p)")
    p.add_argument("--preview-scale", type=int, default=4)
    p.add_argument("--device", default="cuda")
    p.add_argument("--assert-interactive", action="store_true",
                   help="fail unless every edit is under 1 s")
    return p


def run(args) -> dict:
    """The session. Returns {"latency_ms": {edit: ms}, "resume_ms": {edit:
    ms} (1080p only), "branch": {edit: last_replay}, "same_bvh": {edit:
    bool}, "same_geometry": {edit: bool}}, edits in EDITS order."""
    w, h = (1920, 1080) if args.hd else (512, 288)
    if args.size:
        w, h = (int(x) for x in args.size.split("x"))
    pscale = args.preview_scale
    # The 1080p editor loop is served from the scaled preview; at smaller
    # sizes the full accumulating frame is the display.
    preview_loop = args.hd
    scene = create_cornell_box()
    t0 = time.perf_counter()
    r = ProgressiveRenderer(scene, None, RenderConfig(width=w, height=h),
                            device=args.device)
    stats = RenderStats()
    stats.set_scene_counts(scene)
    print(f"startup (bake): {time.perf_counter() - t0:.2f}s", flush=True)

    def frame():
        stats.frame_begin()
        r.step()
        r.accum[:1].cpu()  # waits for the frame (a readback)
        stats.frame_end(r.last_stats["total_rays"])

    def visible():
        """The editor's visible next frame after an edit."""
        if preview_loop:
            r.preview_image(scale=pscale, denoise=True, upscale=False)
        else:
            frame()

    t0 = time.perf_counter()
    frame()
    print(f"first frame (kernel build or cache hit): "
          f"{time.perf_counter() - t0:.2f}s", flush=True)
    for _ in range(4):
        frame()
    if preview_loop:
        visible()  # the preview's first G-buffer and filter

    # Warm each edit path once, so the timed round measures a drag's
    # steady-state tick: the first of a kind pays its first allocations.
    r.set_camera(Camera.create(position=(0.0, 0.05, -2.9), aspect=w / h))
    visible()
    frame()
    scene.update_object_position(
        0, tuple(np.asarray(scene.objects[0].transform.position)))
    visible()
    frame()
    scene.update_material(0, dataclasses.replace(scene.materials[0]))
    visible()
    frame()
    warm_mesh = scene.add_mesh(create_sphere(4, 4))
    warm_obj = scene.add_object("warmup", warm_mesh, 0,
                                position=(0.0, 0.4, 0.3),
                                scale=(0.05, 0.05, 0.05))
    visible()
    frame()
    scene.delete_object(warm_obj)
    visible()
    frame()
    stats = RenderStats()
    stats.set_scene_counts(scene)

    out = {"latency_ms": {}, "resume_ms": {}, "branch": {}, "same_bvh": {},
           "same_geometry": {}}

    def edit(tag, fn, prebake=False):
        before = r.frame
        bvh, ptris = r._host_bvh, r.device_scene.ptris
        t0 = time.perf_counter()
        fn()
        if prebake:
            # Topology edits: bake on a background thread; the visible
            # frame below takes it inside begin_frame.
            r.prebake_async()
        visible()
        out["latency_ms"][tag] = 1e3 * (time.perf_counter() - t0)
        out["branch"][tag] = r.last_replay
        out["same_bvh"][tag] = r._host_bvh is bvh
        out["same_geometry"][tag] = r.device_scene.ptris is ptris
        if preview_loop:
            # Full-resolution accumulation resumes after the interaction.
            t1 = time.perf_counter()
            frame()
            out["resume_ms"][tag] = 1e3 * (time.perf_counter() - t1)
        if r.frame > before:
            raise RuntimeError(f"{tag}: edit must reset accumulation (frame "
                               f"{before} -> {r.frame})")
        extra = (f"  (+{out['resume_ms'][tag]:7.1f} ms full-res resume)"
                 if preview_loop else "")
        print(f"edit [{tag:16s}]: {out['latency_ms'][tag]:7.1f} ms to "
              f"visible frame, replay {out['branch'][tag]}{extra}",
              flush=True)

    # 1. camera move (ui.odin camera controller drag)
    edit("camera_move", lambda: r.set_camera(Camera.create(
        position=(0.25, 0.1, -2.8), aspect=w / h)))

    # 2. transform drag (refit)
    obj_idx = 0
    tr = scene.objects[obj_idx].transform
    edit("transform_drag", lambda: scene.update_object_position(
        obj_idx, tuple(np.asarray(tr.position) + [0.05, 0.0, 0.0])))

    # 3. material repaint (material tables)
    mat_idx = scene.objects[obj_idx].material_index
    edit("material_paint", lambda: scene.update_material(
        mat_idx, dataclasses.replace(scene.materials[mat_idx],
                                     albedo=(0.85, 0.15, 0.1))))

    # 4. light brighten (material tables and the packed light tables)
    li = next(i for i, m in enumerate(scene.materials)
              if m.emission_power > 0)
    edit("light_brighten", lambda: scene.update_material(
        li, dataclasses.replace(
            scene.materials[li],
            emission_power=scene.materials[li].emission_power * 2)))

    # 5. object add: a full bake, on a background thread.
    def add_obj():
        mesh_idx = scene.add_mesh(create_sphere(6, 6))
        mat = scene.add_material(Material(albedo=(0.2, 0.4, 0.9)))
        scene.add_object("added_sphere", mesh_idx, mat,
                         position=(0.0, -0.3, 0.2),
                         scale=(0.25, 0.25, 0.25))
    edit("object_add", add_obj, prebake=True)

    for _ in range(5):  # settle: accumulate a few frames after the edits
        frame()
    print(stats.format_table(), flush=True)

    # The denoised full image: the first call pays the G-buffer pass.
    r.image(denoise=True)
    t0 = time.perf_counter()
    r.image(denoise=True)
    print(f"denoised full-image readback (warm): "
          f"{(time.perf_counter() - t0) * 1e3:7.1f} ms", flush=True)

    # The scaled preview's cadence; with --1080p the native-resolution
    # variant (upscale=False) is the editor loop's.
    for up in ((True, False) if preview_loop else (True,)):
        r.preview_image(scale=pscale, denoise=True, upscale=up)
        pt = []
        for _ in range(5):
            t0 = time.perf_counter()
            r.preview_image(scale=pscale, denoise=True, upscale=up)
            pt.append(time.perf_counter() - t0)
        kind = ("upscaled to full res" if up
                else f"native {w // pscale}x{h // pscale}")
        print(f"preview_image(scale={pscale}, denoised, {kind}) cadence: "
              f"{1e3 * min(pt):.1f} ms best / "
              f"{1e3 * float(np.median(pt)):.1f} ms median "
              f"({1.0 / float(np.median(pt)):.1f} fps)", flush=True)

    worst = max(out["latency_ms"].values())
    print(f"worst edit latency (object_add included): {worst:.1f} ms "
          f"(object_add: {out['latency_ms']['object_add']:.1f} ms)",
          flush=True)
    if out["resume_ms"]:
        print(f"worst full-res resume after edit: "
              f"{max(out['resume_ms'].values()):.1f} ms", flush=True)
    if args.assert_interactive:
        if worst >= 1e3:
            raise RuntimeError(f"edit latency {worst:.0f} ms breaches the "
                               "1 s gate")
        print("PASS: all edits (incl. object add) under 1 s", flush=True)
    return out


def main(argv=None) -> int:
    run(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
