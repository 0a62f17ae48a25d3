"""Live-edit demo: change a material mid-render and watch accumulation
reset (port of the JAX package's examples/live_edit.py).

The headless analog of the reference's ImGui material editor
(src/raytracer/ui.odin:262-347,585-725): every edit goes through the
scene's change journal, is replayed by begin_frame on the next step (the
raytracing_renderer.odin:141-187 path; a material edit rewrites the
material tables only) and zeroes the progressive accumulation, while the
renderer keeps stepping and writes an image before and after the edit.

    python -m raytracer_tpu_torch.examples.live_edit [out_prefix]
        [--size WxH] [--frames N] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import dataclasses

from raytracer_tpu_torch.api import ProgressiveRenderer
from raytracer_tpu_torch.scene.model import create_cornell_box
from raytracer_tpu_torch.utils.config import RenderConfig
from raytracer_tpu_torch.utils.image import write_image
from raytracer_tpu_torch.utils.stats import RenderStats


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("prefix", nargs="?", default="live_edit",
                   help="writes <prefix>_before.png and <prefix>_after.png")
    p.add_argument("--size", default="160x160", help="WxH")
    p.add_argument("--frames", type=int, default=12,
                   help="frames before and after the edit")
    p.add_argument("--device", default="cuda")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    w, h = (int(x) for x in args.size.split("x"))
    scene = create_cornell_box()
    r = ProgressiveRenderer(scene, None, RenderConfig(width=w, height=h),
                            device=args.device)
    stats = RenderStats()
    stats.set_scene_counts(scene)

    replays = []  # each step's replay branch

    def accumulate(n, tag):
        for _ in range(n):
            stats.frame_begin()
            r.step()
            stats.frame_end(r.last_stats["total_rays"])
            replays.append(r.last_replay)
        path = f"{args.prefix}_{tag}.png"
        write_image(path, r.image())
        print(f"{tag}: accumulated to {r.frame} spp -> {path}")
        print(stats.format_table())

    accumulate(args.frames, "before")

    # Mid-render edit: repaint the left wall's (or a tall box's) material
    # red, like dragging the albedo color picker in the reference's editor.
    idx = next((i for i, o in enumerate(scene.objects)
                if "left" in o.name.lower() or "tall" in o.name.lower()), 0)
    obj = scene.objects[idx]
    mat = scene.materials[obj.material_index]
    scene.update_material(
        obj.material_index, dataclasses.replace(mat, albedo=(0.85, 0.1, 0.1)))
    print(f"edited material {obj.material_index} ({obj.name!r}) -> red")

    frames_before_edit = r.frame
    accumulate(args.frames, "after")
    if r.frame > args.frames:
        raise RuntimeError("material edit must have reset accumulation "
                           f"(was {frames_before_edit}, now {r.frame})")
    print(f"accumulation reset on edit ({replays[args.frames]} replay): "
          f"{frames_before_edit} -> {r.frame} frames")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
