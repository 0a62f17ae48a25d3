"""Command-line renderer (port of raytracer_tpu/cli.py).

Usage:
  python -m raytracer_tpu_torch.cli <scene_file> [--width W] [--height H]
      [--spp N] [--out image.png] [--camera X Y Z] [--target X Y Z]
      [--device cuda|cpu] ...

The parser is the JAX package's, plus --device; --accel takes every JAX
value (auto, pallas, bvh, brute) plus cuda, the port's name for pallas.
--restir renders the direct light with ReSTIR DI; it excludes --adaptive
and --spp-batch, as in the JAX package.
"""

from __future__ import annotations

import argparse
import logging
import os
import time

import numpy as np

from raytracer_tpu_torch.api import ProgressiveRenderer
from raytracer_tpu_torch.integrator.denoise import MISS_DEPTH
from raytracer_tpu_torch.ops.camera import Camera
from raytracer_tpu_torch.scene.loaders import load_scene
from raytracer_tpu_torch.utils import compile_cache
from raytracer_tpu_torch.utils.config import RenderConfig
from raytracer_tpu_torch.utils.image import write_image
from raytracer_tpu_torch.utils.stats import RenderStats


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("scene", help="scene file (.json, .gltf, .glb, .obj)")
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--height", type=int, default=1020)
    p.add_argument("--spp", type=int, default=64,
                   help="progressive frames to accumulate")
    p.add_argument("--out", default="render.png")
    p.add_argument("--camera", type=float, nargs=3, default=(0.0, 0.0, -3.0),
                   metavar=("X", "Y", "Z"))
    p.add_argument("--target", type=float, nargs=3, default=(0.0, 0.0, 0.0),
                   metavar=("X", "Y", "Z"))
    p.add_argument("--max-depth", type=int, default=3)
    p.add_argument("--background", type=float, nargs=3,
                   default=(0.53, 0.81, 0.92))
    p.add_argument("--accel",
                   choices=("auto", "pallas", "cuda", "bvh", "brute"),
                   default="auto")
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (cuda, or cpu for the "
                        "kernels' plain torch versions)")
    p.add_argument("--no-transmission", action="store_true")
    p.add_argument("--light-sampling-only", action="store_true",
                   help="direct light via NEE only (USE_LIGHT_SAMPLING_ONLY,"
                        " simple.rchit:10)")
    p.add_argument("--restir", action="store_true",
                   help="use ReSTIR DI for direct lighting")
    p.add_argument("--adaptive", type=float, default=0.0, metavar="TOL",
                   help="adaptive sampling: a pixel stops once the relative "
                        "standard error of its mean luminance drops under "
                        "TOL (0 = off); the render stops early once 99.9%% "
                        "of the pixels have")
    p.add_argument("--denoise", action="store_true",
                   help="edge-aware a-trous denoise of the output (and "
                        "previews); the accumulation itself is untouched")
    p.add_argument("--checkpoint", default=None,
                   help="save/resume accumulation state at this .npz path")
    p.add_argument("--preview", type=int, default=0, metavar="N",
                   help="live preview: rewrite --out (plus a stats table) "
                        "every N frames while accumulating")
    p.add_argument("--aovs", default=None, metavar="PREFIX",
                   help="also write AOV images from one primary trace: "
                        "PREFIX_albedo/_normal/_depth.png (normal encoded "
                        "n*0.5+0.5; depth over the farthest hit)")
    p.add_argument("--preview-scale", type=int, default=1, metavar="K",
                   help="with --preview: write previews from a fresh 1/K-"
                        "resolution sample (denoised per --denoise, "
                        "bilinearly upscaled to the output size) instead of "
                        "reading back the full accumulation")
    p.add_argument("--spp-batch", type=int, default=1, metavar="S",
                   help="render S progressive samples per launch (one "
                        "wavefront of S x pixels lanes); latency per step "
                        "rises about S-fold. --spp must divide by S")
    p.add_argument("--stats-every", type=int, default=0, metavar="N",
                   help="print the stats table every N frames")
    p.add_argument("-v", "--verbose", action="store_true")
    return p


def write_aovs(prefix, aov):
    """PREFIX_albedo.png, PREFIX_normal.png (n*0.5+0.5) and
    PREFIX_depth.png (depth over the farthest hit, misses white)."""
    write_image(f"{prefix}_albedo.png", aov["albedo"])
    write_image(f"{prefix}_normal.png", aov["normal"] * 0.5 + 0.5)
    d = aov["depth"]
    hit = d < MISS_DEPTH
    dmax = float(d[hit].max()) if hit.any() else 1.0
    depth_img = np.where(hit, d / max(dmax, 1e-6), 1.0)
    write_image(f"{prefix}_depth.png",
                np.repeat(depth_img[..., None], 3, axis=-1))


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.restir and args.adaptive > 0:
        parser.error("--restir and --adaptive are mutually exclusive "
                     "(ReSTIR carries its own temporal state)")
    if args.spp_batch > 1:
        if args.restir or args.adaptive > 0:
            parser.error("--spp-batch requires the plain progressive path "
                         "(no --restir / --adaptive)")
        if args.spp % args.spp_batch != 0:
            parser.error("--spp must be a multiple of --spp-batch")
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(levelname)s %(name)s: %(message)s",
    )
    log = logging.getLogger("raytracer_tpu_torch.cli")
    # The warm-start cache: built kernels and builder, reused across runs
    # (RAYTRACER_TPU_CACHE_DIR moves it, as the JAX CLI's XLA cache).
    log.info("native library cache at %s", compile_cache.build_dir())

    scene = load_scene(args.scene)
    cfg = RenderConfig(
        width=args.width,
        height=args.height,
        max_depth=args.max_depth,
        background=tuple(args.background),
        accel=args.accel,
        enable_transmission=not args.no_transmission,
        use_light_sampling_only=args.light_sampling_only,
        use_restir=args.restir,
        adaptive_tol=args.adaptive,
        denoise_preview=args.denoise,
        spp_batch=args.spp_batch,
    )
    camera = Camera.create(
        position=tuple(args.camera),
        aspect=cfg.width / cfg.height,
        target=tuple(args.target),
    )
    renderer = ProgressiveRenderer(scene, camera, cfg, device=args.device)
    log.info("rendering on %s, accel=%s", renderer.device,
             renderer.config.accel)
    if args.checkpoint and os.path.exists(args.checkpoint):
        renderer.load_checkpoint(args.checkpoint)
        log.info("resumed at frame %d", renderer.frame)

    stats = RenderStats()
    stats.set_scene_counts(scene)
    start = time.perf_counter()
    first_launch = True
    while renderer.frame < args.spp:
        stats.frame_begin()
        if not renderer.step():
            break
        stats.frame_end(renderer.last_stats["total_rays"])
        i = renderer.frame - 1  # samples accumulated, 0-based last sample
        if args.verbose or (i + 1) % 16 == 0 or first_launch:
            elapsed = time.perf_counter() - start
            log.info("frame %d/%d (%.2f s)", i + 1, args.spp, elapsed)
        first_launch = False
        if args.stats_every and (i + 1) % args.stats_every == 0:
            print(stats.format_table())
        if args.preview and (i + 1) % args.preview == 0:
            if args.preview_scale > 1:
                write_image(args.out,
                            renderer.preview_image(args.preview_scale))
            else:
                write_image(args.out, renderer.image())
            print(stats.format_table())
            log.info("preview updated: %s (%d spp)", args.out,
                     renderer.frame)
        if args.adaptive > 0 and (i + 1) % 8 == 0:
            frac = renderer.adaptive_converged_fraction()
            if frac >= 0.999:
                log.info("adaptive: %.1f%% of pixels converged, stopping "
                         "at %d/%d frames", frac * 100, i + 1, args.spp)
                break
    elapsed = time.perf_counter() - start

    write_image(args.out, renderer.image())
    if args.aovs:
        write_aovs(args.aovs, renderer.aovs())
        log.info("wrote AOVs: %s_{albedo,normal,depth}.png", args.aovs)
    log.info(
        "wrote %s: %d spp in %.2f s (%.2f spp/s, %d triangles)",
        args.out, renderer.frame, elapsed,
        renderer.frame / max(elapsed, 1e-9), scene.num_triangles,
    )
    if args.checkpoint:
        renderer.save_checkpoint(args.checkpoint)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
