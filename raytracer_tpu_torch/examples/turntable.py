"""Turntable animation: N orbit frames of the Cornell box (port of the JAX
package's examples/turntable.py).

The camera is an input of every frame, not a part of the bake: each
viewpoint of an orbit (or of an animation's camera track) resets the
accumulation and reuses the baked scene and the built kernels, so frame 1
pays the kernels' build (or finds them built) and later frames pay only
render time.

    python -m raytracer_tpu_torch.examples.turntable [--frames N]
        [--spp S] [--size WxH] [--outdir DIR] [--device cuda|cpu]

Writes turntable_000.png .. into --outdir (default: turntable in the
temporary directory).
"""

from __future__ import annotations

import argparse
import math
import os
import tempfile
import time

import numpy as np

from raytracer_tpu_torch.api import ProgressiveRenderer
from raytracer_tpu_torch.ops.camera import Camera
from raytracer_tpu_torch.scene.model import create_cornell_box
from raytracer_tpu_torch.utils.config import RenderConfig
from raytracer_tpu_torch.utils.image import write_image


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--frames", type=int, default=12)
    p.add_argument("--spp", type=int, default=4)
    p.add_argument("--size", default="256x256", help="WxH")
    p.add_argument("--outdir",
                   default=os.path.join(tempfile.gettempdir(), "turntable"))
    p.add_argument("--device", default="cuda")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    w, h = (int(x) for x in args.size.split("x"))
    os.makedirs(args.outdir, exist_ok=True)
    r = ProgressiveRenderer(create_cornell_box(), None,
                            RenderConfig(width=w, height=h),
                            device=args.device)
    radius, height_y = 2.9, 0.1
    times = []
    for i in range(args.frames):
        a = 2 * math.pi * i / args.frames * 0.25 - math.pi * 0.125  # ±22.5°
        t0 = time.perf_counter()
        r.set_camera(Camera.create(
            position=(radius * math.sin(a), height_y,
                      -radius * math.cos(a)),
            aspect=w / h, target=(0.0, 0.0, 0.1)))
        img = r.render(args.spp)  # a camera change resets accumulation
        write_image(os.path.join(args.outdir, f"turntable_{i:03d}.png"), img)
        times.append(time.perf_counter() - t0)
        print(f"frame {i}: {times[-1]:.2f}s ({args.spp} spp)", flush=True)
    steady = (f"{np.median(times[1:]):.2f}s/frame" if len(times) > 1
              else "n/a")
    print(f"first frame (kernel build or cache hit): {times[0]:.2f}s; "
          f"steady state: {steady} over {args.frames} viewpoints, one bake",
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
