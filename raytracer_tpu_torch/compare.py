"""SSIM image comparison CLI (port of raytracer_tpu/compare.py), the
reference's `ssim_compare.py` gate.

Usage: python -m raytracer_tpu_torch.compare <imageA> <imageB>
    [--diff out.png] [--threshold x]

Prints "SSIM: x.xxxxxx" as ssim_compare.py:20-21 does (skimage's default
semantics, in utils/image.py), optionally writes the difference map, and
with --threshold exits 1 when the score is below it."""

from __future__ import annotations

import argparse

import numpy as np

from raytracer_tpu_torch.utils.image import (
    _ssim_single,
    read_image,
    write_image,
)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Compare two images using SSIM.")
    p.add_argument("imageA", help="First image path (reference)")
    p.add_argument("imageB", help="Second image path (test)")
    p.add_argument("--diff", default=None,
                   help="write the difference map to this path")
    p.add_argument("--threshold", type=float, default=None,
                   help="exit non-zero if SSIM is below this value")
    args = p.parse_args(argv)

    a = read_image(args.imageA)
    b = read_image(args.imageB)
    scores, full = [], []
    for c in range(3):
        s, m = _ssim_single(a[..., c].astype(np.float64),
                            b[..., c].astype(np.float64), 7, 255.0)
        scores.append(s)
        full.append(m)
    score = float(np.mean(scores))
    print(f"SSIM: {score:.6f}")

    if args.diff:
        diff = np.clip(np.mean(full, axis=0) * 255.0, 0, 255).astype(np.uint8)
        write_image(args.diff, np.repeat(diff[..., None], 3, axis=-1))
    if args.threshold is not None and score < args.threshold:
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
