"""Image IO + SSIM quality gate.

PNG write/read via PIL; SSIM is a dependency-free numpy reimplementation of
`skimage.metrics.structural_similarity` with the defaults the reference's
`ssim_compare.py:6-21` relies on (win_size=7 uniform window, K1=0.01,
K2=0.03, channel_axis=2, uint8 data_range=255), so scores are comparable to
the reference's gate.
"""

from __future__ import annotations

import numpy as np


def tonemap(linear_rgb: np.ndarray) -> np.ndarray:
    """Linear [0,inf) f32 -> display u8. The reference blits its rgba32f
    accumulation image straight to an sRGB swapchain (UNORM blit performs no
    transfer function), so the honest equivalent is a plain clamp."""
    return (np.clip(linear_rgb, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def write_png(path: str, image: np.ndarray):
    """image: u8[H,W,3] or f32[H,W,3] linear (tonemapped on the way out)."""
    from PIL import Image

    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        arr = tonemap(arr)
    Image.fromarray(arr, mode="RGB").save(path)


def read_png(path: str) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"))


def write_ppm(path: str, image: np.ndarray):
    """Binary P6 PPM dump — the reference's render-dump format
    (.gitignore:7 ignores *.ppm)."""
    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        arr = tonemap(arr)
    h, w = arr.shape[:2]
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(arr.tobytes())


def read_ppm(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    # Header: magic, whitespace-separated w h maxval, single whitespace.
    parts = data.split(maxsplit=4)
    assert parts[0] == b"P6", "only binary P6 PPM supported"
    w, h, maxval = int(parts[1]), int(parts[2]), int(parts[3])
    assert maxval == 255
    pixels = parts[4][: w * h * 3]
    return np.frombuffer(pixels, np.uint8).reshape(h, w, 3)


def write_image(path: str, image: np.ndarray):
    """Dispatch on extension (.png or .ppm)."""
    if path.lower().endswith(".ppm"):
        write_ppm(path, image)
    else:
        write_png(path, image)


def read_image(path: str) -> np.ndarray:
    if path.lower().endswith(".ppm"):
        return read_ppm(path)
    return read_png(path)


def _box_filter(img: np.ndarray, win: int) -> np.ndarray:
    """Mean filter with a win x win window, 'valid' region only, via 2-D
    cumulative sums. img: f64[H,W]."""
    c = np.cumsum(np.cumsum(img, axis=0), axis=1)
    c = np.pad(c, ((1, 0), (1, 0)))
    h, w = img.shape
    oh, ow = h - win + 1, w - win + 1
    s = (
        c[win : win + oh, win : win + ow]
        - c[0:oh, win : win + ow]
        - c[win : win + oh, 0:ow]
        + c[0:oh, 0:ow]
    )
    return s / (win * win)


def _ssim_single(x: np.ndarray, y: np.ndarray, win: int, data_range: float):
    """SSIM for one channel, skimage semantics (uniform filter, unbiased
    covariance, crop win//2 border before averaging)."""
    x = x.astype(np.float64)
    y = y.astype(np.float64)
    np_ = win * win
    cov_norm = np_ / (np_ - 1.0)

    ux = _box_filter(x, win)
    uy = _box_filter(y, win)
    uxx = _box_filter(x * x, win)
    uyy = _box_filter(y * y, win)
    uxy = _box_filter(x * y, win)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    k1, k2 = 0.01, 0.03
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    a1 = 2.0 * ux * uy + c1
    a2 = 2.0 * vxy + c2
    b1 = ux * ux + uy * uy + c1
    b2 = vx + vy + c2
    s = (a1 * a2) / (b1 * b2)
    # skimage computes over the valid region then ignores another pad border;
    # with 'valid' box filtering the result already matches its cropped mean.
    return s.mean(), s


def ssim(image_a: np.ndarray, image_b: np.ndarray, data_range=None,
         win_size: int = 7):
    """Mean SSIM over channels (channel_axis=2), reference gate semantics."""
    a = np.asarray(image_a)
    b = np.asarray(image_b)
    assert a.shape == b.shape, f"shape mismatch {a.shape} vs {b.shape}"
    if data_range is None:
        if a.dtype == np.uint8:
            data_range = 255.0
        else:
            data_range = float(max(a.max() - a.min(), 1e-6))
    if a.ndim == 2:
        return _ssim_single(a, b, win_size, data_range)[0]
    scores = [
        _ssim_single(a[..., c], b[..., c], win_size, data_range)[0]
        for c in range(a.shape[-1])
    ]
    return float(np.mean(scores))
