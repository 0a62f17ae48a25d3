"""Edge-aware preview denoiser, an SVGF-style a-trous wavelet filter (port
of raytracer_tpu/integrator/denoise.py).

The filter runs only when an image is read out (`api.image(denoise=True)`,
`api.preview_image`): the accumulation buffer is never touched, so
convergence and checkpoints are the same with or without it.

  - a G-buffer from one extra primary-ray trace (centre rays, no jitter):
    normal, depth, albedo; the renderer caches it until the camera or the
    scene changes.
  - demodulate by the albedo, filter, remodulate: texture detail stays out
    of the filter.
  - 5x5 B3-spline a-trous taps at power-of-two strides, with per-tap
    weights that stop at normal edges (dot^phi_n), depth edges
    (exp(-|dz|/sigma_z)) and luminance edges (exp(-|dl|/sigma_l)).

Plain torch on the tensors' device: elementwise work and static shifts of
an edge-padded image. It matches the JAX filter within a tolerance, not bit
for bit: XLA on the CPU contracts `acc + w * s_t` into an FMA, and its exp
is not torch's.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from raytracer_tpu_torch.ops.math3d import luminance_rec709
from raytracer_tpu_torch.utils.config import RenderConfig

MISS_DEPTH = 1e30


def gbuffer_pass(scene, camera_ubo, cfg: RenderConfig, pixel_start=0,
                 num_pixels=None):
    """Primary-hit G-buffer for the denoiser: (normal f32[N,3], depth
    f32[N], albedo f32[N,3]) from centre rays (the frame-0 jitter). Miss
    lanes get normal 0, depth MISS_DEPTH and albedo 1, so demodulation
    passes the background through the filter unchanged.
    `pixel_start`/`num_pixels` carve out the tile of a multi-device render
    (parallel/sharding.py:gbuffer_sharded), as in render_wavefront."""
    from raytracer_tpu_torch.integrator.wavefront import (
        _camera_rays, _trace, fetch_surface, tile_pixels,
    )

    cfg = cfg.resolve_accel()
    dev = scene.device
    pixel_idx = tile_pixels(cfg, pixel_start, num_pixels, dev)
    n = pixel_idx.shape[0]
    jitter = torch.full((n, 2), 0.5, dtype=torch.float32, device=dev)
    origin, direction = _camera_rays(
        camera_ubo["inverse_view"], camera_ubo["inverse_proj"],
        cfg.width, cfg.height, jitter, pixel_idx,
    )
    hit = _trace(scene, origin, direction, cfg,
                 torch.ones((n,), dtype=torch.bool, device=dev))
    surf = fetch_surface(scene, hit, direction, hit.hit)
    m = hit.hit[:, None]
    normal = torch.where(m, surf.world_nrm, 0.0)
    depth = torch.where(hit.hit, hit.t, MISS_DEPTH)
    albedo = torch.where(m, surf.albedo, 1.0)
    return normal, depth, albedo


def _pad_edge(a, pad):
    """Edge-replicate an [H, W, C] tensor by `pad` on both spatial axes
    (jnp.pad mode="edge")."""
    nchw = a.permute(2, 0, 1).unsqueeze(0)
    return F.pad(nchw, (pad, pad, pad, pad), mode="replicate")[0].permute(
        1, 2, 0)


def _shift2d(a, dy, dx, pad):
    """Static shift of an edge-padded [H+2p, W+2p, C] tensor: the (dy, dx)
    tap of the padded stack, restricted back to [H, W, C]."""
    h = a.shape[0] - 2 * pad
    w = a.shape[1] - 2 * pad
    return a[pad + dy: pad + dy + h, pad + dx: pad + dx + w]


# 5-tap B3-spline, outer-product 2-D kernel (the SVGF choice).
_H1 = (1 / 16, 1 / 4, 3 / 8, 1 / 4, 1 / 16)


def _pow_int(x, k: int):
    """x ** k for a static power of two k by repeated squaring: the
    lax.integer_pow that JAX's `x ** 64` lowers to."""
    while k > 1:
        x = x * x
        k //= 2
    return x


def atrous_denoise(img, normal, depth, albedo, height, width,
                   iterations: int = 4, sigma_z: float = 1.0,
                   sigma_l: float = 4.0, phi_n: int = 64):
    """Edge-aware a-trous filter of a linear-radiance image.

    img/normal/albedo: f32[N,3], depth: f32[N] (flat pixel-major, as the
    accumulation buffer), all on one device. Returns f32[N,3]. A pure
    function of its inputs: the caller owns G-buffer caching."""
    if phi_n & (phi_n - 1):
        raise ValueError(f"phi_n must be a power of two, got {phi_n}")
    img = img.reshape(height, width, 3)
    nrm = normal.reshape(height, width, 3)
    z = depth.reshape(height, width, 1)
    alb = albedo.reshape(height, width, 3)

    miss = z >= MISS_DEPTH  # [H,W,1]
    # Demodulate and remodulate with the SAME clamped albedo, so a channel
    # of albedo < 1e-3 keeps its highlights and emission.
    alb = torch.clamp_min(alb, 1e-3)
    s = img / alb

    for it in range(iterations):
        step = 1 << it
        pad = 2 * step
        sp = _pad_edge(s, pad)
        np_ = _pad_edge(nrm, pad)
        zp = _pad_edge(z, pad)
        mp = zp >= MISS_DEPTH  # edge padding commutes with the compare
        lum = luminance_rec709(s)[..., None]

        acc = torch.zeros_like(s)
        wsum = torch.zeros_like(lum)
        for ky in range(5):
            for kx in range(5):
                dy = (ky - 2) * step
                dx = (kx - 2) * step
                h = _H1[ky] * _H1[kx]
                s_t = _shift2d(sp, dy, dx, pad)
                n_t = _shift2d(np_, dy, dx, pad)
                z_t = _shift2d(zp, dy, dx, pad)
                m_t = _shift2d(mp, dy, dx, pad)
                both_miss = miss & m_t
                # Normal edge-stop; two miss pixels agree by definition.
                ndot = torch.clamp_min(
                    (nrm * n_t).sum(dim=-1, keepdim=True), 0.0)
                w_n = torch.where(both_miss, 1.0, _pow_int(ndot, phi_n))
                # Depth edge-stop (stride-scaled); miss pairs agree.
                dz = torch.abs(z - z_t)
                w_z = torch.where(both_miss, 1.0,
                                  torch.exp(-dz / (sigma_z * step + 1e-6)))
                # Surface-vs-background boundaries get zero weight.
                w_z = torch.where(miss ^ m_t, 0.0, w_z)
                lum_t = luminance_rec709(s_t)[..., None]
                w_l = torch.exp(-torch.abs(lum - lum_t) / sigma_l)
                w = h * w_n * w_z * w_l
                acc = acc + w * s_t
                wsum = wsum + w
        s = acc / torch.clamp_min(wsum, 1e-8)

    return (s * alb).reshape(-1, 3)


def _resize_weights(n_in, n_out, device):
    """The [n_in, n_out] weights of jax.image.resize "bilinear" along one
    axis of an upscale: a triangle kernel at half-pixel centres, each
    column renormalised to sum to 1 (which re-weights the border), in the
    same f32 steps."""
    inv_scale = 1.0 / (n_out / n_in)
    sample = ((torch.arange(n_out, dtype=torch.float32, device=device) + 0.5)
              * inv_scale - 0.5)
    x = torch.abs(sample[None, :] - torch.arange(
        n_in, dtype=torch.float32, device=device)[:, None])
    w = torch.clamp_min(1.0 - x, 0.0)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def upscale_bilinear(img, h, w, out_h, out_w):
    """Bilinear upscale of a flat [h*w, 3] linear-radiance image to
    [out_h*out_w, 3] (the preview-scale path), as jax.image.resize
    "bilinear" computes it: one weight matrix an axis, the width contracted
    first (on the CPU, within an ulp of the JAX result)."""
    dev = img.device
    out = torch.einsum("hwc,wv->hvc", img.reshape(h, w, 3),
                       _resize_weights(w, out_w, dev))
    out = torch.einsum("hvc,hu->uvc", out, _resize_weights(h, out_h, dev))
    return out.reshape(-1, 3)
