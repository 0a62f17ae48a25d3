"""Adaptive sampling: per-pixel variance-driven progressive rendering (port
of raytracer_tpu/integrator/adaptive.py).

Each pixel keeps a Welford estimate of its luminance variance and stops
sampling once the relative standard error of its mean falls under
`RenderConfig.adaptive_tol` (after at least `adaptive_min_frames`
samples). A retired pixel's lane goes into the wavefront inactive: it
traces nothing, and K1-K4's persistent warps skip it. The shading still
runs on full-size tensors (integrator/wavefront.py), so a frame saves the
traversal of the retired lanes, not their shading.

Exactness: each pixel's sample stream is indexed by its own count (seed =
tea(pixel, count), frame-0 centred jitter per pixel), so a pixel's first k
samples are bit-identical to the plain renderer's first k frames, and
adaptive_tol=0 reproduces the plain accumulation bit for bit. The running
mean is `wavefront.accumulate` with the count as each pixel's frame.

State: mean f32[N,3] (the image), m2 f32[N] (the luminance sum of squared
deviations), count i64[N] (samples taken; uint32 in checkpoints, as the
JAX package writes it).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from raytracer_tpu_torch.integrator.wavefront import (
    accumulate,
    render_wavefront,
)
from raytracer_tpu_torch.ops.math3d import luminance_rec709
from raytracer_tpu_torch.utils.config import RenderConfig


class AdaptiveState(NamedTuple):
    mean: torch.Tensor  # f32[N,3]
    m2: torch.Tensor  # f32[N]
    count: torch.Tensor  # i64[N], a uint32 count

    @staticmethod
    def empty(n: int, device) -> "AdaptiveState":
        return AdaptiveState(
            mean=torch.zeros((n, 3), dtype=torch.float32, device=device),
            m2=torch.zeros((n,), dtype=torch.float32, device=device),
            count=torch.zeros((n,), dtype=torch.int64, device=device),
        )


def active_mask(state: AdaptiveState, cfg: RenderConfig) -> torch.Tensor:
    """bool[N]: pixels still sampling. A pixel retires once it has at least
    `adaptive_min_frames` samples and the relative standard error of its
    mean luminance is under `adaptive_tol` (tol 0 never retires: rel >= 0
    is never < 0)."""
    cf = state.count.to(torch.float32)
    var_of_mean = state.m2 / torch.clamp_min(cf * (cf - 1.0), 1.0)
    rel = torch.sqrt(torch.clamp_min(var_of_mean, 0.0)) / torch.clamp_min(
        luminance_rec709(state.mean), 1e-3)
    converged = ((state.count >= cfg.adaptive_min_frames)
                 & (rel < cfg.adaptive_tol))
    return ~converged


def render_frame_adaptive(scene, camera_ubo, state: AdaptiveState,
                          cfg: RenderConfig, pixel_start=0, num_pixels=None,
                          with_stats: bool = False):
    """One adaptive progressive step: sample only the unconverged pixels,
    each at its own count as its frame, and fold them into the Welford
    state. Returns the new AdaptiveState (and, with with_stats=True, the
    wavefront's ray counts). On the tile [pixel_start, pixel_start +
    num_pixels) of a multi-device render `state` holds the tile's rows:
    convergence is per pixel, so tiles never communicate."""
    active = active_mask(state, cfg)
    out = render_wavefront(scene, camera_ubo, state.count, cfg,
                           pixel_start=pixel_start, num_pixels=num_pixels,
                           active=active, with_stats=with_stats)
    radiance = out[0] if with_stats else out

    # The running mean, with each pixel's count as its frame; inactive
    # lanes keep their mean (their radiance is not a sample).
    blended = accumulate(state.mean, radiance, state.count)
    mean_new = torch.where(active[:, None], blended, state.mean)

    # Welford m2 over luminance (luminance is linear, so the luminance of
    # the running mean is the running mean of the luminances).
    lum = luminance_rec709(radiance)
    delta = lum - luminance_rec709(state.mean)
    delta2 = lum - luminance_rec709(mean_new)
    m2_new = torch.where(active, state.m2 + delta * delta2, state.m2)

    count_new = state.count + active.to(torch.int64)
    new = AdaptiveState(mean=mean_new, m2=m2_new, count=count_new)
    return (new, out[1]) if with_stats else new
