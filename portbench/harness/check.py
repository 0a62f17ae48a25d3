"""What decides `correct`: the program's image, as the timed window left
it, against the plain reference at a sample of pixels drawn from the seed.

Plain NEE cells (`full_history`): the accumulated image is the running
mean of every frame's sample, and each (pixel, frame) sample depends on
nothing else, so the reference traces every frame of the run (the warm
frames and the window's) at the sampled pixels and accumulates them as
the renderer does. Numbers: `max_gap`, the widest absolute gap of a
sampled pixel's channel, and `mean_gap`, the mean absolute gap over the
reference's mean value.

ReSTIR cells (`step`): a pixel's frame reads its neighbours' reservoirs,
which read theirs, so after a run of frames every pixel depends on a
growing neighbourhood. The reference follows the run's last frame from
the program's own state of the frame before (its reservoir at the
sampled pixels and their taps, its accumulation at the sampled pixels),
and checks what this takes from the program by itself: the start (frame
0, from empty reservoirs, in set-up), the reservoir the last frame hands
on, and the state the frames build up, by following frames 0 and 1 from
empty reservoirs itself (at the sampled pixels, frame 0 at the pixels
that frame 1 reads) against the program's state after frame 1. Numbers:
`frame_mean_gap`, the last frame's mean absolute gap in radiance (the
accumulation's gap times the frame count) over the reference frame's
mean value; `reservoir_mismatch`, the share of sampled pixels whose
handed-on sample (light triangle) differs; `start_mean_gap`, frame 0's
mean gap over its mean value; after frame 1, `chain_mean_gap`, the
accumulation's mean gap over its mean value, and `chain_mismatch`, the
share of sampled pixels whose reservoir differs in its light triangle,
its sample count M or its weight W (by more than W_TOLERANCE of W). A
single frame's widest gap is not compared: one path that rounding sends
another way moves a pixel's sample by up to the radiance clamp.
"""

from __future__ import annotations

import numpy as np
import torch

from harness import refrestir
from harness.reference import PathTracer, RefScene, running_mean

# The fields of the reservoir after frame 1 that the chain compares, and
# the relative gap at which two weights W differ (rounding moves W by
# about 1e-7 in float32; a weight that is NaN differs).
CHAIN_FIELDS = ("light_index", "m", "w")
W_TOLERANCE = 1e-3
# The renderer's settings that the reference reads, at their defaults.
REFERENCE_DEFAULTS = dict(
    max_depth=3, rr_start_depth=3, radiance_clamp=5.0,
    background=(0.53, 0.81, 0.92), t_min=0.001, t_max=10000.0,
    max_lights=256, enable_transmission=True, restir_initial_candidates=8,
    restir_spatial_neighbors=4, restir_spatial_radius=16.0,
    restir_max_m=128, restir_initial_visibility=True,
    restir_final_visibility_feedback=False, restir_unbiased_spatial=False)
# Settings that change no pixel's value, and those the reference
# does not model away from these values.
NEUTRAL = ("accel", "stable_bake", "bvh_leaf_size", "compact_deep",
           "compact_decay", "spp_batch", "use_restir", "width", "height")
FIXED = dict(use_direct_lighting=True, use_mis=True,
             use_light_sampling_only=False, adaptive_tol=0.0,
             denoise_preview=False, accumulation_limit=None)


def reference_settings(settings: dict) -> dict:
    cfg = dict(REFERENCE_DEFAULTS)
    for k, v in settings.items():
        if k in FIXED:
            if v != FIXED[k]:
                raise ValueError(f"the reference does not model {k}={v!r}")
        elif k in REFERENCE_DEFAULTS:
            cfg[k] = v
        elif k not in NEUTRAL:
            raise ValueError(f"the reference does not know setting {k!r}")
    cfg["width"], cfg["height"] = settings["width"], settings["height"]
    return cfg


def sample_pixels(seed: int, num_pixels: int, count: int) -> np.ndarray:
    rng = np.random.default_rng([int(seed) % (1 << 63), 0x5EED])
    return np.sort(rng.choice(num_pixels, size=min(count, num_pixels),
                              replace=False))


def gaps(prog, ref, scale=1.0):
    """(widest absolute gap, mean absolute gap over the mean of |ref|),
    both times `scale`."""
    gap = (prog.double().cpu() - ref.double().cpu()).abs() * scale
    mean_ref = float(ref.double().abs().mean()) * scale
    return float(gap.max()), float(gap.mean()) / max(mean_ref, 1e-12)


class Reference:
    """The reference of a cell: the scene, its tracer and its settings, in
    float dtype `dt`."""

    def __init__(self, desc, settings, camera, device, dt=torch.float32):
        self.cfg = reference_settings(settings)
        self.dt = dt
        self.device = device
        self.tracer = PathTracer(RefScene(desc, device, dt), self.cfg,
                                 camera)

    def accumulation(self, pixels, frames: int, lanes: int):
        """The running mean over frames 0..frames-1 at `pixels` (i64)."""
        rows = []
        per = max(1, lanes // max(1, pixels.numel()))
        for f0 in range(0, frames, per):
            f1 = min(frames, f0 + per)
            fr = torch.arange(f0, f1, device=self.device).repeat_interleave(
                pixels.numel())
            px = pixels.repeat(f1 - f0)
            rad = self.tracer.render(px, fr)
            rows.append(rad.reshape(f1 - f0, pixels.numel(), 3))
        return running_mean(torch.cat(rows))

    def restir_frame(self, pixels, frame, prev_of):
        return refrestir.RestirFrame(self.tracer, self.cfg).frame(
            pixels, frame, prev_of)

    def restir_handed_on(self, pixels, frame, prev_of):
        return refrestir.RestirFrame(self.tracer, self.cfg).handed_on(
            pixels, frame, prev_of)[0]

    def empty(self, ids):
        return refrestir.empty(ids.numel(), self.dt, self.device)


def _accumulate(prev, rad, frame: int):
    """The renderer's running mean after frame `frame`."""
    if frame == 0:
        return rad
    a = (1.0 / (torch.tensor(float(frame)) + 1.0)).to(rad.device, rad.dtype)
    return prev.to(rad.device, rad.dtype) + (rad - prev.to(
        rad.device, rad.dtype)) * a


def step_outputs(ref: Reference, pixels, state):
    """What the program outputs at `pixels` in a ReSTIR cell, as the
    reference computes it: from the program's state of the frame before,
    `accum` after the last frame and the `light_index` of the reservoir it
    hands on; from empty reservoirs, frame 0's image `start` and, after
    frames 0 and 1, the `chain`: the accumulation and the reservoir handed
    on (CHAIN_FIELDS). `state` holds `frame` (the last frame's number f),
    `prev_accum` [P,3] and `prev_of` (the program's reservoir of frame f-1
    by pixel ids)."""
    f = state["frame"]
    rad, res = ref.restir_frame(pixels, f, state["prev_of"])
    acc = _accumulate(state["prev_accum"], rad, f)
    start, _ = ref.restir_frame(pixels, 0, ref.empty)
    # Frames 0 and 1 from empty reservoirs: frame 1 at `pixels` reads
    # frame 0's reservoirs at `read`.
    read = refrestir.pixels_read(ref.cfg, pixels, 1, ref.dt)
    res0 = ref.restir_handed_on(read, 0, ref.empty)
    rad1, res1 = ref.restir_frame(
        pixels, 1, lambda ids: {k: v[torch.searchsorted(read, ids)]
                                for k, v in res0.items()})
    chain = {"accum": _accumulate(start, rad1, 1).float()}
    chain.update({k: res1[k] for k in CHAIN_FIELDS})
    return {"accum": acc.float(), "radiance": rad.float(),
            "light_index": res["light_index"], "start": start.float(),
            "chain": chain}


def step_numbers(out, truth, frame: int):
    """Numbers of a ReSTIR cell: outputs `out` (the program's, or the
    control's) against `truth` (the reference's, as step_outputs gives
    them)."""
    gap = (out["accum"].double().cpu() - truth["accum"].double().cpu()).abs()
    frame_mean = float(gap.mean()) * (frame + 1.0) / max(
        float(truth["radiance"].double().abs().mean()), 1e-12)
    mismatch = float((out["light_index"].cpu().long()
                      != truth["light_index"].cpu().long()).double().mean())
    _, start_mean = gaps(out["start"], truth["start"])
    c, t = out["chain"], truth["chain"]
    _, chain_mean = gaps(c["accum"], t["accum"])
    w, w_ref = c["w"].cpu().double(), t["w"].cpu().double()
    same = ((c["light_index"].cpu().long() == t["light_index"].cpu().long())
            & (c["m"].cpu().double() == t["m"].cpu().double())
            & ((w - w_ref).abs() <= W_TOLERANCE * w_ref.abs()))
    return {"frame_mean_gap": frame_mean, "reservoir_mismatch": mismatch,
            "start_mean_gap": start_mean, "chain_mean_gap": chain_mean,
            "chain_mismatch": float((~same).double().mean())}


def verdict(numbers: dict, limits: dict):
    """(correct, {name: {"value", "limit"}}): every number at or under
    its limit."""
    table = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    ok = all(np.isfinite(v) and v <= limits[k] for k, v in numbers.items())
    return ok, table
