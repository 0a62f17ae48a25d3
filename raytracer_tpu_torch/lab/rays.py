"""The traversal lab's workload, ray sets and timer, the ray sets built
on the port's own render path (integrator/wavefront.py: _camera_rays,
_trace, _shade, fetch_surface, _select_lights, _sample_light; ops/rng.py).

The workload is the JAX labs' (tools/kernel_lab.py:31,399-404,
tools/occl_lab.py:245-252, tools/bvh4_lab.py:412-428): the procedural
300k-triangle atrium, 1920x1080, the bench camera, max depth 3. The sets:

  - primary rays with kernel_lab's jitter: seed_pixels(pixel, 1), two
    draws, 0.5 + (r - 0.5) * 0.4 (tools/sort_lab.py:215 sl_make_state1);
  - the bounce-1 wavefront, alive & payload hit after the primary shade,
    in the port renderer's order (lane i is pixel i: the wavefront the card
    really traces) and in `_sort_wavefront`'s order (the JAX labs');
  - the NEE shadow batch of a wavefront's hits (tools/occl_lab.py:186
    shadow_rays_at): at bounce 0 from the primary hits, and at bounce 1
    from the bounce-1 hits in either order. (occl_lab's own "b0" and "b1"
    both trace the bounce-1 wavefront, unsorted and sorted: they are this
    module's shadow_b1 and shadow_b1_sorted.)

A closest-hit set is (origin, direction, t_max) with t_max = 1e4 on live
rays and 1e-3 (T_MIN, no walk) on the rest, as the labs' `prep`. A shadow
set is (origin, direction, t_max, skip_object, active) with t_max folded
to 1e-3 on inactive rays.
"""

from __future__ import annotations

import numpy as np
import torch

from raytracer_tpu_torch.integrator import wavefront as wf
from raytracer_tpu_torch.ops import rng
from raytracer_tpu_torch.ops.camera import Camera
from raytracer_tpu_torch.ops.math3d import (
    cos_theta,
    dot_k,
    length,
    make_basis,
    normalize,
    world_to_local,
)
from raytracer_tpu_torch.ops.quad_traverse import T_MIN
from raytracer_tpu_torch.utils.config import RenderConfig

WIDTH, HEIGHT = 1920, 1080
TRIANGLES = 300_000
CAM_POS, CAM_TARGET = (-16.0, 6.5, -7.5), (8.0, 3.0, 4.0)
T_FAR = 1e4  # the labs' t_max of a live closest-hit ray


def require_cuda():
    """The lab's card: cuda:0, or SystemExit when there is none (the lab
    measures the card and has no CPU fallback)."""
    if not torch.cuda.is_available():
        raise SystemExit("the traversal lab needs a CUDA device; the plain "
                         "versions on the CPU are the tests' job")
    return torch.device("cuda", 0)


def card_line():
    """The card's name, power limit and current SM clock, as nvidia-smi
    reports them now."""
    import subprocess

    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if proc.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Mean device ms of fn() over `reps` launches after one warm-up, by
    CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, *args):
    """(fn(*args), host ms of that one run between two device
    synchronisations): the plain versions' timer."""
    import time

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def atrium(leaf_size, device):
    """The 300k-triangle atrium baked with `leaf_size` on `device`."""
    return atrium_and_bvh(leaf_size, device)[0]


def atrium_and_bvh(leaf_size, device):
    """(the atrium's bake, the binary BVH it was baked from), for the labs
    that build another tree from the BVH (lab/r3_oct_lab.collapse_bvh8)."""
    from raytracer_tpu_torch.scene.benchmark import create_benchmark_atrium
    from raytracer_tpu_torch.scene.device_scene import bake_scene

    return bake_scene(create_benchmark_atrium(TRIANGLES),
                      leaf_size=leaf_size, device=device)


def camera_ubo(device, width, height, position=CAM_POS, target=CAM_TARGET):
    cam = Camera.create(position=position, aspect=width / height,
                        target=target)
    mats = cam.matrices()
    return {k: torch.from_numpy(np.ascontiguousarray(mats[k])).to(device)
            for k in ("inverse_view", "inverse_proj")}


def primary_state(ubo, cfg, device) -> wf.WavefrontState:
    """Frame-1 primary rays with kernel_lab's jitter, every lane alive."""
    n = cfg.num_pixels
    pixel_idx = torch.arange(n, dtype=torch.int64, device=device)
    seed0 = rng.seed_pixels(pixel_idx, 1)
    r1, seed_rgen = rng.rnd(seed0)
    r2, seed_rgen = rng.rnd(seed_rgen)
    jitter = 0.5 + (torch.stack([r1, r2], dim=-1) - 0.5) * 0.4
    origin, direction = wf._camera_rays(
        ubo["inverse_view"], ubo["inverse_proj"], cfg.width, cfg.height,
        jitter, pixel_idx)
    f32 = dict(dtype=torch.float32, device=device)
    yes = torch.ones((n,), dtype=torch.bool, device=device)
    return wf.WavefrontState(
        origin=origin, direction=direction,
        color=torch.zeros((n, 3), **f32), throughput=torch.ones((n, 3), **f32),
        seed_rgen=seed_rgen, seed=seed_rgen, alive=yes, first_bounce=yes,
        is_specular=~yes, prev_brdf_pdf=torch.ones((n,), **f32),
        prev_hit_pos=torch.zeros((n, 3), **f32),
        p_sample_light=torch.zeros((n,), **f32), did_direct=~yes,
        channel=torch.full((n,), -1, dtype=torch.int32, device=device),
        pixel=torch.arange(n, dtype=torch.int32, device=device))


def bounce1_state(ds, state0, cfg) -> wf.WavefrontState:
    """The wavefront after the primary trace and shade, alive & payload
    hit, in the renderer's lane order."""
    hit = wf._trace(ds, state0.origin, state0.direction, cfg, state0.alive)
    st1, payload_hit, _ = wf._shade(ds, state0, hit, cfg)
    return st1._replace(alive=st1.alive & payload_hit)


def wavefronts(ds, width=WIDTH, height=HEIGHT):
    """(cfg, {"primary", "bounce1", "bounce1_sorted"} -> WavefrontState)
    from the bench camera, depth 3."""
    cfg = RenderConfig(width=width, height=height, max_depth=3)
    ubo = camera_ubo(ds.device, width, height)
    s0 = primary_state(ubo, cfg, ds.device)
    s1 = bounce1_state(ds, s0, cfg)
    s1_sorted, _ = wf._sort_wavefront(s1, ds)
    return cfg, {"primary": s0, "bounce1": s1, "bounce1_sorted": s1_sorted}


def shadow_rays(ds, state, cfg):
    """The NEE shadow batch of `state`'s hits: trace it, fetch the surface,
    draw the NEE lottery, pick and sample a light, offset the origin, as
    the integrator's _shade. Returns (origin f32[N,3], direction f32[N,3],
    t_max f32[N] = 0.999 x the distance to the light sample, skip_object
    i32[N] = the light's object, active bool[N])."""
    hit = wf._trace(ds, state.origin, state.direction, cfg, state.alive)
    lane = state.alive & hit.hit
    surf = wf.fetch_surface(ds, hit, state.direction, lane)
    p_sample_light = torch.clamp(surf.roughness, 0.1, 0.9)
    p_draw, seed = rng.rnd_masked(state.seed, lane)
    do_nee = lane & (p_draw < p_sample_light)
    sel = wf._select_lights(ds, cfg, surf.world_pos, surf.obj, do_nee, seed,
                            None)
    l_used = min(ds.num_lights, cfg.max_lights)
    sel_c = torch.clamp(sel.selected, 0, l_used - 1).long()
    m_samp = sel.found
    l_pos, _, l_dir, _, _, _, _, l_valid, _ = wf._sample_light(
        ds, sel.selected, surf.world_pos, sel.seed, m_samp, cfg)
    wi_local = world_to_local(l_dir, make_basis(surf.world_nrm))
    consider = m_samp & l_valid & (cos_theta(wi_local) > 1e-4)
    to_light_n = normalize(l_pos - surf.world_pos)
    offset_from = surf.world_pos + surf.world_nrm * (
        0.001 * torch.sign(dot_k(surf.world_nrm, to_light_n)))
    sr = l_pos - offset_from
    sr_dist = length(sr)
    sr_dir = sr / torch.clamp_min(sr_dist, 1e-20)[:, None]
    active = consider & (sr_dist > 0.0)
    return offset_from, sr_dir, sr_dist * 0.999, ds.light_object[sel_c], active


def closest_sets(ds, width=WIDTH, height=HEIGHT):
    """{"primary", "bounce1", "bounce1_sorted"} -> (origin, direction,
    t_max)."""
    _, states = wavefronts(ds, width, height)
    return {name: (s.origin.contiguous(), s.direction.contiguous(),
                   torch.where(s.alive, T_FAR, T_MIN).to(torch.float32))
            for name, s in states.items()}


def shadow_sets(ds, width=WIDTH, height=HEIGHT):
    """{"shadow_b0", "shadow_b1", "shadow_b1_sorted"} -> (origin,
    direction, t_max, skip_object, active)."""
    cfg, states = wavefronts(ds, width, height)
    out = {}
    for name, key in (("shadow_b0", "primary"), ("shadow_b1", "bounce1"),
                      ("shadow_b1_sorted", "bounce1_sorted")):
        o, d, tm, skip, active = shadow_rays(ds, states[key], cfg)
        out[name] = (o.contiguous(), d.contiguous(),
                     torch.where(active, tm, T_MIN).contiguous(),
                     skip.to(torch.int32).contiguous(), active)
    return out


def resort_key(origin, active, ds):
    """occl_lab's `resort` key (tools/occl_lab.py:275-281): inactive rays
    last, then the 27-bit position Morton code of the origin."""
    return ((~active).to(torch.int64) << 31) | wf.position_morton(origin, ds)


def parity_mismatches(out, ref):
    """The JAX labs' parity count (tools/v2_kernel_lab.py:264,
    tools/v3_kernel_lab.py:385) of closest-hit outputs (t, tri, ...)
    against a reference: rays whose triangle differs and whose t is not
    within rtol 1e-5 (atol 1e-8, numpy's isclose) of the reference's."""
    close = torch.isclose(out[0], ref[0], rtol=1e-5, atol=1e-8)
    return int(((out[1] != ref[1]) & ~close).sum())
