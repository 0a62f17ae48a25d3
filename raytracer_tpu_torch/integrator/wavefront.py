"""The wavefront path-tracing integrator (port of
raytracer_tpu/integrator/wavefront.py).

One lane per pixel: a structure-of-arrays wavefront with an alive mask, the
bounce loop a Python loop, every shading branch a masked lockstep update.

  simple.rgen (per-pixel recursion loop)    ->  render_wavefront
  traceRayEXT                               ->  quad_traverse.intersect_quad
                                                (accel="bvh": binary_traverse.
                                                intersect_bvh_binary)
  simple.rchit (shading + NEE/MIS)          ->  _shade
  rayQueryEXT shadow rays                   ->  quad_traverse.occlusion_quad
                                                (accel="bvh": binary_traverse.
                                                occlusion_bvh_binary)
  simple.rmiss                              ->  the miss branch
  rgba32f accumulation image                ->  accumulate

Every reference quirk the JAX module reproduces is reproduced here:
  - Two RNG streams per pixel (simple.rgen:71-79): the rgen-local seed
    (jitter + Russian roulette) and payload.seed (all shading draws), split
    after the jitter draws. Masked draws keep each lane's stream in the
    reference's serial consumption order.
  - Russian roulette only from depth >= 3, luminance-driven p in [.05,.95]
    (simple.rgen:55-68): dead code at MAX_DEPTH=3.
  - A hit surface that fails to produce a BSDF sample adds the background
    (simple.rchit:701-703 with simple.rgen:106-109).
  - Emissive-hit MIS uses the PREVIOUS bounce's p_sample_light,
    didDirectIllumination and brdf pdf (simple.rchit:641-691).
  - Radiance clamp 5.0 + NaN scrub, then the running mean
    (simple.rgen:121-136).
  - Dielectric transmission/refraction with dispersion (an extension beyond
    the reference); scenes without transmission take the exact reference
    path.

`render_wavefront` is lane-general, as the JAX one: an arbitrary (a range,
strided, repeated) set of pixel ids, a per-lane frame vector and
an `active` lane mask. spp batching (`render_tile_spp_batched`), adaptive
sampling (integrator/adaptive.py), the denoiser's G-buffer and the preview
stand on it.

Deep-bounce compaction (cfg.compact_deep) is the JAX package's: on the
4-wide tree's kernels ("cuda", "pallas" or "auto") with max_depth >
rr_start_depth + 1, the bounce loop is unrolled by depth, the lanes are
sorted before every bounce past the first (`_sort_wavefront`: dead lanes
last, then direction octant and position Morton, with a part-affinity
prefix on multi-part bakes; under an `active` mask from depth 0), and each
bounce past the Russian-roulette onset runs on the prefix of k lanes
(`_compact_prefix`) when the live count fits. JAX's `lax.cond` on the
count is one read of it to the host per such bounce; where the live lanes
overflow k, JAX runs the bounce full size, the port on the prefix of the
latest earlier bounce that holds them (full size only where none does), so
that long-lived paths, as through glass, cost no full-size bounce deep in
the path.
Every lane's state travels with it (the `pixel` field names its lane of
the launch), so the radiance is scattered back through `pixel` and the
image is bit for bit the uncompacted loop's: excluded lanes are dead, and
no operation on a lane depends on its position.

Where the sort does not run: the default depth-3 path and ReSTIR's
indirect bounces, which the JAX package sorts before every bounce past the
first, run unsorted here. The sort is a pure lane permutation, so it cannot
change the image, and on the H100 sorting and permuting cost more than the
walks save (PERF.md). `_occluded_sorted` ports the JAX shadow-ray sort
(`_occluded_pallas_sorted`: origin Morton under dead-last) for the same
measurement; the renderer does not call it. Whether either pays is a
question for a later speed PR (ROADMAP.md).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from raytracer_tpu_torch.ops import brdf, rng
from raytracer_tpu_torch.ops.binary_traverse import (
    intersect_bvh_binary,
    occlusion_bvh_binary,
    stack_fits,
)
from raytracer_tpu_torch.ops.intersect import intersect_brute, occlusion_brute
from raytracer_tpu_torch.ops.light_select import select_lights
from raytracer_tpu_torch.ops.math3d import (
    cos_theta,
    cross,
    dot,
    dot_k,
    length,
    local_to_world,
    luminance_rec709,
    make_basis,
    mis_weight_power,
    normalize,
    world_to_local,
)
from raytracer_tpu_torch.ops.quad_traverse import (
    intersect_quad,
    occlusion_quad,
)
from raytracer_tpu_torch.ops.traverse import intersect_bvh, occlusion_bvh
from raytracer_tpu_torch.utils import profiling
from raytracer_tpu_torch.utils.config import RenderConfig


class WavefrontState(NamedTuple):
    """The RayPayload SoA (ray_common.glsl:13-26) + the rgen-local loop
    state, one lane per pixel."""

    origin: torch.Tensor  # f32[N,3]
    direction: torch.Tensor  # f32[N,3]
    color: torch.Tensor  # f32[N,3]
    throughput: torch.Tensor  # f32[N,3]
    seed_rgen: torch.Tensor  # u32 as i64[N] rgen-local stream (jitter/RR)
    seed: torch.Tensor  # u32 as i64[N] payload.seed stream (shading)
    alive: torch.Tensor  # bool[N]
    first_bounce: torch.Tensor  # bool[N]
    is_specular: torch.Tensor  # bool[N]
    prev_brdf_pdf: torch.Tensor  # f32[N]
    prev_hit_pos: torch.Tensor  # f32[N,3]
    p_sample_light: torch.Tensor  # f32[N]
    did_direct: torch.Tensor  # bool[N]
    # Spectral channel lock for dispersion (-1 = broadband).
    channel: torch.Tensor  # i32[N]
    # The lane of the launch this lane serves (its pixel of the tile): the
    # lane sort permutes lanes, and the radiance is scattered back through
    # this index.
    pixel: torch.Tensor  # i32[N]


def _morton9(q):
    """Spread 9-bit ints (i64) so their bits land 3 apart, for a 3-axis
    interleave (raytracer_tpu/integrator/wavefront.py:91)."""
    q = q & 0x1FF
    q = (q | (q << 16)) & 0x030000FF
    q = (q | (q << 8)) & 0x0300F00F
    q = (q | (q << 4)) & 0x030C30C3
    q = (q | (q << 2)) & 0x09249249
    return q


def position_morton(origin, scene):
    """27-bit Morton code (i64[N]) of each origin on a 512^3 grid over the
    scene's bounds, computed in the JAX package's f32 order."""
    extent = torch.clamp_min(scene.scene_max - scene.scene_min, 1e-6)
    q = torch.clamp((origin - scene.scene_min) / extent * 511.0, 0.0,
                    511.0).to(torch.int64)
    return (_morton9(q[:, 0]) | (_morton9(q[:, 1]) << 1)
            | (_morton9(q[:, 2]) << 2))


def _part_affinity(scene, origin, direction, num_bits):
    """The part of a multi-part bake each ray enters first (the smallest
    slab t_near over the part roots' boxes, part_aabb), i64[N] clipped to
    num_bits bits; a ray that misses every part gets the top bucket. The
    JAX `_part_affinity`, in its f32 operation order; the argmin keeps the
    first of equal values, as jnp.argmin."""
    aabb = scene.part_aabb
    inv = 1.0 / torch.where(torch.abs(direction) < 1e-12,
                            torch.where(direction >= 0, 1e-12, -1e-12),
                            direction)
    t0 = (aabb[None, :, 0:3] - origin[:, None, :]) * inv[:, None, :]
    t1 = (aabb[None, :, 3:6] - origin[:, None, :]) * inv[:, None, :]
    tn = torch.clamp_min(torch.minimum(t0, t1), 0.0).amax(dim=2)
    tf = torch.maximum(t0, t1).amin(dim=2)
    tn = torch.where(tn <= tf, tn, torch.inf)  # [N,P]
    top = (1 << num_bits) - 1
    best = torch.clamp(torch.argmin(tn, dim=1), 0, top)
    miss_all = torch.isinf(tn.amin(dim=1))
    return torch.where(miss_all, top, best)


def _sort_wavefront(state: WavefrontState, scene):
    """Sort lanes by (dead last, direction octant, position Morton), with a
    part-affinity prefix below the dead bit on a multi-part bake: the JAX
    `_sort_wavefront`, its keys in i64. Returns (the permuted state, perm
    i64[N]); lane j of the result is lane perm[j] of `state`. The sort is
    stable, as jnp.argsort, so the permutation is the JAX one. Every field
    moves with its lane (`pixel` records where each came from)."""
    morton = position_morton(state.origin, scene)
    d = state.direction
    octant = ((d[:, 0] >= 0).to(torch.int64)
              | ((d[:, 1] >= 0).to(torch.int64) << 1)
              | ((d[:, 2] >= 0).to(torch.int64) << 2))
    dead = (~state.alive).to(torch.int64)
    p = getattr(scene, "num_parts", 1)
    if p > 1 and getattr(scene, "part_aabb", None) is not None:
        # Bit 30 is free; past 2 parts the Morton tail shortens to make
        # room, and p.bit_length() keeps a bucket for rays missing every
        # part.
        pb = max(1, min(3, p.bit_length()))
        aff = _part_affinity(scene, state.origin, state.direction, pb)
        shift = pb - 1
        key = ((dead << 31) | (aff << (31 - pb))
               | (octant << (27 - shift)) | (morton >> shift))
    else:
        key = (dead << 31) | (octant << 27) | morton
    perm = torch.argsort(key, stable=True)
    return WavefrontState(*(field[perm] for field in state)), perm


def _occluded_sorted(scene, origin, direction, t_max, skip_object, cfg,
                     active):
    """`_occluded` on the 4-wide tree's kernels with the shadow rays
    sorted by origin Morton under dead-last (part affinity below the dead
    bit on a multi-part bake), the result scattered back: the JAX
    `_occluded_pallas_sorted`. A pure permutation of the rays, so the mask
    is `_occluded`'s; the renderer does not call it (module docstring)."""
    n = origin.shape[0]
    morton = position_morton(origin, scene)
    dead = (~active).to(torch.int64)
    p = getattr(scene, "num_parts", 1)
    if p > 1 and getattr(scene, "part_aabb", None) is not None:
        pb = max(1, min(4, p.bit_length()))
        aff = _part_affinity(scene, origin, direction, pb)
        key = (dead << 31) | (aff << 27) | morton
    else:
        key = (dead << 31) | morton
    perm = torch.argsort(key, stable=True)
    t_max_b = torch.as_tensor(t_max, dtype=torch.float32,
                              device=origin.device).expand(n)
    # Inactive lanes get t_max = t_min, so the mask need not be permuted.
    t_eff = torch.where(active, t_max_b, cfg.t_min)
    skip = torch.as_tensor(skip_object, device=origin.device).to(
        torch.int32).expand(n)
    occ_s = occlusion_quad(origin[perm], direction[perm], cfg.t_min,
                           t_eff[perm], scene, skip[perm])
    occ = torch.zeros((n,), dtype=torch.bool, device=origin.device)
    occ[perm] = occ_s
    return occ & active


def _camera_rays(inverse_view, inverse_proj, width, height, jitter,
                 pixel_idx):
    """calculateCameraRay (simple.rgen:41-53) for the given pixels.

    jitter: f32[N,2] subpixel offset (including the 0.5 center);
    pixel_idx: i64[N] raster-order pixel indices."""
    dev = jitter.device
    px = (pixel_idx % width).to(torch.float32)
    py = (pixel_idx // width).to(torch.float32)
    n = pixel_idx.shape[0]
    pixel_center = torch.stack([px, py], dim=-1) + jitter
    in_uv = pixel_center / torch.tensor([width, height], dtype=torch.float32,
                                        device=dev)
    d = in_uv * 2.0 - 1.0

    origin = inverse_view[:3, 3].expand(n, 3).contiguous()
    target_h = (
        inverse_proj[:3, 0] * d[:, 0:1]
        + inverse_proj[:3, 1] * d[:, 1:2]
        + inverse_proj[:3, 2]
        + inverse_proj[:3, 3]
    )
    t = normalize(target_h)
    # t @ inverse_view[:3, :3].T, written out: the same rounding on every
    # device.
    direction = (t[:, 0:1] * inverse_view[:3, 0]
                 + t[:, 1:2] * inverse_view[:3, 1]
                 + t[:, 2:3] * inverse_view[:3, 2])
    return origin, normalize(direction)


def _skip_link(scene, cfg: RenderConfig):
    """Whether accel="bvh" traces `scene` with the skip-link walk: its
    binary tree is too deep for K3/K4's stack (api.py logs it)."""
    return cfg.accel == "bvh" and not stack_fits(scene.bvh_max_depth)


def _trace(scene, origin, direction, cfg: RenderConfig, active):
    if cfg.accel == "brute":
        rec = intersect_brute(
            origin, direction, scene.tri_v0, scene.tri_e1, scene.tri_e2,
            cfg.t_min, cfg.t_max,
        )
        return rec._replace(hit=rec.hit & active,
                            tri=torch.where(active, rec.tri, -1))
    if _skip_link(scene, cfg):
        return intersect_bvh(origin, direction, scene, cfg.t_min, cfg.t_max,
                             active_mask=active)
    if cfg.accel == "bvh":
        return intersect_bvh_binary(origin, direction, scene, cfg.t_min,
                                    cfg.t_max, active_mask=active)
    return intersect_quad(origin, direction, scene, cfg.t_min, cfg.t_max,
                          active_mask=active)


def _occluded(scene, origin, direction, t_max, skip_object, cfg, active):
    if cfg.accel == "brute":
        occ = occlusion_brute(
            origin, direction, cfg.t_min, t_max,
            scene.tri_v0, scene.tri_e1, scene.tri_e2, scene.tri_object,
            skip_object,
        )
        return occ & active
    if _skip_link(scene, cfg):
        return occlusion_bvh(origin, direction, cfg.t_min, t_max, scene,
                             skip_object, active_mask=active) & active
    if cfg.accel == "bvh":
        return occlusion_bvh_binary(origin, direction, cfg.t_min, t_max,
                                    scene, skip_object,
                                    active_mask=active) & active
    return occlusion_quad(origin, direction, cfg.t_min, t_max, scene,
                          skip_object, active_mask=active) & active


def _select_lights(scene, cfg: RenderConfig, world_pos, obj, do_nee, seed,
                   light_index):
    """ops/light_select.py over the first min(L, MAX_LIGHTS) lights
    (simple.rchit:507-541): NEE's pick where `do_nee` is given, the
    emissive-MIS total and weight where `light_index` is. The
    `rt.light_select` span (columns)."""
    l_used = min(scene.num_lights, cfg.max_lights)
    with profiling.span("rt.light_select", columns=l_used):
        return select_lights(
            world_pos, scene.light_center[:l_used],
            scene.light_power[:l_used], scene.light_object[:l_used],
            obj=obj, do_nee=do_nee, seed=seed, light_index=light_index)


def _light_weights_base(scene, hit_pos, cfg: RenderConfig):
    """Un-skipped power/dist² weights [N,Lc] over the first min(L,
    MAX_LIGHTS) lights (ReSTIR's candidate CDF)."""
    l_used = min(scene.num_lights, cfg.max_lights)
    centers = scene.light_center[:l_used]
    powers = scene.light_power[:l_used]
    dx = hit_pos[:, 0:1] - centers[None, :, 0]
    dy = hit_pos[:, 1:2] - centers[None, :, 1]
    dz = hit_pos[:, 2:3] - centers[None, :, 2]
    dist_sq = dx * dx + dy * dy + dz * dz
    return powers[None, :] / torch.clamp_min(dist_sq, 0.001)


def _sample_light(scene, sel, hit_pos, seed, active, cfg: RenderConfig):
    """sampleLight (simple.rchit:239-322): pick a uniform triangle of light
    `sel` (i32[N]), area-sample it with sqrt-barycentrics, return the sample
    and its solid-angle pdf. Consumes 3 masked draws."""
    l_used = min(scene.num_lights, cfg.max_lights)
    sel_c = torch.clamp(sel, 0, l_used - 1).long()
    meta = scene.light_meta_packed[sel_c]  # [N,8]
    first = meta[:, 0].to(torch.int32)
    num_tris = meta[:, 1].to(torch.int32)

    r_tri, seed = rng.rnd_masked(seed, active)
    tri_local = torch.minimum(
        (r_tri * num_tris.to(torch.float32)).to(torch.int32), num_tris - 1)
    ti = torch.clamp(first + tri_local, 0,
                     scene.light_tri_packed.shape[0] - 1).long()
    trow = scene.light_tri_packed[ti]  # [N,16]
    v0 = trow[:, 0:3]
    e1 = trow[:, 3:6]
    e2 = trow[:, 6:9]

    r1, seed = rng.rnd_masked(seed, active)
    r2, seed = rng.rnd_masked(seed, active)
    sqrt_r1 = torch.sqrt(r1)
    bu = 1.0 - sqrt_r1
    bv = sqrt_r1 * (1.0 - r2)
    bw = sqrt_r1 * r2
    pos = bu[:, None] * v0 + bv[:, None] * (v0 + e1) + bw[:, None] * (v0 + e2)

    face_n = cross(e1, e2)
    normal = normalize(face_n)
    to_surface = normalize(hit_pos - pos)
    cos_l = dot(normal, to_surface)
    normal = torch.where((cos_l < 0.0)[:, None], -normal, normal)
    cos_l = torch.abs(cos_l)

    to_light = pos - hit_pos
    dist = torch.clamp_min(length(to_light), 0.01)
    direction = to_light / dist[:, None]
    area = 0.5 * length(face_n)
    cos_theta_l = torch.clamp_min(dot(-direction, normal), 0.0)

    valid = (cos_l > 0.0) & (cos_theta_l > 1e-6) & (num_tris > 0)
    pdf = (
        (1.0 / torch.clamp_min(num_tris.to(torch.float32), 1.0))
        * (1.0 / torch.clamp_min(area, 1e-20))
        * dist * dist / torch.clamp_min(cos_theta_l, 1e-20)
    )
    emission = meta[:, 2:5]
    light_obj = meta[:, 5].to(torch.int32)
    return pos, normal, direction, dist, pdf, emission, light_obj, valid, seed


class SurfaceHit(NamedTuple):
    """Interpolated hit surface + material fetch (simple.rchit:590-614)."""

    world_pos: torch.Tensor  # f32[N,3]
    world_nrm: torch.Tensor  # f32[N,3] face-forward flipped
    front_facing: torch.Tensor  # bool[N]
    tri: torch.Tensor  # i64[N] clipped triangle index
    e1: torch.Tensor  # f32[N,3] (for the emissive-hit area pdf)
    e2: torch.Tensor  # f32[N,3]
    obj: torch.Tensor  # i32[N]
    mat: torch.Tensor  # i32[N]
    albedo: torch.Tensor  # f32[N,3]
    roughness: torch.Tensor  # f32[N]
    metallic: torch.Tensor  # f32[N]
    emission_color: torch.Tensor  # f32[N,3]
    emission_power: torch.Tensor  # f32[N]
    transmission: torch.Tensor  # f32[N]
    ior: torch.Tensor  # f32[N]
    dispersion: torch.Tensor  # f32[N]
    light_index: torch.Tensor  # i32[N] owning object's light (-1 if none)
    light_num_tris: torch.Tensor  # f32[N] that light's triangle count


def fetch_surface(scene, hit, ray_dir, lane) -> SurfaceHit:
    """Barycentric interpolation of the hit triangle + material lookup:
    one tri_shade row and one mat_packed row per lane (the `rt.fetch_surface`
    span)."""
    with profiling.span("rt.fetch_surface"):
        t_count = scene.tri_shade.shape[0]
        ti = torch.clamp(hit.tri, 0, t_count - 1).long()
        row = scene.tri_shade[ti]  # [N,24]
        v0 = row[:, 0:3]
        e1 = row[:, 3:6]
        e2 = row[:, 6:9]
        bary_u = hit.u[:, None]
        bary_v = hit.v[:, None]
        world_pos = v0 + bary_u * e1 + bary_v * e2
        bw = 1.0 - bary_u - bary_v
        n_interp = (
            bw * row[:, 9:12] + bary_u * row[:, 12:15] + bary_v * row[:, 15:18]
        )
        world_nrm = normalize(n_interp)
        front_facing = dot(world_nrm, -ray_dir) > 0.0
        world_nrm = torch.where(front_facing[:, None], world_nrm, -world_nrm)
        obj = torch.where(lane, row[:, 18].to(torch.int32), 0)
        mat = torch.where(lane, row[:, 19].to(torch.int32), 0)
        mrow = scene.mat_packed[mat.long()]  # [N,16]
        return SurfaceHit(
            world_pos=world_pos,
            world_nrm=world_nrm,
            front_facing=front_facing,
            tri=ti,
            e1=e1,
            e2=e2,
            obj=obj,
            mat=mat,
            albedo=mrow[:, 0:3],
            roughness=mrow[:, 7],
            metallic=mrow[:, 8],
            emission_color=mrow[:, 3:6],
            emission_power=mrow[:, 6],
            transmission=mrow[:, 9],
            ior=mrow[:, 10],
            dispersion=mrow[:, 11],
            light_index=row[:, 20].to(torch.int32),
            light_num_tris=row[:, 21],
        )


def _shade(scene, state: WavefrontState, hit, cfg: RenderConfig,
           suppress_nee: bool = False):
    """The simple.rchit port. Lanes where `state.alive & hit.hit` shade;
    every other lane is left as it was.

    `suppress_nee=True` skips the NEE lottery and its draws and marks the
    shaded surface lanes did_direct, so the next bounce's emissive-hit MIS
    stays off: ReSTIR (integrator/restir.py) supplies the direct light at
    this vertex.

    The call is the `rt.shade` span, with `rt.fetch_surface`,
    `rt.light_select` (ops/light_select.py: NEE's pick and its selection
    pdf, and the emissive-MIS total and weight, in one launch) and, where
    the scene has a transmissive material, `rt.dielectric` (lanes) under
    it. Counters: `shade.lanes`, the lanes that shade, and
    `_sample_dielectric`'s.

    Returns (new_state, payload_hit bool[N], shadow_ray_count i64[])."""
    with profiling.span("rt.shade", suppress_nee=suppress_nee):
        lane = state.alive & hit.hit
        n = state.origin.shape[0]
        dev = state.origin.device
        no_lanes = torch.zeros(n, dtype=torch.bool, device=dev)
        zero_count = torch.zeros((), dtype=torch.int64, device=dev)

        surf = fetch_surface(scene, hit, state.direction, lane)
        world_pos = surf.world_pos
        world_nrm = surf.world_nrm
        ray_dir = state.direction
        albedo = surf.albedo
        roughness = surf.roughness
        metallic = surf.metallic
        emission_color = surf.emission_color
        emission_power = surf.emission_power
        is_emissive = emission_power > 0.0

        color = state.color
        throughput = state.throughput
        seed = state.seed

        basis = make_basis(world_nrm)
        wo_local = world_to_local(-ray_dir, basis)

        # --- dielectric lanes (extension; see module docstring) ---
        transmits = cfg.enable_transmission and scene.transmissive
        if transmits:
            dielectric = lane & (surf.transmission > 0.0)
        else:
            dielectric = no_lanes
        surface_lane = lane & ~dielectric
        if profiling.counting():
            profiling.count("shade.lanes", lane.sum())

        # --- NEE with MIS (simple.rchit:618-632) ---
        did_direct = no_lanes
        p_sample_light = torch.clamp(roughness, 0.1, 0.9)
        mis_nee = cfg.use_mis and not cfg.use_light_sampling_only
        lit = cfg.use_direct_lighting and scene.num_lights > 0
        draw = lit and not suppress_nee
        do_nee = None
        if draw:
            if mis_nee:
                # Stochastic NEE lottery (simple.rchit:621-623).
                p_draw, seed = rng.rnd_masked(seed, surface_lane)
                do_nee = surface_lane & (p_draw < p_sample_light)
            else:
                # USE_MIS=0 (simple.rchit:628-631): NEE every bounce, weight 1.
                do_nee = surface_lane
        if lit and (draw or mis_nee):
            # One pass a lane over the lights, shared by the NEE pick and
            # the emissive-MIS selection pdf below.
            sel = _select_lights(scene, cfg, world_pos, surf.obj, do_nee,
                                 seed, surf.light_index if mis_nee else None)
        if suppress_nee:
            did_direct = surface_lane
            shadow_rays = zero_count
        elif draw:
            seed = sel.seed
            m_samp = sel.found
            (l_pos, _l_nrm, l_dir, _l_dist, l_pdf, l_emission, light_obj,
             l_valid, seed
             ) = _sample_light(scene, sel.selected, world_pos, seed, m_samp,
                               cfg)

            wi_local = world_to_local(l_dir, basis)
            consider = m_samp & l_valid & (cos_theta(wi_local) > 1e-4)

            # Shadow ray (isVisibleRQ, simple.rchit:350-385).
            eps = 0.001
            to_light_n = normalize(l_pos - world_pos)
            offset_from = world_pos + world_nrm * (
                eps * torch.sign(dot_k(world_nrm, to_light_n))
            )
            sr = l_pos - offset_from
            sr_dist = length(sr)
            sr_dir = sr / torch.clamp_min(sr_dist, 1e-20)[:, None]
            shadow_lane = consider & (sr_dist > 0.0)
            occ = _occluded(scene, offset_from, sr_dir, sr_dist * 0.999,
                            light_obj, cfg, shadow_lane)
            visible = shadow_lane & ~occ

            brdf_val = brdf.evaluate_full(wo_local, wi_local, albedo,
                                          roughness, metallic)
            light_pdf = l_pdf * sel.pdf
            p_spec = brdf.specular_probability(albedo, roughness, metallic)
            h_local = normalize(wo_local + wi_local)
            spec_pdf = brdf.microfacet_pdf(wo_local, h_local, roughness)
            diff_pdf = cos_theta(wi_local) / brdf.M_PI
            brdf_pdf = p_spec * spec_pdf + (1.0 - p_spec) * diff_pdf
            if mis_nee:
                weight = mis_weight_power(light_pdf, brdf_pdf)
            else:
                weight = torch.ones_like(light_pdf)  # evaluateLightMIS else

            radiance = (
                brdf_val * l_emission
                * (cos_theta(wi_local) * weight
                   / torch.clamp_min(light_pdf, 1e-6))[:, None]
            )
            if mis_nee:
                # Stochastic-NEE unbiasing divide (simple.rchit:625).
                contrib = throughput * radiance / p_sample_light[:, None]
            else:
                contrib = throughput * radiance
            color = torch.where(visible[:, None], color + contrib, color)
            did_direct = do_nee
            shadow_rays = shadow_lane.sum()
            count_rays(n, shadow_rays)
        elif cfg.use_direct_lighting and mis_nee:
            # No lights: the NEE lottery draw still happens (simple.rchit:622).
            _, seed = rng.rnd_masked(seed, surface_lane)
            shadow_rays = zero_count
        else:
            shadow_rays = zero_count

        # --- BSDF sampling (simple.rchit:634-639 -> sampleBRDF) ---
        sample, seed_after_brdf = brdf.sample_brdf(
            wo_local, albedo, roughness, metallic, seed)
        # Only surface lanes consume its 3 draws; dielectric lanes draw below.
        seed_surface = torch.where(surface_lane, seed_after_brdf, seed)

        # --- emissive-hit handling (simple.rchit:641-686) ---
        if cfg.use_direct_lighting and mis_nee:
            add_full = surface_lane & is_emissive & (
                state.first_bounce | state.is_specular)
            color = torch.where(
                add_full[:, None],
                color + throughput * emission_color * emission_power[:, None],
                color,
            )
            if scene.num_lights > 0:
                light_idx = surf.light_index
                add_mis = (
                    surface_lane & is_emissive
                    & ~(state.first_bounce | state.is_specular)
                    & ~state.did_direct & (light_idx >= 0)
                )
                d = length(world_pos - state.prev_hit_pos)
                cos_light = torch.clamp_min(dot(world_nrm, -ray_dir), 0.0)
                tri_area = 0.5 * length(cross(surf.e1, surf.e2))
                num_tris_l = surf.light_num_tris
                pdf_geo = (
                    (1.0 / torch.clamp_min(num_tris_l, 1.0))
                    * (1.0 / torch.clamp_min(tri_area, 1e-20))
                    * d * d / torch.clamp_min(cos_light, 1e-20)
                )
                # computeLightSelectionPdf uses the un-skipped total
                # (simple.rchit:536-541).
                light_sel = torch.where(
                    sel.total_all > 0.0,
                    sel.w_this / torch.clamp_min(sel.total_all, 1e-20), 0.0)
                light_pdf_hit = light_sel * pdf_geo
                mis_w = mis_weight_power(state.prev_brdf_pdf, light_pdf_hit)
                contrib = (
                    throughput * emission_color
                    * (emission_power * mis_w
                       / torch.clamp_min(1.0 - state.p_sample_light, 1e-20)
                       )[:, None]
                )
                color = torch.where(add_mis[:, None], color + contrib, color)
        else:
            add_full = surface_lane & is_emissive
            if cfg.use_direct_lighting:  # USE_MIS=0 branch (simple.rchit:679)
                add_full = add_full & (state.first_bounce | state.is_specular)
            color = torch.where(
                add_full[:, None],
                color + throughput * emission_color * emission_power[:, None],
                color,
            )

        # --- bounce update (simple.rchit:693-703) ---
        sample_ok = (sample.pdf > 0.0) & (cos_theta(sample.direction) > 0.0)
        new_dir_surface = local_to_world(sample.direction, basis)
        tp_scale = ((cos_theta(sample.direction) / sample.pdf)[:, None]
                    * sample.value)

        # --- dielectric transmission lanes (extension) ---
        if transmits:
            with profiling.span("rt.dielectric", lanes=n):
                (diel_dir, diel_tp, diel_ok, new_channel, seed_diel) = (
                    _sample_dielectric(
                        ray_dir, world_nrm, surf.front_facing, albedo,
                        surf.ior, surf.transmission, surf.dispersion,
                        state.channel, seed, dielectric,
                    )
                )
                seed = torch.where(dielectric, seed_diel, seed_surface)
                new_dir = torch.where(dielectric[:, None], diel_dir,
                                      new_dir_surface)
                tp_mult = torch.where(dielectric[:, None], diel_tp, tp_scale)
                sample_ok = torch.where(dielectric, diel_ok, sample_ok)
                new_specular = dielectric | sample.is_specular
                new_pdf = torch.where(dielectric, 1.0, sample.pdf)
                channel = torch.where(dielectric, new_channel, state.channel)
        else:
            seed = seed_surface
            new_dir = new_dir_surface
            tp_mult = tp_scale
            new_specular = sample.is_specular
            new_pdf = sample.pdf
            channel = state.channel

        upd = lane & sample_ok
        throughput = torch.where(upd[:, None], throughput * tp_mult,
                                 throughput)

        new_state = WavefrontState(
            origin=torch.where(upd[:, None], world_pos, state.origin),
            direction=torch.where(upd[:, None], new_dir, state.direction),
            color=torch.where(lane[:, None], color, state.color),
            throughput=throughput,
            seed_rgen=state.seed_rgen,
            seed=torch.where(lane, seed, state.seed),
            alive=state.alive,
            first_bounce=state.first_bounce & ~lane,
            is_specular=torch.where(upd, new_specular, state.is_specular),
            prev_brdf_pdf=torch.where(upd, new_pdf, state.prev_brdf_pdf),
            prev_hit_pos=torch.where(upd[:, None], world_pos,
                                     state.prev_hit_pos),
            p_sample_light=torch.where(lane, p_sample_light,
                                       state.p_sample_light),
            did_direct=torch.where(lane, did_direct, state.did_direct),
            channel=channel,
            pixel=state.pixel,
        )
        payload_hit = lane & sample_ok
        return new_state, payload_hit, shadow_rays


def _sample_dielectric(ray_dir, normal, front_facing, albedo, ior,
                       transmission, dispersion, channel, seed, active):
    """Smooth dielectric BSDF (reflection/refraction), extension lanes only.

    Consumes 2 masked draws (transmit lottery + Fresnel lottery) plus one
    masked draw on the first dispersive event (the spectral channel pick).
    Dispersion (KHR_materials_dispersion, D = 20/Abbe): nF - nC =
    (ior - 1) * D / 20; R/G/B use ior + {-1/2, 0, +1/2} of that spread. The
    first dispersive refraction locks the path to one channel (prob 1/3
    each, throughput x3 in that channel).

    Counters, of the `active` lanes: `dielectric.lanes`, all of them;
    `dielectric.refracted`, those that took the transmission lobe;
    `dielectric.tir`, those at total internal reflection; and
    `dielectric.locked`, those whose channel the dispersion locked here."""
    is_dispersive = dispersion > 0.0
    need_channel = active & is_dispersive & (channel < 0)
    r_chan, seed = rng.rnd_masked(seed, need_channel)
    picked = torch.clamp_max((r_chan * 3.0).to(torch.int32), 2)
    channel = torch.where(need_channel, picked, channel)

    spread = (ior - 1.0) * dispersion / 20.0
    # R (nC, long wavelength) < G (nd) < B (nF, short wavelength).
    chan_offset = torch.where(channel == 0, -0.5,
                              torch.where(channel == 2, 0.5, 0.0))
    ior_eff = torch.where(is_dispersive & (channel >= 0),
                          ior + chan_offset * spread, ior)

    r_lottery, seed = rng.rnd_masked(seed, active)
    r_fresnel, seed = rng.rnd_masked(seed, active)

    ior = ior_eff
    eta = torch.where(front_facing, 1.0 / ior, ior)
    cos_i = torch.clamp(dot(-ray_dir, normal), 0.0, 1.0)
    sin2_t = eta * eta * torch.clamp_min(1.0 - cos_i * cos_i, 0.0)
    tir = sin2_t > 1.0
    cos_t = torch.sqrt(torch.clamp_min(1.0 - sin2_t, 0.0))

    f0 = ((ior - 1.0) / (ior + 1.0)) ** 2
    fresnel = f0 + (1.0 - f0) * torch.pow(1.0 - cos_i, 5.0)
    fresnel = torch.where(tir, 1.0, fresnel)

    refl_dir = normalize(ray_dir + 2.0 * cos_i[:, None] * normal)
    refr_dir = normalize(
        eta[:, None] * ray_dir + (eta * cos_i - cos_t)[:, None] * normal)

    take_transmit = r_lottery < transmission
    reflect_lobe = ~take_transmit | (r_fresnel < fresnel)
    new_dir = torch.where(reflect_lobe[:, None], refl_dir, refr_dir)
    # Reflection off the dielectric is untinted; transmission is tinted by
    # albedo (absorption proxy).
    tp = torch.where(reflect_lobe[:, None], torch.ones_like(albedo), albedo)
    chan_onehot = (
        torch.arange(3, device=channel.device)[None, :] == channel[:, None]
    ).to(torch.float32) * 3.0
    tp = torch.where(need_channel[:, None], tp * chan_onehot, tp)
    ok = torch.ones_like(take_transmit)
    if profiling.counting():
        profiling.count("dielectric.lanes", active.sum())
        profiling.count("dielectric.refracted", (active & ~reflect_lobe).sum())
        profiling.count("dielectric.tir", (active & tir).sum())
        profiling.count("dielectric.locked", need_channel.sum())
    return new_dir, tp, ok, channel, seed


_M32 = 0xFFFFFFFF


def _lane_frames(frame_number, n, dev):
    """The frame of each of `n` lanes as i64[n] in [0, 2^32) on `dev`
    (ops/rng.py's uint32 convention), from an int or a per-lane tensor.
    An int is filled on the device, not copied there, so no step waits on
    a host-to-device copy."""
    if torch.is_tensor(frame_number):
        frame = frame_number.to(device=dev, dtype=torch.int64).expand(n)
    else:
        frame = torch.full((n,), int(frame_number), dtype=torch.int64,
                           device=dev)
    return frame & _M32


def render_wavefront(scene, camera_ubo, frame_number, cfg: RenderConfig,
                     pixel_start=0, num_pixels=None, with_stats: bool = False,
                     active=None, pixel_indices=None):
    """One progressive sample of a set of pixels: radiance f32[N,3] (and,
    when with_stats=True, a dict of i64[] ray counts on the device: alive
    rays traced per bounce, shadow rays, their total). The body of
    simple.rgen:70-125 (everything but accumulation).

    The lanes are every pixel by default, the contiguous tile
    [pixel_start, pixel_start + num_pixels) of a multi-device render
    (parallel/sharding.py), or `pixel_indices` (i64[N] global pixel ids: a
    range, strided or repeated; it overrides the tile). Seeds and camera
    rays use the global ids, so each lane's radiance is bit-identical to the
    same (pixel, frame) lane of any other launch shape. `frame_number` is an int
    or a per-lane tensor [N] (adaptive sampling: each pixel at its own
    count; spp batching: repeated ids at successive frames). `active`
    (bool[N]) masks lanes out of the whole sample: they trace nothing and
    their radiance is not a sample, so the caller must not accumulate it.

    Under deep compaction each read of the live count is an `rt.sync` span
    (site `compact`, the bounce's depth, its prefix, the live count and the
    lanes it runs on), and each bounce whose live lanes no prefix of the
    schedule holds, so that it runs full size, adds 1 to the counter
    `compact.full_size`."""
    cfg = cfg.resolve_accel()
    if pixel_indices is None and (pixel_start or num_pixels is not None):
        pixel_indices = tile_pixels(cfg, pixel_start, num_pixels,
                                    scene.device)
    state = start_wavefront(scene, camera_ubo, frame_number, cfg,
                            active=active, pixel_indices=pixel_indices)
    clear_color = torch.tensor(cfg.background, dtype=torch.float32,
                               device=scene.device)
    rays_traced = torch.zeros((), dtype=torch.int64, device=scene.device)
    shadow_total = torch.zeros((), dtype=torch.int64, device=scene.device)
    deep = deep_compacts(cfg)
    n = state.alive.shape[0]
    for depth in range(cfg.max_depth):
        k = None
        if deep:
            if depth > 0 or active is not None:
                state, _ = _sort_wavefront(state, scene)
            k = _compact_prefix(n, depth, cfg)
            if k is not None:
                with profiling.span("rt.sync", site="compact", depth=depth,
                                    prefix=k) as attrs:
                    live = int(state.alive.sum())
                    k = _compact_prefix(n, depth, cfg, live)
                    if attrs is not None:
                        attrs.update(live=live, lanes=n if k is None else k)
                if k is None:
                    profiling.count("compact.full_size", 1)
        if k is None:
            state, rays, shadow_rays = path_bounce(scene, state, depth, cfg,
                                                   clear_color)
        else:
            sub, rays, shadow_rays = path_bounce(
                scene, WavefrontState(*(f[:k] for f in state)), depth, cfg,
                clear_color)
            state = WavefrontState(*(torch.cat([a, f[k:]])
                                     for a, f in zip(sub, state)))
        rays_traced = rays_traced + rays
        shadow_total = shadow_total + shadow_rays
    radiance = final_radiance(state, cfg)
    if deep:
        # Undo the sort: each lane's radiance back to its lane.
        radiance = torch.zeros_like(radiance).index_copy_(
            0, state.pixel.long(), radiance)
    if with_stats:
        return radiance, {"rays_traced": rays_traced,
                          "shadow_rays": shadow_total,
                          "total_rays": rays_traced + shadow_total}
    return radiance


def deep_compacts(cfg: RenderConfig) -> bool:
    """Whether render_wavefront runs cfg's bounces with deep compaction
    (module docstring): the JAX package's condition, with "cuda" for
    "pallas"."""
    cfg = cfg.resolve_accel()
    return (cfg.accel == "cuda" and cfg.compact_deep
            and cfg.max_depth > cfg.rr_start_depth + 1)


def _compact_prefix(n, depth, cfg: RenderConfig, live: int = 0):
    """The lane prefix of the bounce at `depth` under deep compaction (None:
    full size), the JAX `_compact_prefix`: n x compact_decay per bounce past
    the Russian-roulette onset, rounded up to 1024 lanes. Where more than
    `live` lanes are alive than that holds, the prefix of the latest earlier
    bounce of the schedule that holds them, and full size only where none
    does; JAX runs such a bounce full size."""
    for d in range(depth, cfg.rr_start_depth, -1):
        frac = cfg.compact_decay ** (d - cfg.rr_start_depth)
        k = max(1024, -(-int(n * frac) // 1024) * 1024)
        if k >= n:
            return None
        if live <= k:
            return k
    return None


def tile_pixels(cfg: RenderConfig, pixel_start, num_pixels, device):
    """The global pixel ids i64[n] of the tile [pixel_start, pixel_start +
    n), n = num_pixels (default: the rest of cfg's image)."""
    start = int(pixel_start)
    n = cfg.num_pixels - start if num_pixels is None else int(num_pixels)
    return torch.arange(start, start + n, dtype=torch.int64, device=device)


def start_wavefront(scene, camera_ubo, frame_number, cfg: RenderConfig,
                    active=None, pixel_indices=None) -> WavefrontState:
    """The camera rays and the seeded streams of render_wavefront's lanes
    (its arguments): the state before the first bounce."""
    dev = scene.device
    if pixel_indices is not None:
        pixel_idx = torch.as_tensor(pixel_indices, device=dev).to(torch.int64)
    else:
        pixel_idx = torch.arange(cfg.num_pixels, dtype=torch.int64,
                                 device=dev)
    n = pixel_idx.shape[0]
    frame = _lane_frames(frame_number, n, dev)
    seed0 = rng.seed_pixels(pixel_idx, frame)

    # Jitter (getSampleOffset, simple.rgen:25-38): centered on frame 0,
    # else 0.4-amplitude, per lane. Two masked draws keep stream alignment.
    jitter_mask = frame > 0
    r1, seed_rgen = rng.rnd_masked(seed0, jitter_mask)
    r2, seed_rgen = rng.rnd_masked(seed_rgen, jitter_mask)
    jitter = torch.where(
        jitter_mask[:, None],
        0.5 + (torch.stack([r1, r2], dim=-1) - 0.5) * 0.4,
        torch.full((n, 2), 0.5, dtype=torch.float32, device=dev),
    )

    origin, direction = _camera_rays(
        camera_ubo["inverse_view"], camera_ubo["inverse_proj"],
        cfg.width, cfg.height, jitter, pixel_idx,
    )

    # Inactive lanes start dead. The JAX renderer sorts them to the back of
    # the wavefront from depth 0 so that its kernel groups retire in one
    # pop; the port sorts only where deep compaction needs dead lanes last
    # (render_wavefront): the traversal wrappers give a dead lane t_max =
    # t_min, and K1-K4's persistent warps fetch only live rays.
    if active is None:
        alive = torch.ones((n,), dtype=torch.bool, device=dev)
    else:
        alive = torch.as_tensor(active, device=dev).to(torch.bool)
    f32 = dict(dtype=torch.float32, device=dev)
    return WavefrontState(
        origin=origin,
        direction=direction,
        color=torch.zeros((n, 3), **f32),
        throughput=torch.ones((n, 3), **f32),
        seed_rgen=seed_rgen,
        seed=seed_rgen,
        alive=alive,
        first_bounce=torch.ones((n,), dtype=torch.bool, device=dev),
        is_specular=torch.zeros((n,), dtype=torch.bool, device=dev),
        prev_brdf_pdf=torch.ones((n,), **f32),
        prev_hit_pos=torch.zeros((n, 3), **f32),
        p_sample_light=torch.zeros((n,), **f32),
        did_direct=torch.zeros((n,), dtype=torch.bool, device=dev),
        channel=torch.full((n,), -1, dtype=torch.int32, device=dev),
        pixel=torch.arange(n, dtype=torch.int32, device=dev),
    )


def path_bounce(scene, state: WavefrontState, depth: int, cfg: RenderConfig,
                clear_color):
    """One bounce of simple.rgen's loop: Russian roulette, the closest-hit
    trace, `_shade`, then `end_bounce`; the `rt.bounce` span. Returns
    (state, rays traced, shadow rays), the counts as i64[] device
    tensors."""
    n = state.alive.shape[0]
    with profiling.span("rt.bounce", depth=depth, lanes=n):
        # Russian roulette (simple.rgen:55-68,88-90).
        if depth >= cfg.rr_start_depth:
            rr_lane = state.alive
            lum = luminance_rec709(state.throughput)
            p = torch.clamp(lum, 0.05, 0.95)
            r, seed_rgen = rng.rnd_masked(state.seed_rgen, rr_lane)
            rr_kill = rr_lane & (r > p)
            throughput = torch.where(
                (rr_lane & ~rr_kill)[:, None],
                state.throughput / p[:, None], state.throughput)
            state = state._replace(seed_rgen=seed_rgen,
                                   throughput=throughput,
                                   alive=state.alive & ~rr_kill)

        rays = state.alive.sum()
        count_rays(n, rays)
        hit = _trace(scene, state.origin, state.direction, cfg, state.alive)
        state, payload_hit, shadow_rays = _shade(scene, state, hit, cfg)
        return end_bounce(state, payload_hit, clear_color), rays, shadow_rays


def count_rays(lanes: int, live):
    """The traversal counters of one launch: `trace.lanes`, its lanes, and
    `trace.live`, the live ones among them (an i64[] count the caller
    already has for its ray statistics, so no kernel is added)."""
    profiling.count("trace.lanes", lanes)
    profiling.count("trace.live", live)


def end_bounce(state: WavefrontState, payload_hit, clear_color):
    """The miss branch (simple.rgen:106-109), including the failed-BSDF-
    sample quirk (payload.hit=false from rchit), then the throughput
    validity kill (simple.rgen:115-118)."""
    missed = state.alive & ~payload_hit
    state = state._replace(
        color=torch.where(missed[:, None],
                          state.color + state.throughput * clear_color,
                          state.color),
        alive=state.alive & payload_hit,
    )
    tp = state.throughput
    bad = ((torch.isnan(tp) | torch.isinf(tp)).any(dim=-1)
           | (tp < 0.001).all(dim=-1))
    return state._replace(alive=state.alive & ~bad)


def final_radiance(state: WavefrontState, cfg: RenderConfig):
    """Clamp + NaN scrub (simple.rgen:121-125)."""
    final = torch.clamp_max(state.color, cfg.radiance_clamp)
    invalid = (torch.isnan(final) | torch.isinf(final)).any(dim=-1)
    return torch.where(invalid[:, None], 0.0, final)


def accumulate(accum, radiance, frame_number):
    """The progressive running mean (simple.rgen:127-136): frame 0 stores,
    later frames blend with weight 1/(frame+1), computed in f32.

    `frame_number` is an int or a per-pixel frame tensor [N] (adaptive
    sampling: each pixel blends at its own count)."""
    frame = _lane_frames(frame_number, radiance.shape[0], radiance.device)
    a = 1.0 / (frame.to(torch.float32) + 1.0)
    blended = accum + (radiance - accum) * a[:, None]
    return torch.where((frame == 0)[:, None], radiance, blended)


def render_tile_spp_batched(scene, camera_ubo, accum, frame_number: int,
                            cfg: RenderConfig, pixel_start=0, n_local=None,
                            with_stats: bool = False):
    """cfg.spp_batch progressive samples of a contiguous pixel tile
    [pixel_start, pixel_start + n_local) (default: every pixel) in one
    wavefront: the tile's global pixel ids repeated S times with the
    per-lane frames frame_number + [0..S), folded into the tile's
    accumulation in order by the sequential formula (`accumulate`). Each
    lane's radiance is that of the same (pixel, frame) lane of a 1-spp
    launch, so the result equals S sequential steps. Returns the new
    accumulation (and, with with_stats=True, the launch's ray counts)."""
    s_count = cfg.spp_batch
    dev = scene.device
    frame = int(frame_number)
    pix = tile_pixels(cfg, pixel_start, n_local, dev)
    n = pix.shape[0]
    frames = frame + torch.arange(
        s_count, dtype=torch.int64, device=dev).repeat_interleave(n)
    out = render_wavefront(scene, camera_ubo, frames, cfg,
                           pixel_indices=pix.repeat(s_count),
                           with_stats=with_stats)
    radiance = (out[0] if with_stats else out).reshape(s_count, n, 3)
    for s in range(s_count):
        accum = accumulate(accum, radiance[s], frame + s)
    return (accum, out[1]) if with_stats else accum


def render_frame(scene, camera_ubo, accum, frame_number: int,
                 cfg: RenderConfig, with_stats: bool = False):
    """One progressive step: returns the new accumulation f32[N,3] (and
    render_wavefront's ray counts when with_stats=True). With
    cfg.spp_batch = S > 1 the step renders S samples in one launch and
    advances the accumulation by S counts."""
    if cfg.spp_batch > 1:
        return render_tile_spp_batched(scene, camera_ubo, accum,
                                       frame_number, cfg,
                                       with_stats=with_stats)
    if with_stats:
        radiance, stats = render_wavefront(scene, camera_ubo, frame_number,
                                           cfg, with_stats=True)
        return accumulate(accum, radiance, frame_number), stats
    radiance = render_wavefront(scene, camera_ubo, frame_number, cfg)
    return accumulate(accum, radiance, frame_number)
