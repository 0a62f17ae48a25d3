"""ReSTIR DI: reservoir-based direct-light resampling (port of
raytracer_tpu/integrator/restir.py).

Bitterli et al. 2020, "Spatiotemporal reservoir resampling for real-time
ray tracing with dynamic direct lighting", on the RTXDI reservoir layout:
a structure of arrays over pixels with weight_sum, target_pdf (p-hat of
the kept sample), M (candidates seen), light_index (the global light-
triangle id, -1 invalid), uv (the point on it), distance and W.

Per frame, every step a masked lockstep update over the pixel wavefront:
  1. G-buffer: the primary trace and surface fetch (restir.rgen).
  2. Initial candidates: RIS over `restir_initial_candidates` area-light
     samples; p-hat = luminance of the unshadowed contribution.
  3. Visibility (restir_initial_visibility, default on): one shadow ray for
     the survivor; an occluded one loses its payload, not only W.
  4. Temporal reuse: merge the previous frame's reservoir at the same
     pixel, M clamped to `restir_max_m` (the camera is static while the
     accumulation lasts; a move resets both).
  5. Spatial reuse: `restir_spatial_neighbors` random taps within
     `restir_spatial_radius` pixels, every tap reading a snapshot of the
     post-temporal buffer, the neighbour's M clamped; with
     restir_unbiased_spatial the Alg.-6 Z-count replaces the M-sum.
  6. Shade: the final sample's unshadowed radiance times W behind one more
     shadow ray; with restir_final_visibility_feedback that ray's verdict
     also invalidates the reservoir handed to the next frame. Indirect
     bounces follow as in render_wavefront, with NEE suppressed at the
     primary vertex only.

Both bias fixes stay off by default, as in the JAX package
(utils/config.py). The draws come from a stream of their own, seeded
tea(pixel, frame ^ 0x9E3779B9), so the path tracer's streams are untouched.

The reservoir passes are plain torch: in the JAX package they are
elementwise ops and gathers outside any Pallas kernel. The rays go through
the renderer's traversal kernels (K1/K2, or K3/K4 under accel="bvh").

On a multi-device render (parallel/sharding.py) each rank runs these
steps on its contiguous pixel tile, its lanes seeded by their global pixel
ids, and step 5's taps that cross the tile's edge read halo rows that
`_exchange_halo` brings from the previous and the next rank, once a frame.
The indirect bounces run unsorted (the JAX package sorts them before each
bounce; integrator/wavefront.py says why the port does not), so lane i is
the tile's pixel i and no scatter back is needed; both are image-neutral.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from raytracer_tpu_torch.integrator import wavefront as wf
from raytracer_tpu_torch.ops import brdf, rng
from raytracer_tpu_torch.ops.math3d import (
    cos_theta,
    cross,
    dot,
    dot_k,
    length,
    luminance_rec601,
    make_basis,
    normalize,
    world_to_local,
)
from raytracer_tpu_torch.utils import profiling
from raytracer_tpu_torch.utils.config import RenderConfig

_RESTIR_STREAM = 0x9E3779B9


class Reservoir(NamedTuple):
    """RTXDI_DIReservoir SoA (restir_structs.glsl:1-11)."""

    weight_sum: torch.Tensor  # f32[N]
    target_pdf: torch.Tensor  # f32[N]
    m: torch.Tensor  # f32[N] (float so temporal clamping is exact)
    light_index: torch.Tensor  # i32[N] (-1 invalid)
    uv: torch.Tensor  # f32[N,2] the sample's (r1, r2) on its triangle
    distance: torch.Tensor  # f32[N]
    w: torch.Tensor  # f32[N] final contribution weight

    @staticmethod
    def empty(n: int, device="cpu") -> "Reservoir":
        """RTXDI_EmptyDIReservoir (restir_structs.glsl:13-23)."""
        f32 = dict(dtype=torch.float32, device=device)
        return Reservoir(
            weight_sum=torch.zeros(n, **f32),
            target_pdf=torch.zeros(n, **f32),
            m=torch.zeros(n, **f32),
            light_index=torch.full((n,), -1, dtype=torch.int32,
                                   device=device),
            uv=torch.zeros((n, 2), **f32),
            distance=torch.zeros(n, **f32),
            w=torch.zeros(n, **f32),
        )


class GBuffer(NamedTuple):
    """The restir.rgen G-buffer images as SoA (restir.rgen:20-28)."""

    position: torch.Tensor  # f32[N,3]
    normal: torch.Tensor  # f32[N,3]
    albedo: torch.Tensor  # f32[N,3]
    roughness: torch.Tensor  # f32[N]
    metallic: torch.Tensor  # f32[N]
    emission: torch.Tensor  # f32[N,3] (color*power)
    hit: torch.Tensor  # bool[N]
    object: torch.Tensor  # i32[N]


def _reservoir_update(res: Reservoir, cand_light, cand_uv, cand_dist,
                      cand_target, cand_weight, r):
    """Streaming RIS update: keep the candidate with probability
    weight / weight_sum."""
    weight_sum = res.weight_sum + cand_weight
    take = (cand_weight > 0.0) & (r * weight_sum <= cand_weight)
    return Reservoir(
        weight_sum=weight_sum,
        target_pdf=torch.where(take, cand_target, res.target_pdf),
        m=res.m + 1.0,
        light_index=torch.where(take, cand_light, res.light_index),
        uv=torch.where(take[:, None], cand_uv, res.uv),
        distance=torch.where(take, cand_dist, res.distance),
        w=res.w,  # finalized later
    )


def _reservoir_merge(res: Reservoir, other: Reservoir, other_target_here, r,
                     valid):
    """Merge `other` (its target pdf re-evaluated at the receiver) into
    `res`; `valid` masks the lanes where `other` contributes."""
    m_other = torch.where(valid, other.m, 0.0)
    w_other = torch.where(valid, other_target_here * other.w * m_other, 0.0)
    weight_sum = res.weight_sum + w_other
    take = (w_other > 0.0) & (r * weight_sum <= w_other)
    return Reservoir(
        weight_sum=weight_sum,
        target_pdf=torch.where(take, other_target_here, res.target_pdf),
        m=res.m + m_other,
        light_index=torch.where(take, other.light_index, res.light_index),
        uv=torch.where(take[:, None], other.uv, res.uv),
        distance=torch.where(take, other.distance, res.distance),
        w=res.w,
    )


def _finalize(res: Reservoir, z=None) -> Reservoir:
    """W = w_sum / (M * p-hat). With `z` (the Alg.-6 Z-count: the M-mass of
    only the participants whose surface could have produced the chosen
    sample) the denominator uses Z instead of M."""
    denom_m = res.m if z is None else z
    w = torch.where(
        (res.target_pdf > 0.0) & (denom_m > 0.0),
        res.weight_sum / torch.clamp_min(denom_m * res.target_pdf, 1e-20),
        0.0,
    )
    return res._replace(w=w)


def _invalidate(res: Reservoir, killed) -> Reservoir:
    """Drop the sample of the `killed` lanes, payload and all: zeroing only
    W would let the next _finalize resurrect it from weight_sum. M stays,
    as the candidate count remains part of the RIS history."""
    return res._replace(
        w=torch.where(killed, 0.0, res.w),
        weight_sum=torch.where(killed, 0.0, res.weight_sum),
        target_pdf=torch.where(killed, 0.0, res.target_pdf),
        light_index=torch.where(killed, -1, res.light_index),
    )


def _sample_light_point(scene, tri_global, r1, r2):
    """Area-sample the global light triangle `tri_global` at the
    barycentric randoms (r1, r2), as sampleLight does (simple.rchit:266-282).
    Returns (pos, face normal (unnormalized), area, num_tris, emission,
    light_idx); one light_tri_packed row per lane."""
    ti = torch.clamp(tri_global, 0,
                     scene.light_tri_packed.shape[0] - 1).long()
    trow = scene.light_tri_packed[ti]  # [N,16]
    v0 = trow[:, 0:3]
    e1 = trow[:, 3:6]
    e2 = trow[:, 6:9]
    light_idx = trow[:, 10].to(torch.int32)
    num_tris = trow[:, 11].to(torch.int32)
    sqrt_r1 = torch.sqrt(r1)
    bu = 1.0 - sqrt_r1
    bv = sqrt_r1 * (1.0 - r2)
    bw = sqrt_r1 * r2
    pos = bu[:, None] * v0 + bv[:, None] * (v0 + e1) + bw[:, None] * (v0 + e2)
    face_n = cross(e1, e2)
    area = 0.5 * length(face_n)
    emission = trow[:, 12:15]
    return pos, face_n, area, num_tris, emission, light_idx


def _target_pdf(scene, gbuf: GBuffer, tri_global, uv):
    """The geometry of the sample (tri_global, uv = (r1, r2)) seen from the
    G-buffer surface: (pos, dist, wi, cos_l, area, num_tris, emission,
    surface basis, light_idx)."""
    pos, face_n, area, num_tris, emission, light_idx = _sample_light_point(
        scene, tri_global, uv[:, 0], uv[:, 1])
    to_light = pos - gbuf.position
    dist = torch.clamp_min(length(to_light), 0.01)
    wi = to_light / dist[:, None]
    n_light = normalize(face_n)
    cos_l = torch.abs(dot(n_light, -wi))
    basis = make_basis(gbuf.normal)
    return pos, dist, wi, cos_l, area, num_tris, emission, basis, light_idx


def _unshadowed_radiance(scene, gbuf: GBuffer, wo_world, tri_global, uv):
    """(radiance f32[N,3], dist, light position, wi, valid) of the sample
    (tri_global, uv): f * Le * cos(theta) * cos_L * area * numTris / dist^2,
    the area-measure contribution whose luminance is the target p-hat."""
    (pos, dist, wi, cos_l, area, num_tris, emission, basis, light_idx
     ) = _target_pdf(scene, gbuf, tri_global, uv)
    wo_local = world_to_local(-wo_world, basis)
    wi_local = world_to_local(wi, basis)
    f = brdf.evaluate_full(wo_local, wi_local, gbuf.albedo, gbuf.roughness,
                           gbuf.metallic)
    cos_surf = torch.clamp_min(cos_theta(wi_local), 0.0)
    geom = cos_surf * cos_l / (dist * dist)
    scale = geom * area * torch.clamp_min(num_tris.to(torch.float32), 1.0)
    radiance = f * emission * scale[:, None]
    valid = ((tri_global >= 0) & (light_idx >= 0) & (cos_l > 1e-6)
             & (cos_surf > 0.0) & gbuf.hit)
    radiance = torch.where(valid[:, None], radiance, 0.0)
    return radiance, dist, pos, wi, valid


def _shadow_ray(scene, gbuf: GBuffer, lpos, wi, light_index):
    """isVisibleRQ's ray from the G-buffer surface to the light point:
    (origin, direction, distance, the light triangle's object to skip)."""
    eps = 0.001
    lt_count = scene.light_tri_packed.shape[0]
    light_obj = scene.light_tri_object[
        torch.clamp(light_index, 0, lt_count - 1).long()]
    offset_from = gbuf.position + gbuf.normal * (
        eps * torch.sign(dot_k(gbuf.normal, wi)))
    sr = lpos - offset_from
    sr_dist = length(sr)
    sr_dir = sr / torch.clamp_min(sr_dist, 1e-20)[:, None]
    return offset_from, sr_dir, sr_dist, light_obj


def _exchange_halo(rows: dict, h: int, group, num_tiles: int) -> dict:
    """Extend each [n_local, ...] tensor of `rows` with `h` boundary rows
    from the previous tile's rank in front and the next one's behind: one
    exchange with each neighbour, every tensor's rows packed into one
    message of bytes. Edge tiles get zero rows on their missing side, which
    read as empty reservoirs and degenerate normals and are masked off by
    the callers' validity gates (the JAX version's ppermute pair)."""
    from raytracer_tpu_torch.parallel.sharding import comm_device

    names = list(rows)
    n = rows[names[0]].shape[0]
    dev = rows[names[0]].device
    parts = [rows[k].reshape(n, -1).contiguous().view(torch.uint8)
             for k in names]
    packed = torch.cat(parts, dim=1)
    comm = comm_device(group, dev)
    from_prev, from_next = (torch.zeros((h, packed.shape[1]),
                                        dtype=torch.uint8, device=comm)
                            for _ in range(2))
    rank = dist.get_rank(group) if num_tiles > 1 else 0
    ops = []
    for peer, send, recv in ((rank - 1, packed[:h], from_prev),
                             (rank + 1, packed[-h:], from_next)):
        if 0 <= peer < num_tiles:
            peer = dist.get_global_rank(group, peer)
            ops += [dist.P2POp(dist.isend, send.to(comm), peer, group),
                    dist.P2POp(dist.irecv, recv, peer, group)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    ext = torch.cat([from_prev.to(dev), packed, from_next.to(dev)])
    out, col = {}, 0
    for k, part in zip(names, parts):
        width = part.shape[1]
        out[k] = ext[:, col:col + width].contiguous().view(
            rows[k].dtype).reshape((n + 2 * h,) + rows[k].shape[1:])
        col += width
    return out


def restir_direct(scene, gbuf: GBuffer, wo_world, prev_reservoir,
                  frame_number, cfg: RenderConfig, occlusion_fn,
                  pixel_start=0, num_tiles: int = 1, group=None,
                  timer=None):
    """ReSTIR DI steps 2-6 over the pixels [pixel_start, pixel_start + N)
    of cfg's image (lane i is pixel pixel_start + i; by default every
    pixel). `occlusion_fn(origin, direction, t_max, skip_object, active)`
    traces the shadow rays. Returns (direct radiance f32[N,3], the
    reservoir for the next frame, shadow rays traced i64[]).

    With `group` (a multi-device render: this rank's tile of `num_tiles`),
    step 5's taps across the tile's edge read the halo rows of the
    neighbouring ranks' tiles, so the tile is bit-identical to the same
    pixels of a single-device pass whenever the halo, min((radius + 1) *
    width, N) rows, covers the tap radius. `timer` (utils/profiling.py
    PhaseTimer) times the exchange as its "halo" phase. The call is the
    `rt.restir_direct` span."""
    with profiling.span("rt.restir_direct"):
        n = gbuf.position.shape[0]
        dev = gbuf.position.device
        l_used = min(scene.num_lights, cfg.max_lights)
        if l_used == 0:
            return (torch.zeros((n, 3), dtype=torch.float32, device=dev),
                    Reservoir.empty(n, dev),
                    torch.zeros((), dtype=torch.int64, device=dev))

        start = int(pixel_start)
        pixel_idx = torch.arange(start, start + n, dtype=torch.int64,
                                 device=dev)
        seed = rng.tea(pixel_idx,
                       wf._lane_frames(frame_number, n, dev) ^ _RESTIR_STREAM)

        # Light-selection weights (power/dist^2, as the path tracer's NEE).
        weights = wf._light_weights_base(scene, gbuf.position, cfg)
        weights = torch.where(
            scene.light_object[None, :l_used] == gbuf.object[:, None], 0.0,
            weights)
        total_w = weights.sum(dim=-1)
        cdf = torch.cumsum(weights, dim=1)

        # --- 2. initial candidates (RIS) ---
        res = Reservoir.empty(n, dev)
        lt_count = scene.light_tri_packed.shape[0]
        for _ in range(cfg.restir_initial_candidates):
            r_sel, seed = rng.rnd(seed)
            r_tri, seed = rng.rnd(seed)
            r1, seed = rng.rnd(seed)
            r2, seed = rng.rnd(seed)
            r_keep, seed = rng.rnd(seed)
            pick = r_sel * total_w
            at_or_past = cdf >= pick[:, None]
            # First column where the CDF reaches the pick (0 when none does).
            light = at_or_past.to(torch.int32).argmax(dim=1).to(torch.int32)
            found = at_or_past.any(dim=1) & (total_w > 0.0)
            sel_c = torch.clamp(light, 0, l_used - 1).long()
            sel_w = weights.gather(1, sel_c[:, None])[:, 0]
            # A uniform triangle of the light -> the global light-triangle id
            # (the sample's identity, with uv the point on it).
            meta = scene.light_meta_packed[sel_c]
            num_tris = meta[:, 1].to(torch.int32)
            tri_local = torch.minimum(
                (r_tri * num_tris.to(torch.float32)).to(torch.int32),
                num_tris - 1)
            tri_global = torch.where(
                found,
                torch.clamp(meta[:, 0].to(torch.int32) + tri_local, 0,
                            lt_count - 1),
                -1).to(torch.int32)
            source_pdf = torch.where(
                found, sel_w / torch.clamp_min(total_w, 1e-20), 0.0)
            uv = torch.stack([r1, r2], dim=-1)
            radiance, dist, _pos, _wi, valid = _unshadowed_radiance(
                scene, gbuf, wo_world, tri_global, uv)
            target = luminance_rec601(radiance)
            # RIS weight = p-hat / p_source (the triangle and area pdfs are
            # folded into the area-measure radiance).
            cand_weight = torch.where(
                valid & (source_pdf > 0.0),
                target / torch.clamp_min(source_pdf, 1e-20), 0.0)
            res = _reservoir_update(res, tri_global, uv, dist, target,
                                    cand_weight, r_keep)
        res = _finalize(res)

        # --- 3. visibility of the survivor (no RNG draws) ---
        shadow_rays = torch.zeros((), dtype=torch.int64, device=dev)
        if cfg.restir_initial_visibility:
            _, _, lpos, wi, valid = _unshadowed_radiance(
                scene, gbuf, wo_world, res.light_index, res.uv)
            origin, sr_dir, sr_dist, light_obj = _shadow_ray(
                scene, gbuf, lpos, wi, res.light_index)
            occ_active = valid & (sr_dist > 0.0)
            occ = occlusion_fn(origin, sr_dir, sr_dist * 0.999, light_obj,
                               occ_active)
            live = occ_active.sum()
            wf.count_rays(n, live)
            shadow_rays = shadow_rays + live
            res = _invalidate(res, occ | ~valid)

        # --- 4. temporal reuse ---
        if prev_reservoir is not None:
            r_t, seed = rng.rnd(seed)
            prev = prev_reservoir._replace(
                m=torch.clamp_max(prev_reservoir.m, float(cfg.restir_max_m)))
            prev_rad, _, _, _, prev_valid = _unshadowed_radiance(
                scene, gbuf, wo_world, prev.light_index, prev.uv)
            res = _reservoir_merge(res, prev, luminance_rec601(prev_rad), r_t,
                                   prev_valid & (prev.w > 0.0))
            res = _finalize(res)

        # --- 5. spatial reuse ---
        # Every tap reads this snapshot of the post-temporal buffer, never the
        # evolving `res`: a tap that read a neighbour which already merged
        # this pixel's sample would feed it back, and temporal reuse would
        # compound that across frames (the JAX module measured the 64-light
        # grid at about twice the right brightness by frame 16).
        width = cfg.width
        src = res
        m_canonical = res.m
        unbiased = (cfg.restir_unbiased_spatial
                    and cfg.restir_spatial_neighbors > 0)
        halo = 0
        if group is not None:
            # A tap moves at most `radius` rows plus a partial row in the
            # flat index, so (radius + 1) * width halo rows cover it;
            # clamping to the tile keeps short tiles legal (taps past the
            # clamped halo are dropped by `reach`, the bias case the
            # renderer warns about). The snapshot is fixed, so one exchange
            # serves every tap.
            halo = min((int(cfg.restir_spatial_radius) + 1) * width, n)
            rows = {"normal": gbuf.normal, "m": src.m, "w": src.w,
                    "light_index": src.light_index, "uv": src.uv,
                    "distance": src.distance}
            if unbiased:
                # The Z-count evaluates the final sample's p-hat at each tap's
                # surface, so the taps' surface attributes ride the same halo.
                rows.update(position=gbuf.position, albedo=gbuf.albedo,
                            roughness=gbuf.roughness, metallic=gbuf.metallic,
                            hit=gbuf.hit, object=gbuf.object, wo=wo_world)
            if timer is None:
                ext = _exchange_halo(rows, halo, group, num_tiles)
            else:
                # The span starts with the rows to send ready.
                with profiling.span("rt.sync", site="halo"):
                    profiling.sync(gbuf.normal)
                done = []
                with timer.phase("halo", done):
                    ext = _exchange_halo(rows, halo, group, num_tiles)
                    done.append(ext["normal"])
            zeros = torch.zeros(n, dtype=torch.float32, device=dev)
        taps = []  # (tap gather index, M-mass merged)
        px0 = pixel_idx % width
        py0 = pixel_idx // width
        for _ in range(cfg.restir_spatial_neighbors):
            r_a, seed = rng.rnd(seed)
            r_b, seed = rng.rnd(seed)
            r_m, seed = rng.rnd(seed)
            ang = 2.0 * 3.14159265 * r_a
            rad = cfg.restir_spatial_radius * torch.sqrt(r_b)
            dx = (torch.cos(ang) * rad).to(torch.int32)
            dy = (torch.sin(ang) * rad).to(torch.int32)
            px = px0 + dx
            py = py0 + dy
            in_bounds = ((px >= 0) & (px < width) & (py >= 0)
                         & (py < cfg.height))
            if group is None:
                nbr = torch.clamp(py * width + px, 0, n - 1)
                nbr_res = Reservoir(*(a[nbr] for a in src))
                nbr_normal = gbuf.normal[nbr]
                reach = in_bounds
            else:
                ext_idx = py * width + px - start + halo
                reach = in_bounds & (ext_idx >= 0) & (ext_idx < n + 2 * halo)
                nbr = torch.clamp(ext_idx, 0, n + 2 * halo - 1)
                nbr_res = Reservoir(
                    weight_sum=zeros, target_pdf=zeros,  # not read by merge
                    **{k: ext[k][nbr] for k in ("m", "light_index", "uv",
                                                "distance", "w")})
                nbr_normal = ext["normal"][nbr]
            nbr_res = nbr_res._replace(
                m=torch.clamp_max(nbr_res.m, float(cfg.restir_max_m)))
            # Geometric similarity gate.
            nrm_ok = dot(nbr_normal, gbuf.normal) > 0.9
            nbr_rad, _, _, _, nbr_valid = _unshadowed_radiance(
                scene, gbuf, wo_world, nbr_res.light_index, nbr_res.uv)
            participate = (reach & nrm_ok & nbr_valid & (nbr_res.w > 0.0)
                           & gbuf.hit)
            res = _reservoir_merge(res, nbr_res, luminance_rec601(nbr_rad),
                                   r_m, participate)
            if unbiased:
                taps.append((nbr, torch.where(participate, nbr_res.m, 0.0)))
        if unbiased:
            # The Alg.-6 Z-count of the final sample: the receiver covers
            # its own choice; a tap adds its merged M-mass iff the sample's
            # p-hat at the tap's surface is positive.
            z = m_canonical
            surf = (dict(gbuf._asdict(), wo=wo_world) if group is None
                    else ext)
            for nbr, m_mass in taps:
                tap_gbuf = GBuffer(
                    **{k: surf[k][nbr] for k in (
                        "position", "normal", "albedo", "roughness",
                        "metallic", "hit", "object")},
                    emission=gbuf.emission,  # unread by _unshadowed_radiance
                )
                tap_rad, _, _, _, tap_valid = _unshadowed_radiance(
                    scene, tap_gbuf, surf["wo"][nbr], res.light_index, res.uv)
                covered = tap_valid & (luminance_rec601(tap_rad) > 0.0)
                z = z + torch.where(covered, m_mass, 0.0)
            res = _finalize(res, z=z)
        else:
            res = _finalize(res)

        # --- 6. shade the final sample ---
        # Spatial reuse can import a sample that is visible at the neighbour
        # and occluded here, so the final sample gets a shadow ray of its own.
        radiance, _, lpos, wi, valid = _unshadowed_radiance(
            scene, gbuf, wo_world, res.light_index, res.uv)
        origin, sr_dir, sr_dist, light_obj = _shadow_ray(
            scene, gbuf, lpos, wi, res.light_index)
        shadeable = valid & (res.w > 0.0)
        occ_final_active = shadeable & (sr_dist > 0.0)
        occ_final = occlusion_fn(origin, sr_dir, sr_dist * 0.999, light_obj,
                                 occ_final_active)
        live = occ_final_active.sum()
        wf.count_rays(n, live)
        shadow_rays = shadow_rays + live
        direct = radiance * res.w[:, None]
        direct = torch.where((shadeable & ~occ_final)[:, None], direct, 0.0)
        if cfg.restir_final_visibility_feedback:
            # The step-6 ray is paid for: an occluded-here sample must not ride
            # next frame's temporal reuse (shading black for ~M frames).
            res = _invalidate(res, occ_final_active & occ_final)
        return direct, res, shadow_rays


def render_wavefront_restir(scene, camera_ubo, prev_reservoir, frame_number,
                            cfg: RenderConfig, pixel_start=0, num_pixels=None,
                            num_tiles: int = 1, group=None,
                            with_stats: bool = False, timer=None):
    """One progressive sample of every pixel (or of the tile [pixel_start,
    pixel_start + num_pixels), the rank's of `num_tiles` in `group`; see
    restir_direct) with ReSTIR DI at the primary vertex and path-traced
    indirect bounces. Returns (radiance f32[N,3], reservoir), plus
    render_wavefront's dict of ray counts with with_stats=True (ReSTIR's
    shadow rays in shadow_rays).

    The primary trace doubles as the G-buffer pass; `_shade` runs with
    suppress_nee=True there (directly visible emitters still add, as
    simple.rchit's first-bounce path) and normally afterwards."""
    cfg = cfg.resolve_accel()
    dev = scene.device
    state = wf.start_wavefront(
        scene, camera_ubo, frame_number, cfg,
        pixel_indices=wf.tile_pixels(cfg, pixel_start, num_pixels, dev))
    clear_color = torch.tensor(cfg.background, dtype=torch.float32,
                               device=dev)

    # --- primary trace + G-buffer (restir.rgen) ---
    n = state.alive.shape[0]
    with profiling.span("rt.bounce", depth=0, lanes=n):
        rays_traced = state.alive.sum()
        wf.count_rays(n, rays_traced)
        hit = wf._trace(scene, state.origin, state.direction, cfg,
                        state.alive)
        lane = state.alive & hit.hit
        surf = wf.fetch_surface(scene, hit, state.direction, lane)
        # Dielectric lanes carry their own light transport (the plain path
        # skips NEE on them too); ReSTIR covers the opaque surface lanes.
        if cfg.enable_transmission:
            restir_lane = lane & ~(surf.transmission > 0.0)
        else:
            restir_lane = lane
        gbuf = GBuffer(
            position=surf.world_pos,
            normal=surf.world_nrm,
            albedo=surf.albedo,
            roughness=surf.roughness,
            metallic=surf.metallic,
            emission=surf.emission_color * surf.emission_power[:, None],
            hit=restir_lane,
            object=surf.obj,
        )

        def occlusion_fn(o, d, t_max, skip_obj, active):
            return wf._occluded(scene, o, d, t_max, skip_obj, cfg, active)

        direct, reservoir, shadow_total = restir_direct(
            scene, gbuf, state.direction, prev_reservoir, frame_number,
            cfg, occlusion_fn, pixel_start=pixel_start,
            num_tiles=num_tiles, group=group, timer=timer)

        # --- primary shading (BRDF sample + emission, NEE suppressed) ---
        state, payload_hit, _ = wf._shade(scene, state, hit, cfg,
                                          suppress_nee=True)
        # ReSTIR's direct light at this vertex is the full estimate (no
        # MIS split), so the next bounce's emissive hit stays suppressed on
        # the specular-lobe lanes too: the reference's isSpecular
        # full-emission add (simple.rchit:644) would count glossy direct
        # light twice.
        state = state._replace(
            color=state.color + torch.where(restir_lane[:, None], direct,
                                            0.0),
            is_specular=torch.where(restir_lane, False, state.is_specular),
        )
        state = wf.end_bounce(state, payload_hit, clear_color)

    # --- indirect bounces (path tracing with NEE) ---
    for depth in range(1, cfg.max_depth):
        state, rays, shadow_rays = wf.path_bounce(scene, state, depth, cfg,
                                                  clear_color)
        rays_traced = rays_traced + rays
        shadow_total = shadow_total + shadow_rays

    radiance = wf.final_radiance(state, cfg)
    if with_stats:
        return radiance, reservoir, {
            "rays_traced": rays_traced, "shadow_rays": shadow_total,
            "total_rays": rays_traced + shadow_total}
    return radiance, reservoir


def render_frame_restir(scene, camera_ubo, accum, prev_reservoir,
                        frame_number: int, cfg: RenderConfig, pixel_start=0,
                        num_pixels=None, num_tiles: int = 1, group=None,
                        with_stats: bool = False, timer=None):
    """One progressive step with ReSTIR DI: (accum', reservoir), plus the
    ray counts with with_stats=True; on a tile (render_wavefront_restir's
    arguments) `accum` and the reservoirs hold the tile's rows."""
    out = render_wavefront_restir(
        scene, camera_ubo, prev_reservoir, frame_number, cfg,
        pixel_start=pixel_start, num_pixels=num_pixels, num_tiles=num_tiles,
        group=group, with_stats=with_stats, timer=timer)
    accum = wf.accumulate(accum, out[0], frame_number)
    return (accum, *out[1:])
