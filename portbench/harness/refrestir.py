"""The plain reference of one ReSTIR DI frame (Bitterli et al. 2020, on the
RTXDI reservoir layout) for a sample of pixels, followed from a given
reservoir of the frame before: the program's, or the reference's own
from empty reservoirs.

A pixel's frame reads its own reservoir of the frame before (temporal
reuse) and, through `restir_spatial_neighbors` random taps within
`restir_spatial_radius` pixels, its neighbours' post-temporal reservoirs
(spatial reuse). The reference therefore computes, for the sampled
pixels and every tap of theirs: the primary hit (the G-buffer), the
initial RIS over `restir_initial_candidates` light samples, the
survivor's shadow ray and the temporal merge with the handed-in
reservoir; then, for the sampled pixels, the spatial merges, the final
sample's shadow ray, the primary vertex's BSDF sample with next-event
estimation suppressed, and the indirect bounces with NEE/MIS. Its draws
come from the ReSTIR stream tea(pixel, frame ^ 0x9E3779B9), so the path
tracer's streams are untouched. Only the defaults of the two bias fixes
(both off) are modelled.
"""

from __future__ import annotations

import torch

from harness import refmath as m

STREAM = 0x9E3779B9
FIELDS = ("weight_sum", "target_pdf", "m", "light_index", "uv", "distance",
          "w")


def empty(n, dt, device):
    f = dict(dtype=dt, device=device)
    return dict(weight_sum=torch.zeros(n, **f), target_pdf=torch.zeros(n, **f),
                m=torch.zeros(n, **f),
                light_index=torch.full((n,), -1, dtype=torch.int64,
                                       device=device),
                uv=torch.zeros((n, 2), **f), distance=torch.zeros(n, **f),
                w=torch.zeros(n, **f))


def _update(res, light, uv, dist, target, weight, r):
    ws = res["weight_sum"] + weight
    take = (weight > 0.0) & (r * ws <= weight)
    return dict(weight_sum=ws,
                target_pdf=torch.where(take, target, res["target_pdf"]),
                m=res["m"] + 1.0,
                light_index=torch.where(take, light, res["light_index"]),
                uv=torch.where(take[:, None], uv, res["uv"]),
                distance=torch.where(take, dist, res["distance"]),
                w=res["w"])


def _merge(res, other, target_here, r, valid):
    m_o = torch.where(valid, other["m"], 0.0)
    w_o = torch.where(valid, target_here * other["w"] * m_o, 0.0)
    ws = res["weight_sum"] + w_o
    take = (w_o > 0.0) & (r * ws <= w_o)
    return dict(weight_sum=ws,
                target_pdf=torch.where(take, target_here, res["target_pdf"]),
                m=res["m"] + m_o,
                light_index=torch.where(take, other["light_index"],
                                        res["light_index"]),
                uv=torch.where(take[:, None], other["uv"], res["uv"]),
                distance=torch.where(take, other["distance"],
                                     res["distance"]),
                w=res["w"])


def _finalize(res):
    w = torch.where((res["target_pdf"] > 0.0) & (res["m"] > 0.0),
                    res["weight_sum"] / torch.clamp_min(
                        res["m"] * res["target_pdf"], 1e-20), 0.0)
    return dict(res, w=w)


def _invalidate(res, killed):
    return dict(res, w=torch.where(killed, 0.0, res["w"]),
                weight_sum=torch.where(killed, 0.0, res["weight_sum"]),
                target_pdf=torch.where(killed, 0.0, res["target_pdf"]),
                light_index=torch.where(killed, -1, res["light_index"]))


def _take(d, idx):
    return {k: v[idx] for k, v in d.items()}


def skip_to_taps(cfg, pixels, frame, dt):
    """The ReSTIR streams of `pixels` at `frame` where the spatial taps
    draw: past the candidates' 5 draws each and the temporal one, which
    depend on no data."""
    seed = m.tea(pixels, torch.full_like(pixels, int(frame) & m.M32)
                 ^ STREAM)
    for _ in range(5 * cfg["restir_initial_candidates"] + 1):
        _, seed = m.rnd(seed, dt)
    return seed


def taps(cfg, pixels, seed, dt):
    """The spatial taps of `pixels` from their ReSTIR streams at the taps'
    draws: [(tap pixel ids clamped into the image, inside it, the merge's
    draw)], one a neighbour."""
    w, h = cfg["width"], cfg["height"]
    px0, py0 = pixels % w, pixels // w
    out = []
    for _ in range(cfg["restir_spatial_neighbors"]):
        r_a, seed = m.rnd(seed, dt)
        r_b, seed = m.rnd(seed, dt)
        r_m, seed = m.rnd(seed, dt)
        ang = 2.0 * 3.14159265 * r_a
        rad = cfg["restir_spatial_radius"] * torch.sqrt(r_b)
        px = px0 + (torch.cos(ang) * rad).to(torch.int32)
        py = py0 + (torch.sin(ang) * rad).to(torch.int32)
        inside = (px >= 0) & (px < w) & (py >= 0) & (py < h)
        out.append((torch.clamp(py * w + px, 0, w * h - 1), inside, r_m))
    return out


def pixels_read(cfg, pixels, frame, dt=torch.float32):
    """Every pixel whose reservoir of the frame before the frame of
    `pixels` reads, with the reference in dtype `dt`: theirs and their
    taps' (sorted, unique)."""
    seed = skip_to_taps(cfg, pixels, frame, dt)
    found = taps(cfg, pixels, seed, dt)
    return torch.unique(torch.cat([pixels] + [t for t, _, _ in found]))


class RestirFrame:
    def __init__(self, tracer, cfg):
        for key, default in (("restir_unbiased_spatial", False),
                             ("restir_final_visibility_feedback", False)):
            if cfg.get(key, default) != default:
                raise ValueError(f"the reference models {key}={default} "
                                 "only")
        self.pt = tracer
        self.s = tracer.s
        self.cfg = cfg

    def _unshadowed(self, g, wo, tri, uv):
        """(radiance, light point, wi, valid) of the sample (global light
        triangle `tri`, barycentric draws uv) seen from surface `g`."""
        s = self.s
        ti = torch.clamp(tri, 0, s.v0.shape[0] - 1)
        pos, face_n, area = self.pt.light_point(ti, uv[:, 0], uv[:, 1])
        light_idx = s.tri_light[ti]
        num_tris = s.tri_light_n[ti]
        emission = torch.where(
            (light_idx >= 0)[:, None],
            s.light_emit[torch.clamp(light_idx, 0, max(s.num_lights - 1, 0))],
            0.0)
        to_light = pos - g["pos"]
        dist = torch.clamp_min(m.length(to_light), 0.01)
        wi = to_light / dist[:, None]
        cos_l = torch.abs(m.dot(m.normalize(face_n), -wi))
        basis = m.make_basis(g["nrm"])
        wo_l = m.to_local(-wo, basis)
        wi_l = m.to_local(wi, basis)
        f = m.brdf_eval(wo_l, wi_l, g["albedo"], g["rough"], g["metal"])
        cos_surf = torch.clamp_min(wi_l[:, 2], 0.0)
        geom = cos_surf * cos_l / (dist * dist)
        scale = geom * area * torch.clamp_min(num_tris, 1.0)
        radiance = f * emission * scale[:, None]
        valid = ((tri >= 0) & (light_idx >= 0) & (cos_l > 1e-6)
                 & (cos_surf > 0.0) & g["hit"])
        return torch.where(valid[:, None], radiance, 0.0), pos, wi, valid

    def _visible(self, g, lpos, wi, tri, active):
        s = self.s
        obj = s.obj[torch.clamp(tri, 0, s.v0.shape[0] - 1)]
        origin = g["pos"] + g["nrm"] * (0.001 * torch.sign(
            m.dot(g["nrm"], wi)[:, None]))
        sr = lpos - origin
        dist = m.length(sr)
        sr_dir = sr / torch.clamp_min(dist, 1e-20)[:, None]
        act = active & (dist > 0.0)
        occ = self.pt.occluded(origin, sr_dir, dist * 0.999, obj, act)
        return act, occ

    def gbuffer(self, pixels, frame):
        """(G-buffer, primary state, primary hit) of `pixels` at `frame`."""
        pt, s = self.pt, self.s
        frames = torch.full_like(pixels, int(frame))
        st = pt.start(pixels, frames)
        hit = pt.trace(st["origin"], st["direction"], st["alive"])
        lane = st["alive"] & hit[4]
        sf = pt.surface(hit, st["direction"], lane)
        mr = sf["mrow"]
        opaque = lane & ~(mr[:, 9] > 0.0) if self.cfg[
            "enable_transmission"] else lane
        g = dict(pos=sf["pos"], nrm=sf["nrm"], albedo=mr[:, 0:3],
                 rough=mr[:, 7], metal=mr[:, 8], hit=opaque, obj=sf["obj"])
        return g, st, hit

    def temporal(self, pixels, frame, prev):
        """Steps 2-4 for `pixels`: (post-temporal reservoir, G-buffer,
        primary state, hit, the ReSTIR streams after step 4)."""
        s, cfg, dt = self.s, self.cfg, self.s.dt
        g, st, hit = self.gbuffer(pixels, frame)
        wo = st["direction"]
        n = pixels.shape[0]
        dev = pixels.device
        nl = min(s.num_lights, cfg["max_lights"])
        seed = m.tea(pixels, torch.full_like(pixels, int(frame) & m.M32)
                     ^ STREAM)
        weights = self.pt.light_weights(g["pos"])
        weights = torch.where(s.light_obj[None, :nl] == g["obj"][:, None],
                              0.0, weights)
        total = weights.sum(-1)
        cdf = torch.cumsum(weights, dim=1)
        res = empty(n, dt, dev)
        for _ in range(cfg["restir_initial_candidates"]):
            r_sel, seed = m.rnd(seed, dt)
            r_tri, seed = m.rnd(seed, dt)
            r1, seed = m.rnd(seed, dt)
            r2, seed = m.rnd(seed, dt)
            r_keep, seed = m.rnd(seed, dt)
            at_or_past = cdf >= (r_sel * total)[:, None]
            light = at_or_past.to(torch.int32).argmax(1).to(torch.int64)
            found = at_or_past.any(1) & (total > 0.0)
            sel_c = torch.clamp(light, 0, nl - 1)
            sel_w = weights.gather(1, sel_c[:, None])[:, 0]
            count = s.light_count[sel_c]
            local = torch.minimum((r_tri * count.to(dt)).to(torch.int64),
                                  count - 1)
            tri = torch.where(found, torch.clamp(
                s.light_first[sel_c] + local, 0, s.v0.shape[0] - 1), -1)
            src_pdf = torch.where(found, sel_w / torch.clamp_min(total, 1e-20),
                                  0.0)
            uv = torch.stack([r1, r2], -1)
            rad, lpos, _, valid = self._unshadowed(g, wo, tri, uv)
            dist = torch.clamp_min(m.length(lpos - g["pos"]), 0.01)
            target = m.luminance601(rad)
            cw = torch.where(valid & (src_pdf > 0.0),
                             target / torch.clamp_min(src_pdf, 1e-20), 0.0)
            res = _update(res, tri, uv, dist, target, cw, r_keep)
        res = _finalize(res)
        if cfg["restir_initial_visibility"]:
            _, lpos, wi, valid = self._unshadowed(g, wo, res["light_index"],
                                                  res["uv"])
            _, occ = self._visible(g, lpos, wi, res["light_index"], valid)
            res = _invalidate(res, occ | ~valid)
        r_t, seed = m.rnd(seed, dt)
        prev = dict(prev, m=torch.clamp_max(prev["m"],
                                            float(cfg["restir_max_m"])))
        prev_rad, _, _, prev_valid = self._unshadowed(
            g, wo, prev["light_index"], prev["uv"])
        res = _merge(res, prev, m.luminance601(prev_rad), r_t,
                     prev_valid & (prev["w"] > 0.0))
        return _finalize(res), g, st, hit, seed

    def handed_on(self, pixels, frame, prev_of):
        """The reservoir that frame `frame` of `pixels` hands on (a dict of
        FIELDS), with the G-buffer and the primary state. `prev_of(ids)`
        gives the reservoir of the frame before at pixel ids `ids`."""
        pt, cfg = self.pt, self.cfg
        found = taps(cfg, pixels, skip_to_taps(cfg, pixels, frame, self.s.dt),
                     self.s.dt)
        everyone = torch.unique(torch.cat([pixels]
                                          + [t for t, _, _ in found]))
        src, g_all, _, _, _ = self.temporal(everyone, frame,
                                            prev_of(everyone))

        def rows(ids):
            return torch.searchsorted(everyone, ids)

        mine = rows(pixels)
        res = _take(src, mine)
        g = _take(g_all, mine)
        st = pt.start(pixels, torch.full_like(pixels, int(frame)))
        wo = st["direction"]
        for tap, inside, r_m in found:
            j = rows(tap)
            nbr = _take(src, j)
            nbr["m"] = torch.clamp_max(nbr["m"], float(cfg["restir_max_m"]))
            nrm_ok = m.dot(g_all["nrm"][j], g["nrm"]) > 0.9
            rad, _, _, valid = self._unshadowed(g, wo, nbr["light_index"],
                                                nbr["uv"])
            join = inside & nrm_ok & valid & (nbr["w"] > 0.0) & g["hit"]
            res = _merge(res, nbr, m.luminance601(rad), r_m, join)
        return _finalize(res), g, st

    def frame(self, pixels, frame, prev_of):
        """Frame `frame` of `pixels`: (clamped radiance [n,3], the reservoir
        handed on, dict of tensors), `prev_of` as handed_on's."""
        pt, cfg = self.pt, self.cfg
        dev = pixels.device
        res, g, st = self.handed_on(pixels, frame, prev_of)
        wo = st["direction"]
        rad, lpos, wi, valid = self._unshadowed(g, wo, res["light_index"],
                                                res["uv"])
        shadeable = valid & (res["w"] > 0.0)
        act, occ = self._visible(g, lpos, wi, res["light_index"], shadeable)
        direct = torch.where((shadeable & ~occ)[:, None],
                             rad * res["w"][:, None], 0.0)

        bg = torch.tensor(cfg["background"], dtype=self.s.dt, device=dev)
        hit = pt.trace(st["origin"], st["direction"], st["alive"])
        payload = pt.shade(st, hit, suppress_nee=True)
        st["color"] = st["color"] + torch.where(g["hit"][:, None], direct,
                                                0.0)
        st["specular"] = torch.where(g["hit"], False, st["specular"])
        st = pt.end_bounce(st, payload, bg)
        for depth in range(1, cfg["max_depth"]):
            st = pt.bounce(st, depth, bg)
        from harness.reference import final_radiance

        return final_radiance(st["color"], cfg["radiance_clamp"]), res
