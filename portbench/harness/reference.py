"""The plain reference of the progressive path tracer: plain torch, no
kernel and nothing of the program. It flattens the scene description
itself (world-space triangles, vertex normals, materials, the emissive
objects as lights), builds its own intersection structure (refbvh.py),
and traces any set of (pixel, frame) lanes:

  camera ray with the frame's jitter (TEA-16 seeded streams); per bounce
  Russian roulette from `rr_start_depth`, the closest hit, the surface
  (interpolated normal, face-forwarded), next-event estimation with the
  power/distance^2 light choice, area sampling of a uniform triangle of
  the light, a shadow ray and the power-heuristic MIS weight against the
  GGX/Lambert pdf; emissive hits with MIS against the previous bounce's
  light pdf; the BSDF sample (or a smooth dielectric's reflection or
  refraction, with dispersion); the miss adds the background; then the
  radiance clamp and the running mean over frames.

Written to the semantics of the renderer's shaders, in their operation
order, so that float32 lanes agree with the program's to rounding; `dt`
sets the float type of everything but the boxes' culling (a lower one is
the control).
"""

from __future__ import annotations

import numpy as np
import torch

from harness import refmath as m
from harness.refbvh import RefBVH


class RefScene:
    def __init__(self, desc, device, dt=torch.float32):
        v0s, e1s, e2s, n0s, n1s, n2s, objs = [], [], [], [], [], [], []
        first, cursor = [], 0
        for oi, ob in enumerate(desc.objects):
            mesh = desc.meshes[ob.mesh]
            mm, nm = ob.model_matrix(), ob.normal_matrix()
            wpos = mesh.positions @ mm[:3, :3].T + mm[:3, 3]
            wnrm = mesh.normals @ nm[:3, :3].T
            tris = mesh.indices.reshape(-1, 3).astype(np.int64)
            a, b, c = wpos[tris[:, 0]], wpos[tris[:, 1]], wpos[tris[:, 2]]
            v0s.append(a)
            e1s.append(b - a)
            e2s.append(c - a)
            n0s.append(wnrm[tris[:, 0]])
            n1s.append(wnrm[tris[:, 1]])
            n2s.append(wnrm[tris[:, 2]])
            objs.append(np.full(len(tris), oi, np.int64))
            first.append(cursor)
            cursor += len(tris)
        f32 = np.float32
        v0, e1, e2 = (np.concatenate(x).astype(f32) for x in (v0s, e1s, e2s))
        n0, n1, n2 = (np.concatenate(x).astype(f32) for x in (n0s, n1s, n2s))
        obj = np.concatenate(objs)
        mats = np.zeros((len(desc.materials), 12), f32)
        for i, mt in enumerate(desc.materials):
            mats[i, 0:3] = mt.albedo
            mats[i, 3:6] = mt.emission_color
            mats[i, 6:12] = (mt.emission_power, mt.roughness, mt.metallic,
                             mt.transmission, mt.ior, mt.dispersion)
        obj_mat = np.asarray([o.material for o in desc.objects], np.int64)

        light_obj, l_first, l_count, l_center, l_emit, l_power = (
            [], [], [], [], [], [])
        obj_light = np.full(len(desc.objects), -1, np.int64)
        obj_light_n = np.zeros(len(desc.objects), np.int64)
        for oi, ob in enumerate(desc.objects):
            mt = desc.materials[ob.material]
            if mt.emission_power > 0:
                obj_light[oi] = len(light_obj)
                n_tris = desc.meshes[ob.mesh].num_triangles
                obj_light_n[oi] = n_tris
                light_obj.append(oi)
                l_first.append(first[oi])
                l_count.append(n_tris)
                l_center.append(ob.model_matrix()[:3, 3])
                l_emit.append(np.asarray(mt.emission_color, f32)
                              * mt.emission_power)
                l_power.append(mt.emission_power)
        self.num_lights = len(light_obj)

        def t(a, dtype=dt):
            return torch.from_numpy(np.ascontiguousarray(a)).to(
                device=device, dtype=dtype)

        i64 = torch.int64
        self.device, self.dt = device, dt
        self.v0, self.e1, self.e2 = t(v0), t(e1), t(e2)
        self.n0, self.n1, self.n2 = t(n0), t(n1), t(n2)
        self.obj = t(obj, i64)
        self.mat = t(obj_mat[obj], i64)
        self.tri_light = t(obj_light[obj], i64)
        self.tri_light_n = t(obj_light_n[obj].astype(f32))
        self.materials = t(mats)
        nl = self.num_lights
        self.light_obj = t(np.asarray(light_obj, np.int64).reshape(nl), i64)
        self.light_first = t(np.asarray(l_first, np.int64).reshape(nl), i64)
        self.light_count = t(np.asarray(l_count, np.int64).reshape(nl), i64)
        self.light_center = t(np.asarray(l_center, f32).reshape(nl, 3))
        self.light_emit = t(np.asarray(l_emit, f32).reshape(nl, 3))
        self.light_power = t(np.asarray(l_power, f32).reshape(nl))
        self.bvh = RefBVH(v0, e1, e2, obj, device, dt)


def camera_matrices(position, target, width, height):
    """(inverse view, inverse projection) float32 numpy: a right-handed
    look-at with up +y, a 45-degree perspective (near 0.1, far 1000, GL
    clip depth) and the Vulkan y flip."""
    eye = np.asarray(position, np.float32)
    f = np.asarray(target, np.float32) - eye
    fwd = f / np.linalg.norm(f)
    up = np.asarray((0.0, 1.0, 0.0), np.float32)
    center = eye + fwd
    f = center - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, up)
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    view = np.eye(4, dtype=np.float32)
    view[0, :3], view[1, :3], view[2, :3] = s, u, -f
    view[0, 3] = -np.dot(s, eye)
    view[1, 3] = -np.dot(u, eye)
    view[2, 3] = np.dot(f, eye)
    tan = np.tan(np.radians(45.0) / 2.0)
    aspect = float(width / height)
    proj = np.zeros((4, 4), np.float32)
    proj[0, 0] = 1.0 / (aspect * tan)
    proj[1, 1] = 1.0 / tan
    proj[2, 2] = -(1000.0 + 0.1) / (1000.0 - 0.1)
    proj[2, 3] = -(2.0 * 1000.0 * 0.1) / (1000.0 - 0.1)
    proj[3, 2] = -1.0
    proj[1, 1] *= -1.0
    return (np.linalg.inv(view).astype(np.float32),
            np.linalg.inv(proj).astype(np.float32))


class PathTracer:
    """The reference integrator over a RefScene. `cfg` holds width,
    height, max_depth, rr_start_depth, radiance_clamp, background, t_min,
    t_max, max_lights and enable_transmission (next-event estimation with
    MIS, as the renderer's default)."""

    def __init__(self, scene: RefScene, cfg: dict, camera):
        self.s = scene
        self.cfg = cfg
        dev = scene.device
        inv_view, inv_proj = camera_matrices(camera["position"],
                                             camera["target"], cfg["width"],
                                             cfg["height"])
        self.inv_view = torch.from_numpy(inv_view).to(dev, scene.dt)
        self.inv_proj = torch.from_numpy(inv_proj).to(dev, scene.dt)

    # -- lanes ------------------------------------------------------------
    def start(self, pixels, frames):
        """The lanes' state before the first bounce (dict of tensors)."""
        s, cfg, dt = self.s, self.cfg, self.s.dt
        dev = s.device
        n = pixels.shape[0]
        frames = frames & m.M32
        seed = m.tea(pixels, frames)
        jm = frames > 0
        r1, seed = m.rnd_masked(seed, jm, dt)
        r2, seed = m.rnd_masked(seed, jm, dt)
        jitter = torch.where(jm[:, None],
                             0.5 + (torch.stack([r1, r2], -1) - 0.5) * 0.4,
                             torch.full((n, 2), 0.5, dtype=dt, device=dev))
        w, h = cfg["width"], cfg["height"]
        px = (pixels % w).to(dt)
        py = (pixels // w).to(dt)
        uv = (torch.stack([px, py], -1) + jitter) / torch.tensor(
            [w, h], dtype=dt, device=dev)
        dd = uv * 2.0 - 1.0
        iv, ip = self.inv_view, self.inv_proj
        target = (ip[:3, 0] * dd[:, 0:1] + ip[:3, 1] * dd[:, 1:2]
                  + ip[:3, 2] + ip[:3, 3])
        tn = m.normalize(target)
        direction = m.normalize(tn[:, 0:1] * iv[:3, 0] + tn[:, 1:2] * iv[:3, 1]
                                + tn[:, 2:3] * iv[:3, 2])
        f = dict(dtype=dt, device=dev)
        b = dict(dtype=torch.bool, device=dev)
        return dict(
            origin=iv[:3, 3].expand(n, 3).contiguous(), direction=direction,
            color=torch.zeros((n, 3), **f), throughput=torch.ones((n, 3), **f),
            seed_rgen=seed, seed=seed, alive=torch.ones((n,), **b),
            first=torch.ones((n,), **b), specular=torch.zeros((n,), **b),
            prev_pdf=torch.ones((n,), **f), prev_pos=torch.zeros((n, 3), **f),
            p_light=torch.zeros((n,), **f), did_direct=torch.zeros((n,), **b),
            channel=torch.full((n,), -1, dtype=torch.int64, device=dev))

    def render(self, pixels, frames, from_depth=0, state=None):
        """Clamped radiance [n,3] of the lanes (pixel ids, frame numbers),
        tracing bounces from_depth..max_depth-1 of `state` (default: the
        camera rays)."""
        cfg = self.cfg
        st = self.start(pixels, frames) if state is None else state
        bg = torch.tensor(cfg["background"], dtype=self.s.dt,
                          device=self.s.device)
        for depth in range(from_depth, cfg["max_depth"]):
            st = self.bounce(st, depth, bg)
        return final_radiance(st["color"], cfg["radiance_clamp"])

    def bounce(self, st, depth, bg):
        cfg, dt = self.cfg, self.s.dt
        if depth >= cfg["rr_start_depth"]:
            lum = m.luminance709(st["throughput"])
            p = torch.clamp(lum, 0.05, 0.95)
            r, seed_rgen = m.rnd_masked(st["seed_rgen"], st["alive"], dt)
            kill = st["alive"] & (r > p)
            st["throughput"] = torch.where(
                (st["alive"] & ~kill)[:, None],
                st["throughput"] / p[:, None], st["throughput"])
            st["seed_rgen"] = seed_rgen
            st["alive"] = st["alive"] & ~kill
        hit = self.trace(st["origin"], st["direction"], st["alive"])
        return self.end_bounce(st, self.shade(st, hit), bg)

    def end_bounce(self, st, payload_hit, bg):
        """The miss (the background), then the throughput kill."""
        missed = st["alive"] & ~payload_hit
        st["color"] = torch.where(missed[:, None],
                                  st["color"] + st["throughput"] * bg,
                                  st["color"])
        st["alive"] = st["alive"] & payload_hit
        tp = st["throughput"]
        bad = ((torch.isnan(tp) | torch.isinf(tp)).any(-1)
               | (tp < 0.001).all(-1))
        st["alive"] = st["alive"] & ~bad
        return st

    # -- rays -------------------------------------------------------------
    def trace(self, origin, direction, alive):
        """(t, tri, u, v, hit) for every lane; dead lanes miss."""
        s, cfg = self.s, self.cfg
        n = origin.shape[0]
        dev = origin.device
        t = torch.full((n,), cfg["t_max"], dtype=s.dt, device=dev)
        tri = torch.full((n,), -1, dtype=torch.int64, device=dev)
        u = torch.zeros((n,), dtype=s.dt, device=dev)
        v = torch.zeros((n,), dtype=s.dt, device=dev)
        idx = torch.nonzero(alive).squeeze(1)
        if idx.numel():
            ti, tr, ui, vi, _ = s.bvh.closest(origin[idx], direction[idx],
                                              cfg["t_min"], cfg["t_max"])
            t[idx], tri[idx], u[idx], v[idx] = ti, tr, ui, vi
        return t, tri, u, v, tri >= 0

    def occluded(self, origin, direction, t_max, skip_object, active):
        s, cfg = self.s, self.cfg
        occ = torch.zeros((origin.shape[0],), dtype=torch.bool,
                          device=origin.device)
        idx = torch.nonzero(active).squeeze(1)
        if idx.numel():
            occ[idx] = s.bvh.occluded(origin[idx], direction[idx],
                                      cfg["t_min"], t_max[idx],
                                      skip_object[idx])
        return occ

    # -- lights -----------------------------------------------------------
    def light_weights(self, pos):
        """Power/dist^2 weights [n, L] over the first max_lights lights."""
        s = self.s
        nl = min(s.num_lights, self.cfg["max_lights"])
        c = s.light_center[:nl]
        dx = pos[:, 0:1] - c[None, :, 0]
        dy = pos[:, 1:2] - c[None, :, 1]
        dz = pos[:, 2:3] - c[None, :, 2]
        return s.light_power[:nl][None, :] / torch.clamp_min(
            dx * dx + dy * dy + dz * dz, 0.001)

    def light_point(self, tri, r1, r2):
        """(point, face normal (unnormalised), area, v0, e1, e2) of global
        triangle `tri` at the barycentric draws (r1, r2)."""
        s = self.s
        v0, e1, e2 = s.v0[tri], s.e1[tri], s.e2[tri]
        sq = torch.sqrt(r1)
        bu = 1.0 - sq
        bv = sq * (1.0 - r2)
        bw = sq * r2
        pos = (bu[:, None] * v0 + bv[:, None] * (v0 + e1)
               + bw[:, None] * (v0 + e2))
        face_n = m.cross(e1, e2)
        return pos, face_n, 0.5 * m.length(face_n)

    def sample_light(self, sel, hit_pos, seed, active):
        s, dt = self.s, self.s.dt
        nl = min(s.num_lights, self.cfg["max_lights"])
        sel_c = torch.clamp(sel, 0, nl - 1)
        first = s.light_first[sel_c]
        count = s.light_count[sel_c]
        r_tri, seed = m.rnd_masked(seed, active, dt)
        local = torch.minimum((r_tri * count.to(dt)).to(torch.int64),
                              count - 1)
        tri = torch.clamp(first + local, 0, s.v0.shape[0] - 1)
        r1, seed = m.rnd_masked(seed, active, dt)
        r2, seed = m.rnd_masked(seed, active, dt)
        pos, face_n, area = self.light_point(tri, r1, r2)
        normal = m.normalize(face_n)
        to_surface = m.normalize(hit_pos - pos)
        cos_l = m.dot(normal, to_surface)
        normal = torch.where((cos_l < 0.0)[:, None], -normal, normal)
        cos_l = torch.abs(cos_l)
        to_light = pos - hit_pos
        dist = torch.clamp_min(m.length(to_light), 0.01)
        direction = to_light / dist[:, None]
        cos_theta_l = torch.clamp_min(m.dot(-direction, normal), 0.0)
        valid = (cos_l > 0.0) & (cos_theta_l > 1e-6) & (count > 0)
        pdf = ((1.0 / torch.clamp_min(count.to(dt), 1.0))
               * (1.0 / torch.clamp_min(area, 1e-20))
               * dist * dist / torch.clamp_min(cos_theta_l, 1e-20))
        return (pos, direction, pdf, s.light_emit[sel_c], s.light_obj[sel_c],
                valid, seed)

    # -- shading ----------------------------------------------------------
    def surface(self, hit, ray_dir, lane):
        s = self.s
        t, tri, u, v, _ = hit
        ti = torch.clamp(tri, 0, s.v0.shape[0] - 1)
        v0, e1, e2 = s.v0[ti], s.e1[ti], s.e2[ti]
        bu, bv = u[:, None], v[:, None]
        pos = v0 + bu * e1 + bv * e2
        bw = 1.0 - bu - bv
        nrm = m.normalize(bw * s.n0[ti] + bu * s.n1[ti] + bv * s.n2[ti])
        front = m.dot(nrm, -ray_dir) > 0.0
        nrm = torch.where(front[:, None], nrm, -nrm)
        mat = torch.where(lane, s.mat[ti], 0)
        obj = torch.where(lane, s.obj[ti], 0)
        return dict(pos=pos, nrm=nrm, front=front, e1=e1, e2=e2, obj=obj,
                    mrow=s.materials[mat], light=s.tri_light[ti],
                    light_n=s.tri_light_n[ti])

    def shade(self, st, hit, suppress_nee=False):
        """One closest-hit shading of the lanes alive & hit, in place;
        returns payload_hit."""
        s, cfg, dt = self.s, self.cfg, self.s.dt
        lane = st["alive"] & hit[4]
        n = lane.shape[0]
        dev = lane.device
        no = torch.zeros((n,), dtype=torch.bool, device=dev)
        sf = self.surface(hit, st["direction"], lane)
        pos, nrm, mr = sf["pos"], sf["nrm"], sf["mrow"]
        albedo, em_color, em_power = mr[:, 0:3], mr[:, 3:6], mr[:, 6]
        rough, metal, transm = mr[:, 7], mr[:, 8], mr[:, 9]
        ior, disp = mr[:, 10], mr[:, 11]
        emissive = em_power > 0.0
        ray_dir = st["direction"]
        color, tp, seed = st["color"], st["throughput"], st["seed"]
        basis = m.make_basis(nrm)
        wo = m.to_local(-ray_dir, basis)
        dielectric = (lane & (transm > 0.0) if cfg["enable_transmission"]
                      else no)
        surf = lane & ~dielectric

        did_direct = no
        p_light = torch.clamp(rough, 0.1, 0.9)
        nl = min(s.num_lights, cfg["max_lights"])
        w_base = self.light_weights(pos) if nl > 0 else None
        if suppress_nee:
            did_direct = surf
        elif nl > 0:
            p_draw, seed = m.rnd_masked(seed, surf, dt)
            do_nee = surf & (p_draw < p_light)
            weights = torch.where(s.light_obj[:nl][None, :]
                                  == sf["obj"][:, None], 0.0, w_base)
            total = weights.sum(-1)
            m_sel = do_nee & (total > 0.0)
            r_sel, seed = m.rnd_masked(seed, m_sel, dt)
            r1 = r_sel * total
            at_or_past = torch.cumsum(weights, dim=1) >= r1[:, None]
            found = at_or_past.any(1)
            sel = at_or_past.to(torch.int32).argmax(1).to(torch.int64)
            m_samp = m_sel & found
            sel_c = torch.clamp(sel, 0, nl - 1)
            sel_pdf = (weights.gather(1, sel_c[:, None])[:, 0]
                       / torch.clamp_min(total, 1e-20))
            (l_pos, l_dir, l_pdf, l_emit, l_obj, l_valid,
             seed) = self.sample_light(sel, pos, seed, m_samp)
            wi = m.to_local(l_dir, basis)
            consider = m_samp & l_valid & (wi[:, 2] > 1e-4)
            to_light_n = m.normalize(l_pos - pos)
            origin = pos + nrm * (0.001 * torch.sign(
                m.dot(nrm, to_light_n)[:, None]))
            sr = l_pos - origin
            sr_dist = m.length(sr)
            sr_dir = sr / torch.clamp_min(sr_dist, 1e-20)[:, None]
            shadow = consider & (sr_dist > 0.0)
            occ = self.occluded(origin, sr_dir, sr_dist * 0.999, l_obj,
                                shadow)
            visible = shadow & ~occ
            f = m.brdf_eval(wo, wi, albedo, rough, metal)
            light_pdf = l_pdf * sel_pdf
            p_spec = m.spec_probability(albedo, rough, metal)
            h = m.normalize(wo + wi)
            brdf_pdf = (p_spec * m.microfacet_pdf(wo, h, rough)
                        + (1.0 - p_spec) * (wi[:, 2] / m.M_PI))
            weight = m.mis_power(light_pdf, brdf_pdf)
            radiance = f * l_emit * (wi[:, 2] * weight / torch.clamp_min(
                light_pdf, 1e-6))[:, None]
            contrib = tp * radiance / p_light[:, None]
            color = torch.where(visible[:, None], color + contrib, color)
            did_direct = do_nee
        else:
            _, seed = m.rnd_masked(seed, surf, dt)

        wi_s, value, pdf, is_spec, seed_brdf = m.sample_brdf(
            wo, albedo, rough, metal, seed, dt)
        # Only surface lanes consume the BSDF's draws; dielectric lanes
        # draw from `seed` below.
        seed_surf = torch.where(surf, seed_brdf, seed)

        add_full = surf & emissive & (st["first"] | st["specular"])
        color = torch.where(add_full[:, None],
                            color + tp * em_color * em_power[:, None], color)
        if nl > 0:
            li = sf["light"]
            add_mis = (surf & emissive & ~(st["first"] | st["specular"])
                       & ~st["did_direct"] & (li >= 0))
            d = m.length(pos - st["prev_pos"])
            cos_light = torch.clamp_min(m.dot(nrm, -ray_dir), 0.0)
            area = 0.5 * m.length(m.cross(sf["e1"], sf["e2"]))
            pdf_geo = ((1.0 / torch.clamp_min(sf["light_n"], 1.0))
                       * (1.0 / torch.clamp_min(area, 1e-20))
                       * d * d / torch.clamp_min(cos_light, 1e-20))
            total_all = w_base.sum(-1)
            w_this = w_base.gather(1, torch.clamp(li, 0, nl - 1)[:, None])[:, 0]
            sel = torch.where(total_all > 0.0,
                              w_this / torch.clamp_min(total_all, 1e-20), 0.0)
            mis_w = m.mis_power(st["prev_pdf"], sel * pdf_geo)
            contrib = tp * em_color * (
                em_power * mis_w
                / torch.clamp_min(1.0 - st["p_light"], 1e-20))[:, None]
            color = torch.where(add_mis[:, None], color + contrib, color)

        ok = (pdf > 0.0) & (wi_s[:, 2] > 0.0)
        new_dir = m.to_world(wi_s, basis)
        tp_mult = (wi_s[:, 2] / pdf)[:, None] * value
        new_spec, new_pdf, channel = is_spec, pdf, st["channel"]
        if cfg["enable_transmission"]:
            d_dir, d_tp, d_channel, d_seed = self.dielectric(
                ray_dir, nrm, sf["front"], albedo, ior, transm, disp,
                st["channel"], seed, dielectric)
            seed = torch.where(dielectric, d_seed, seed_surf)
            new_dir = torch.where(dielectric[:, None], d_dir, new_dir)
            tp_mult = torch.where(dielectric[:, None], d_tp, tp_mult)
            ok = torch.where(dielectric, True, ok)
            new_spec = dielectric | is_spec
            new_pdf = torch.where(dielectric, 1.0, pdf)
            channel = torch.where(dielectric, d_channel, st["channel"])
        else:
            seed = seed_surf

        upd = lane & ok
        st["throughput"] = torch.where(upd[:, None], tp * tp_mult, tp)
        st["origin"] = torch.where(upd[:, None], pos, st["origin"])
        st["direction"] = torch.where(upd[:, None], new_dir, ray_dir)
        st["color"] = torch.where(lane[:, None], color, st["color"])
        st["seed"] = torch.where(lane, seed, st["seed"])
        st["first"] = st["first"] & ~lane
        st["specular"] = torch.where(upd, new_spec, st["specular"])
        st["prev_pdf"] = torch.where(upd, new_pdf, st["prev_pdf"])
        st["prev_pos"] = torch.where(upd[:, None], pos, st["prev_pos"])
        st["p_light"] = torch.where(lane, p_light, st["p_light"])
        st["did_direct"] = torch.where(lane, did_direct, st["did_direct"])
        st["channel"] = channel
        return upd

    def dielectric(self, ray_dir, normal, front, albedo, ior, transmission,
                   dispersion, channel, seed, active):
        """A smooth dielectric's reflection or refraction (two draws, one
        more for the channel of the first dispersive refraction)."""
        dt = self.s.dt
        dispersive = dispersion > 0.0
        need = active & dispersive & (channel < 0)
        r_chan, seed = m.rnd_masked(seed, need, dt)
        picked = torch.clamp_max((r_chan * 3.0).to(torch.int64), 2)
        channel = torch.where(need, picked, channel)
        spread = (ior - 1.0) * dispersion / 20.0
        off = torch.where(channel == 0, -0.5,
                          torch.where(channel == 2, 0.5, 0.0)).to(dt)
        ior = torch.where(dispersive & (channel >= 0), ior + off * spread,
                          ior)
        r_lot, seed = m.rnd_masked(seed, active, dt)
        r_fre, seed = m.rnd_masked(seed, active, dt)
        eta = torch.where(front, 1.0 / ior, ior)
        cos_i = torch.clamp(m.dot(-ray_dir, normal), 0.0, 1.0)
        sin2_t = eta * eta * torch.clamp_min(1.0 - cos_i * cos_i, 0.0)
        tir = sin2_t > 1.0
        cos_t = torch.sqrt(torch.clamp_min(1.0 - sin2_t, 0.0))
        f0 = ((ior - 1.0) / (ior + 1.0)) ** 2
        fres = torch.where(tir, 1.0,
                           f0 + (1.0 - f0) * torch.pow(1.0 - cos_i, 5.0))
        refl = m.normalize(ray_dir + 2.0 * cos_i[:, None] * normal)
        refr = m.normalize(eta[:, None] * ray_dir
                           + (eta * cos_i - cos_t)[:, None] * normal)
        reflect = ~(r_lot < transmission) | (r_fre < fres)
        new_dir = torch.where(reflect[:, None], refl, refr)
        tp = torch.where(reflect[:, None], torch.ones_like(albedo), albedo)
        onehot = (torch.arange(3, device=channel.device)[None, :]
                  == channel[:, None]).to(dt) * 3.0
        tp = torch.where(need[:, None], tp * onehot, tp)
        return new_dir, tp, channel, seed


def final_radiance(color, clamp):
    final = torch.clamp_max(color, clamp)
    bad = (torch.isnan(final) | torch.isinf(final)).any(-1)
    return torch.where(bad[:, None], 0.0, final)


def running_mean(radiance):
    """The progressive accumulation of per-frame radiance [F, n, 3] (frame
    0 first): frame 0 stores, frame f blends with weight 1/(f+1)."""
    acc = radiance[0]
    for f in range(1, radiance.shape[0]):
        a = 1.0 / (torch.tensor(float(f), dtype=torch.float32) + 1.0)
        acc = acc + (radiance[f] - acc) * a.to(radiance.device, acc.dtype)
    return acc
