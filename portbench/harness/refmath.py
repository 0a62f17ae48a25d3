"""The arithmetic of the plain reference: the per-pixel random streams, the
vector helpers and the GGX metallic-roughness BRDF, written out in the
operation order of the renderer's shaders (frozen copies), in a float
dtype of the caller's choice (float32 for the reference, a lower one for
the control).

Random streams: seed = TEA-16(pixel, frame), then a Numerical-Recipes LCG
(a = 1664525, c = 1013904223), a draw being (state & 0xFFFFFF) / 2^24.
A uint32 lives in an int64 tensor in [0, 2^32).
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
M_PI = 3.14159265359  # the shaders' value
EPS_PDF = 1e-6
EPS_COS = 1e-4
EPS_VOH = 1e-4
MIN_ROUGHNESS = 0.02


def tea(v0, v1):
    v0 = v0 & M32
    v1 = v1 & M32
    s0 = 0
    for _ in range(16):
        s0 = (s0 + 0x9E3779B9) & M32
        v0 = (v0 + ((((v1 << 4) + 0xA341316C) & M32) ^ ((v1 + s0) & M32)
                    ^ ((v1 >> 5) + 0xC8013EA4))) & M32
        v1 = (v1 + ((((v0 << 4) + 0xAD90777D) & M32) ^ ((v0 + s0) & M32)
                    ^ ((v0 >> 5) + 0x7E95761E))) & M32
    return v0


def rnd(state, dt):
    """(a draw in [0, 1) as dt, the advanced state)."""
    new = (state * 1664525 + 1013904223) & M32
    sample = ((new & 0x00FFFFFF).to(torch.float32)
              * (1.0 / float(0x01000000))).to(dt)
    return sample, new


def rnd_masked(state, mask, dt):
    """A draw; the state advances only where `mask` holds."""
    sample, new = rnd(state, dt)
    return sample, torch.where(mask, new, state)


def dot(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def cross(a, b):
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def length(v):
    return torch.sqrt(torch.clamp_min(dot(v, v), 0.0))


def normalize(v, eps: float = 1e-8):
    return v / torch.clamp_min(length(v), eps)[..., None]


def make_basis(normal):
    n = normalize(normal)
    use_y = torch.abs(n[..., 0:1]) > 0.9
    a = torch.where(use_y, n.new_tensor([0.0, 1.0, 0.0]),
                    n.new_tensor([1.0, 0.0, 0.0]))
    axis1 = normalize(cross(n, a))
    axis0 = cross(n, axis1)
    return axis0, axis1, n


def to_local(v, basis):
    t, b, n = basis
    return torch.stack([dot(v, t), dot(v, b), dot(v, n)], dim=-1)


def to_world(v, basis):
    t, b, n = basis
    return t * v[..., 0:1] + b * v[..., 1:2] + n * v[..., 2:3]


def luminance709(c):
    return c[..., 0] * 0.2126 + c[..., 1] * 0.7152 + c[..., 2] * 0.0722


def luminance601(c):
    return c[..., 0] * 0.299 + c[..., 1] * 0.587 + c[..., 2] * 0.114


def mis_power(pdf1, pdf2):
    a2 = pdf1 * pdf1
    w = a2 / torch.clamp_min(a2 + pdf2 * pdf2, 1e-30)
    return torch.where((pdf1 <= 0.0) | (pdf2 <= 0.0), 0.0, w)


def _smoothstep(e0, e1, x):
    t = torch.clamp((x - e0) / (e1 - e0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def _reflect(i, n):
    return i - 2.0 * dot(n, i)[..., None] * n


def f0_of(albedo, metallic):
    return 0.04 + (albedo - 0.04) * metallic[..., None]


def spec_probability(albedo, roughness, metallic):
    base = torch.amax(f0_of(albedo, metallic), dim=-1)
    influence = _smoothstep(0.0, 1.0, roughness * 0.7)
    return base + (base * 0.5 - base) * influence


def d_ggx(n_dot_h, roughness):
    a = torch.clamp_min(roughness, MIN_ROUGHNESS)
    a2 = a * a
    nh = torch.clamp(n_dot_h, 0.0, 1.0)
    denom = nh * nh * (a2 - 1.0) + 1.0
    return a2 / (M_PI * denom * denom)


def g_smith(n_dot_v, n_dot_l, roughness):
    a = torch.clamp_min(roughness, MIN_ROUGHNESS)
    k = a * 0.5
    nv = torch.clamp(n_dot_v, EPS_COS, 1.0)
    nl = torch.clamp(n_dot_l, EPS_COS, 1.0)
    return (nv / (nv * (1.0 - k) + k)) * (nl / (nl * (1.0 - k) + k))


def f_schlick(f0, v_dot_h):
    p = torch.pow(torch.clamp(1.0 - v_dot_h, 0.0, 1.0), 5.0)
    return f0 + (1.0 - f0) * p[..., None]


def brdf_eval(wo, wi, albedo, roughness, metallic):
    """Diffuse + specular GGX value; zero below either horizon."""
    n_dot_l = wi[..., 2]
    n_dot_v = wo[..., 2]
    valid = (n_dot_l > 0.0) & (n_dot_v > 0.0)
    h = normalize(wo + wi)
    n_dot_h = h[..., 2]
    v_dot_h = dot(wo, h)
    f = f_schlick(f0_of(albedo, metallic), v_dot_h)
    diffuse = albedo * (1.0 - metallic)[..., None] * (1.0 - f) / M_PI
    d = d_ggx(n_dot_h, roughness)
    g = g_smith(n_dot_v, n_dot_l, roughness)
    denom = 4.0 * torch.clamp_min(n_dot_v * n_dot_l, 1e-12)
    specular = (d * g / denom)[..., None] * f
    vm = valid[..., None]
    return torch.where(vm, diffuse, 0.0) + torch.where(vm, specular, 0.0)


def microfacet_f(wo, wi, h, albedo, roughness, metallic):
    n_dot_l = wi[..., 2]
    n_dot_v = wo[..., 2]
    valid = (n_dot_l > 0.0) & (n_dot_v > 0.0)
    d = d_ggx(h[..., 2], roughness)
    g = g_smith(n_dot_v, n_dot_l, roughness)
    f = f_schlick(f0_of(albedo, metallic), dot(wo, h))
    denom = 4.0 * torch.clamp_min(n_dot_v * n_dot_l, 1e-12)
    return torch.where(valid[..., None], (d * g / denom)[..., None] * f, 0.0)


def microfacet_pdf(wo, h, roughness):
    nh = torch.clamp_min(h[..., 2], EPS_COS)
    voh = torch.clamp_min(dot(wo, h), EPS_VOH)
    return torch.clamp_min(d_ggx(nh, roughness) * nh / (4.0 * voh), EPS_PDF)


def sample_brdf(wo, albedo, roughness, metallic, seed, dt):
    """Three draws (r1, r2, lobe lottery): (direction, value, pdf,
    is_specular, new seed), local frame."""
    r1, seed = rnd(seed, dt)
    r2, seed = rnd(seed, dt)
    lottery, seed = rnd(seed, dt)
    p_spec = spec_probability(albedo, roughness, metallic)
    take_spec = lottery < p_spec

    a = roughness * roughness
    phi = 2.0 * M_PI * r1
    cos_t = torch.sqrt((1.0 - r2)
                       / torch.clamp_min(1.0 + (a * a - 1.0) * r2, 1e-12))
    sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    h = torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t],
                    dim=-1)
    wi_spec = _reflect(-wo, h)
    spec_ok = wi_spec[..., 2] > 0.0

    cos_d = torch.sqrt(r2)
    sin_d = torch.sqrt(torch.clamp_min(1.0 - r2, 0.0))
    wi_diff = torch.stack([torch.cos(phi) * sin_d, torch.sin(phi) * sin_d,
                           cos_d], dim=-1)

    use_spec = take_spec & spec_ok
    wi = torch.where(use_spec[..., None], wi_spec, wi_diff)
    value_spec = microfacet_f(wo, wi_spec, h, albedo, roughness, metallic)
    hd = normalize(wo + wi)
    vdh = torch.clamp(dot(wo, hd), 0.0, 1.0)
    fd = f_schlick(f0_of(albedo, metallic), vdh)
    value_diff = albedo * (1.0 - metallic)[..., None] * (1.0 - fd) / M_PI
    value = torch.where(use_spec[..., None], value_spec, value_diff)

    h_final = normalize(wo + wi)
    spec_pdf = microfacet_pdf(wo, h_final, roughness)
    diff_pdf = torch.clamp_min(wi[..., 2], 0.0) / M_PI
    pdf = torch.clamp_min(p_spec * spec_pdf + (1.0 - p_spec) * diff_pdf,
                          EPS_PDF)
    return wi, value, pdf, use_spec, seed
