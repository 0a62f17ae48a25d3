"""GGX metallic-roughness BRDF: evaluation, sampling, pdfs (port of
raytracer_tpu/ops/brdf.py, every constant and branch kept).

  - D_GGX with MIN_ROUGHNESS=0.02 floor          (simple.rchit:77-83)
  - Smith G1*G1 with k = a/2                      (simple.rchit:85-93)
  - Schlick Fresnel, F0 = mix(0.04, albedo, metal)(simple.rchit:96-98)
  - Lambert diffuse * (1 - F) * (1 - metallic)    (simple.rchit:143-147)
  - specular-vs-diffuse lottery probability       (simple.rchit:69-75)
  - GGX half-vector sampling (a = roughness^2)    (simple.rchit:202-217)
  - cosine-weighted diffuse sampling              (simple.rchit:100-110)
  - combined pdf p_spec*pdf_spec + (1-p)*pdf_diff (simple.rchit:443-448)
  - below-horizon specular falls back to diffuse  (simple.rchit:412-423)

All functions work in the local shading frame (normal = +z) on f32 tensors
with leading batch dimensions.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from raytracer_tpu_torch.ops import rng
from raytracer_tpu_torch.ops.math3d import (
    cos_theta,
    dot,
    max3,
    normalize,
    reflect,
    smoothstep,
)

M_PI = 3.14159265359  # math.glsl:1 (the reference's value, not pi)

EPS_PDF = 1e-6  # simple.rchit:63
EPS_COS = 1e-4  # simple.rchit:64
EPS_VOH = 1e-4  # simple.rchit:65
MIN_ROUGHNESS = 0.02  # simple.rchit:66


def f0_from_material(albedo, metallic):
    """F0 = mix(0.04, albedo, metallic) (simple.rchit:70,140)."""
    return 0.04 + (albedo - 0.04) * metallic[..., None]


def specular_probability(albedo, roughness, metallic):
    """Spec-vs-diffuse lottery probability (simple.rchit:69-75)."""
    base = max3(f0_from_material(albedo, metallic))
    influence = smoothstep(0.0, 1.0, roughness * 0.7)
    return base + (base * 0.5 - base) * influence  # mix(base, base*0.5, t)


def d_ggx(n_dot_h, roughness):
    """GGX NDF with alpha = max(roughness, MIN_ROUGHNESS)."""
    a = torch.clamp_min(roughness, MIN_ROUGHNESS)
    a2 = a * a
    nh = torch.clamp(n_dot_h, 0.0, 1.0)
    denom = nh * nh * (a2 - 1.0) + 1.0
    return a2 / (M_PI * denom * denom)


def g_smith(n_dot_v, n_dot_l, roughness):
    """Smith G1*G1 with k = a/2."""
    a = torch.clamp_min(roughness, MIN_ROUGHNESS)
    k = a * 0.5
    nv = torch.clamp(n_dot_v, EPS_COS, 1.0)
    nl = torch.clamp(n_dot_l, EPS_COS, 1.0)
    g1v = nv / (nv * (1.0 - k) + k)
    g1l = nl / (nl * (1.0 - k) + k)
    return g1v * g1l


def f_schlick(f0, v_dot_h):
    """Schlick Fresnel."""
    p = torch.pow(torch.clamp(1.0 - v_dot_h, 0.0, 1.0), 5.0)
    return f0 + (1.0 - f0) * p[..., None]


class BRDFEval(NamedTuple):
    diffuse: torch.Tensor  # [..., 3]
    specular: torch.Tensor  # [..., 3]
    diffuse_pdf: torch.Tensor  # [...]
    specular_pdf: torch.Tensor  # [...]


def evaluate_components(wo, wi, albedo, roughness, metallic) -> BRDFEval:
    """evaluateBRDFComponents (simple.rchit:118-160); zero everything when
    either direction is below the horizon."""
    n_dot_l = cos_theta(wi)
    n_dot_v = cos_theta(wo)
    valid = (n_dot_l > 0.0) & (n_dot_v > 0.0)

    h = normalize(wo + wi)
    n_dot_h = cos_theta(h)
    v_dot_h = dot(wo, h)

    f0 = f0_from_material(albedo, metallic)
    f = f_schlick(f0, v_dot_h)

    diffuse_albedo = albedo * (1.0 - metallic)[..., None]
    diffuse = diffuse_albedo * (1.0 - f) / M_PI
    diffuse_pdf = n_dot_l / M_PI

    d = d_ggx(n_dot_h, roughness)
    g = g_smith(n_dot_v, n_dot_l, roughness)
    denom = 4.0 * torch.clamp_min(n_dot_v * n_dot_l, 1e-12)
    specular = (d * g / denom)[..., None] * f
    specular_pdf = d * n_dot_h / (4.0 * torch.clamp_min(v_dot_h, 1e-12))

    vm = valid[..., None]
    return BRDFEval(
        diffuse=torch.where(vm, diffuse, 0.0),
        specular=torch.where(vm, specular, 0.0),
        diffuse_pdf=torch.where(valid, diffuse_pdf, 0.0),
        specular_pdf=torch.where(valid, specular_pdf, 0.0),
    )


def evaluate_full(wo, wi, albedo, roughness, metallic):
    """evaluateFullBRDF (simple.rchit:163-166): diffuse + specular."""
    ev = evaluate_components(wo, wi, albedo, roughness, metallic)
    return ev.diffuse + ev.specular


def microfacet_f(wo, wi, h, albedo, roughness, metallic):
    """Cook-Torrance specular lobe only (simple.rchit:168-193)."""
    n_dot_l = cos_theta(wi)
    n_dot_v = cos_theta(wo)
    valid = (n_dot_l > 0.0) & (n_dot_v > 0.0)
    d = d_ggx(cos_theta(h), roughness)
    g = g_smith(n_dot_v, n_dot_l, roughness)
    f = f_schlick(f0_from_material(albedo, metallic), dot(wo, h))
    denom = 4.0 * torch.clamp_min(n_dot_v * n_dot_l, 1e-12)
    return torch.where(valid[..., None], (d * g / denom)[..., None] * f, 0.0)


def microfacet_pdf(wo, h, roughness):
    """Half-vector pdf converted to wi measure (simple.rchit:195-200)."""
    nh = torch.clamp_min(cos_theta(h), EPS_COS)
    voh = torch.clamp_min(dot(wo, h), EPS_VOH)
    d = d_ggx(nh, roughness)
    return torch.clamp_min(d * nh / (4.0 * voh), EPS_PDF)


def sample_ggx(r1, r2, roughness):
    """GGX half-vector sample, local frame, alpha = roughness^2."""
    a = roughness * roughness
    phi = 2.0 * M_PI * r1
    cos_t = torch.sqrt(
        (1.0 - r2) / torch.clamp_min(1.0 + (a * a - 1.0) * r2, 1e-12))
    sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    return torch.stack(
        [sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t], dim=-1
    )


def sample_cosine(r1, r2):
    """Cosine-weighted hemisphere sample, local frame."""
    phi = 2.0 * M_PI * r1
    cos_t = torch.sqrt(r2)
    sin_t = torch.sqrt(torch.clamp_min(1.0 - r2, 0.0))
    return torch.stack(
        [torch.cos(phi) * sin_t, torch.sin(phi) * sin_t, cos_t], dim=-1
    )


class BSDFSample(NamedTuple):
    direction: torch.Tensor  # [..., 3] local frame
    value: torch.Tensor  # [..., 3] BRDF value (no cosine)
    pdf: torch.Tensor  # [...]
    is_specular: torch.Tensor  # [...] bool


def _diffuse_value(wo, wi, albedo, metallic):
    """Diffuse lobe with Fresnel damping, as inside sampleBRDF."""
    h = normalize(wo + wi)
    v_dot_h = torch.clamp(dot(wo, h), 0.0, 1.0)
    f = f_schlick(f0_from_material(albedo, metallic), v_dot_h)
    diffuse_albedo = albedo * (1.0 - metallic)[..., None]
    return diffuse_albedo * (1.0 - f) / M_PI


def sample_brdf(wo, albedo, roughness, metallic, seed) -> tuple:
    """sampleBRDF (simple.rchit:403-449) in lockstep form: draws (r1, r2)
    then the lobe lottery from `seed`. Returns (BSDFSample, new_seed)."""
    r1, seed = rng.rnd(seed)
    r2, seed = rng.rnd(seed)
    lottery, seed = rng.rnd(seed)

    p_spec = specular_probability(albedo, roughness, metallic)
    take_spec = lottery < p_spec

    h = sample_ggx(r1, r2, roughness)
    wi_spec = reflect(-wo, h)
    spec_ok = cos_theta(wi_spec) > 0.0

    wi_diff = sample_cosine(r1, r2)

    use_spec = take_spec & spec_ok
    wi = torch.where(use_spec[..., None], wi_spec, wi_diff)

    value_spec = microfacet_f(wo, wi_spec, h, albedo, roughness, metallic)
    value_diff = _diffuse_value(wo, wi, albedo, metallic)
    value = torch.where(use_spec[..., None], value_spec, value_diff)

    h_final = normalize(wo + wi)
    spec_pdf = microfacet_pdf(wo, h_final, roughness)
    diff_pdf = torch.clamp_min(cos_theta(wi), 0.0) / M_PI
    pdf = p_spec * spec_pdf + (1.0 - p_spec) * diff_pdf
    pdf = torch.clamp_min(pdf, EPS_PDF)

    return BSDFSample(direction=wi, value=value, pdf=pdf,
                      is_specular=use_spec), seed
