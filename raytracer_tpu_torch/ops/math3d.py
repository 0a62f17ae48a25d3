"""Vector math for the shading and sampling code (port of
raytracer_tpu/ops/math3d.py).

Every function takes tensors with leading batch dimensions and the 3-vector
in the trailing axis. Dot products and cross products are written out
component by component, left to right: the same rounding on the CPU and on
the card, and the order XLA's reduce of three terms uses.
"""

from __future__ import annotations

import torch

EPS = 1e-8


def dot(a, b):
    """Batched dot product over the trailing axis, keepdims=False."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def dot_k(a, b):
    """Batched dot product, keepdims=True (for broadcasting against vec3s)."""
    return dot(a, b)[..., None]


def cross(a, b):
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1
    )


def length(v):
    return torch.sqrt(torch.clamp_min(dot(v, v), 0.0))


def normalize(v, eps: float = EPS):
    return v / torch.clamp_min(length(v), eps)[..., None]


def reflect(i, n):
    """GLSL reflect: i - 2*dot(n,i)*n (i points toward the surface)."""
    return i - 2.0 * dot_k(n, i) * n


def luminance_rec709(color):
    """Rec.709 luma, used by Russian roulette (simple.rgen:59)."""
    return color[..., 0] * 0.2126 + color[..., 1] * 0.7152 \
        + color[..., 2] * 0.0722


def luminance_rec601(color):
    """Rec.601 luma, the rchit 'luminance' helper (simple.rchit:113-115):
    ReSTIR's target pdf."""
    return color[..., 0] * 0.299 + color[..., 1] * 0.587 \
        + color[..., 2] * 0.114


def mis_weight_power(pdf1, pdf2):
    """Guarded power heuristic (simple.rchit:234-237): 0 if either pdf<=0."""
    a2 = pdf1 * pdf1
    w = a2 / torch.clamp_min(a2 + pdf2 * pdf2, 1e-30)
    return torch.where((pdf1 <= 0.0) | (pdf2 <= 0.0), 0.0, w)


def make_basis(normal):
    """Orthonormal basis with `normal` as the z-axis (createBasis,
    math.glsl:9-15). Returns (t, b, n)."""
    n = normalize(normal)
    use_y = torch.abs(n[..., 0:1]) > 0.9
    ey = n.new_tensor([0.0, 1.0, 0.0])
    ex = n.new_tensor([1.0, 0.0, 0.0])
    a = torch.where(use_y, ey, ex)
    axis1 = normalize(cross(n, a))
    axis0 = cross(n, axis1)
    return axis0, axis1, n


def world_to_local(v, basis):
    """Project a world vector onto the basis rows (math.glsl:18-24)."""
    t, b, n = basis
    return torch.stack([dot(v, t), dot(v, b), dot(v, n)], dim=-1)


def local_to_world(v, basis):
    """math.glsl:27-29."""
    t, b, n = basis
    return t * v[..., 0:1] + b * v[..., 1:2] + n * v[..., 2:3]


def cos_theta(w):
    """z component in the local shading frame (math.glsl:31-33)."""
    return w[..., 2]


def max3(v):
    """Max over the trailing 3-vector (math.glsl:39-41)."""
    return torch.amax(v, dim=-1)


def smoothstep(edge0, edge1, x):
    t = torch.clamp((x - edge0) / (edge1 - edge0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)
