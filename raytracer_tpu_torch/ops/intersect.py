"""Ray-triangle intersection: batched Möller–Trumbore and the O(T) oracle
(port of raytracer_tpu/ops/intersect.py).

  - `intersect_brute`: every triangle against every ray, in triangle chunks
    so the [R, CHUNK] broadcast stays bounded: the correctness oracle and
    accel="brute".
  - `occlusion_brute`: the any-hit variant for NEE shadow rays, ignoring the
    triangles of each ray's `skip_object` (the sampled light).

The BVH versions with the same interfaces are in ops/quad_traverse.py.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from raytracer_tpu_torch.ops.math3d import cross, dot

EPS_DET = 1e-10


class HitRecord(NamedTuple):
    t: torch.Tensor  # f32[R] hit distance (t_max when missed)
    tri: torch.Tensor  # i32[R] triangle index (-1 when missed)
    u: torch.Tensor  # f32[R] barycentric of v1
    v: torch.Tensor  # f32[R] barycentric of v2
    hit: torch.Tensor  # bool[R]


def moller_trumbore(origin, direction, v0, e1, e2, t_min, t_max):
    """Double-sided Möller–Trumbore. All args broadcast; returns (t, u, v,
    valid). `t_max` may be per-ray (the current closest hit)."""
    pvec = cross(direction, e2)
    det = dot(e1, pvec)
    inv_det = torch.where(torch.abs(det) > EPS_DET, 1.0 / det, 0.0)
    tvec = origin - v0
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    v = dot(direction, qvec) * inv_det
    t = dot(e2, qvec) * inv_det
    valid = (
        (torch.abs(det) > EPS_DET)
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > t_min)
        & (t < t_max)
    )
    return t, u, v, valid


def _pick_chunk(t_total: int, preferred: int) -> int:
    """Largest divisor of t_total that is <= preferred (the bake pads
    triangle counts to a multiple of 128, so 128 always qualifies)."""
    c = min(preferred, t_total)
    while c > 1 and t_total % c:
        c -= 1
    return c


def intersect_brute(origin, direction, tri_v0, tri_e1, tri_e2,
                    t_min: float, t_max: float,
                    chunk_size: int = 512) -> HitRecord:
    """Closest hit over all triangles. origin/direction f32[R,3]; triangle
    arrays f32[T,3]. Within a chunk the first minimal t wins; across chunks
    only a strictly smaller t replaces the best (the JAX scan's rule)."""
    r = origin.shape[0]
    dev = origin.device
    t_total = tri_v0.shape[0]
    chunk_size = _pick_chunk(t_total, chunk_size)
    best_t = torch.full((r,), float(t_max), dtype=torch.float32, device=dev)
    best_tri = torch.full((r,), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros((r,), dtype=torch.float32, device=dev)
    best_v = torch.zeros((r,), dtype=torch.float32, device=dev)
    rows = torch.arange(r, device=dev)
    o = origin[:, None, :]
    d = direction[:, None, :]
    for start in range(0, t_total, chunk_size):
        sl = slice(start, start + chunk_size)
        t, u, v, valid = moller_trumbore(
            o, d, tri_v0[None, sl], tri_e1[None, sl], tri_e2[None, sl],
            t_min, best_t[:, None],
        )
        t = torch.where(valid, t, torch.inf)
        k = torch.argmin(t, dim=1)
        tk = t[rows, k]
        improved = tk < best_t
        best_t = torch.where(improved, tk, best_t)
        best_u = torch.where(improved, u[rows, k], best_u)
        best_v = torch.where(improved, v[rows, k], best_v)
        best_tri = torch.where(improved, (k + start).to(torch.int32),
                               best_tri)
    return HitRecord(t=best_t, tri=best_tri, u=best_u, v=best_v,
                     hit=best_tri >= 0)


def occlusion_brute(origin, direction, t_min, t_max, tri_v0, tri_e1, tri_e2,
                    tri_object, skip_object, chunk_size: int = 512):
    """Any-hit test: True where the segment (t_min, t_max) is blocked by a
    triangle NOT belonging to `skip_object` (i32[R]). t_max is f32[R]."""
    t_total = tri_v0.shape[0]
    chunk_size = _pick_chunk(t_total, chunk_size)
    occluded = torch.zeros(origin.shape[0], dtype=torch.bool,
                           device=origin.device)
    o = origin[:, None, :]
    d = direction[:, None, :]
    for start in range(0, t_total, chunk_size):
        sl = slice(start, start + chunk_size)
        _, _, _, valid = moller_trumbore(
            o, d, tri_v0[None, sl], tri_e1[None, sl], tri_e2[None, sl],
            t_min, t_max[:, None],
        )
        relevant = valid & (tri_object[None, sl] != skip_object[:, None])
        occluded = occluded | relevant.any(dim=1)
    return occluded
