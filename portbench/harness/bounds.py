"""Published peaks of the card and the bytes a traversal launch cannot do
without, for the kernels' roofline shares.

A launch's least traffic is what its rays and the scene fix, whatever
tree or walk implements it: each live lane's inputs read once (origin and
direction 24 B, t_max 4 B, and the occlusion kernel's skip object 4 B)
and its outputs written once (closest hit: t, triangle, u, v 16 B;
occlusion: one byte), a dead lane's t_max and outputs, and the scene's
triangles once (three float32 3-vectors, 36 B; the occlusion kernel also
reads each triangle's object, 4 B). Node arrays are not counted: they
belong to one tree among many.
"""

from __future__ import annotations

# NVIDIA H100 SXM (80 GB HBM3), data sheet, at its 700 W limit.
PEAK_BYTES_PER_S = 3.35e12

_CALL = {  # (live lane bytes, dead lane bytes, bytes a triangle)
    "intersect_quad": (24 + 4 + 16, 4 + 16, 36),
    "occlusion_quad": (24 + 4 + 4 + 1, 4 + 1, 40),
}


def traversal_bytes(calls, num_triangles: int) -> int:
    """Least bytes of the traversal launches `calls` [(name, lanes,
    live)] on a scene of `num_triangles` triangles."""
    total = 0
    for name, lanes, live in calls:
        live_b, dead_b, tri_b = _CALL[name]
        total += live * live_b + (lanes - live) * dead_b + (
            num_triangles * tri_b)
    return total


def bound_seconds(nbytes: int) -> float:
    return nbytes / PEAK_BYTES_PER_S
