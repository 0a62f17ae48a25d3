"""The reference's own intersection structure, built from the triangles it
is handed and nothing of the program's bake.

Triangles whose box spans more than a sixteenth of the scene are tested
against every ray (walls, floors: a handful). The rest sit in a binary
tree over their Morton order (30-bit centroid codes), laid out as an
implicit heap: leaf i of 2^k holds `leaf` consecutive triangles, node j
has children 2j and 2j + 1. Boxes are float32 and widened by a margin, so
the culling is conservative; the triangle test (Möller–Trumbore, double
sided, in the renderer's operation order) runs in the caller's dtype.

The walk is one masked step a loop iteration for every ray still on its
stack: pop a node; an internal one pushes its hit children, the nearer
on top; a leaf tests its triangles. Plain torch, so it runs on any device.
"""

from __future__ import annotations

import numpy as np
import torch

EPS_DET = 1e-10
STACK = 64


def _spread10(q):
    q = q & 0x3FF
    q = (q | (q << 16)) & 0x030000FF
    q = (q | (q << 8)) & 0x0300F00F
    q = (q | (q << 4)) & 0x030C30C3
    q = (q | (q << 2)) & 0x09249249
    return q


def moller(o, d, v0, e1, e2, t_min, t_max):
    """(t, u, v, valid) of rays against triangles; everything broadcasts."""
    px = d[..., 1] * e2[..., 2] - d[..., 2] * e2[..., 1]
    py = d[..., 2] * e2[..., 0] - d[..., 0] * e2[..., 2]
    pz = d[..., 0] * e2[..., 1] - d[..., 1] * e2[..., 0]
    det = e1[..., 0] * px + e1[..., 1] * py + e1[..., 2] * pz
    ok = torch.abs(det) > EPS_DET
    inv_det = torch.where(ok, 1.0 / det, 0.0)
    tx = o[..., 0] - v0[..., 0]
    ty = o[..., 1] - v0[..., 1]
    tz = o[..., 2] - v0[..., 2]
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1[..., 2] - tz * e1[..., 1]
    qy = tz * e1[..., 0] - tx * e1[..., 2]
    qz = tx * e1[..., 1] - ty * e1[..., 0]
    v = (d[..., 0] * qx + d[..., 1] * qy + d[..., 2] * qz) * inv_det
    t = (e2[..., 0] * qx + e2[..., 1] * qy + e2[..., 2] * qz) * inv_det
    valid = (ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > t_min)
             & (t < t_max))
    return t, u, v, valid


class RefBVH:
    def __init__(self, v0, e1, e2, tri_object, device, dt=torch.float32,
                 leaf=8):
        """v0, e1, e2: float32 numpy [T,3]; tri_object: int [T]."""
        p1, p2 = v0 + e1, v0 + e2
        lo = np.minimum(np.minimum(v0, p1), p2)
        hi = np.maximum(np.maximum(v0, p1), p2)
        s_lo, s_hi = lo.min(0), hi.max(0)
        ext = float((s_hi - s_lo).max())
        big = (hi - lo).max(1) > ext / 16.0
        rest = np.nonzero(~big)[0]
        cen = (lo[rest] + hi[rest]) * 0.5
        q = np.clip((cen - s_lo) / max(ext, 1e-6) * 1023.0, 0, 1023).astype(
            np.int64)
        code = _spread10(q[:, 0]) | (_spread10(q[:, 1]) << 1) | (
            _spread10(q[:, 2]) << 2)
        ids = rest[np.argsort(code, kind="stable")]
        n_leaf = max(1, -(-len(ids) // leaf))
        n_leaf = 1 << (n_leaf - 1).bit_length()
        slots = np.full(n_leaf * leaf, -1, np.int64)
        slots[:len(ids)] = ids
        slots = slots.reshape(n_leaf, leaf)
        valid = slots >= 0
        safe = np.where(valid, slots, 0)
        box_lo = np.where(valid[..., None], lo[safe], np.inf).min(1)
        box_hi = np.where(valid[..., None], hi[safe], -np.inf).max(1)
        nodes_lo = np.full((2 * n_leaf, 3), np.inf, np.float32)
        nodes_hi = np.full((2 * n_leaf, 3), -np.inf, np.float32)
        nodes_lo[n_leaf:] = box_lo
        nodes_hi[n_leaf:] = box_hi
        for j in range(n_leaf - 1, 0, -1):
            nodes_lo[j] = np.minimum(nodes_lo[2 * j], nodes_lo[2 * j + 1])
            nodes_hi[j] = np.maximum(nodes_hi[2 * j], nodes_hi[2 * j + 1])
        # An empty node (padding leaves and the nodes above only them)
        # becomes a point far beyond any ray's reach.
        empty = ~(nodes_lo <= nodes_hi).all(1)
        nodes_lo[empty] = 1e30
        nodes_hi[empty] = 1e30
        margin = 1e-4 * ext + 1e-6
        self.n_leaf = n_leaf
        self.leaf = leaf
        self.dt = dt
        to = dict(device=device)
        self.lo = torch.from_numpy(nodes_lo - margin).to(**to)
        self.hi = torch.from_numpy(nodes_hi + margin).to(**to)
        self.slots = torch.from_numpy(slots).to(**to)
        self.big = torch.from_numpy(np.nonzero(big)[0]).to(**to)
        tri = np.concatenate([v0, e1, e2], axis=1).astype(np.float32)
        # One zero row after the triangles: the padding slots' target.
        tri = np.concatenate([tri, np.zeros((1, 9), np.float32)])
        self.tri = torch.from_numpy(tri).to(device=device, dtype=dt)
        obj = np.concatenate([np.asarray(tri_object, np.int64), [-1]])
        self.obj = torch.from_numpy(obj).to(**to)
        self.pad = len(v0)

    def _rows(self, tris):
        r = self.tri[torch.where(tris >= 0, tris, self.pad)]
        return r[..., 0:3], r[..., 3:6], r[..., 6:9]

    def _slab(self, o, inv, nodes, t_lo, t_hi):
        lo, hi = self.lo[nodes], self.hi[nodes]
        t0 = (lo - o) * inv
        t1 = (hi - o) * inv
        tn = torch.clamp_min(torch.minimum(t0, t1).amax(-1), t_lo)
        tf = torch.maximum(t0, t1).amin(-1)
        return (tn <= tf) & (tn < t_hi), tn

    def closest(self, o, d, t_min, t_max):
        """(t, tri, u, v, hit) of the nearest hit in (t_min, t_max); t_max
        a float or [R]; tri the triangle's index, -1 on a miss."""
        dt, dev = self.dt, o.device
        r = o.shape[0]
        best_t = torch.as_tensor(t_max, dtype=dt, device=dev).expand(
            r).clone()
        best_tri = torch.full((r,), -1, dtype=torch.int64, device=dev)
        best_u = torch.zeros((r,), dtype=dt, device=dev)
        best_v = torch.zeros((r,), dtype=dt, device=dev)
        rows = torch.arange(r, device=dev)

        def consider(ray, tris):
            """Test rays `ray` against their candidate triangles tris [k,m]
            and keep an improvement (the first least t of the row)."""
            v0, e1, e2 = self._rows(tris)
            t, u, v, ok = moller(o[ray, None], d[ray, None], v0, e1, e2,
                                 t_min, best_t[ray, None])
            ok = ok & (tris >= 0)
            t = torch.where(ok, t, torch.inf)
            k = torch.argmin(t, dim=1)
            sel = torch.arange(len(ray), device=dev)
            tk = t[sel, k]
            imp = tk < best_t[ray]
            ri = ray[imp]
            best_t[ri] = tk[imp]
            best_u[ri] = u[sel, k][imp]
            best_v[ri] = v[sel, k][imp]
            best_tri[ri] = tris[sel, k][imp]

        for s in range(0, r, 65536):
            ray = rows[s:s + 65536]
            if len(self.big):
                consider(ray, self.big.expand(len(ray), -1))
        self._walk(o, d, t_min, best_t, consider, any_hit=False)
        return best_t, best_tri, best_u, best_v, best_tri >= 0

    def occluded(self, o, d, t_min, t_max, skip_object):
        """bool[R]: a triangle not of the ray's `skip_object` lies in
        (t_min, t_max)."""
        dt, dev = self.dt, o.device
        r = o.shape[0]
        t_max = torch.as_tensor(t_max, dtype=dt, device=dev).expand(r)
        occ = torch.zeros((r,), dtype=torch.bool, device=dev)
        rows = torch.arange(r, device=dev)

        def consider(ray, tris):
            v0, e1, e2 = self._rows(tris)
            _, _, _, ok = moller(o[ray, None], d[ray, None], v0, e1, e2,
                                 t_min, t_max[ray, None])
            ok = ok & (tris >= 0) & (self.obj[tris.clamp_min(0)]
                                     != skip_object[ray, None])
            occ[ray] |= ok.any(dim=1)

        for s in range(0, r, 65536):
            ray = rows[s:s + 65536]
            if len(self.big):
                consider(ray, self.big.expand(len(ray), -1))
        # An occluded ray walks no further: its t cap is -inf.
        cap = torch.where(occ, -torch.inf, t_max.to(torch.float32))
        self._walk(o, d, t_min, cap, consider, any_hit=True, occ=occ)
        return occ

    def _walk(self, o, d, t_min, cap, consider, any_hit, occ=None):
        """The stack walk of every ray; `cap` is the live t bound (the best
        hit so far for closest hit; -inf once occluded for any hit)."""
        dev = o.device
        r = o.shape[0]
        of = o.to(torch.float32)
        df = d.to(torch.float32)
        inv = 1.0 / torch.where(torch.abs(df) < 1e-20,
                                torch.where(df >= 0, 1e-20, -1e-20), df)
        stack = torch.zeros((r, STACK), dtype=torch.int64, device=dev)
        stack[:, 0] = 1
        sp = torch.ones((r,), dtype=torch.int64, device=dev)
        ids = torch.arange(r, device=dev)
        while ids.numel():
            top = sp[ids] - 1
            node = stack[ids, top]
            sp[ids] = top
            limit = cap[ids].to(torch.float32)
            leaf = node >= self.n_leaf
            ii, ni = ids[~leaf], node[~leaf]
            if ii.numel():
                c0, c1 = 2 * ni, 2 * ni + 1
                lim = limit[~leaf]
                h0, t0 = self._slab(of[ii, None], inv[ii, None], c0[:, None],
                                    t_min, lim[:, None])
                h1, t1 = self._slab(of[ii, None], inv[ii, None], c1[:, None],
                                    t_min, lim[:, None])
                h0, t0, h1, t1 = h0[:, 0], t0[:, 0], h1[:, 0], t1[:, 0]
                near0 = t0 <= t1
                # Push the far child first, so the near one pops next.
                for push, child in ((torch.where(near0, h1, h0),
                                     torch.where(near0, c1, c0)),
                                    (torch.where(near0, h0, h1),
                                     torch.where(near0, c0, c1))):
                    pi = ii[push]
                    stack[pi, sp[pi]] = child[push]
                    sp[pi] += 1
            li, nl = ids[leaf], node[leaf]
            if li.numel():
                # A leaf is reached only through its parent's slab test
                # against the bound at that time; test its box again.
                lh, _ = self._slab(of[li, None], inv[li, None], nl[:, None],
                                   t_min, limit[leaf][:, None])
                li, nl = li[lh[:, 0]], nl[lh[:, 0]]
                if li.numel():
                    consider(li, self.slots[nl - self.n_leaf])
                    if any_hit:
                        sp[li[occ[li]]] = 0
                        cap[li] = torch.where(occ[li], -torch.inf, cap[li])
            ids = ids[sp[ids] > 0]
