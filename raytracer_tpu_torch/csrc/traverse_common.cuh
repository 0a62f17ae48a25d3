// Device helpers shared by the traversal kernels (quad_traverse.cu,
// binary_traverse.cu, lab_traverse.cu, lab2_traverse.cu, lab3_traverse.cu):
// the ray with its clamped inverse direction, the slab test of one box,
// Moller-Trumbore against one leaf triangle, the closest-hit leaf loops
// (serial, ILP and component-major; the persistent walks' grouped loops are
// in persistent_walk.cuh), and the binary, 4-wide and 8-wide node steps,
// which take a push policy.
//
// Each term is written in the order of the plain torch versions
// (ops/quad_traverse.py: _inv_dir, _slab_children, _moller), and the
// libraries are built with -fmad=false, so a kernel equals its plain
// version bit for bit.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace traverse {

constexpr float kBig = 3.0e38f;   // "no hit" t_near
constexpr int kTriStride = 12;    // floats per triangle in a leaf row
constexpr int kThreads = 128;     // threads per block, one ray each

__device__ __forceinline__ float nan_value() {
  return __int_as_float(0x7fc00000);
}

// torch.minimum / torch.maximum semantics: a NaN operand gives NaN.
__device__ __forceinline__ float nmin(float a, float b) {
  return (isnan(a) || isnan(b)) ? nan_value() : fminf(a, b);
}
__device__ __forceinline__ float nmax(float a, float b) {
  return (isnan(a) || isnan(b)) ? nan_value() : fmaxf(a, b);
}

__device__ __forceinline__ float inv_dir(float d) {
  float a = fabsf(d) < 1e-20f ? (d >= 0.0f ? 1e-20f : -1e-20f) : d;
  return 1.0f / a;
}

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

__device__ __forceinline__ Ray load_ray(const float* __restrict__ origin,
                                        const float* __restrict__ direction,
                                        int64_t i) {
  Ray r;
  r.ox = origin[3 * i + 0];
  r.oy = origin[3 * i + 1];
  r.oz = origin[3 * i + 2];
  r.dx = direction[3 * i + 0];
  r.dy = direction[3 * i + 1];
  r.dz = direction[3 * i + 2];
  r.ix = inv_dir(r.dx);
  r.iy = inv_dir(r.dy);
  r.iz = inv_dir(r.dz);
  return r;
}

// Slab test of one box (min.xyz, max.xyz) against [t_min, t_cap].
__device__ __forceinline__ bool slab(const Ray& r, float mnx, float mny,
                                     float mnz, float mxx, float mxy,
                                     float mxz, float t_min, float t_cap,
                                     float* t_near) {
  float t0x = (mnx - r.ox) * r.ix;
  float t1x = (mxx - r.ox) * r.ix;
  float t0y = (mny - r.oy) * r.iy;
  float t1y = (mxy - r.oy) * r.iy;
  float t0z = (mnz - r.oz) * r.iz;
  float t1z = (mxz - r.oz) * r.iz;
  float tn = nmax(nmax(nmin(t0x, t1x), nmin(t0y, t1y)),
                  nmax(nmin(t0z, t1z), t_min));
  float tf = nmin(nmin(nmax(t0x, t1x), nmax(t0y, t1y)),
                  nmin(nmax(t0z, t1z), t_cap));
  *t_near = tn;
  return tn <= tf;
}

// Moller-Trumbore against one leaf triangle (3 float4: v0, e1, e2, tri_f,
// obj_f, pad); returns whether the hit is valid for (t_min, t_cap) and sets
// t, u, v.
__device__ __forceinline__ bool moller(const Ray& r, float4 a, float4 b,
                                       float4 c, float t_min, float t_cap,
                                       float* t_out, float* u_out,
                                       float* v_out) {
  float v0x = a.x, v0y = a.y, v0z = a.z;
  float e1x = a.w, e1y = b.x, e1z = b.y;
  float e2x = b.z, e2y = b.w, e2z = c.x;
  float px = r.dy * e2z - r.dz * e2y;
  float py = r.dz * e2x - r.dx * e2z;
  float pz = r.dx * e2y - r.dy * e2x;
  float det = e1x * px + e1y * py + e1z * pz;
  bool ok_det = fabsf(det) > 1e-10f;
  float inv_det = ok_det ? 1.0f / det : 0.0f;
  float tx = r.ox - v0x;
  float ty = r.oy - v0y;
  float tz = r.oz - v0z;
  float u = (tx * px + ty * py + tz * pz) * inv_det;
  float qx = ty * e1z - tz * e1y;
  float qy = tz * e1x - tx * e1z;
  float qz = tx * e1y - ty * e1x;
  float v = (r.dx * qx + r.dy * qy + r.dz * qz) * inv_det;
  float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
  *t_out = t;
  *u_out = u;
  *v_out = v;
  return ok_det && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > t_min &&
         t < t_cap;
}

// Closest-hit leaf: the `leaf` triangles of one leaf row (3 float4 each) in
// order k = 0..leaf-1, each kept when its t is strictly below the best t.
__device__ __forceinline__ void closest_leaf(const Ray& r,
                                             const float4* __restrict__ row,
                                             int leaf, float t_min,
                                             float& bt, int& btri, float& bu,
                                             float& bv) {
  for (int k = 0; k < leaf; ++k) {
    float4 a = __ldg(row + 3 * k);
    float4 b = __ldg(row + 3 * k + 1);
    float4 c = __ldg(row + 3 * k + 2);
    float t, u, v;
    if (moller(r, a, b, c, t_min, bt, &t, &u, &v)) {
      bt = t;
      btri = (int)c.y;
      bu = u;
      bv = v;
    }
  }
}

// The node steps' push policy: every hit child goes through push(meta), the
// near one (pushed last) through push.near(meta). The persistent walks keep
// the entry popped next in a register (persistent_walk.cuh's binary_node,
// lab_traverse.cu), and the queued walks (lab2_traverse.cu) route leaf
// children to a leaf queue.

// A pnodes row (lanes 0-5 left box, 6-11 right box, 12/13 the child metas
// as f32): its 4 float4, loaded in order.
struct BinaryRow {
  float4 f0, f1, f2, f3;
};

__device__ __forceinline__ BinaryRow load_binary_row(
    const float4* __restrict__ p) {
  return {__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3)};
}

// Binary node step on a loaded row: slab-test both children against
// [t_min, t_cap] and push the hit ones: far first and near last (kOrdered;
// near is the smaller t_near, a tie keeps left), or right first and left
// last.
template <bool kOrdered, class Push>
__device__ __forceinline__ void binary_visit(const Ray& r,
                                             const BinaryRow& row,
                                             float t_min, float t_cap,
                                             const Push& push) {
  const float4 f0 = row.f0, f1 = row.f1, f2 = row.f2, f3 = row.f3;
  float tn_l, tn_r;
  bool hit_l = slab(r, f0.x, f0.y, f0.z, f0.w, f1.x, f1.y, t_min, t_cap,
                    &tn_l);
  bool hit_r = slab(r, f1.z, f1.w, f2.x, f2.y, f2.z, f2.w, t_min, t_cap,
                    &tn_r);
  int lmeta = (int)f3.x;
  int rmeta = (int)f3.y;
  float near_l = hit_l ? tn_l : kBig;
  float near_r = hit_r ? tn_r : kBig;
  bool swap = kOrdered && near_r < near_l;
  if (swap ? hit_l : hit_r) push(swap ? lmeta : rmeta);
  if (swap ? hit_r : hit_l) push.near(swap ? rmeta : lmeta);
}

// Binary node step on pnodes row `p`: its row loaded, then binary_visit.
template <bool kOrdered, class Push>
__device__ __forceinline__ void binary_visit(const Ray& r,
                                             const float4* __restrict__ p,
                                             float t_min, float t_cap,
                                             const Push& push) {
  binary_visit<kOrdered>(r, load_binary_row(p), t_min, t_cap, push);
}

// Slab tests of the 4 boxes in float4 q[0..5] (min.xyz, max.xyz each)
// against [t_min, t_cap] with NaN-propagating min/max (an absent child's
// NaN box is never hit), and the first level of a tournament of their
// t_near (a missed child counting as kBig): the pair minima m01 = min(t0,
// t1) and m23, and whether the second of each pair is strictly nearer
// (b01, b23).
__device__ __forceinline__ void four_slabs(const Ray& r,
                                           const float4* __restrict__ q,
                                           float t_min, float t_cap,
                                           bool (&hit)[4], float& m01,
                                           float& m23, int& b01, int& b23) {
  float b[24];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float4 f = __ldg(q + j);
    b[4 * j + 0] = f.x;
    b[4 * j + 1] = f.y;
    b[4 * j + 2] = f.z;
    b[4 * j + 3] = f.w;
  }
  float tn[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float* x = b + 6 * c;
    hit[c] = slab(r, x[0], x[1], x[2], x[3], x[4], x[5], t_min, t_cap,
                  &tn[c]);
    tn[c] = hit[c] ? tn[c] : kBig;
  }
  b01 = tn[1] < tn[0];
  b23 = tn[3] < tn[2];
  m01 = nmin(tn[0], tn[1]);
  m23 = nmin(tn[2], tn[3]);
}

// Push the hit children of `hit`/`kids` in child order, but child `near`
// (-1: none) last, through push.near. The near child is picked by
// comparison, not by a dynamic index, so the arrays stay in registers.
template <int kW, class Push>
__device__ __forceinline__ void push_near_last(const bool (&hit)[kW],
                                               const int (&kids)[kW],
                                               int near, const Push& push) {
#pragma unroll
  for (int c = 0; c < kW; ++c) {
    if (hit[c] && c != near) push(kids[c]);
  }
#pragma unroll
  for (int c = 0; c < kW; ++c) {
    if (c == near && hit[c]) push.near(kids[c]);
  }
}

// 4-wide node step: slab-test the 4 children of quad row `q` (6 float4: 4
// boxes) against [t_min, t_cap] and push the hit ones of metas `m` in
// child order; with kOrdered the nearest (the TPU kernel's 2-bit argmin
// of t_near) goes last instead, through push.near.
template <bool kOrdered, class Push>
__device__ __forceinline__ void quad_visit(const Ray& r,
                                           const float4* __restrict__ q,
                                           int4 m, float t_min, float t_cap,
                                           const Push& push) {
  bool hit[4];
  float m01, m23;
  int b01, b23;
  four_slabs(r, q, t_min, t_cap, hit, m01, m23, b01, b23);
  const int near = kOrdered ? (m23 < m01 ? 2 + b23 : b01) : -1;
  const int kids[4] = {m.x, m.y, m.z, m.w};
  push_near_last(hit, kids, near, push);
}

// The child metas a node row holds as exact f32 (float4 `f`), as int4; an
// absent child's NaN becomes 0.
__device__ __forceinline__ int4 row_metas(float4 f) {
  return make_int4(__float2int_rz(f.x), __float2int_rz(f.y),
                   __float2int_rz(f.z), __float2int_rz(f.w));
}

// 8-wide node step (tools/r3_oct_lab.py:154-234 per ray) on oct row `o`
// (16 float4: the 8 boxes in float4 0-11, the 8 child metas as exact f32
// in float4 12-13): slab-test the children against [t_min, t_cap],
// children 0-3 and then 4-7, so that 24 box floats are live at a time, not
// 48; pick the near child by the TPU kernel's 3-bit tournament of t_near
// (a missed child counts as kBig; each level compares with a strict <, so
// a tie keeps the lower index), and push the hit ones in child order but
// the near one, which goes last through push.near.
template <class Push>
__device__ __forceinline__ void oct_visit(const Ray& r,
                                          const float4* __restrict__ o,
                                          float t_min, float t_cap,
                                          const Push& push) {
  bool lo[4], hi[4];
  float m01, m23, m45, m67;
  int b01, b23, b45, b67;
  four_slabs(r, o, t_min, t_cap, lo, m01, m23, b01, b23);
  four_slabs(r, o + 6, t_min, t_cap, hi, m45, m67, b45, b67);
  int near_lo = m23 < m01 ? 2 + b23 : b01;
  int near_hi = m67 < m45 ? 6 + b67 : 4 + b45;
  int near = nmin(m45, m67) < nmin(m01, m23) ? near_hi : near_lo;
  const int4 k0 = row_metas(__ldg(o + 12));
  const int4 k1 = row_metas(__ldg(o + 13));
  const bool hit[8] = {lo[0], lo[1], lo[2], lo[3], hi[0], hi[1], hi[2], hi[3]};
  const int kids[8] = {k0.x, k0.y, k0.z, k0.w, k1.x, k1.y, k1.z, k1.w};
  push_near_last(hit, kids, near, push);
}

// One level of the pairwise min tree: pair (2a, 2a+1) -> slot a for a <
// kW, a tie keeping the lower index; then the next level. A template
// recursion, so every index is a constant and the candidates stay in
// registers.
template <int kW>
__device__ __forceinline__ void min_tree(float* ts, float* us, float* vs,
                                         int* tris) {
  if constexpr (kW >= 1) {
#pragma unroll
    for (int a = 0; a < kW; ++a) {
      bool take_b = ts[2 * a + 1] < ts[2 * a];
      ts[a] = take_b ? ts[2 * a + 1] : ts[2 * a];
      us[a] = take_b ? us[2 * a + 1] : us[2 * a];
      vs[a] = take_b ? vs[2 * a + 1] : vs[2 * a];
      tris[a] = take_b ? tris[2 * a + 1] : tris[2 * a];
    }
    min_tree<kW / 2>(ts, us, vs, tris);
  }
}

// The ILP closest-hit leaf (tools/kernel_lab.py:187 leaf_fn_ilp,
// tools/r3_kernel_lab.py:102 _leaf_step_leafpar): every triangle against
// the entry best t, then a pairwise min tree (3 levels for 8); a tie keeps
// the lower index, so the winner is the serial leaf's.
template <int kLeaf>
__device__ __forceinline__ void ilp_leaf(const Ray& r,
                                         const float4* __restrict__ row,
                                         float t_min, float& bt, int& btri,
                                         float& bu, float& bv) {
  float ts[kLeaf], us[kLeaf], vs[kLeaf];
  int tris[kLeaf];
#pragma unroll
  for (int k = 0; k < kLeaf; ++k) {
    float4 a = __ldg(row + 3 * k);
    float4 b = __ldg(row + 3 * k + 1);
    float4 c = __ldg(row + 3 * k + 2);
    float t, u, v;
    bool valid = moller(r, a, b, c, t_min, bt, &t, &u, &v);
    ts[k] = valid ? t : kBig;
    us[k] = u;
    vs[k] = v;
    tris[k] = (int)c.y;
  }
  min_tree<kLeaf / 2>(ts, us, vs, tris);
  if (ts[0] < bt) {
    bt = ts[0];
    btri = tris[0];
    bu = us[0];
    bv = vs[0];
  }
}

// Lane j of a float4 (j a constant once the loops are unrolled).
__device__ __forceinline__ float lane(float4 v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// The component-major leaf (tools/v2_kernel_lab.py:82-118 per ray, and
// tools/smem_lab.py:66 transp_kernel with leaf 8): float4 quads*c + k4 of
// the row holds component c (v0.xyz, e1.xyz, e2.xyz, tri_f) of triangles
// 4*k4 .. 4*k4+3. The triangles of the first `groups` float4 groups (1..
// leaf/4) against the entry best t; the least t (an invalid triangle
// counts as t = BIG) and the TPU kernels' reduction of the indices, max
// over the triangles of (t at the least ? index : -1), so -1 takes part
// unless every triangle is at the least t; kept if below the best t. The
// first group's loads do not wait for `groups`.
__device__ __forceinline__ void cm_leaf(const Ray& r,
                                        const float4* __restrict__ row,
                                        int leaf, int groups, float t_min,
                                        float& bt, int& btri) {
  const int quads = leaf / 4;  // float4s per component
  float tmin = kBig;
  int trimax = -1;
  bool first = true;
  int k4 = 0;
  do {
    float4 comp[10];
#pragma unroll
    for (int c = 0; c < 10; ++c) comp[c] = __ldg(row + quads * c + k4);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float4 a = make_float4(lane(comp[0], j), lane(comp[1], j),
                             lane(comp[2], j), lane(comp[3], j));
      float4 b = make_float4(lane(comp[4], j), lane(comp[5], j),
                             lane(comp[6], j), lane(comp[7], j));
      float4 c = make_float4(lane(comp[8], j), lane(comp[9], j), 0.0f, 0.0f);
      float t, u, v;
      bool valid = moller(r, a, b, c, t_min, bt, &t, &u, &v);
      float tc = valid ? t : kBig;
      int tri = (int)c.y;
      if (first) {
        tmin = tc;
        trimax = tri;
        first = false;
      } else if (tc < tmin) {  // every triangle before is above the least
        tmin = tc;
        trimax = max(tri, -1);
      } else if (tc == tmin) {
        trimax = max(trimax, tri);
      } else {
        trimax = max(trimax, -1);
      }
    }
  } while (++k4 < groups);
  if (tmin < bt) {
    bt = tmin;
    btri = trimax;
  }
}

inline unsigned blocks_for(int64_t n, int threads = kThreads) {
  return (unsigned)((n + threads - 1) / threads);
}

}  // namespace traverse
