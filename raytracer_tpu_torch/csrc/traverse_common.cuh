// Device helpers shared by the traversal kernels (quad_traverse.cu,
// binary_traverse.cu): the ray with its clamped inverse direction, the slab
// test of one box and Moller-Trumbore against one leaf triangle.
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

inline unsigned blocks_for(int64_t n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace traverse
