// Closest-hit and any-hit traversal of the binary BVH, one thread per ray,
// for Hopper (sm_90a).
//
// Replaces the TPU kernels raytracer_tpu/ops/pallas_traverse.py:167
// (_closest_kernel, K3) and :227 (_occlusion_kernel, K4). Those walk one
// tree per 4096-ray packet with an SMEM stack, ordering children by the
// packet's minimum t_near, because Mosaic has no per-lane gathers; none of
// that carries over. Here each thread walks its own ray depth-first with a
// private stack of STACK_CAP = 128 metas in local memory (a meta >= 0 is a
// pnodes row, a meta < 0 is leaf block ~meta), starting from root_meta:
//
//   - an internal node reads its pnodes row (both child boxes and both
//     child metas, 4 x float4), slab-tests the two children against
//     [t_min, best t] (t_max for any-hit) and pushes the hit ones, far
//     first and near last; near is the smaller t_near, a tie keeps left;
//   - a leaf tests its leaf_size triangles in order with Moller-Trumbore;
//     closest hit keeps a strictly smaller t, any-hit returns at the first
//     triangle not of the ray's skip object;
//   - a ray whose t_max <= t_min (inactive lanes get exactly t_min) cannot
//     accept a hit and is not walked.
//
// t_min is an argument: K3 fixes it at 1e-3, but the backend these kernels
// serve (accel="bvh", whose JAX walk takes any t_min) does not. The
// arithmetic, leaf loops and node step (traverse_common.cuh) are written in
// the order of the plain torch versions in ops/binary_traverse.py, and the
// library is built with -fmad=false, so the kernels equal them bit for bit.
//
// What bounds it on the card: dependent loads, as for the 4-wide kernels,
// and about twice as many of them, since a binary walk pops twice the
// nodes of a 4-wide one. A tree deeper than STACK_CAP - 2 is refused by the
// wrapper (stack_fits), so the stack never overflows. Making it fast
// (a shared-memory cache of the top levels, wider nodes) is later work.

#include "traverse_common.cuh"

using namespace traverse;

namespace {

constexpr int kStackCap = 128;  // per-ray stack entries (STACK_CAP)

__global__ void __launch_bounds__(kThreads)
closest_kernel(const float* __restrict__ origin,
               const float* __restrict__ direction,
               const float* __restrict__ t_max, int64_t n, float t_min,
               int root, const float4* __restrict__ pnodes,
               const float4* __restrict__ ptris, int leaf,
               float* __restrict__ out_t, int* __restrict__ out_tri,
               float* __restrict__ out_u, float* __restrict__ out_v) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Ray r = load_ray(origin, direction, i);
  float bt = t_max[i];
  int btri = -1;
  float bu = 0.0f, bv = 0.0f;
  const int leaf_f4 = leaf * kTriStride / 4;

  int stack[kStackCap];
  int sp = 0;
  if (bt > t_min) stack[sp++] = root;
  while (sp > 0) {
    int meta = stack[--sp];
    if (meta < 0) {
      closest_leaf(r, ptris + (int64_t)(~meta) * leaf_f4, leaf, t_min, bt,
                   btri, bu, bv);
    } else {
      binary_visit<true>(r, pnodes + (int64_t)meta * 4, t_min, bt, stack,
                         sp);
    }
  }
  out_t[i] = bt;
  out_tri[i] = btri;
  out_u[i] = bu;
  out_v[i] = bv;
}

__global__ void __launch_bounds__(kThreads)
occlusion_kernel(const float* __restrict__ origin,
                 const float* __restrict__ direction,
                 const float* __restrict__ t_max,
                 const int* __restrict__ skip_object, int64_t n,
                 float t_min, int root, const float4* __restrict__ pnodes,
                 const float4* __restrict__ ptris, int leaf,
                 bool* __restrict__ out_occ) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Ray r = load_ray(origin, direction, i);
  float tm = t_max[i];
  float skip = (float)skip_object[i];
  const int leaf_f4 = leaf * kTriStride / 4;
  bool occ = false;

  int stack[kStackCap];
  int sp = 0;
  if (tm > t_min) stack[sp++] = root;
  while (sp > 0 && !occ) {
    int meta = stack[--sp];
    if (meta < 0) {
      occ = occluded_leaf(r, ptris + (int64_t)(~meta) * leaf_f4, leaf, t_min,
                          tm, skip);
    } else {
      binary_visit<true>(r, pnodes + (int64_t)meta * 4, t_min, tm, stack,
                         sp);
    }
  }
  out_occ[i] = occ;
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each launches on `stream`
// and returns the launch's cudaError_t; none synchronises or allocates.
extern "C" int binary_closest(const float* origin, const float* direction,
                              const float* t_max, int64_t n, float t_min,
                              int root, const float* pnodes,
                              const float* ptris, int leaf, float* out_t,
                              int* out_tri, float* out_u, float* out_v,
                              void* stream) {
  closest_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      origin, direction, t_max, n, t_min, root,
      reinterpret_cast<const float4*>(pnodes),
      reinterpret_cast<const float4*>(ptris), leaf, out_t, out_tri, out_u,
      out_v);
  return (int)cudaGetLastError();
}

extern "C" int binary_occlusion(const float* origin, const float* direction,
                                const float* t_max, const int* skip_object,
                                int64_t n, float t_min, int root,
                                const float* pnodes, const float* ptris,
                                int leaf, bool* out_occ, void* stream) {
  occlusion_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      origin, direction, t_max, skip_object, n, t_min, root,
      reinterpret_cast<const float4*>(pnodes),
      reinterpret_cast<const float4*>(ptris), leaf, out_occ);
  return (int)cudaGetLastError();
}
