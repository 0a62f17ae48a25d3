// Closest-hit and any-hit traversal of the 4-wide collapsed BVH, one
// thread per ray, for Hopper (sm_90a).
//
// Replaces the TPU kernels raytracer_tpu/ops/pallas_subpacket.py:329
// (_closest_kernel, K1) and :423 (_occlusion_kernel, K2). Those run one
// traversal per 256-ray sub-packet row with SMEM stacks and leaf queues,
// because Mosaic has no per-lane gathers; none of that carries over. Here
// each thread walks its own ray depth-first with a private stack:
//
//   - an internal node reads its quad row (4 child boxes, 6 x float4) and
//     the 4 child metas (one int4), slab-tests the 4 children with
//     NaN-propagating min/max (absent children are NaN boxes and never
//     hit), and pushes the hit ones: closest hit in child order except the
//     nearest, which goes last; any-hit in child order;
//   - a leaf (meta < 0, block ~meta) tests its leaf_size triangles in
//     order, 3 x float4 each, with Moller-Trumbore; closest hit keeps a
//     strictly smaller t, any-hit returns at the first triangle not of the
//     ray's skip object.
//
// The arithmetic (traverse_common.cuh) is written in the order of the
// plain torch versions in ops/quad_traverse.py, and the library is built
// with -fmad=false, so the kernels equal them bit for bit.
//
// What bounds it on the card: dependent loads. Each step of a ray's walk
// is a 128-byte node read or a leaf_size*48-byte leaf read whose address
// comes from the step before, and the threads of a warp diverge on
// incoherent rays. The design keeps the walk's state (ray, best hit,
// stack) in registers and local memory and reads every node and leaf row
// with vector loads through the read-only cache; making it fast (wider
// loads, warp-coherent scheduling, ray sorting) is later work.

#include "traverse_common.cuh"

using namespace traverse;

namespace {

constexpr int kCap = 64;          // per-ray stack entries
constexpr float kTMin = 1e-3f;    // traceRayEXT t_min (simple.rgen:92-104)

__global__ void __launch_bounds__(128)
closest_kernel(const float* __restrict__ origin,
               const float* __restrict__ direction,
               const float* __restrict__ t_max, int64_t n, int root,
               const int4* __restrict__ qmeta,
               const float4* __restrict__ qnodes,
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

  int stack[kCap];
  int sp = 0;
  if (bt > kTMin) stack[sp++] = root;
  while (sp > 0) {
    int meta = stack[--sp];
    if (meta < 0) {
      closest_leaf(r, ptris + (int64_t)(~meta) * leaf_f4, leaf, kTMin, bt,
                   btri, bu, bv);
    } else {
      quad_visit<true>(r, qnodes + (int64_t)meta * 8, __ldg(qmeta + meta),
                       kTMin, bt, stack, sp);
    }
  }
  out_t[i] = bt;
  out_tri[i] = btri;
  out_u[i] = bu;
  out_v[i] = bv;
}

__global__ void __launch_bounds__(128)
occlusion_kernel(const float* __restrict__ origin,
                 const float* __restrict__ direction,
                 const float* __restrict__ t_max,
                 const int* __restrict__ skip_object, int64_t n, int root,
                 const int4* __restrict__ qmeta,
                 const float4* __restrict__ qnodes,
                 const float4* __restrict__ ptris, int leaf,
                 bool* __restrict__ out_occ) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Ray r = load_ray(origin, direction, i);
  float tm = t_max[i];
  float skip = (float)skip_object[i];
  const int leaf_f4 = leaf * kTriStride / 4;
  bool occ = false;

  int stack[kCap];
  int sp = 0;
  if (tm > kTMin) stack[sp++] = root;
  while (sp > 0 && !occ) {
    int meta = stack[--sp];
    if (meta < 0) {
      occ = occluded_leaf(r, ptris + (int64_t)(~meta) * leaf_f4, leaf, kTMin,
                          tm, skip);
    } else {
      quad_visit<false>(r, qnodes + (int64_t)meta * 8, __ldg(qmeta + meta),
                        kTMin, tm, stack, sp);
    }
  }
  out_occ[i] = occ;
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each launches on `stream`
// and returns the launch's cudaError_t; none synchronises or allocates.
extern "C" int quad_closest(const float* origin, const float* direction,
                            const float* t_max, int64_t n, int root,
                            const int* qmeta, const float* qnodes,
                            const float* ptris, int leaf, float* out_t,
                            int* out_tri, float* out_u, float* out_v,
                            void* stream) {
  closest_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      origin, direction, t_max, n, root,
      reinterpret_cast<const int4*>(qmeta),
      reinterpret_cast<const float4*>(qnodes),
      reinterpret_cast<const float4*>(ptris), leaf, out_t, out_tri, out_u,
      out_v);
  return (int)cudaGetLastError();
}

extern "C" int quad_occlusion(const float* origin, const float* direction,
                              const float* t_max, const int* skip_object,
                              int64_t n, int root, const int* qmeta,
                              const float* qnodes, const float* ptris,
                              int leaf, bool* out_occ, void* stream) {
  occlusion_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      origin, direction, t_max, skip_object, n, root,
      reinterpret_cast<const int4*>(qmeta),
      reinterpret_cast<const float4*>(qnodes),
      reinterpret_cast<const float4*>(ptris), leaf, out_occ);
  return (int)cudaGetLastError();
}
