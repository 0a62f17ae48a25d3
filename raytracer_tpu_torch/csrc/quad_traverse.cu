// Closest-hit (K1) and any-hit (K2) traversal of the 4-wide collapsed BVH
// for Hopper (sm_90a).
//
// Replaces the TPU kernels raytracer_tpu/ops/pallas_subpacket.py:329
// (_closest_kernel, K1) and :423 (_occlusion_kernel, K2). Those run one
// traversal per 256-ray sub-packet row with SMEM stacks and leaf queues,
// because Mosaic has no per-lane gathers; none of that carries over. Here
// each lane walks one ray depth-first at a time.
//
// What bounds them on the card: the latency of dependent loads, not bytes
// or arithmetic (the one-thread-per-ray design ran at 2.7% and 5.9% of its
// operation bound). Each step of a walk reads a 128-byte node row or a leaf
// row whose address comes from the step before, and the lanes of a warp
// walk different rays. What each part of the design does about it:
//
//   1. Persistent warps that fetch live rays. The grid fills the card (the
//      SMs x the resident blocks the occupancy calculator reports), and a
//      warp takes ray indices from a global counter with one atomicAdd for
//      all its idle lanes. An inactive ray (t_max <= 1e-3) is answered at
//      fetch time and never holds a lane; once kRefillAt lanes of a warp
//      are idle they take new rays while the others walk on, so a warp
//      does not wait for its slowest ray.
//   2. Leaves stop at their last real triangle: `counts[block]` (the last
//      slot with a non-zero edge, plus one) bounds the leaf loop. The slots
//      past it are zero triangles (det = 0), which are never valid.
//   3. Grouped leaf loads: the 3 x kGroup float4 of kGroup triangles are
//      loaded before the first of their tests, so a leaf visit waits on
//      memory once per group, not once per triangle behind the previous
//      test's division. The tests still run in slot order.
//   4. One line per node: the child metas are read from the node's own
//      128-byte row (lanes 24-27, exact f32), not from a second array. The
//      entry to be popped next stays in a register (K1's near child, K2's
//      last hit child), and the rest of the stack is in shared memory,
//      laid out [entry][thread] so that each thread has its own bank.
//   5. While-while: the lanes of a warp run node steps until none has an
//      internal node next, then leaf visits until none has a leaf next, so
//      node and leaf code do not alternate inside a warp.
//
// Parts 1, 2, 3 and 5, the shared-memory stack and the launch are
// persistent_walk.cuh's, shared with the binary tree's K3/K4
// (binary_traverse.cu); this file holds the 4-wide node steps.
//
// kGroup and kRefillAt were chosen on the card (PERF.md §6;
// lab/quad_variant_lab.py rebuilds this file with other values to time
// them).
//
// Per ray the walk pops the plain version's entries in its order
// (ops/quad_traverse.py), tests each leaf's triangles in slot order with a
// strictly smaller t kept, and uses the arithmetic of traverse_common.cuh
// (slab, moller) built with -fmad=false, so each kernel equals its plain
// version bit for bit. Only the interleaving of a warp's rays changes.

#include "persistent_walk.cuh"

using namespace traverse;

namespace {

constexpr int kGroup = 4;         // triangles of a leaf loaded together
constexpr int kRefillAt = 16;     // idle lanes of 32 at which a warp fetches
constexpr int kCap = 64;          // stack entries at most (q_stack_need)
constexpr float kTMin = 1e-3f;    // traceRayEXT t_min (simple.rgen:92-104)

// Slab tests of the 4 children of node row `q` (8 float4: the 4 boxes in
// float4 0-5, the child metas as exact f32 in float4 6) against [1e-3,
// t_cap]. An absent child has a NaN box, never hit, and a NaN meta, which
// __float2int_rz makes 0.
__device__ __forceinline__ void test_children(const Ray& r,
                                              const float4* __restrict__ q,
                                              float t_cap, bool (&hit)[4],
                                              float (&tn)[4], int (&kid)[4]) {
  float b[24];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float4 f = __ldg(q + j);
    b[4 * j + 0] = f.x;
    b[4 * j + 1] = f.y;
    b[4 * j + 2] = f.z;
    b[4 * j + 3] = f.w;
  }
  float4 m = __ldg(q + 6);
  kid[0] = __float2int_rz(m.x);
  kid[1] = __float2int_rz(m.y);
  kid[2] = __float2int_rz(m.z);
  kid[3] = __float2int_rz(m.w);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float* x = b + 6 * c;
    hit[c] = slab(r, x[0], x[1], x[2], x[3], x[4], x[5], kTMin, t_cap,
                  &tn[c]);
  }
}

// Closest-hit node step: push the hit children in child order but the
// nearest (the TPU kernel's 2-bit argmin of t_near, a missed child counting
// as kBig), and return the nearest as the next entry, or pop when it was
// missed. The plain version pushes the nearest last and pops it at once.
__device__ __forceinline__ int closest_node(const Ray& r,
                                            const float4* __restrict__ q,
                                            float bt, Stack& st) {
  bool hit[4];
  float tn[4];
  int kid[4];
  test_children(r, q, bt, hit, tn, kid);
#pragma unroll
  for (int c = 0; c < 4; ++c) tn[c] = hit[c] ? tn[c] : kBig;
  int b0 = tn[1] < tn[0];
  int b1 = tn[3] < tn[2];
  bool use_hi = nmin(tn[2], tn[3]) < nmin(tn[0], tn[1]);
  int near = use_hi ? 2 + b1 : b0;
  bool near_hit = false;
  int next = 0;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (hit[c] && c != near) st.push(kid[c]);
    if (c == near) {
      near_hit = hit[c];
      next = kid[c];
    }
  }
  return near_hit ? next : st.pop();
}

// Any-hit node step: push the hit children in child order but the last,
// and return that one as the next entry (the plain version pushes all and
// pops the last at once), or pop when none was hit.
__device__ __forceinline__ int any_node(const Ray& r,
                                        const float4* __restrict__ q,
                                        float t_max, Stack& st) {
  bool hit[4];
  float tn[4];
  int kid[4];
  test_children(r, q, t_max, hit, tn, kid);
  int last = -1;
#pragma unroll
  for (int c = 0; c < 4; ++c) last = hit[c] ? c : last;
  int next = 0;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (hit[c] && c != last) st.push(kid[c]);
    if (c == last) next = kid[c];
  }
  return last >= 0 ? next : st.pop();
}

__global__ void __launch_bounds__(kThreads)
closest_kernel(const float* __restrict__ origin,
               const float* __restrict__ direction,
               const float* __restrict__ t_max, int n, int root,
               const float4* __restrict__ qnodes,
               const float4* __restrict__ ptris,
               const int* __restrict__ counts, int leaf,
               int* __restrict__ next_ray, float* __restrict__ out_t,
               int* __restrict__ out_tri, float* __restrict__ out_u,
               float* __restrict__ out_v) {
  extern __shared__ int smem[];
  closest_walk<kGroup, kRefillAt>(
      smem, origin, direction, t_max, n, kTMin, root, ptris, counts, leaf,
      next_ray, out_t, out_tri, out_u, out_v,
      [&](const Ray& r, int cur, float bt, Stack& st) {
        return closest_node(r, qnodes + (int64_t)cur * 8, bt, st);
      });
}

__global__ void __launch_bounds__(kThreads)
occlusion_kernel(const float* __restrict__ origin,
                 const float* __restrict__ direction,
                 const float* __restrict__ t_max,
                 const int* __restrict__ skip_object, int n, int root,
                 const float4* __restrict__ qnodes,
                 const float4* __restrict__ ptris,
                 const int* __restrict__ counts, int leaf,
                 int* __restrict__ next_ray, bool* __restrict__ out_occ) {
  extern __shared__ int smem[];
  any_walk<kGroup, kRefillAt>(
      smem, origin, direction, t_max, skip_object, n, kTMin, root, ptris,
      counts, leaf, next_ray, out_occ,
      [&](const Ray& r, int cur, float tm, Stack& st) {
        return any_node(r, qnodes + (int64_t)cur * 8, tm, st);
      });
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each zeroes the ray counter
// `next_ray` (one int32 on the device) and launches on `stream`, and
// returns the first cudaError_t; none synchronises or allocates. `need` is
// the tree's stack bound (<= 64).
extern "C" int quad_closest(const float* origin, const float* direction,
                            const float* t_max, int64_t n, int root,
                            const float* qnodes, const float* ptris,
                            const int* leaf_counts, int leaf, int need,
                            int* next_ray, float* out_t, int* out_tri,
                            float* out_u, float* out_v, void* stream) {
  return launch(closest_kernel, n, need, kCap, next_ray, stream, origin,
                direction, t_max, (int)n, root,
                reinterpret_cast<const float4*>(qnodes),
                reinterpret_cast<const float4*>(ptris), leaf_counts, leaf,
                next_ray, out_t, out_tri, out_u, out_v);
}

extern "C" int quad_occlusion(const float* origin, const float* direction,
                              const float* t_max, const int* skip_object,
                              int64_t n, int root, const float* qnodes,
                              const float* ptris, const int* leaf_counts,
                              int leaf, int need, int* next_ray,
                              bool* out_occ, void* stream) {
  return launch(occlusion_kernel, n, need, kCap, next_ray, stream, origin,
                direction, t_max, skip_object, (int)n, root,
                reinterpret_cast<const float4*>(qnodes),
                reinterpret_cast<const float4*>(ptris), leaf_counts, leaf,
                next_ray, out_occ);
}

// What a launch of kernel `occlusion` (0 K1, 1 K2) at stack need `need`
// looks like on the current device: out[0..8] as persistent_walk.cuh's
// info().
extern "C" int quad_launch_info(int occlusion, int need, int* out) {
  return occlusion
             ? info<kGroup, kRefillAt>(occlusion_kernel, need, kCap, out)
             : info<kGroup, kRefillAt>(closest_kernel, need, kCap, out);
}
