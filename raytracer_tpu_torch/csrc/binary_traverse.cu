// Closest-hit (K3) and any-hit (K4) traversal of the binary BVH for Hopper
// (sm_90a): the kernels of accel="bvh".
//
// Replaces the TPU kernels raytracer_tpu/ops/pallas_traverse.py:167
// (_closest_kernel, K3) and :227 (_occlusion_kernel, K4). Those walk one
// tree per 4096-ray packet with an SMEM stack, ordering children by the
// packet's minimum t_near, because Mosaic has no per-lane gathers; none of
// that carries over. Here each lane walks one ray depth-first at a time: a
// meta >= 0 is a pnodes row (both child boxes and both child metas, 4
// float4), a meta < 0 is leaf block ~meta, starting from root_meta.
//
// What bounds them on the card: the latency of dependent loads, as for the
// 4-wide K1/K2, and more of them, since a binary walk pops about 1.5x the
// nodes of a 4-wide one (the one-thread-per-ray design ran at 2.3% and
// 5.4% of its operation bound). Each step reads a 64-byte node row or a
// leaf row whose address comes from the step before, and the lanes of a
// warp walk different rays. The design is K1/K2's (persistent_walk.cuh):
//
//   1. Persistent warps that fetch live rays. The grid fills the card, and
//      a warp takes ray indices from a global counter with one atomicAdd
//      for all its idle lanes. An inactive ray (t_max <= the launch's
//      t_min) is answered at fetch time and never holds a lane; once
//      kRefillAt lanes of a warp are idle they take new rays while the
//      others walk on, so a warp does not wait for its slowest ray.
//   2. Leaves stop at their last real triangle: `counts[block]` (shared
//      with K1/K2, which read the same leaf rows) bounds the leaf loop. The
//      slots past it are zero triangles (det = 0), which are never valid.
//   3. Grouped leaf loads: the 3 x kGroup float4 of kGroup triangles are
//      loaded before the first of their tests, so a leaf visit waits on
//      memory once per group, not once per triangle behind the previous
//      test's division.
//   4. The entry to visit next stays in a register: the node step
//      (persistent_walk.cuh's binary_node on binary_visit<true> of
//      traverse_common.cuh, the lab's and the plain version's) pushes the
//      far child to the stack and keeps the near one when both are hit (a
//      tie keeps left), keeps the one hit child, and pops when none is
//      hit. The rest of the stack is in shared memory,
//      laid out [entry][thread]: `need` = bvh_max_depth + 2 entries a
//      thread (the wrapper's; at most STACK_CAP = 128, 64 KB a block),
//      where the one-thread-per-ray design kept 128 in local memory.
//   5. While-while: the lanes of a warp run node steps until none has an
//      internal node next, then leaf visits until none has a leaf next.
//
// t_min is an argument, used by the inactive test, every slab test and
// every Moller-Trumbore test: K3 is the renderer's fallback for a t_min
// other than 1e-3. K4 keeps the near-first order of the plain walk: its
// mask does not depend on the order, but its steps (and so its bound) do.
// Per ray the walk pops the plain version's entries (ops/binary_traverse.py)
// in its order, tests each leaf's triangles in slot order with a strictly
// smaller t kept, and uses the arithmetic of traverse_common.cuh built with
// -fmad=false, so each kernel equals its plain version bit for bit.

#include "persistent_walk.cuh"

using namespace traverse;

namespace {

constexpr int kGroup = 4;      // triangles of a leaf loaded together
constexpr int kRefillAt = 16;  // idle lanes of 32 at which a warp fetches
constexpr int kCap = 128;      // stack entries at most (STACK_CAP)

__global__ void __launch_bounds__(kThreads)
closest_kernel(const float* __restrict__ origin,
               const float* __restrict__ direction,
               const float* __restrict__ t_max, int n, float t_min, int root,
               const float4* __restrict__ pnodes,
               const float4* __restrict__ ptris,
               const int* __restrict__ counts, int leaf,
               int* __restrict__ next_ray, float* __restrict__ out_t,
               int* __restrict__ out_tri, float* __restrict__ out_u,
               float* __restrict__ out_v) {
  extern __shared__ int smem[];
  closest_walk<kGroup, kRefillAt>(
      smem, origin, direction, t_max, n, t_min, root, ptris, counts, leaf,
      next_ray, out_t, out_tri, out_u, out_v,
      [&](const Ray& r, int cur, float bt, Stack& st) {
        return binary_node(r, pnodes + (int64_t)cur * 4, t_min, bt, st);
      });
}

__global__ void __launch_bounds__(kThreads)
occlusion_kernel(const float* __restrict__ origin,
                 const float* __restrict__ direction,
                 const float* __restrict__ t_max,
                 const int* __restrict__ skip_object, int n, float t_min,
                 int root, const float4* __restrict__ pnodes,
                 const float4* __restrict__ ptris,
                 const int* __restrict__ counts, int leaf,
                 int* __restrict__ next_ray, bool* __restrict__ out_occ) {
  extern __shared__ int smem[];
  any_walk<kGroup, kRefillAt>(
      smem, origin, direction, t_max, skip_object, n, t_min, root, ptris,
      counts, leaf, next_ray, out_occ,
      [&](const Ray& r, int cur, float tm, Stack& st) {
        return binary_node(r, pnodes + (int64_t)cur * 4, t_min, tm, st);
      });
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each zeroes the ray counter
// `next_ray` (one int32 on the device) and launches on `stream`, and
// returns the first cudaError_t; none synchronises or allocates. `need` is
// the stack entries a thread (1..128).
extern "C" int binary_closest(const float* origin, const float* direction,
                              const float* t_max, int64_t n, float t_min,
                              int root, const float* pnodes,
                              const float* ptris, const int* leaf_counts,
                              int leaf, int need, int* next_ray,
                              float* out_t, int* out_tri, float* out_u,
                              float* out_v, void* stream) {
  return launch(closest_kernel, n, need, kCap, next_ray, stream, origin,
                direction, t_max, (int)n, t_min, root,
                reinterpret_cast<const float4*>(pnodes),
                reinterpret_cast<const float4*>(ptris), leaf_counts, leaf,
                next_ray, out_t, out_tri, out_u, out_v);
}

extern "C" int binary_occlusion(const float* origin, const float* direction,
                                const float* t_max, const int* skip_object,
                                int64_t n, float t_min, int root,
                                const float* pnodes, const float* ptris,
                                const int* leaf_counts, int leaf, int need,
                                int* next_ray, bool* out_occ, void* stream) {
  return launch(occlusion_kernel, n, need, kCap, next_ray, stream, origin,
                direction, t_max, skip_object, (int)n, t_min, root,
                reinterpret_cast<const float4*>(pnodes),
                reinterpret_cast<const float4*>(ptris), leaf_counts, leaf,
                next_ray, out_occ);
}

// What a launch of kernel `occlusion` (0 K3, 1 K4) at stack need `need`
// looks like on the current device: out[0..8] as persistent_walk.cuh's
// info().
extern "C" int binary_launch_info(int occlusion, int need, int* out) {
  return occlusion
             ? info<kGroup, kRefillAt>(occlusion_kernel, need, kCap, out)
             : info<kGroup, kRefillAt>(closest_kernel, need, kCap, out);
}
