// The traversal lab's binary and 4-wide closest-hit and any-hit kernels for
// Hopper (sm_90a): L1 and L9 one thread per ray, with per-ray visit
// counters; L2 on persistent warps.
//
// Replaces the TPU lab kernels
//   - tools/kernel_lab.py:273 (run_closest_lab, L1a): K3 with per-packet
//     visit/leaf counters, variants base, nored, leafilp, pop2, pop4;
//   - tools/kernel_lab.py:378 (run_closest_ts, L1b): the nored kernel with
//     a parametric packet height;
//   - tools/occl_lab.py:163 (run_occl_lab, L9): K4 with counters, variants
//     base, lean, noorder, resort;
//   - tools/bvh4_lab.py:302 (run_closest4, L2): the 4-wide closest hit,
//     nearest child pushed last or children in fixed order.
// Those walk one tree per packet with an SMEM stack (and, for L2, a
// deferred leaf queue) because Mosaic has no per-lane gathers; none of that
// carries over. Each lane walks its own ray depth-first.
//
//   - lab_closest: K3's walk (binary_visit, far first, near last) with
//     counters, one thread per ray with a private stack in local memory,
//     counting per ray what the TPU kernels count per packet: nvisit, every
//     pop, and nleaf, the leaf pops. Variant 0 serves both `base` and
//     `nored`: for one ray, any(hit) and min(t_near) < BIG are the same
//     predicate. Variant 1 (`leafilp`) tests every triangle of a leaf
//     against the entry best t and picks the winner with a pairwise min
//     tree in which a tie keeps the lower index; it equals the serial leaf,
//     and needs the leaf size as a template argument (8 or 16, the sizes
//     the lab bakes). Variants 2/3 (`pop2`, `pop4`) are
//     tools/kernel_lab.py:69's multi-pop loop: read k = min(sp, N) metas
//     off the top of the stack, sp -= k, visit them in order (each internal
//     visit pushes at the current sp and later visits see the updated best
//     t), nvisit += k. `threads` is the block size: L1b's rays per packet
//     become threads per block, which changes neither the results nor the
//     counts.
//   - lab_occlusion: K4's walk with counters, one thread per ray;
//     `ordered` serves base, lean and resort (where the packet refreshes
//     its union cap only matters across lanes; resort is a permutation of
//     the rays, applied by the wrapper), and !ordered pushes right first so
//     left pops first (noorder).
//   - lab_closest4 (L2): K1's walk, with `ordered` (nearest hit child last)
//     or the hit children pushed in order 0..3 (K2's order). No counters
//     (the TPU kernel has none). It runs on K1's machinery,
//     persistent_walk.cuh's closest_walk: persistent warps taking rays from
//     a per-launch counter (one atomicAdd per refill of a warp's idle
//     lanes, once kRefillAt are idle; an inactive ray answered at fetch
//     time), the stack in dynamic shared memory sized by the tree's stack
//     need (q_stack_need entries a thread, laid out [entry][thread]),
//     while-while (node steps until no lane of the warp has an internal
//     node next, then leaf visits), leaves stopped at their last real
//     triangle (ops/quad_traverse leaf_counts) with their loads issued
//     kGroup triangles at a time. Its node step is the shared quad_visit
//     on the metas of the node's own 128-byte row (float4 6; qmeta is not
//     read). `ordered` keeps the last child pushed, leaf or internal, in a
//     register as the entry visited next, as K1 does: it takes K1's steps
//     in K1's order, and equals K1 on every ray. Child order writes every
//     hit child to the shared-memory stack and pops the next entry (the
//     register policy spilled there).
//
// The arithmetic, leaf loops and node steps are traverse_common.cuh's,
// written in the order of the plain torch versions (raytracer_tpu_torch/
// lab/*.py), and the library is built with -fmad=false, so each kernel
// equals its plain version bit for bit, counts included.
//
// What bounds them on the card: dependent node and leaf loads, as for
// K1-K4. L1 and L9 keep their one-thread-per-ray design (a warp waits for
// its slowest ray, the stack sits in local memory); their counters add two
// registers, the multi-pop variants keep up to N metas in registers, the
// ILP leaf 4 x leaf values. The wrappers refuse a tree whose stack bound
// exceeds the stack, so it never overflows.

#include "persistent_walk.cuh"

using namespace traverse;

namespace {

constexpr int kStackCap = 128;  // binary stack (STACK_CAP)
constexpr int kQuadCap = 64;    // 4-wide stack (CAP)
constexpr float kTMin = 1e-3f;  // the lab kernels' fixed t_min
constexpr int kMaxThreads = 1024;

// kNpop metas popped per step; kIlpLeaf 0 = the serial leaf, else the ILP
// leaf of that many triangles.
template <int kNpop, int kIlpLeaf>
__global__ void __launch_bounds__(kMaxThreads)
closest_lab_kernel(const float* __restrict__ origin,
                   const float* __restrict__ direction,
                   const float* __restrict__ t_max, int64_t n, int root,
                   const float4* __restrict__ pnodes,
                   const float4* __restrict__ ptris, int leaf,
                   float* __restrict__ out_t, int* __restrict__ out_tri,
                   float* __restrict__ out_u, float* __restrict__ out_v,
                   int* __restrict__ out_nvisit, int* __restrict__ out_nleaf) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Ray r = load_ray(origin, direction, i);
  float bt = t_max[i];
  int btri = -1;
  float bu = 0.0f, bv = 0.0f;
  const int leaf_f4 = leaf * kTriStride / 4;
  int nvisit = 0, nleaf = 0;

  int stack[kStackCap];
  int sp = 0;
  if (bt > kTMin) stack[sp++] = root;
  while (sp > 0) {
    const int k = min(sp, kNpop);
    int metas[kNpop];
#pragma unroll
    for (int j = 0; j < kNpop; ++j) metas[j] = stack[max(sp - 1 - j, 0)];
    sp -= k;
    nvisit += k;
#pragma unroll
    for (int j = 0; j < kNpop; ++j) {
      if (j >= k) break;
      const int meta = metas[j];
      if (meta < 0) {
        ++nleaf;
        const float4* row = ptris + (int64_t)(~meta) * leaf_f4;
        if constexpr (kIlpLeaf > 0) {
          ilp_leaf<kIlpLeaf>(r, row, kTMin, bt, btri, bu, bv);
        } else {
          closest_leaf(r, row, leaf, kTMin, bt, btri, bu, bv);
        }
      } else {
        binary_visit<true>(r, pnodes + (int64_t)meta * 4, kTMin, bt, stack,
                           sp);
      }
    }
  }
  out_t[i] = bt;
  out_tri[i] = btri;
  out_u[i] = bu;
  out_v[i] = bv;
  out_nvisit[i] = nvisit;
  out_nleaf[i] = nleaf;
}

template <bool kOrdered>
__global__ void __launch_bounds__(kThreads)
occlusion_lab_kernel(const float* __restrict__ origin,
                     const float* __restrict__ direction,
                     const float* __restrict__ t_max,
                     const int* __restrict__ skip_object, int64_t n, int root,
                     const float4* __restrict__ pnodes,
                     const float4* __restrict__ ptris, int leaf,
                     bool* __restrict__ out_occ, int* __restrict__ out_nvisit,
                     int* __restrict__ out_nleaf) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Ray r = load_ray(origin, direction, i);
  float tm = t_max[i];
  float skip = (float)skip_object[i];
  const int leaf_f4 = leaf * kTriStride / 4;
  bool occ = false;
  int nvisit = 0, nleaf = 0;

  int stack[kStackCap];
  int sp = 0;
  if (tm > kTMin) stack[sp++] = root;
  while (sp > 0 && !occ) {
    int meta = stack[--sp];
    ++nvisit;
    if (meta < 0) {
      ++nleaf;
      occ = occluded_leaf(r, ptris + (int64_t)(~meta) * leaf_f4, leaf, kTMin,
                          tm, skip);
    } else {
      binary_visit<kOrdered>(r, pnodes + (int64_t)meta * 4, kTMin, tm, stack,
                             sp);
    }
  }
  out_occ[i] = occ;
  out_nvisit[i] = nvisit;
  out_nleaf[i] = nleaf;
}

// L2's persistent walk: K1's constants.
constexpr int kGroup = 4;      // triangles of a leaf loaded together
constexpr int kRefillAt = 16;  // idle lanes of 32 at which a warp fetches

// quad_visit's push policies in L2. In K1's order (LastInRegister) every
// hit child, leaf or internal, is pushed, but the last one stays in
// `next`, the entry the plain walk pops next (so it is never written);
// each one before it goes to the stack. In child order (AllToStack) every
// hit child goes to the stack and the next entry is popped from it: with
// the register policy there ptxas spilled to local memory at the 80
// registers it gives the kernel (6 blocks a SM); with this one it does not.
struct LastInRegister {
  Stack& st;
  int& next;
  __device__ __forceinline__ void operator()(int meta) const {
    if (next != kNone) st.push(next);
    next = meta;
  }
  __device__ __forceinline__ void near(int meta) const { (*this)(meta); }
};

struct AllToStack {
  Stack& st;
  __device__ __forceinline__ void operator()(int meta) const { st.push(meta); }
  __device__ __forceinline__ void near(int meta) const { st.push(meta); }
};

// L2's node step on qnodes row `q` (the metas from its float4 6): the near
// child last (kOrdered) or child order; returns the entry the plain walk
// pops next, or kNone when the stack is empty.
template <bool kOrdered>
__device__ __forceinline__ int quad_node(const Ray& r,
                                         const float4* __restrict__ q,
                                         float bt, Stack& st) {
  const int4 m = row_metas(__ldg(q + 6));
  if constexpr (kOrdered) {
    int next = kNone;
    quad_visit<true>(r, q, m, kTMin, bt, LastInRegister{st, next});
    return next != kNone ? next : st.pop();
  } else {
    quad_visit<false>(r, q, m, kTMin, bt, AllToStack{st});
    return st.pop();
  }
}

// L2: the 4-wide closest hit on closest_walk, one 128-byte qnodes row a
// node step.
template <bool kOrdered>
__global__ void __launch_bounds__(kThreads)
closest4_persistent_kernel(const float* __restrict__ origin,
                           const float* __restrict__ direction,
                           const float* __restrict__ t_max, int n, int root,
                           const float4* __restrict__ qnodes,
                           const float4* __restrict__ ptris,
                           const int* __restrict__ counts, int leaf,
                           int* __restrict__ next_ray,
                           float* __restrict__ out_t,
                           int* __restrict__ out_tri,
                           float* __restrict__ out_u,
                           float* __restrict__ out_v) {
  extern __shared__ int smem[];
  closest_walk<kGroup, kRefillAt>(
      smem, origin, direction, t_max, n, kTMin, root, ptris, counts, leaf,
      next_ray, out_t, out_tri, out_u, out_v,
      [&](const Ray& r, int cur, float bt, Stack& st) {
        return quad_node<kOrdered>(r, qnodes + (int64_t)cur * 8, bt, st);
      });
}

template <int kNpop, int kIlpLeaf>
int launch_closest(const float* origin, const float* direction,
                   const float* t_max, int64_t n, int root,
                   const float* pnodes, const float* ptris, int leaf,
                   float* out_t, int* out_tri, float* out_u, float* out_v,
                   int* out_nvisit, int* out_nleaf, int threads,
                   cudaStream_t stream) {
  closest_lab_kernel<kNpop, kIlpLeaf>
      <<<blocks_for(n, threads), threads, 0, stream>>>(
          origin, direction, t_max, n, root,
          reinterpret_cast<const float4*>(pnodes),
          reinterpret_cast<const float4*>(ptris), leaf, out_t, out_tri,
          out_u, out_v, out_nvisit, out_nleaf);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each launches on `stream` and
// returns the launch's cudaError_t (cudaErrorInvalidValue for an argument
// no kernel takes); none synchronises or allocates.

// variant: 0 base/nored, 1 leafilp (leaf 8 or 16), 2 pop2, 3 pop4;
// threads: a power of two in [32, 1024].
extern "C" int lab_closest(const float* origin, const float* direction,
                           const float* t_max, int64_t n, int root,
                           const float* pnodes, const float* ptris, int leaf,
                           int variant, int threads, float* out_t,
                           int* out_tri, float* out_u, float* out_v,
                           int* out_nvisit, int* out_nleaf, void* stream) {
  if (threads < 32 || threads > kMaxThreads || (threads & (threads - 1))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
#define LAB_CLOSEST_ARGS                                                  \
  origin, direction, t_max, n, root, pnodes, ptris, leaf, out_t, out_tri, \
      out_u, out_v, out_nvisit, out_nleaf, threads, s
  switch (variant) {
    case 0:
      return launch_closest<1, 0>(LAB_CLOSEST_ARGS);
    case 1:
      if (leaf == 8) return launch_closest<1, 8>(LAB_CLOSEST_ARGS);
      if (leaf == 16) return launch_closest<1, 16>(LAB_CLOSEST_ARGS);
      return (int)cudaErrorInvalidValue;
    case 2:
      return launch_closest<2, 0>(LAB_CLOSEST_ARGS);
    case 3:
      return launch_closest<4, 0>(LAB_CLOSEST_ARGS);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef LAB_CLOSEST_ARGS
}

extern "C" int lab_occlusion(const float* origin, const float* direction,
                             const float* t_max, const int* skip_object,
                             int64_t n, int root, const float* pnodes,
                             const float* ptris, int leaf, int ordered,
                             bool* out_occ, int* out_nvisit, int* out_nleaf,
                             void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  auto p4 = reinterpret_cast<const float4*>(pnodes);
  auto t4 = reinterpret_cast<const float4*>(ptris);
  if (ordered) {
    occlusion_lab_kernel<true><<<blocks_for(n), kThreads, 0, s>>>(
        origin, direction, t_max, skip_object, n, root, p4, t4, leaf,
        out_occ, out_nvisit, out_nleaf);
  } else {
    occlusion_lab_kernel<false><<<blocks_for(n), kThreads, 0, s>>>(
        origin, direction, t_max, skip_object, n, root, p4, t4, leaf,
        out_occ, out_nvisit, out_nleaf);
  }
  return (int)cudaGetLastError();
}

// L2 on persistent warps. After the rays: root, the qnodes rows (the
// metas in float4 6), ptris, its leaf counts, leaf, the tree's stack need
// `need` (1..64: the shared memory holds need entries a thread) and the
// ray counter `next_ray` (one int32, zeroed here on `stream`); then
// ordered: 1 the near child last, 0 child order.
extern "C" int lab_closest4(const float* origin, const float* direction,
                            const float* t_max, int64_t n, int root,
                            const float* qnodes, const float* ptris,
                            const int* leaf_counts, int leaf, int need,
                            int* next_ray, int ordered, float* out_t,
                            int* out_tri, float* out_u, float* out_v,
                            void* stream) {
  auto q4 = reinterpret_cast<const float4*>(qnodes);
  auto t4 = reinterpret_cast<const float4*>(ptris);
  auto kernel = ordered ? closest4_persistent_kernel<true>
                        : closest4_persistent_kernel<false>;
  return launch(kernel, n, need, kQuadCap, next_ray, stream, origin,
                direction, t_max, (int)n, root, q4, t4, leaf_counts, leaf,
                next_ray, out_t, out_tri, out_u, out_v);
}

// What a launch of `kernel` (0 L2 ordered, 1 L2 child order) at stack need
// `need` looks like on the current device: out[0..7] as
// persistent_walk.cuh's info().
extern "C" int lab_launch_info(int kernel, int need, int* out) {
  switch (kernel) {
    case 0:
      return info<kGroup, kRefillAt>(closest4_persistent_kernel<true>, need,
                                     kQuadCap, out);
    case 1:
      return info<kGroup, kRefillAt>(closest4_persistent_kernel<false>, need,
                                     kQuadCap, out);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
