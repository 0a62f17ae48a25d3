// The traversal lab's binary and 4-wide closest-hit and any-hit kernels for
// Hopper (sm_90a): L1 and L9 (K3 and K4 with per-ray visit counters) and L2
// (the 4-wide closest hit), all on persistent warps.
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
// carries over. Each lane walks its own ray depth-first, on K1-K4's
// machinery (persistent_walk.cuh): persistent warps taking rays from a
// per-launch counter (one atomicAdd per refill of a warp's idle lanes, once
// kRefillAt are idle; an inactive ray answered at fetch time), the stack in
// dynamic shared memory sized by the tree's stack need (laid out
// [entry][thread]) below the entry visited next, which stays in a
// register, and leaves stopped at their last real triangle (ops/
// quad_traverse leaf_counts) with their loads issued kGroup triangles at a
// time.
//
//   - lab_closest (L1): K3's walk (closest_walk with K3's node step,
//     binary_node: far child to the stack, near one to the register) and a
//     counting hook that counts per ray what the TPU kernels count per
//     packet: nvisit, every entry visited, and nleaf, the leaf ones; an
//     inactive ray gets 0s. Variant 0 serves both `base` and `nored` (for
//     one ray, any(hit) and min(t_near) < BIG are the same predicate) and
//     takes K3's steps in K3's order with K3's arithmetic, so it equals K3
//     on every ray. Variant 1 (`leafilp`) tests every slot of a leaf row
//     against the entry best t and picks the winner with a pairwise min
//     tree in which a tie keeps the lower index (ilp_leaf; 8 or 16, the
//     sizes the lab bakes): it equals the serial leaf. Variants 2/3
//     (`pop2`, `pop4`) are tools/kernel_lab.py:69's multi-pop step: the
//     register entry and up to N - 1 entries popped from the stack, visited
//     in order (a leaf tested when its turn comes, an internal node pushing
//     its hit children far then near, each visit seeing the best t of
//     those before it), nvisit += k. A step mixes leaves and nodes, so it
//     has a walk of its own (closest_multipop_kernel) on the same fetch and
//     Stack, with K1's "last in register" push: visit j's children lie
//     above visit j-1's, as on the plain walk's stack. Each lane keeps its
//     step's entries in registers, and the warp runs while-while over
//     them: a lane's visits stay in its order, the lanes of a warp need
//     not visit in step. Its stack need is npop x (depth + 2), the plain
//     walk's bound. `threads` is the block (L1b maps the TPU's rays per
//     packet to threads per block, 64-1024, which changes neither results
//     nor counts): the stack's stride, and need x threads x 4 B of shared
//     memory a block. At 1024 threads a thread has 64 registers, so that
//     block loads its leaves 2 triangles at a time (kL1Group).
//   - lab_occlusion (L9): K4's walk (any_walk) with the counting hook;
//     `ordered` serves base, lean and resort (where the packet refreshes
//     its union cap only matters across lanes; resort is a permutation of
//     the rays, applied by the wrapper) and equals K4's mask; !ordered
//     pushes right first so left pops first (noorder), on the same node
//     step with the left child in the register.
//   - lab_closest4 (L2): K1's walk, with `ordered` (nearest hit child last)
//     or the hit children pushed in order 0..3 (K2's order). No counters
//     (the TPU kernel has none). Its node step is the shared quad_visit on
//     the metas of the node's own 128-byte row (float4 6; qmeta is not
//     read). `ordered` keeps the last child pushed, leaf or internal, in a
//     register as the entry visited next, as K1 does: it takes K1's steps
//     in K1's order, and equals K1 on every ray. Child order writes every
//     hit child to the shared-memory stack and pops the next entry (the
//     register policy spilled there).
//
// The arithmetic, leaf loops and node steps are traverse_common.cuh's and
// persistent_walk.cuh's, written in the order of the plain torch versions
// (raytracer_tpu_torch/lab/*.py), and the library is built with
// -fmad=false, so each kernel equals its plain version bit for bit, counts
// included.
//
// What bounds them on the card: dependent node and leaf loads, as for
// K1-K4, whose machinery they share (PERF.md gives each kernel's bound on
// the triangles it tests and its time against it); a warp no longer waits
// for its slowest ray, and no stack sits in local memory. The counters add
// two registers a thread and two stores a ray, which cost L9 one block a
// SM against K4 (80 registers, 6 blocks; see occlusion_lab_persistent_
// kernel); the multi-pop walk keeps N + 1 entries in registers and moves
// every pushed entry but the last through the shared stack; the ILP leaf
// holds a whole row's candidates (124 registers at leaf 16, 4 blocks). The
// wrappers refuse a stack need above the stack (STACK_CAP), so it never
// overflows.

#include "persistent_walk.cuh"

using namespace traverse;

namespace {

constexpr int kStackCap = 128;  // binary stack (STACK_CAP)
constexpr int kQuadCap = 64;    // 4-wide stack (CAP)
constexpr float kTMin = 1e-3f;  // the lab kernels' fixed t_min

// K1-K4's constants.
constexpr int kGroup = 4;      // triangles of a leaf loaded together
constexpr int kRefillAt = 16;  // idle lanes of 32 at which a warp fetches

// The push policies of L2's quad_visit (and of L1's multi-pop step's
// binary_visit). In K1's order (LastInRegister) every hit child, leaf or
// internal, is pushed, but the last one stays in `next`, the entry the
// plain walk pops next (so it is never written); each one before it goes
// to the stack. In L2's child order (AllToStack) every hit child goes to
// the stack and the next entry is popped from it: with the register policy
// there ptxas spilled to local memory at the 80 registers it gives the
// kernel (6 blocks a SM); with this one it does not.
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

// L1's and L9's per-ray hook on closest_walk and any_walk: nvisit counts
// every entry the walk visits, nleaf the leaf ones, written when the ray
// ends (0s for an inactive ray). A closest-hit leaf is tested as K3 tests
// it (kIlpLeaf 0: the row up to its count, kG triangles at a time) or
// with the ILP leaf of kIlpLeaf slots, the whole row.
template <int kIlpLeaf, int kG = kGroup>
struct CountingHook {
  int* __restrict__ out_nvisit;
  int* __restrict__ out_nleaf;
  int nvisit = 0, nleaf = 0;
  __device__ __forceinline__ void start() { nvisit = nleaf = 0; }
  __device__ __forceinline__ void visit(bool leaf) {
    ++nvisit;
    nleaf += leaf;
  }
  __device__ __forceinline__ void finish(int i) const {
    out_nvisit[i] = nvisit;
    out_nleaf[i] = nleaf;
  }
  __device__ __forceinline__ void skip(int i) const {
    out_nvisit[i] = 0;
    out_nleaf[i] = 0;
  }
  __device__ __forceinline__ void closest_leaf(
      const Ray& r, const float4* __restrict__ row, int count, int leaf,
      float t_min, float& bt, int& btri, float& bu, float& bv) const {
    if constexpr (kIlpLeaf > 0) {
      ilp_leaf<kIlpLeaf>(r, row, t_min, bt, btri, bu, bv);
    } else {
      closest_leaf_grouped<kG>(r, row, count, leaf, t_min, bt, btri, bu, bv);
    }
  }
};

// The leaf group of L1's kernel at kBlock threads a block. At 1024 threads
// a thread has 64 registers, and K3's G = 4 spilled there (210 B), so that
// block loads its leaves 2 triangles at a time (62 registers); a group
// changes when loads are issued, not what is tested.
template <int kBlock>
constexpr int kL1Group = kBlock == 1024 ? 2 : kGroup;

// L1 base/nored (kIlpLeaf 0) and leafilp at kBlock threads a block: K3's
// walk with counters, its leaves grouped by kL1Group<kBlock>.
template <int kIlpLeaf, int kBlock>
__global__ void __launch_bounds__(kBlock)
closest_lab_persistent_kernel(const float* __restrict__ origin,
                              const float* __restrict__ direction,
                              const float* __restrict__ t_max, int n,
                              int root, const float4* __restrict__ pnodes,
                              const float4* __restrict__ ptris,
                              const int* __restrict__ counts, int leaf,
                              int* __restrict__ next_ray,
                              float* __restrict__ out_t,
                              int* __restrict__ out_tri,
                              float* __restrict__ out_u,
                              float* __restrict__ out_v,
                              int* __restrict__ out_nvisit,
                              int* __restrict__ out_nleaf) {
  extern __shared__ int smem[];
  constexpr int kG = kL1Group<kBlock>;
  closest_walk<kG, kRefillAt, kBlock>(
      smem, origin, direction, t_max, n, kTMin, root, ptris, counts, leaf,
      next_ray, out_t, out_tri, out_u, out_v,
      [&](const Ray& r, int cur, float bt, BlockStack<kBlock>& st) {
        return binary_node(r, pnodes + (int64_t)cur * 4, kTMin, bt, st);
      },
      CountingHook<kIlpLeaf, kG>{out_nvisit, out_nleaf});
}

// L1 pop2/pop4: the multi-pop walk of a persistent block. A step of a lane
// takes the plain walk's top k = min(sp, kNpop) entries (its register
// entry `next`, the last one the step before pushed, and the rest popped
// from the stack) and visits them in that order: a leaf tested, an
// internal node pushing its hit children with LastInRegister, so that the
// last one pushed is the next step's first entry and the stack keeps the
// plain walk's order (visit j's children above visit j-1's). A step's
// visits are in order for its ray, but the lanes of a warp need not visit
// in step: `step` holds the entries the lane has yet to visit, and the
// warp runs node visits until no lane's next entry is an internal node,
// then leaf visits until none is a leaf (while-while, as closest_walk), a
// lane beginning its next step when its step runs out. Under plain launch
// bounds ptxas kept pop4 at 80 registers and spilled; 5 blocks a SM let
// it take 90 and spill nothing (pop2: 6 blocks, 80 registers).
template <int kNpop>
__global__ void __launch_bounds__(kThreads, kNpop > 2 ? 5 : 6)
closest_multipop_kernel(const float* __restrict__ origin,
                        const float* __restrict__ direction,
                        const float* __restrict__ t_max, int n, int root,
                        const float4* __restrict__ pnodes,
                        const float4* __restrict__ ptris,
                        const int* __restrict__ counts, int leaf,
                        int* __restrict__ next_ray, float* __restrict__ out_t,
                        int* __restrict__ out_tri, float* __restrict__ out_u,
                        float* __restrict__ out_v,
                        int* __restrict__ out_nvisit,
                        int* __restrict__ out_nleaf) {
  extern __shared__ int smem[];
  Stack st(smem);
  CountingHook<0> hook{out_nvisit, out_nleaf};
  const int leaf_f4 = leaf * kTriStride / 4;
  int ray = -1;          // the lane's ray, -1 when idle
  int step[kNpop];       // the step's entries left, in order; then kNone
  int next = kNone;      // the last entry the step pushed
  bool drained = false;
  Ray r{};
  float bt = 0.0f, bu = 0.0f, bv = 0.0f;
  int btri = -1;
  auto begin = [&]() {  // the next step; step[0] kNone: the ray ends
    step[0] = next != kNone ? next : st.pop();
    next = kNone;
#pragma unroll
    for (int j = 1; j < kNpop; ++j) step[j] = st.pop();
  };
  auto take = [&]() {  // the entry visited now; the rest move up
    const int meta = step[0];
#pragma unroll
    for (int j = 1; j < kNpop; ++j) step[j - 1] = step[j];
    step[kNpop - 1] = kNone;
    return meta;
  };
  auto start = [&](int i, float tm) {
    r = load_ray(origin, direction, i);
    bt = tm;
    btri = -1;
    bu = bv = 0.0f;
    st.clear();
    next = root;
    begin();
    hook.start();
  };
  auto skip = [&](int i, float tm) {
    out_t[i] = tm;
    out_tri[i] = -1;
    out_u[i] = 0.0f;
    out_v[i] = 0.0f;
    hook.skip(i);
  };
#pragma unroll
  for (int j = 0; j < kNpop; ++j) step[j] = kNone;
  for (;;) {
    if (fetch<kRefillAt>(ray, drained, n, next_ray, t_max, kTMin, start,
                         skip) == kFull) {
      return;
    }
    while (__any_sync(kFull, step[0] >= 0)) {
      if (step[0] >= 0) {
        const int node = take();
        hook.visit(false);
        binary_visit<true>(r, pnodes + (int64_t)node * 4, kTMin, bt,
                           LastInRegister{st, next});
        if (step[0] == kNone) begin();
      }
    }
    while (__any_sync(kFull, is_leaf(step[0]))) {
      if (is_leaf(step[0])) {
        const int block = ~take();
        hook.visit(true);
        hook.closest_leaf(r, ptris + (int64_t)block * leaf_f4,
                          __ldg(counts + block), leaf, kTMin, bt, btri, bu,
                          bv);
        if (step[0] == kNone) begin();
      }
    }
    if (ray >= 0 && step[0] == kNone) {
      out_t[ray] = bt;
      out_tri[ray] = btri;
      out_u[ray] = bu;
      out_v[ray] = bv;
      hook.finish(ray);
      ray = -1;
    }
  }
}

// L9: K4's walk with counters; the near child first (kOrdered) or the left
// child first. Under plain launch bounds ptxas kept it at K4's 72
// registers (7 blocks a SM) and spilled 42 B for the counters; 6 blocks a
// SM let it take 80 and spill nothing.
template <bool kOrdered>
__global__ void __launch_bounds__(kThreads, 6)
occlusion_lab_persistent_kernel(const float* __restrict__ origin,
                                const float* __restrict__ direction,
                                const float* __restrict__ t_max,
                                const int* __restrict__ skip_object, int n,
                                int root, const float4* __restrict__ pnodes,
                                const float4* __restrict__ ptris,
                                const int* __restrict__ counts, int leaf,
                                int* __restrict__ next_ray,
                                bool* __restrict__ out_occ,
                                int* __restrict__ out_nvisit,
                                int* __restrict__ out_nleaf) {
  extern __shared__ int smem[];
  any_walk<kGroup, kRefillAt>(
      smem, origin, direction, t_max, skip_object, n, kTMin, root, ptris,
      counts, leaf, next_ray, out_occ,
      [&](const Ray& r, int cur, float tm, Stack& st) {
        return binary_node<kOrdered>(r, pnodes + (int64_t)cur * 4, kTMin, tm,
                                     st);
      },
      CountingHook<0>{out_nvisit, out_nleaf});
}

// lab_closest's launch of an L1 kernel in blocks of kBlock threads.
template <int kBlock, class Kernel>
int closest_launch(Kernel kernel, const float* origin,
                   const float* direction, const float* t_max, int64_t n,
                   int root, const float* pnodes, const float* ptris,
                   const int* leaf_counts, int leaf, int need, int* next_ray,
                   float* out_t, int* out_tri, float* out_u, float* out_v,
                   int* out_nvisit, int* out_nleaf, void* stream) {
  return launch<kBlock>(kernel, n, need, kStackCap, next_ray, stream, origin,
                        direction, t_max, (int)n, root,
                        reinterpret_cast<const float4*>(pnodes),
                        reinterpret_cast<const float4*>(ptris), leaf_counts,
                        leaf, next_ray, out_t, out_tri, out_u, out_v,
                        out_nvisit, out_nleaf);
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each zeroes its ray counter
// `next_ray` (one int32 on the device) and launches on `stream`, and
// returns the first cudaError_t (cudaErrorInvalidValue for an argument no
// kernel takes); none synchronises or allocates.

// L1. After the rays: root, the pnodes rows, ptris, its leaf counts, leaf,
// the stack need `need` (1..128: the shared memory holds need entries a
// thread; stack_need for variants 0 and 1, npop x (depth + 2) for 2 and 3)
// and the ray counter; then variant: 0 base/nored, 1 leafilp (leaf 8 or
// 16), 2 pop2, 3 pop4; threads: 64, 128, 256, 512 or 1024 for variant 0,
// 128 for the others.
extern "C" int lab_closest(const float* origin, const float* direction,
                           const float* t_max, int64_t n, int root,
                           const float* pnodes, const float* ptris,
                           const int* leaf_counts, int leaf, int need,
                           int* next_ray, int variant, int threads,
                           float* out_t, int* out_tri, float* out_u,
                           float* out_v, int* out_nvisit, int* out_nleaf,
                           void* stream) {
#define LAB_CLOSEST_ARGS                                                 \
  origin, direction, t_max, n, root, pnodes, ptris, leaf_counts, leaf,  \
      need, next_ray, out_t, out_tri, out_u, out_v, out_nvisit, out_nleaf, \
      stream
  if (variant == 0) {
    switch (threads) {
      case 64:
        return closest_launch<64>(closest_lab_persistent_kernel<0, 64>,
                                  LAB_CLOSEST_ARGS);
      case 128:
        return closest_launch<128>(closest_lab_persistent_kernel<0, 128>,
                                   LAB_CLOSEST_ARGS);
      case 256:
        return closest_launch<256>(closest_lab_persistent_kernel<0, 256>,
                                   LAB_CLOSEST_ARGS);
      case 512:
        return closest_launch<512>(closest_lab_persistent_kernel<0, 512>,
                                   LAB_CLOSEST_ARGS);
      case 1024:
        return closest_launch<1024>(closest_lab_persistent_kernel<0, 1024>,
                                    LAB_CLOSEST_ARGS);
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  if (threads != kThreads) return (int)cudaErrorInvalidValue;
  switch (variant) {
    case 1:
      if (leaf == 8) {
        return closest_launch<kThreads>(
            closest_lab_persistent_kernel<8, kThreads>, LAB_CLOSEST_ARGS);
      }
      if (leaf == 16) {
        return closest_launch<kThreads>(
            closest_lab_persistent_kernel<16, kThreads>, LAB_CLOSEST_ARGS);
      }
      return (int)cudaErrorInvalidValue;
    case 2:
      return closest_launch<kThreads>(closest_multipop_kernel<2>,
                                      LAB_CLOSEST_ARGS);
    case 3:
      return closest_launch<kThreads>(closest_multipop_kernel<4>,
                                      LAB_CLOSEST_ARGS);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef LAB_CLOSEST_ARGS
}

// L9, after the rays and skip_object: as lab_closest's (need: stack_need);
// then ordered: 1 the near child first (base, lean, resort), 0 the left
// child first (noorder).
extern "C" int lab_occlusion(const float* origin, const float* direction,
                             const float* t_max, const int* skip_object,
                             int64_t n, int root, const float* pnodes,
                             const float* ptris, const int* leaf_counts,
                             int leaf, int need, int* next_ray, int ordered,
                             bool* out_occ, int* out_nvisit, int* out_nleaf,
                             void* stream) {
  auto kernel = ordered ? occlusion_lab_persistent_kernel<true>
                        : occlusion_lab_persistent_kernel<false>;
  return launch(kernel, n, need, kStackCap, next_ray, stream, origin,
                direction, t_max, skip_object, (int)n, root,
                reinterpret_cast<const float4*>(pnodes),
                reinterpret_cast<const float4*>(ptris), leaf_counts, leaf,
                next_ray, out_occ, out_nvisit, out_nleaf);
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

// What a launch of `kernel` at stack need `need` looks like on the current
// device: out[0..8] as persistent_walk.cuh's info(). Kernels: 0 L2
// ordered, 1 L2 child order; 2 L1 base (128 threads), 3 leafilp leaf 8, 4
// leafilp leaf 16, 5 pop2, 6 pop4, 7-10 L1b at 64, 256, 512, 1024 threads;
// 11 L9 ordered, 12 L9 noorder.
extern "C" int lab_launch_info(int kernel, int need, int* out) {
  switch (kernel) {
    case 0:
      return info<kGroup, kRefillAt>(closest4_persistent_kernel<true>, need,
                                     kQuadCap, out);
    case 1:
      return info<kGroup, kRefillAt>(closest4_persistent_kernel<false>, need,
                                     kQuadCap, out);
    case 2:
      return info<kGroup, kRefillAt>(
          closest_lab_persistent_kernel<0, kThreads>, need, kStackCap, out);
    case 3:
      return info<kGroup, kRefillAt>(
          closest_lab_persistent_kernel<8, kThreads>, need, kStackCap, out);
    case 4:
      return info<kGroup, kRefillAt>(
          closest_lab_persistent_kernel<16, kThreads>, need, kStackCap, out);
    case 5:
      return info<kGroup, kRefillAt>(closest_multipop_kernel<2>, need,
                                     kStackCap, out);
    case 6:
      return info<kGroup, kRefillAt>(closest_multipop_kernel<4>, need,
                                     kStackCap, out);
    case 7:
      return info<kGroup, kRefillAt, 64>(closest_lab_persistent_kernel<0, 64>,
                                         need, kStackCap, out);
    case 8:
      return info<kGroup, kRefillAt, 256>(
          closest_lab_persistent_kernel<0, 256>, need, kStackCap, out);
    case 9:
      return info<kGroup, kRefillAt, 512>(
          closest_lab_persistent_kernel<0, 512>, need, kStackCap, out);
    case 10:
      return info<kL1Group<1024>, kRefillAt, 1024>(
          closest_lab_persistent_kernel<0, 1024>, need, kStackCap, out);
    case 11:
      return info<kGroup, kRefillAt>(occlusion_lab_persistent_kernel<true>,
                                     need, kStackCap, out);
    case 12:
      return info<kGroup, kRefillAt>(occlusion_lab_persistent_kernel<false>,
                                     need, kStackCap, out);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
