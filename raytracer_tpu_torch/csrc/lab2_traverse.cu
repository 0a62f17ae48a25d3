// The traversal lab's deferred-leaf and component-major kernels for Hopper
// (sm_90a), all on persistent warps: L3-L8 (L5 two walks a thread).
//
// Replaces the TPU lab kernels
//   - tools/v2_kernel_lab.py:174 (run_closest_v2, L3): K3's walk over
//     component-major leaf rows with a one-pass leaf reduction;
//   - tools/v3_kernel_lab.py:290 (run_closest_v3, L4): the deferred-leaf
//     walk of the production sub-packet kernel on the binary tree, with
//     step counters; variants base, nocond, dblread; drain_at;
//   - tools/v4_interleave_lab.py:276 (run_closest_v4, L5): two L4 walks
//     interleaved in one instance, sharing the step kind or not;
//   - tools/r3_kernel_lab.py:334 (run_closest_variant, L6): the deferred-
//     leaf walk on the 4-wide tree, with register descent, the division-
//     free Moller-Trumbore and the ILP leaf;
//   - tools/r3_oct_lab.py:265 (run_closest8, _closest_kernel8 :105, L7):
//     the deferred-leaf walk on the 8-wide (oct) tree;
//   - tools/r3_occl3_lab.py:133 (run_occl_ordered,
//     _occlusion_kernel_ordered :36, L8): the deferred-leaf any-hit walk
//     on the 4-wide tree with the near child pushed last (and, for the
//     comparison with K2, in child order).
// The TPU kernels walk one tree per 8-row sub-packet (a row per ray path)
// out of SMEM stacks and queues, because Mosaic has no per-lane gathers.
// Here each lane walks its own ray (L5: its own two):
//
//   - the deferred-leaf walk (lab/queue_walk.py): only internal nodes go on
//     the stack (CAP = 64); a hit leaf child goes into the leaf queue (LQ =
//     16) when it is pushed. Each step is a leaf step, popping the queue's
//     top block and testing it, when ln >= drain_at or (no node pending and
//     ln > 0); else an internal step, popping one node (with descent, the
//     near child kept in a register instead, if any) and pushing its hit
//     children far first, near last. The push policy routes them
//     (traverse_common.cuh's node steps take it in place of the stack);
//   - lab_closest_queued (L4): that walk on the binary tree, one 64-byte
//     pnodes row a node step (binary_visit<true>), counting per ray what
//     the TPU kernel counts per packet: nit, every step, and nleaf, the
//     leaf steps. `nocond` drops leaf children at push time (its results
//     are wrong by design); `dblread` loads row max(node-1, 0) as well and
//     folds its first float, times 0.0, into the t cap (1 + 0*x is not
//     folded without fast-math, so the load stays and the results equal
//     base's while boxes are finite);
//   - lab_closest_pair (L5): a lane walks the rays 2j and 2j+1 of the pair
//     j it fetches, each in a slot of its own (a LaneQueue, the ray and its
//     best hit), with L4 base's node step and leaf. `shared`: each step
//     both take a leaf step if either one's drain condition holds, else
//     both an internal step; a ray with nothing of that kind sits the step
//     out. `switch`: each ray its own kind, so per ray it is L4 base. A
//     node step loads both slots' rows before either slot's slab test: two
//     independent row loads in flight in one thread, where L4 has one;
//   - lab_closest4_queued (L6): the 4-wide walk (quad_visit<true>, the
//     metas from the qnodes row's float4 6); the near child (the 2-bit
//     argmin) is pushed last. `descent` keeps the stack's top in a register
//     (RegisterPush); without it every internal child is written to the
//     shared-memory stack and the next node popped from it (SharedPush).
//     Both pop the same nodes in the same order, so they are equal; their
//     times differ by what the register saves. Leaf kinds: serial, division-
//     free (accepts in det-scaled space, best t carried as num/den through
//     the step, one divide at its end), both to the row's count, or ILP
//     (ilp_leaf<8>: every slot of the row against the entry best t, then a
//     min tree);
//   - lab_closest8_queued (L7): the 8-wide walk (oct_visit of
//     traverse_common.cuh): a node step reads its 256-byte onodes row, the
//     boxes of children 0-3, then of 4-7 (the tournament's first level of
//     each half kept between them), and the 8 metas from the row's columns
//     48:56 (exact f32); it pushes the hit children in child order but the
//     near one (the 3-bit tournament), which goes last. A step queues up
//     to 8 leaves, so drain_at is in 1..LQ-8;
//   - lab_occlusion4_queued (L8): the 4-wide walk (quad_visit, the metas
//     from the qnodes row's float4 6) with the any-hit leaf step
//     against t_max (skip_object as f32): an occluded ray stops at once, as
//     the TPU kernel's per-row exit; the node step caps its slab tests at
//     t_max and pushes the near child last (ordered) or every child in
//     child order (the production K2's order);
//   - lab_closest_cm (L3): K3's walk itself (persistent_walk.cuh's
//     closest_walk and binary_node: leaves on the stack) with a leaf hook of
//     its own: a leaf reads each of its 10 used components as float4s
//     (component c of triangle k at lane leaf*c + k), 4 triangles a float4,
//     up to the group holding the row's last real triangle, tests them
//     against the entry best t, and keeps the least t and, among the
//     triangles at that t, the largest index (cm_leaf).
//
// The arithmetic is traverse_common.cuh's, written in the order of the
// plain torch versions, and the library is built with -fmad=false, so each
// kernel equals its plain version bit for bit, counts included.
//
// What bounds them on the card: the latency of dependent node and leaf
// loads, as for K1-K4, not bytes or arithmetic. The deferred leaf changes
// when a leaf row is read, not how many: the queue holds up to drain_at
// blocks while the walk descends, which delays the best t and can only add
// visits.
//
// L3 runs on K3's closest_walk. L4, L6, L7 and L8 run K1-K4's machinery
// (persistent_walk.cuh's fetch, Stack, grouped leaves and launch) in one
// walk, queued_walk, for a closest-hit or an any-hit ray (ClosestRay with
// its leaf kind, AnyRay), a push policy (RegisterPush, L4 nocond's
// RegisterPushTo<true> or L6's SharedPush) and a per-ray hook (L4's
// StepCounts; the others count nothing). L5 runs two of queued_walk's lane
// states (LaneQueue, ClosestRay) in each thread, on the same pieces:
//
//   1. persistent warps: the occupancy calculator's grid, each warp taking
//      rays (L5: pairs, fetch_with) from a per-launch counter (one
//      atomicAdd per refill of its idle lanes, once kRefillAt are idle); an
//      inactive ray (L5: a pair of two) is answered at fetch time, and L8's
//      occluded ray frees its lane at once;
//   2. the stack and the leaf queue in dynamic shared memory, laid out
//      [entry][thread]: the tree's stack need (OctTree.stack_need,
//      q_stack_need, the binary tree's stack_need = depth + 2; at most CAP)
//      plus LQ entries a thread (L5: twice), the stack's top in a register
//      (RegisterPush: the last internal child a step pushes is the node the
//      plain walk pops next, and is never written; L6 without descent
//      writes it and pops it back). L3 has K3's stack (depth + 2 entries, at
//      most 128) and no queue;
//   3. while-while over the drain rule: node steps while a lane's next step
//      (L5: a slot's) is a node step, then leaf steps while a lane's next
//      step is a leaf step; each lane's (slot's) next step is still decided
//      by its own state (L5 shared: its pair's), so its sequence of steps
//      is the plain walk's;
//   4. one row per node: the metas come from the node row, not from
//      ometa/qmeta;
//   5. leaves stop at their last real triangle (ops/quad_traverse
//      leaf_counts of the row-major ptris), their loads issued kGroup
//      triangles at a time (closest_leaf_grouped, divfree_leaf_grouped,
//      occluded_leaf_grouped), or a float4 group of 4 at a time (L3). The
//      slots past the count hold zero triangles, never accepted, so results
//      and steps do not change. L6's ILP leaf loads the whole row at once.
// Per ray, an L7 node step reads 224 B of its 256-byte row (two 128-byte
// lines) where the 4-wide walk reads 112 B of one line, for fewer node
// steps; each does 8 slab tests (25 FP32 operations each) and the 3-bit
// tournament (13). A component-major leaf group is 10 float4 for 4
// triangles, where the row-major layout takes 12. PERF.md gives each
// kernel's byte and operation bound and its time against it.

#include <type_traits>

#include "persistent_walk.cuh"

using namespace traverse;

namespace {

constexpr int kCap = 64;         // the queued walks' internal-node stack
constexpr int kLQ = 16;         // the leaf queue
constexpr int kBinaryCap = 128;  // L3's stack need at most (K3's STACK_CAP)
constexpr float kTMin = 1e-3f;  // the lab kernels' fixed t_min

enum BinaryVariant { kBase = 0, kNocond = 1, kDblread = 2 };
enum LeafKind { kSerialLeaf = 0, kDivfreeLeaf = 1, kIlpLeaf = 2 };

// ---------------------------------------------------------------------------
// L3, L4, L6, L7 and L8 on persistent warps (persistent_walk.cuh's fetch,
// Stack, grouped leaves and launch).
// ---------------------------------------------------------------------------

constexpr int kGroup = 4;      // triangles of a leaf loaded together (K1's)
constexpr int kRefillAt = 16;  // idle lanes of 32 at which a warp fetches

// The queued walk's state of one lane: the internal node it visits next in
// a register (`cur`, kNone when none; the plain walk's stack top), the
// internal nodes below it and the leaf queue in the block's dynamic shared
// memory, `need` stack entries then kLQ queue entries a thread, each laid
// out [entry][thread]. lq.sp is the plain walk's ln.
struct LaneQueue {
  Stack st;
  Stack lq;
  int cur = kNone;
  __device__ LaneQueue(int* smem, int need)
      : st(smem), lq(smem + need * kThreads) {}
  __device__ __forceinline__ void start(int root) {
    st.clear();
    lq.clear();
    cur = root >= 0 ? root : kNone;
    if (root < 0) lq.push(~root);
  }
  __device__ __forceinline__ void clear() {
    cur = kNone;
    st.clear();
    lq.clear();
  }
  // The drain rule: a leaf step when ln >= drain_at, or when no node is
  // pending and ln > 0; else a node step while a node is pending.
  __device__ __forceinline__ bool wants_leaf(int drain_at) const {
    return lq.sp >= drain_at || (cur == kNone && lq.sp > 0);
  }
  __device__ __forceinline__ bool wants_node(int drain_at) const {
    return cur != kNone && lq.sp < drain_at;
  }
  __device__ __forceinline__ bool alive() const {
    return cur != kNone || lq.sp > 0;
  }
};

// The push policy of a persistent node step: a hit internal child goes on
// the stack, but the last one pushed stays in `top` (the node the plain
// walk pops next, so it is never written); a hit leaf child goes into the
// leaf queue, or nowhere with kDropLeaves (L4 nocond).
template <bool kDropLeaves = false>
struct RegisterPushTo {
  int& top;
  Stack& st;
  Stack& lq;
  __device__ __forceinline__ void operator()(int meta) const {
    if (meta >= 0) {
      if (top != kNone) st.push(top);
      top = meta;
    } else if (!kDropLeaves) {
      lq.push(~meta);
    }
  }
  __device__ __forceinline__ void near(int meta) const { (*this)(meta); }
};

using RegisterPush = RegisterPushTo<>;

// L6's push policy without descent: a hit internal child goes on the
// stack, every one of them, and the next node is popped from it (`top` is
// never set); a hit leaf child goes into the leaf queue. It pops
// RegisterPush's nodes in RegisterPush's order, so the two walks are
// equal; their times differ by what the register top entry saves.
struct SharedPush {
  int& top;
  Stack& st;
  Stack& lq;
  __device__ __forceinline__ void operator()(int meta) const {
    if (meta >= 0) {
      st.push(meta);
    } else {
      lq.push(~meta);
    }
  }
  __device__ __forceinline__ void near(int meta) const { (*this)(meta); }
};

// tools/r3_kernel_lab.py:47 _leaf_step_divfree, one triangle: the accept
// test in det-scaled space against the best t carried as num / den.
__device__ __forceinline__ void divfree_test(const Ray& r, float4 f0,
                                             float4 f1, float4 f2,
                                             float& num, float& den,
                                             int& btri, float& su,
                                             float& sv) {
  float v0x = f0.x, v0y = f0.y, v0z = f0.z;
  float e1x = f0.w, e1y = f1.x, e1z = f1.y;
  float e2x = f1.z, e2y = f1.w, e2z = f2.x;
  float px = r.dy * e2z - r.dz * e2y;
  float py = r.dz * e2x - r.dx * e2z;
  float pz = r.dx * e2y - r.dy * e2x;
  float det = e1x * px + e1y * py + e1z * pz;
  float s = det >= 0.0f ? 1.0f : -1.0f;
  float a = det * s;
  float tx = r.ox - v0x;
  float ty = r.oy - v0y;
  float tz = r.oz - v0z;
  float up = (tx * px + ty * py + tz * pz) * s;
  float qx = ty * e1z - tz * e1y;
  float qy = tz * e1x - tx * e1z;
  float qz = tx * e1y - ty * e1x;
  float vp = (r.dx * qx + r.dy * qy + r.dz * qz) * s;
  float tp = (e2x * qx + e2y * qy + e2z * qz) * s;
  if (a > 1e-10f && up >= 0.0f && vp >= 0.0f && up + vp <= a &&
      tp > kTMin * a && tp * den < num * a) {
    num = tp;
    den = a;
    btri = (int)f2.y;
    su = up;
    sv = vp;
  }
}

// The division-free leaf (_leaf_step_divfree per ray): (num, den) = (entry
// best t, 1), the row's first `count` triangles in slot order, loaded as in
// closest_leaf_grouped, and one divide at the end. A zero triangle past
// the count has a = 0 and is never accepted, so stopping there changes
// nothing.
template <int kGroup>
__device__ __forceinline__ void divfree_leaf_grouped(
    const Ray& r, const float4* __restrict__ row, int count, int leaf,
    float& bt, int& btri, float& bu, float& bv) {
  float num = bt, den = 1.0f, su = bu, sv = bv;
  float4 a[kGroup], b[kGroup], c[kGroup];
  load_group<kGroup>(row, 0, leaf, a, b, c);
  for (int k = 0;;) {
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      if (k + j < count) divfree_test(r, a[j], b[j], c[j], num, den, btri,
                                      su, sv);
    }
    k += kGroup;
    if (k >= count) break;
    load_group<kGroup>(row, k, count, a, b, c);
  }
  float inv = 1.0f / den;
  bt = num * inv;
  bu = su * inv;
  bv = sv * inv;
}

// A closest-hit ray (L6, L7): its best hit, its leaf step and its outputs.
// The leaf step is kLeafKind's: serial (the row's triangles up to its
// count, closest_leaf_grouped), division-free (divfree_leaf_grouped, to the
// count) or ILP (ilp_leaf<8>, the whole row: its point is 8 independent
// tests).
template <int kLeafKind>
struct ClosestRay {
  const float4* __restrict__ ptris;
  const int* __restrict__ counts;
  int leaf;
  float* __restrict__ out_t;
  int* __restrict__ out_tri;
  float* __restrict__ out_u;
  float* __restrict__ out_v;
  float bt = 0.0f, bu = 0.0f, bv = 0.0f;
  int btri = -1;
  __device__ __forceinline__ void start(int, float tm) {
    bt = tm;
    btri = -1;
    bu = bv = 0.0f;
  }
  __device__ __forceinline__ void skip(int i, float tm) const {
    out_t[i] = tm;
    out_tri[i] = -1;
    out_u[i] = 0.0f;
    out_v[i] = 0.0f;
  }
  __device__ __forceinline__ float bound() const { return bt; }
  // Returns whether the ray ends here: never before its queue is empty.
  __device__ __forceinline__ bool leaf_step(const Ray& r, int block,
                                            int leaf_f4) {
    const float4* row = ptris + (int64_t)block * leaf_f4;
    if constexpr (kLeafKind == kIlpLeaf) {
      ilp_leaf<8>(r, row, kTMin, bt, btri, bu, bv);
    } else if constexpr (kLeafKind == kDivfreeLeaf) {
      divfree_leaf_grouped<kGroup>(r, row, __ldg(counts + block), leaf, bt,
                                   btri, bu, bv);
    } else {
      closest_leaf_grouped<kGroup>(r, row, __ldg(counts + block), leaf,
                                   kTMin, bt, btri, bu, bv);
    }
    return false;
  }
  __device__ __forceinline__ void finish(int i) const {
    out_t[i] = bt;
    out_tri[i] = btri;
    out_u[i] = bu;
    out_v[i] = bv;
  }
};

// An any-hit ray (L8): t_max as the slab cap, its skip_object as f32, and
// a leaf step that ends the ray at its first occluder.
struct AnyRay {
  const int* __restrict__ skip_object;
  const float4* __restrict__ ptris;
  const int* __restrict__ counts;
  int leaf;
  bool* __restrict__ out_occ;
  float tm = 0.0f, skip_f = 0.0f;
  bool occ = false;
  __device__ __forceinline__ void start(int i, float t) {
    tm = t;
    skip_f = (float)skip_object[i];
    occ = false;
  }
  __device__ __forceinline__ void skip(int i, float) const {
    out_occ[i] = false;
  }
  __device__ __forceinline__ float bound() const { return tm; }
  __device__ __forceinline__ bool leaf_step(const Ray& r, int block,
                                            int leaf_f4) {
    occ = occluded_leaf_grouped<kGroup>(r, ptris + (int64_t)block * leaf_f4,
                                        __ldg(counts + block), leaf, kTMin,
                                        tm, skip_f);
    return occ;
  }
  __device__ __forceinline__ void finish(int i) const { out_occ[i] = occ; }
};

// The queued walk of a persistent block, for a ray kind `ray_kind`
// (ClosestRay, AnyRay) and a push policy `Push` (RegisterPush, SharedPush):
// persistent_walk.cuh's fetch, then while-while over the drain rule, node
// steps (`visit(r, node, bound, push)`, then the node the policy kept in
// `top`, or a pop) until no lane's next step is a node step, then leaf
// steps (the queue's top block) until none is a leaf step. `hook` is a
// per-ray hook as closest_walk's (visit(leaf) at each step; WalkHook, the
// default, counts nothing; L4's StepCounts counts its steps).
template <class Push = RegisterPush, class RayKind, class Visit,
          class Hook = WalkHook<kGroup>>
__device__ __forceinline__ void queued_walk(
    int* smem, int need, const float* __restrict__ origin,
    const float* __restrict__ direction, const float* __restrict__ t_max,
    int n, int root, int drain_at, int* __restrict__ next_ray,
    RayKind ray_kind, const Visit& visit, Hook hook = {}) {
  LaneQueue q(smem, need);
  const int leaf_f4 = ray_kind.leaf * kTriStride / 4;
  int ray = -1;
  bool drained = false;
  Ray r{};
  auto start = [&](int i, float tm) {
    r = load_ray(origin, direction, i);
    ray_kind.start(i, tm);
    q.start(root);
    hook.start();
  };
  auto skip = [&](int i, float tm) {
    ray_kind.skip(i, tm);
    hook.skip(i);
  };
  for (;;) {
    if (fetch<kRefillAt>(ray, drained, n, next_ray, t_max, kTMin, start,
                         skip) == kFull) {
      return;
    }
    while (__any_sync(kFull, q.wants_node(drain_at))) {
      if (q.wants_node(drain_at)) {
        int top = kNone;
        hook.visit(false);
        visit(r, q.cur, ray_kind.bound(), Push{top, q.st, q.lq});
        q.cur = top != kNone ? top : q.st.pop();
      }
    }
    while (__any_sync(kFull, q.wants_leaf(drain_at))) {
      if (q.wants_leaf(drain_at)) {
        hook.visit(true);
        if (ray_kind.leaf_step(r, q.lq.pop(), leaf_f4)) q.clear();
      }
    }
    if (ray >= 0 && !q.alive()) {
      ray_kind.finish(ray);
      hook.finish(ray);
      ray = -1;
    }
  }
}

// L7: the 8-wide walk, one 256-byte onodes row a node step.
__global__ void __launch_bounds__(kThreads)
closest8_queued_kernel(const float* __restrict__ origin,
                       const float* __restrict__ direction,
                       const float* __restrict__ t_max, int n, int root,
                       const float4* __restrict__ onodes,
                       const float4* __restrict__ ptris,
                       const int* __restrict__ counts, int leaf, int need,
                       int drain_at, int* __restrict__ next_ray,
                       float* __restrict__ out_t, int* __restrict__ out_tri,
                       float* __restrict__ out_u, float* __restrict__ out_v) {
  extern __shared__ int smem[];
  queued_walk(
      smem, need, origin, direction, t_max, n, root, drain_at, next_ray,
      ClosestRay<kSerialLeaf>{ptris, counts, leaf, out_t, out_tri, out_u,
                              out_v},
      [&](const Ray& r, int node, float bt, const RegisterPush& push) {
        oct_visit(r, onodes + (int64_t)node * 16, kTMin, bt, push);
      });
}

// L8: the 4-wide any-hit walk, one 128-byte qnodes row a node step (the
// metas from its float4 6); the near child last (kOrdered) or child order.
template <bool kOrdered>
__global__ void __launch_bounds__(kThreads)
occlusion4_queued_kernel(const float* __restrict__ origin,
                         const float* __restrict__ direction,
                         const float* __restrict__ t_max,
                         const int* __restrict__ skip_object, int n, int root,
                         const float4* __restrict__ qnodes,
                         const float4* __restrict__ ptris,
                         const int* __restrict__ counts, int leaf, int need,
                         int drain_at, int* __restrict__ next_ray,
                         bool* __restrict__ out_occ) {
  extern __shared__ int smem[];
  queued_walk(
      smem, need, origin, direction, t_max, n, root, drain_at, next_ray,
      AnyRay{skip_object, ptris, counts, leaf, out_occ},
      [&](const Ray& r, int node, float tm, const RegisterPush& push) {
        const float4* row = qnodes + (int64_t)node * 8;
        quad_visit<kOrdered>(r, row, row_metas(__ldg(row + 6)), kTMin, tm,
                             push);
      });
}

// L6: the 4-wide closest-hit walk, one 128-byte qnodes row a node step (the
// metas from its float4 6), the near child last; the stack's top in a
// register (kDescent, RegisterPush) or every internal child through shared
// memory (SharedPush); kLeafKind's leaf step.
template <bool kDescent, int kLeafKind>
__global__ void __launch_bounds__(kThreads)
closest4_queued_persistent_kernel(const float* __restrict__ origin,
                                  const float* __restrict__ direction,
                                  const float* __restrict__ t_max, int n,
                                  int root, const float4* __restrict__ qnodes,
                                  const float4* __restrict__ ptris,
                                  const int* __restrict__ counts, int leaf,
                                  int need, int drain_at,
                                  int* __restrict__ next_ray,
                                  float* __restrict__ out_t,
                                  int* __restrict__ out_tri,
                                  float* __restrict__ out_u,
                                  float* __restrict__ out_v) {
  using Push = std::conditional_t<kDescent, RegisterPush, SharedPush>;
  extern __shared__ int smem[];
  queued_walk<Push>(
      smem, need, origin, direction, t_max, n, root, drain_at, next_ray,
      ClosestRay<kLeafKind>{ptris, counts, leaf, out_t, out_tri, out_u,
                            out_v},
      [&](const Ray& r, int node, float bt, const Push& push) {
        const float4* row = qnodes + (int64_t)node * 8;
        quad_visit<true>(r, row, row_metas(__ldg(row + 6)), kTMin, bt, push);
      });
}

using Closest4Queued = void (*)(const float*, const float*, const float*,
                                int, int, const float4*, const float4*,
                                const int*, int, int, int, int*, float*,
                                int*, float*, float*);

// L6's kernel for (descent, leaf_kind), or nullptr.
Closest4Queued closest4_queued(int descent, int leaf_kind) {
  switch (leaf_kind * 2 + (descent ? 1 : 0)) {
    case kSerialLeaf * 2:
      return closest4_queued_persistent_kernel<false, kSerialLeaf>;
    case kSerialLeaf * 2 + 1:
      return closest4_queued_persistent_kernel<true, kSerialLeaf>;
    case kDivfreeLeaf * 2:
      return closest4_queued_persistent_kernel<false, kDivfreeLeaf>;
    case kDivfreeLeaf * 2 + 1:
      return closest4_queued_persistent_kernel<true, kDivfreeLeaf>;
    case kIlpLeaf * 2:
      return closest4_queued_persistent_kernel<false, kIlpLeaf>;
    case kIlpLeaf * 2 + 1:
      return closest4_queued_persistent_kernel<true, kIlpLeaf>;
    default:
      return nullptr;
  }
}

// L3: K3's walk (binary_node, the far child to the stack and the near one
// in a register, leaves on the stack) over component-major leaf rows. The
// leaf is cm_leaf up to the float4 group that holds the row's last real
// triangle (ceil(count / 4) groups, at least one), which gives every
// slot's bits: a slot past the count has zero edges, so it is never valid
// and its t counts as kBig. Under a best t below kBig it can change neither
// the least t nor the index at it, and a leaf whose least t is kBig keeps
// nothing. Where the best t is not below kBig, a row all at kBig would be
// kept with its largest index, so there the leaf tests every group. L3 has
// no u, v: the walk writes 0s to the wrapper's scratch.
struct CmLeafHook : WalkHook<kGroup> {
  __device__ __forceinline__ void closest_leaf(
      const Ray& r, const float4* __restrict__ row, int count, int leaf,
      float t_min, float& bt, int& btri, float&, float&) const {
    const int groups = bt < kBig ? max((count + 3) >> 2, 1) : leaf >> 2;
    cm_leaf(r, row, leaf, groups, t_min, bt, btri);
  }
};

// Under plain launch bounds ptxas kept it at 72 registers and spilled 38 B
// (the 10 float4 of a group live across 4 tests); 6 blocks a SM let it
// take up to 80, K3's.
__global__ void __launch_bounds__(kThreads, 6)
closest_cm_persistent_kernel(const float* __restrict__ origin,
                             const float* __restrict__ direction,
                             const float* __restrict__ t_max, int n,
                             int root, const float4* __restrict__ pnodes,
                             const float4* __restrict__ ptris_cm,
                             const int* __restrict__ counts, int leaf,
                             int* __restrict__ next_ray,
                             float* __restrict__ out_t,
                             int* __restrict__ out_tri,
                             float* __restrict__ out_u,
                             float* __restrict__ out_v) {
  extern __shared__ int smem[];
  closest_walk<kGroup, kRefillAt>(
      smem, origin, direction, t_max, n, kTMin, root, ptris_cm, counts, leaf,
      next_ray, out_t, out_tri, out_u, out_v,
      [&](const Ray& r, int cur, float bt, Stack& st) {
        return binary_node(r, pnodes + (int64_t)cur * 4, kTMin, bt, st);
      },
      CmLeafHook{});
}

// L4's per-ray hook on queued_walk: nit counts every step, nleaf the leaf
// steps, written when the ray ends (0s for an inactive ray).
struct StepCounts {
  int* __restrict__ out_nit;
  int* __restrict__ out_nleaf;
  int nit = 0, nleaf = 0;
  __device__ __forceinline__ void start() { nit = nleaf = 0; }
  __device__ __forceinline__ void visit(bool leaf) {
    ++nit;
    nleaf += leaf;
  }
  __device__ __forceinline__ void finish(int i) const {
    out_nit[i] = nit;
    out_nleaf[i] = nleaf;
  }
  __device__ __forceinline__ void skip(int i) const {
    out_nit[i] = 0;
    out_nleaf[i] = 0;
  }
};

// L4: the binary deferred-leaf walk, one 64-byte pnodes row a node step
// (binary_visit<true>: far child first, near last, so the near one stays
// in the register), leaves to their counts, with StepCounts. nocond drops
// the hit leaf children (RegisterPushTo<true>); dblread also loads row
// max(node - 1, 0), independent of the node's own row, and folds its first
// float, times 0.0, into the t cap (1 + 0 * x is not folded without
// fast-math, so the load stays and the results equal base's while boxes
// are finite).
template <int kVariant>
__global__ void __launch_bounds__(kThreads)
binary_queued_kernel(const float* __restrict__ origin,
                     const float* __restrict__ direction,
                     const float* __restrict__ t_max, int n, int root,
                     const float4* __restrict__ pnodes,
                     const float4* __restrict__ ptris,
                     const int* __restrict__ counts, int leaf, int need,
                     int drain_at, int* __restrict__ next_ray,
                     float* __restrict__ out_t, int* __restrict__ out_tri,
                     float* __restrict__ out_u, float* __restrict__ out_v,
                     int* __restrict__ out_nit, int* __restrict__ out_nleaf) {
  using Push = RegisterPushTo<kVariant == kNocond>;
  extern __shared__ int smem[];
  queued_walk<Push>(
      smem, need, origin, direction, t_max, n, root, drain_at, next_ray,
      ClosestRay<kSerialLeaf>{ptris, counts, leaf, out_t, out_tri, out_u,
                              out_v},
      [&](const Ray& r, int node, float bt, const Push& push) {
        float t_cap = bt;
        if constexpr (kVariant == kDblread) {
          const float x = __ldg(reinterpret_cast<const float*>(
              pnodes + (int64_t)max(node - 1, 0) * 4));
          t_cap = bt * (1.0f + 0.0f * x);
        }
        binary_visit<true>(r, pnodes + (int64_t)node * 4, kTMin, t_cap,
                           push);
      },
      StepCounts{out_nit, out_nleaf});
}

using BinaryQueued = void (*)(const float*, const float*, const float*, int,
                              int, const float4*, const float4*, const int*,
                              int, int, int, int*, float*, int*, float*,
                              float*, int*, int*);

// L4's kernel for `variant`, or nullptr.
BinaryQueued binary_queued(int variant) {
  switch (variant) {
    case kBase:
      return binary_queued_kernel<kBase>;
    case kNocond:
      return binary_queued_kernel<kNocond>;
    case kDblread:
      return binary_queued_kernel<kDblread>;
    default:
      return nullptr;
  }
}

// One of an L5 lane's two walks: its ray, its LaneQueue, its best hit, and
// the index of its ray while it walks it (-1: the slot is dead, with no
// ray, an inactive one, or one that has ended).
struct PairSlot {
  LaneQueue q;
  ClosestRay<kSerialLeaf> hit;
  Ray r{};
  int ray = -1;
  __device__ PairSlot(int* smem, int need, const ClosestRay<kSerialLeaf>& h)
      : q(smem, need), hit(h) {}
  // Take ray i of n, whose t_max is tm: walked when tm > t_min, else
  // answered at once (ClosestRay::skip; nothing for i >= n) and dead.
  __device__ __forceinline__ void start(const float* __restrict__ origin,
                                        const float* __restrict__ direction,
                                        int i, int n, float tm, int root) {
    if (tm > kTMin) {
      r = load_ray(origin, direction, i);
      hit.start(i, tm);
      q.start(root);
      ray = i;
    } else {
      if (i < n) hit.skip(i, tm);
      q.clear();
      ray = -1;
    }
  }
  // queued_walk's node step on the slot's row, loaded: the hit children
  // through RegisterPush, then the node it kept in `top`, or a pop.
  __device__ __forceinline__ void node_step(const BinaryRow& row) {
    int top = kNone;
    binary_visit<true>(r, row, kTMin, hit.bound(),
                       RegisterPush{top, q.st, q.lq});
    q.cur = top != kNone ? top : q.st.pop();
  }
  // queued_walk's leaf step: the queue's top block (a closest-hit walk
  // never ends early).
  __device__ __forceinline__ void leaf_step(int leaf_f4) {
    hit.leaf_step(r, q.lq.pop(), leaf_f4);
  }
  __device__ __forceinline__ void finish() {
    if (ray >= 0) hit.finish(ray);
    ray = -1;
  }
};

// Pair j's record for fetch_with: its rays' t_max (an odd n's missing
// second ray inactive), live when either ray is.
struct PairRecords {
  int n;
  __device__ __forceinline__ float2 load(const float* __restrict__ t_max,
                                         int j) const {
    return make_float2(t_max[2 * j],
                       2 * j + 1 < n ? t_max[2 * j + 1] : kTMin);
  }
  __device__ __forceinline__ bool live(float2 tm, float t_min) const {
    return tm.x > t_min || tm.y > t_min;
  }
};

// Whether slot `s` of a pair (its partner `o`) takes a node step next:
// under kShared, when neither slot's drain rule asks for a leaf step and
// `s` has a node; else by its own drain rule.
template <bool kShared>
__device__ __forceinline__ bool next_node(const LaneQueue& s,
                                          const LaneQueue& o, int drain_at) {
  if constexpr (kShared) {
    return s.wants_node(drain_at) && !o.wants_leaf(drain_at);
  }
  return s.wants_node(drain_at);
}

// Whether slot `s` takes a leaf step next: under kShared, when either
// slot's drain rule asks for one and `s` has a leaf queued; else by its own
// drain rule.
template <bool kShared>
__device__ __forceinline__ bool next_leaf(const LaneQueue& s,
                                          const LaneQueue& o, int drain_at) {
  if constexpr (kShared) {
    return s.lq.sp > 0 && (s.wants_leaf(drain_at) || o.wants_leaf(drain_at));
  }
  return s.wants_leaf(drain_at);
}

// L5: two binary deferred-leaf walks a thread, rays 2j and 2j+1 of pair j,
// on queued_walk's pieces: fetch_with over pairs (a pair whose rays are
// both inactive is answered at fetch time; in a live pair an inactive ray
// is answered at once and its slot stays dead), two LaneQueues in the
// block's shared memory (each `need` + kLQ entries a thread), RegisterPush
// and ClosestRay's leaf step to the counts. While-while over the pairs'
// step kinds: node steps while a lane has a slot whose next step is a node
// step, both slots' rows loaded before either slot's slab test; then leaf
// steps while a lane has a slot whose next step is a leaf step. A slot's
// next step is decided by the pair's state (kShared: the pair's kind, a
// slot with nothing of it sitting the step out) or its own, as the plain
// walk decides it, so each slot takes the plain walk's steps in the plain
// walk's order.
template <bool kShared>
__global__ void __launch_bounds__(kThreads)
pair_queued_kernel(const float* __restrict__ origin,
                   const float* __restrict__ direction,
                   const float* __restrict__ t_max, int n, int root,
                   const float4* __restrict__ pnodes,
                   const float4* __restrict__ ptris,
                   const int* __restrict__ counts, int leaf, int need,
                   int drain_at, int* __restrict__ next_pair,
                   float* __restrict__ out_t, int* __restrict__ out_tri,
                   float* __restrict__ out_u, float* __restrict__ out_v) {
  extern __shared__ int smem[];
  const ClosestRay<kSerialLeaf> hit{ptris, counts, leaf, out_t, out_tri,
                                    out_u, out_v};
  PairSlot a(smem, need, hit);
  PairSlot b(smem + (need + kLQ) * kThreads, need, hit);
  const int leaf_f4 = leaf * kTriStride / 4;
  const int pairs = (n + 1) / 2;
  int pair = -1;
  bool drained = false;
  auto start = [&](int j, float2 tm) {
    a.start(origin, direction, 2 * j, n, tm.x, root);
    b.start(origin, direction, 2 * j + 1, n, tm.y, root);
  };
  auto skip = [&](int j, float2 tm) {
    a.hit.skip(2 * j, tm.x);
    if (2 * j + 1 < n) b.hit.skip(2 * j + 1, tm.y);
  };
  for (;;) {
    if (fetch_with<kRefillAt>(pair, drained, pairs, next_pair, t_max, kTMin,
                              PairRecords{n}, start, skip) == kFull) {
      return;
    }
    for (;;) {
      const bool na = next_node<kShared>(a.q, b.q, drain_at);
      const bool nb = next_node<kShared>(b.q, a.q, drain_at);
      if (!__any_sync(kFull, na || nb)) break;
      BinaryRow ra, rb;  // both rows in flight before either slab test
      if (na) ra = load_binary_row(pnodes + (int64_t)a.q.cur * 4);
      if (nb) rb = load_binary_row(pnodes + (int64_t)b.q.cur * 4);
      if (na) a.node_step(ra);
      if (nb) b.node_step(rb);
    }
    for (;;) {
      const bool la = next_leaf<kShared>(a.q, b.q, drain_at);
      const bool lb = next_leaf<kShared>(b.q, a.q, drain_at);
      if (!__any_sync(kFull, la || lb)) break;
      if (la) a.leaf_step(leaf_f4);
      if (lb) b.leaf_step(leaf_f4);
    }
    if (pair >= 0 && !a.q.alive() && !b.q.alive()) {
      a.finish();
      b.finish();
      pair = -1;
    }
  }
}

using PairQueued = void (*)(const float*, const float*, const float*, int,
                            int, const float4*, const float4*, const int*,
                            int, int, int, int*, float*, int*, float*,
                            float*);

// L5's kernel: the shared step kind or each ray its own (switch).
PairQueued pair_queued(bool shared) {
  if (shared) return pair_queued_kernel<true>;
  return pair_queued_kernel<false>;
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each launches on `stream` and
// returns the launch's cudaError_t (cudaErrorInvalidValue for an argument
// no kernel takes); none synchronises or allocates.

// The persistent walks (L3-L8). After the rays: root, node rows (pnodes
// f32[NB,16], qnodes f32[N4,32] or onodes f32[N8,64], the metas in the
// rows), leaf rows, the leaf counts of the row-major ptris, leaf, the
// tree's stack need `need` (L3: 1..kBinaryCap, K3's stack; the queued
// walks 1..kCap: the shared memory holds need + kLQ entries a thread, L5's
// twice) and the work counter `next_ray` (one int32, zeroed here on
// `stream`; L5's counts pairs); then the queued walks' drain_at.

// L3. ptris_cm: the component-major leaf rows (leaf a multiple of 4); out_u
// and out_v are scratch the walk writes.
extern "C" int lab_closest_cm(const float* origin, const float* direction,
                              const float* t_max, int64_t n, int root,
                              const float* pnodes, const float* ptris_cm,
                              const int* leaf_counts, int leaf, int need,
                              int* next_ray, float* out_t, int* out_tri,
                              float* out_u, float* out_v, void* stream) {
  if (leaf % 4) return (int)cudaErrorInvalidValue;
  return launch(closest_cm_persistent_kernel, n, need, kBinaryCap, next_ray,
                stream, origin, direction, t_max, (int)n, root,
                reinterpret_cast<const float4*>(pnodes),
                reinterpret_cast<const float4*>(ptris_cm), leaf_counts, leaf,
                next_ray, out_t, out_tri, out_u, out_v);
}

// L4. variant: 0 base, 1 nocond, 2 dblread; drain_at in 1..LQ-2.
extern "C" int lab_closest_queued(const float* origin, const float* direction,
                                  const float* t_max, int64_t n, int root,
                                  const float* pnodes, const float* ptris,
                                  const int* leaf_counts, int leaf, int need,
                                  int* next_ray, int drain_at, int variant,
                                  float* out_t, int* out_tri, float* out_u,
                                  float* out_v, int* out_nit, int* out_nleaf,
                                  void* stream) {
  if (drain_at < 1 || drain_at > kLQ - 2) return (int)cudaErrorInvalidValue;
  if (need < 1 || need > kCap) return (int)cudaErrorInvalidValue;
  BinaryQueued kernel = binary_queued(variant);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  return launch(kernel, n, need + kLQ, kCap + kLQ, next_ray, stream, origin,
                direction, t_max, (int)n, root,
                reinterpret_cast<const float4*>(pnodes),
                reinterpret_cast<const float4*>(ptris), leaf_counts, leaf,
                need, drain_at, next_ray, out_t, out_tri, out_u, out_v,
                out_nit, out_nleaf);
}

// L5. shared: 1 the pair shares the step kind, 0 each ray takes its own
// (switch); drain_at in 1..LQ-2; (n + 1) / 2 pairs.
extern "C" int lab_closest_pair(const float* origin, const float* direction,
                                const float* t_max, int64_t n, int root,
                                const float* pnodes, const float* ptris,
                                const int* leaf_counts, int leaf, int need,
                                int* next_ray, int drain_at, int shared,
                                float* out_t, int* out_tri, float* out_u,
                                float* out_v, void* stream) {
  if (drain_at < 1 || drain_at > kLQ - 2) return (int)cudaErrorInvalidValue;
  if (need < 1 || need > kCap || n > kMaxRays) {
    return (int)cudaErrorInvalidValue;
  }
  return launch(pair_queued(shared != 0), (n + 1) / 2, 2 * (need + kLQ),
                2 * (kCap + kLQ), next_ray, stream, origin, direction, t_max,
                (int)n, root, reinterpret_cast<const float4*>(pnodes),
                reinterpret_cast<const float4*>(ptris), leaf_counts, leaf,
                need, drain_at, next_ray, out_t, out_tri, out_u, out_v);
}

// drain_at in 1..LQ-8 (an 8-wide step queues up to 8 leaves).
extern "C" int lab_closest8_queued(const float* origin, const float* direction,
                                   const float* t_max, int64_t n, int root,
                                   const float* onodes, const float* ptris,
                                   const int* leaf_counts, int leaf,
                                   int need, int* next_ray, int drain_at,
                                   float* out_t, int* out_tri, float* out_u,
                                   float* out_v, void* stream) {
  if (drain_at < 1 || drain_at > kLQ - 8) return (int)cudaErrorInvalidValue;
  if (need < 1 || need > kCap) return (int)cudaErrorInvalidValue;
  return launch(closest8_queued_kernel, n, need + kLQ, kCap + kLQ, next_ray,
                stream, origin, direction, t_max, (int)n, root,
                reinterpret_cast<const float4*>(onodes),
                reinterpret_cast<const float4*>(ptris), leaf_counts, leaf,
                need, drain_at, next_ray, out_t, out_tri, out_u, out_v);
}

// ordered: 1 the near child last, 0 child order; drain_at in 1..LQ-4.
extern "C" int lab_occlusion4_queued(const float* origin,
                                     const float* direction,
                                     const float* t_max,
                                     const int* skip_object, int64_t n,
                                     int root, const float* qnodes,
                                     const float* ptris,
                                     const int* leaf_counts, int leaf,
                                     int need, int* next_ray, int drain_at,
                                     int ordered, bool* out_occ,
                                     void* stream) {
  if (drain_at < 1 || drain_at > kLQ - 4) return (int)cudaErrorInvalidValue;
  if (need < 1 || need > kCap) return (int)cudaErrorInvalidValue;
  auto q4 = reinterpret_cast<const float4*>(qnodes);
  auto t4 = reinterpret_cast<const float4*>(ptris);
  if (ordered) {
    return launch(occlusion4_queued_kernel<true>, n, need + kLQ, kCap + kLQ,
                  next_ray, stream, origin, direction, t_max, skip_object,
                  (int)n, root, q4, t4, leaf_counts, leaf, need, drain_at,
                  next_ray, out_occ);
  }
  return launch(occlusion4_queued_kernel<false>, n, need + kLQ, kCap + kLQ,
                next_ray, stream, origin, direction, t_max, skip_object,
                (int)n, root, q4, t4, leaf_counts, leaf, need, drain_at,
                next_ray, out_occ);
}

// leaf_kind: 0 serial, 1 division-free, 2 ILP (leaf 8); descent: 1 the
// stack's top in a register, 0 every internal child through shared memory;
// drain_at in 1..LQ-4 (a 4-wide step queues up to 4 leaves).
extern "C" int lab_closest4_queued(const float* origin, const float* direction,
                                   const float* t_max, int64_t n, int root,
                                   const float* qnodes, const float* ptris,
                                   const int* leaf_counts, int leaf,
                                   int need, int* next_ray, int drain_at,
                                   int descent, int leaf_kind, float* out_t,
                                   int* out_tri, float* out_u, float* out_v,
                                   void* stream) {
  if (drain_at < 1 || drain_at > kLQ - 4) return (int)cudaErrorInvalidValue;
  if (need < 1 || need > kCap) return (int)cudaErrorInvalidValue;
  if (leaf_kind == kIlpLeaf && leaf != 8) return (int)cudaErrorInvalidValue;
  Closest4Queued kernel = closest4_queued(descent, leaf_kind);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  return launch(kernel, n, need + kLQ, kCap + kLQ, next_ray, stream, origin,
                direction, t_max, (int)n, root,
                reinterpret_cast<const float4*>(qnodes),
                reinterpret_cast<const float4*>(ptris), leaf_counts, leaf,
                need, drain_at, next_ray, out_t, out_tri, out_u, out_v);
}

// What a launch of `kernel` (0 L7, 1 L8 ordered, 2 L8 child order, 3 +
// 2 * leaf_kind + descent L6, 9 L3, 10 + variant L4, 13 L5 shared, 14 L5
// switch) at stack need `need` looks like on the current device: out[0..8]
// as persistent_walk.cuh's info(), the queued walks' shared memory holding
// the queue too (L5's two stacks and two queues).
extern "C" int lab2_launch_info(int kernel, int need, int* out) {
  if (kernel == 9) {
    return info<kGroup, kRefillAt>(closest_cm_persistent_kernel, need,
                                   kBinaryCap, out);
  }
  if (need < 1 || need > kCap) return (int)cudaErrorInvalidValue;
  if (kernel == 13 || kernel == 14) {
    return info<kGroup, kRefillAt>(pair_queued(kernel == 13),
                                   2 * (need + kLQ), 2 * (kCap + kLQ), out);
  }
  if (kernel >= 10) {
    BinaryQueued l4 = binary_queued(kernel - 10);
    if (l4 == nullptr) return (int)cudaErrorInvalidValue;
    return info<kGroup, kRefillAt>(l4, need + kLQ, kCap + kLQ, out);
  }
  if (kernel >= 3) {
    Closest4Queued l6 = closest4_queued((kernel - 3) % 2, (kernel - 3) / 2);
    if (l6 == nullptr) return (int)cudaErrorInvalidValue;
    return info<kGroup, kRefillAt>(l6, need + kLQ, kCap + kLQ, out);
  }
  switch (kernel) {
    case 0:
      return info<kGroup, kRefillAt>(closest8_queued_kernel, need + kLQ,
                                     kCap + kLQ, out);
    case 1:
      return info<kGroup, kRefillAt>(occlusion4_queued_kernel<true>,
                                     need + kLQ, kCap + kLQ, out);
    case 2:
      return info<kGroup, kRefillAt>(occlusion4_queued_kernel<false>,
                                     need + kLQ, kCap + kLQ, out);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
