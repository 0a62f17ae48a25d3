// The traversal lab's deferred-leaf and component-major kernels, one thread
// per ray (two for lab_closest_pair), for Hopper (sm_90a).
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
// Here each thread walks its own ray with the same state in local memory:
//
//   - the deferred-leaf walk (lab/queue_walk.py): only internal nodes go on
//     the stack (CAP = 64); a hit leaf child goes into the leaf queue (LQ =
//     16) when it is pushed. Each step is a leaf step, popping the queue's
//     top block and testing it, when ln >= drain_at or (no node pending and
//     ln > 0); else an internal step, popping one node (with descent, the
//     near child kept in `cur` instead, if any) and pushing its hit
//     children far first, near last. The push policy QueuePush routes them
//     (traverse_common.cuh's node steps take it in place of the stack);
//   - lab_closest_queued (L4) counts per ray what the TPU kernel counts per
//     packet: nit, every step, and nleaf, the leaf steps. `nocond` drops
//     leaf children at push time (its results are wrong by design);
//     `dblread` loads row max(node-1, 0) as well and folds its first float,
//     times 0.0, into the t cap (1 + 0*x is not folded without fast-math,
//     so the load stays and the results equal base's while boxes are
//     finite);
//   - lab_closest_pair (L5): thread j walks rays 2j and 2j+1. `shared`:
//     each step both take a leaf step if either one's drain condition
//     holds, else both an internal step; a ray with nothing of that kind
//     sits the step out. `switch`: each ray its own kind, so per ray it is
//     L4 base;
//   - lab_closest4_queued (L6): the 4-wide walk; the near child (the 2-bit
//     argmin) is pushed last or, with descent, kept in `cur` (a near leaf
//     goes to the queue); leaf kinds serial, division-free (accepts in
//     det-scaled space, best t carried as num/den through the step, one
//     divide at its end) or ILP (leaf 8);
//   - lab_closest8_queued (L7): the 8-wide walk (oct_visit of
//     traverse_common.cuh): a node reads the 48 box floats of its 256-byte
//     onodes row (12 float4; the row's f32 metas and padding are not read)
//     and its 8 metas from ometa (2 int4), slab-tests the 8 children, and
//     pushes the hit ones in child order but the near one (the 3-bit
//     tournament), which goes last. A step queues up to 8 leaves, so
//     drain_at is in 1..LQ-8; the stack holds up to 7 children per oct
//     level, and the wrapper refuses a tree whose stack need exceeds CAP;
//   - lab_occlusion4_queued (L8): the 4-wide walk with the any-hit leaf
//     step (occluded_leaf against t_max, skip_object as f32): an occluded
//     ray stops at once, as the TPU kernel's per-row exit; the internal
//     step caps its slab tests at t_max and pushes the near child last
//     (ordered) or every child in child order (the production K2's order);
//   - lab_closest_cm (L3): K3's stack walk (leaves on the stack, STACK_CAP
//     128); a leaf reads each of its 10 used components as leaf/4 float4
//     (component c of triangle k at lane leaf*c + k), tests every triangle
//     against the entry best t, and keeps the least t and, among the
//     triangles at that t, the largest index.
//
// The arithmetic is traverse_common.cuh's, written in the order of the
// plain torch versions, and the library is built with -fmad=false, so each
// kernel equals its plain version bit for bit, counts included.
//
// What bounds them on the card: dependent node and leaf loads, as for K1-K4.
// The deferred leaf changes when a leaf row is read, not how many: the
// queue holds up to drain_at blocks while the walk descends, which delays
// the best t and can only add visits. Stack and queue sit in local memory
// (320 B a ray, 640 B for the pair kernel), cached in L1. The wrappers
// refuse trees whose stack bound exceeds CAP and drain_at above LQ less a
// node's width, so neither overflows.
//
// L7 and L8 are first versions, simple and right, not tuned. Per ray, L7
// reads 224 B an oct node (192 B of boxes, 32 B of metas) against the
// 4-wide walk's 112 B, for fewer internal steps; each step does 8 slab
// tests (25 FP32 operations each) and the 3-bit tournament (13). L8 reads
// what the 4-wide queued walk reads, until its ray is occluded. Both, like
// L4-L6, are bounded by their dependent node and leaf loads, not by their
// arithmetic (PERF.md gives each kernel's byte and operation bound).

#include "traverse_common.cuh"

using namespace traverse;

namespace {

constexpr int kStackCap = 128;  // L3's binary stack (STACK_CAP)
constexpr int kCap = 64;        // the queued walks' internal-node stack
constexpr int kLQ = 16;         // the leaf queue
constexpr float kTMin = 1e-3f;  // the lab kernels' fixed t_min

enum BinaryVariant { kBase = 0, kNocond = 1, kDblread = 2 };
enum LeafKind { kSerialLeaf = 0, kDivfreeLeaf = 1, kIlpLeaf = 2 };

// One ray of a queued walk: the ray, its best hit, its stack, queue and
// descent register.
struct QueuedRay {
  Ray r;
  float bt, bu, bv;
  int btri;
  int stack[kCap];
  int sp;
  int lq[kLQ];
  int ln;
  int cur;  // the node kept by descent, or -1
};

__device__ __forceinline__ void init_ray(QueuedRay& q, const Ray& r,
                                         float t_max, int root,
                                         bool descent) {
  q.r = r;
  q.bt = t_max;
  q.btri = -1;
  q.bu = 0.0f;
  q.bv = 0.0f;
  q.sp = 0;
  q.ln = 0;
  q.cur = -1;
  if (!(t_max > kTMin)) return;  // cannot accept a hit: not walked
  if (root < 0) {
    q.lq[q.ln++] = ~root;
  } else if (descent) {
    q.cur = root;
  } else {
    q.stack[q.sp++] = root;
  }
}

__device__ __forceinline__ bool has_node(const QueuedRay& q) {
  return q.cur >= 0 || q.sp > 0;
}

__device__ __forceinline__ bool alive(const QueuedRay& q) {
  return has_node(q) || q.ln > 0;
}

__device__ __forceinline__ bool wants_leaf(const QueuedRay& q,
                                           int drain_at) {
  return q.ln >= drain_at || (!has_node(q) && q.ln > 0);
}

// Routes the hit children of a node step: internal ones to the stack (the
// near one, with kDescent, to `cur`), leaf ones to the queue (or nowhere,
// with kDropLeaves).
template <bool kDescent, bool kDropLeaves>
struct QueuePush {
  QueuedRay& q;
  __device__ __forceinline__ void operator()(int meta) const {
    if (meta >= 0) {
      q.stack[q.sp++] = meta;
    } else if (!kDropLeaves) {
      q.lq[q.ln++] = ~meta;
    }
  }
  __device__ __forceinline__ void near(int meta) const {
    if (kDescent && meta >= 0) {
      q.cur = meta;
    } else {
      (*this)(meta);
    }
  }
};

// tools/r3_kernel_lab.py:47 _leaf_step_divfree, per ray: the accept test in
// det-scaled space, (num, den) = (entry best t, 1), one divide at the end.
__device__ __forceinline__ void divfree_leaf(const Ray& r,
                                             const float4* __restrict__ row,
                                             int leaf, float& bt, int& btri,
                                             float& bu, float& bv) {
  float num = bt, den = 1.0f, su = bu, sv = bv;
  for (int k = 0; k < leaf; ++k) {
    float4 f0 = __ldg(row + 3 * k);
    float4 f1 = __ldg(row + 3 * k + 1);
    float4 f2 = __ldg(row + 3 * k + 2);
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
  float inv = 1.0f / den;
  bt = num * inv;
  bu = su * inv;
  bv = sv * inv;
}

template <int kLeafKind>
__device__ __forceinline__ void leaf_step(QueuedRay& q,
                                          const float4* __restrict__ ptris,
                                          int leaf) {
  const int blk = q.lq[--q.ln];
  const float4* row = ptris + (int64_t)blk * (leaf * kTriStride / 4);
  if constexpr (kLeafKind == kIlpLeaf) {
    ilp_leaf<8>(q.r, row, kTMin, q.bt, q.btri, q.bu, q.bv);
  } else if constexpr (kLeafKind == kDivfreeLeaf) {
    divfree_leaf(q.r, row, leaf, q.bt, q.btri, q.bu, q.bv);
  } else {
    closest_leaf(q.r, row, leaf, kTMin, q.bt, q.btri, q.bu, q.bv);
  }
}

template <int kVariant>
__device__ __forceinline__ void binary_step(QueuedRay& q,
                                            const float4* __restrict__ pnodes) {
  const int node = q.stack[--q.sp];
  float t_cap = q.bt;
  if constexpr (kVariant == kDblread) {
    const float x = __ldg(reinterpret_cast<const float*>(
        pnodes + (int64_t)max(node - 1, 0) * 4));
    t_cap = q.bt * (1.0f + 0.0f * x);
  }
  binary_visit<true>(q.r, pnodes + (int64_t)node * 4, kTMin, t_cap,
                     QueuePush<false, kVariant == kNocond>{q});
}

// The 4-wide internal step, its slab tests capped at the best t (t_max for
// any-hit, which never shrinks); the near child last (kOrdered) or child
// order.
template <bool kDescent, bool kOrdered = true>
__device__ __forceinline__ void quad_step(QueuedRay& q,
                                          const int4* __restrict__ qmeta,
                                          const float4* __restrict__ qnodes) {
  int node;
  if (kDescent && q.cur >= 0) {
    node = q.cur;
    q.cur = -1;
  } else {
    node = q.stack[--q.sp];
  }
  quad_visit<kOrdered>(q.r, qnodes + (int64_t)node * 8, __ldg(qmeta + node),
                       kTMin, q.bt, QueuePush<kDescent, false>{q});
}

// The 8-wide internal step: onodes rows are 16 float4, ometa 2 int4 a node.
__device__ __forceinline__ void oct_step(QueuedRay& q,
                                         const int4* __restrict__ ometa,
                                         const float4* __restrict__ onodes) {
  const int node = q.stack[--q.sp];
  oct_visit(q.r, onodes + (int64_t)node * 16, __ldg(ometa + 2 * node),
            __ldg(ometa + 2 * node + 1), kTMin, q.bt,
            QueuePush<false, false>{q});
}

// The any-hit leaf step: pop the queue's top block and test it against
// t_max (q.bt) with occluded_leaf; whether a triangle not of object `skip`
// hits.
__device__ __forceinline__ bool any_leaf_step(QueuedRay& q,
                                              const float4* __restrict__ ptris,
                                              int leaf, float skip) {
  const int blk = q.lq[--q.ln];
  return occluded_leaf(q.r, ptris + (int64_t)blk * (leaf * kTriStride / 4),
                       leaf, kTMin, q.bt, skip);
}

__device__ __forceinline__ void store_hit(const QueuedRay& q, int64_t i,
                                          float* out_t, int* out_tri,
                                          float* out_u, float* out_v) {
  out_t[i] = q.bt;
  out_tri[i] = q.btri;
  out_u[i] = q.bu;
  out_v[i] = q.bv;
}

template <int kVariant>
__global__ void __launch_bounds__(kThreads)
closest_queued_kernel(const float* __restrict__ origin,
                      const float* __restrict__ direction,
                      const float* __restrict__ t_max, int64_t n, int root,
                      const float4* __restrict__ pnodes,
                      const float4* __restrict__ ptris, int leaf,
                      int drain_at, float* __restrict__ out_t,
                      int* __restrict__ out_tri, float* __restrict__ out_u,
                      float* __restrict__ out_v, int* __restrict__ out_nit,
                      int* __restrict__ out_nleaf) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  QueuedRay q;
  init_ray(q, load_ray(origin, direction, i), t_max[i], root, false);
  int nit = 0, nleaf = 0;
  while (alive(q)) {
    ++nit;
    if (wants_leaf(q, drain_at)) {
      ++nleaf;
      leaf_step<kSerialLeaf>(q, ptris, leaf);
    } else {
      binary_step<kVariant>(q, pnodes);
    }
  }
  store_hit(q, i, out_t, out_tri, out_u, out_v);
  out_nit[i] = nit;
  out_nleaf[i] = nleaf;
}

// One step of a pair's ray, of the kind the pair chose: a ray with nothing
// of that kind sits it out.
__device__ __forceinline__ void pair_step(QueuedRay& q, bool leaf_kind,
                                          const float4* __restrict__ pnodes,
                                          const float4* __restrict__ ptris,
                                          int leaf) {
  if (leaf_kind) {
    if (q.ln > 0) leaf_step<kSerialLeaf>(q, ptris, leaf);
  } else if (has_node(q)) {
    binary_step<kBase>(q, pnodes);
  }
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
closest_pair_kernel(const float* __restrict__ origin,
                    const float* __restrict__ direction,
                    const float* __restrict__ t_max, int64_t n, int root,
                    const float4* __restrict__ pnodes,
                    const float4* __restrict__ ptris, int leaf, int drain_at,
                    float* __restrict__ out_t, int* __restrict__ out_tri,
                    float* __restrict__ out_u, float* __restrict__ out_v) {
  int64_t ia = 2 * ((int64_t)blockIdx.x * blockDim.x + threadIdx.x);
  if (ia >= n) return;
  const int64_t ib = ia + 1;
  const bool has_b = ib < n;
  QueuedRay a, b;
  const Ray ra = load_ray(origin, direction, ia);
  init_ray(a, ra, t_max[ia], root, false);
  // An odd ray count leaves the last thread one ray; its partner is never
  // walked.
  init_ray(b, has_b ? load_ray(origin, direction, ib) : ra,
           has_b ? t_max[ib] : kTMin, root, false);
  while (alive(a) || alive(b)) {
    bool leaf_a = wants_leaf(a, drain_at);
    bool leaf_b = wants_leaf(b, drain_at);
    if (kShared) leaf_a = leaf_b = leaf_a || leaf_b;
    pair_step(a, leaf_a, pnodes, ptris, leaf);
    pair_step(b, leaf_b, pnodes, ptris, leaf);
  }
  store_hit(a, ia, out_t, out_tri, out_u, out_v);
  if (has_b) store_hit(b, ib, out_t, out_tri, out_u, out_v);
}

template <bool kDescent, int kLeafKind>
__global__ void __launch_bounds__(kThreads)
closest4_queued_kernel(const float* __restrict__ origin,
                       const float* __restrict__ direction,
                       const float* __restrict__ t_max, int64_t n, int root,
                       const int4* __restrict__ qmeta,
                       const float4* __restrict__ qnodes,
                       const float4* __restrict__ ptris, int leaf,
                       int drain_at, float* __restrict__ out_t,
                       int* __restrict__ out_tri, float* __restrict__ out_u,
                       float* __restrict__ out_v) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  QueuedRay q;
  init_ray(q, load_ray(origin, direction, i), t_max[i], root, kDescent);
  while (alive(q)) {
    if (wants_leaf(q, drain_at)) {
      leaf_step<kLeafKind>(q, ptris, leaf);
    } else {
      quad_step<kDescent>(q, qmeta, qnodes);
    }
  }
  store_hit(q, i, out_t, out_tri, out_u, out_v);
}

__global__ void __launch_bounds__(kThreads)
closest8_queued_kernel(const float* __restrict__ origin,
                       const float* __restrict__ direction,
                       const float* __restrict__ t_max, int64_t n, int root,
                       const int4* __restrict__ ometa,
                       const float4* __restrict__ onodes,
                       const float4* __restrict__ ptris, int leaf,
                       int drain_at, float* __restrict__ out_t,
                       int* __restrict__ out_tri, float* __restrict__ out_u,
                       float* __restrict__ out_v) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  QueuedRay q;
  init_ray(q, load_ray(origin, direction, i), t_max[i], root, false);
  while (alive(q)) {
    if (wants_leaf(q, drain_at)) {
      leaf_step<kSerialLeaf>(q, ptris, leaf);
    } else {
      oct_step(q, ometa, onodes);
    }
  }
  store_hit(q, i, out_t, out_tri, out_u, out_v);
}

// The best t of a QueuedRay is t_max throughout: any-hit never shrinks it.
template <bool kOrdered>
__global__ void __launch_bounds__(kThreads)
occlusion4_queued_kernel(const float* __restrict__ origin,
                         const float* __restrict__ direction,
                         const float* __restrict__ t_max,
                         const int* __restrict__ skip_object, int64_t n,
                         int root, const int4* __restrict__ qmeta,
                         const float4* __restrict__ qnodes,
                         const float4* __restrict__ ptris, int leaf,
                         int drain_at, bool* __restrict__ out_occ) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  QueuedRay q;
  init_ray(q, load_ray(origin, direction, i), t_max[i], root, false);
  const float skip = (float)skip_object[i];
  bool occ = false;
  while (!occ && alive(q)) {
    if (wants_leaf(q, drain_at)) {
      occ = any_leaf_step(q, ptris, leaf, skip);
    } else {
      quad_step<false, kOrdered>(q, qmeta, qnodes);
    }
  }
  out_occ[i] = occ;
}

__global__ void __launch_bounds__(kThreads)
closest_cm_kernel(const float* __restrict__ origin,
                  const float* __restrict__ direction,
                  const float* __restrict__ t_max, int64_t n, int root,
                  const float4* __restrict__ pnodes,
                  const float4* __restrict__ ptris_cm, int leaf,
                  float* __restrict__ out_t, int* __restrict__ out_tri) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Ray r = load_ray(origin, direction, i);
  float bt = t_max[i];
  int btri = -1;
  const int leaf_f4 = leaf * kTriStride / 4;

  int stack[kStackCap];
  int sp = 0;
  if (bt > kTMin) stack[sp++] = root;
  while (sp > 0) {
    const int meta = stack[--sp];
    if (meta < 0) {
      cm_leaf(r, ptris_cm + (int64_t)(~meta) * leaf_f4, leaf, kTMin, bt,
              btri);
    } else {
      binary_visit<true>(r, pnodes + (int64_t)meta * 4, kTMin, bt, stack,
                         sp);
    }
  }
  out_t[i] = bt;
  out_tri[i] = btri;
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each launches on `stream` and
// returns the launch's cudaError_t (cudaErrorInvalidValue for an argument
// no kernel takes); none synchronises or allocates.

// leaf: a multiple of 4.
extern "C" int lab_closest_cm(const float* origin, const float* direction,
                              const float* t_max, int64_t n, int root,
                              const float* pnodes, const float* ptris_cm,
                              int leaf, float* out_t, int* out_tri,
                              void* stream) {
  if (leaf % 4) return (int)cudaErrorInvalidValue;
  closest_cm_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      origin, direction, t_max, n, root,
      reinterpret_cast<const float4*>(pnodes),
      reinterpret_cast<const float4*>(ptris_cm), leaf, out_t, out_tri);
  return (int)cudaGetLastError();
}

// variant: 0 base, 1 nocond, 2 dblread; drain_at in 1..LQ-2.
extern "C" int lab_closest_queued(const float* origin, const float* direction,
                                  const float* t_max, int64_t n, int root,
                                  const float* pnodes, const float* ptris,
                                  int leaf, int drain_at, int variant,
                                  float* out_t, int* out_tri, float* out_u,
                                  float* out_v, int* out_nit, int* out_nleaf,
                                  void* stream) {
  if (drain_at < 1 || drain_at > kLQ - 2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  auto p4 = reinterpret_cast<const float4*>(pnodes);
  auto t4 = reinterpret_cast<const float4*>(ptris);
#define LAB_QUEUED_LAUNCH(V)                                              \
  closest_queued_kernel<V><<<blocks_for(n), kThreads, 0, s>>>(            \
      origin, direction, t_max, n, root, p4, t4, leaf, drain_at, out_t,   \
      out_tri, out_u, out_v, out_nit, out_nleaf)
  switch (variant) {
    case kBase:
      LAB_QUEUED_LAUNCH(kBase);
      break;
    case kNocond:
      LAB_QUEUED_LAUNCH(kNocond);
      break;
    case kDblread:
      LAB_QUEUED_LAUNCH(kDblread);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef LAB_QUEUED_LAUNCH
  return (int)cudaGetLastError();
}

// shared: 1 the pair shares the step kind, 0 each ray takes its own.
extern "C" int lab_closest_pair(const float* origin, const float* direction,
                                const float* t_max, int64_t n, int root,
                                const float* pnodes, const float* ptris,
                                int leaf, int drain_at, int shared,
                                float* out_t, int* out_tri, float* out_u,
                                float* out_v, void* stream) {
  if (drain_at < 1 || drain_at > kLQ - 2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  auto p4 = reinterpret_cast<const float4*>(pnodes);
  auto t4 = reinterpret_cast<const float4*>(ptris);
  const unsigned blocks = blocks_for((n + 1) / 2);
  if (shared) {
    closest_pair_kernel<true><<<blocks, kThreads, 0, s>>>(
        origin, direction, t_max, n, root, p4, t4, leaf, drain_at, out_t,
        out_tri, out_u, out_v);
  } else {
    closest_pair_kernel<false><<<blocks, kThreads, 0, s>>>(
        origin, direction, t_max, n, root, p4, t4, leaf, drain_at, out_t,
        out_tri, out_u, out_v);
  }
  return (int)cudaGetLastError();
}

// leaf_kind: 0 serial, 1 division-free, 2 ILP (leaf 8); drain_at in
// 1..LQ-4 (a 4-wide step queues up to 4 leaves).
extern "C" int lab_closest4_queued(const float* origin, const float* direction,
                                   const float* t_max, int64_t n, int root,
                                   const int* qmeta, const float* qnodes,
                                   const float* ptris, int leaf, int drain_at,
                                   int descent, int leaf_kind, float* out_t,
                                   int* out_tri, float* out_u, float* out_v,
                                   void* stream) {
  if (drain_at < 1 || drain_at > kLQ - 4) return (int)cudaErrorInvalidValue;
  if (leaf_kind == kIlpLeaf && leaf != 8) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  auto m4 = reinterpret_cast<const int4*>(qmeta);
  auto q4 = reinterpret_cast<const float4*>(qnodes);
  auto t4 = reinterpret_cast<const float4*>(ptris);
#define LAB_QUAD_LAUNCH(D, K)                                              \
  closest4_queued_kernel<D, K><<<blocks_for(n), kThreads, 0, s>>>(         \
      origin, direction, t_max, n, root, m4, q4, t4, leaf, drain_at, out_t, \
      out_tri, out_u, out_v)
  switch (leaf_kind * 2 + (descent ? 1 : 0)) {
    case kSerialLeaf * 2:
      LAB_QUAD_LAUNCH(false, kSerialLeaf);
      break;
    case kSerialLeaf * 2 + 1:
      LAB_QUAD_LAUNCH(true, kSerialLeaf);
      break;
    case kDivfreeLeaf * 2:
      LAB_QUAD_LAUNCH(false, kDivfreeLeaf);
      break;
    case kDivfreeLeaf * 2 + 1:
      LAB_QUAD_LAUNCH(true, kDivfreeLeaf);
      break;
    case kIlpLeaf * 2:
      LAB_QUAD_LAUNCH(false, kIlpLeaf);
      break;
    case kIlpLeaf * 2 + 1:
      LAB_QUAD_LAUNCH(true, kIlpLeaf);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef LAB_QUAD_LAUNCH
  return (int)cudaGetLastError();
}

// onodes f32[N8,64], ometa i32[8*N8]; drain_at in 1..LQ-8 (an 8-wide step
// queues up to 8 leaves).
extern "C" int lab_closest8_queued(const float* origin, const float* direction,
                                   const float* t_max, int64_t n, int root,
                                   const int* ometa, const float* onodes,
                                   const float* ptris, int leaf, int drain_at,
                                   float* out_t, int* out_tri, float* out_u,
                                   float* out_v, void* stream) {
  if (drain_at < 1 || drain_at > kLQ - 8) return (int)cudaErrorInvalidValue;
  closest8_queued_kernel<<<blocks_for(n), kThreads, 0,
                           (cudaStream_t)stream>>>(
      origin, direction, t_max, n, root, reinterpret_cast<const int4*>(ometa),
      reinterpret_cast<const float4*>(onodes),
      reinterpret_cast<const float4*>(ptris), leaf, drain_at, out_t, out_tri,
      out_u, out_v);
  return (int)cudaGetLastError();
}

// ordered: 1 the near child last, 0 child order; drain_at in 1..LQ-4.
extern "C" int lab_occlusion4_queued(const float* origin,
                                     const float* direction,
                                     const float* t_max,
                                     const int* skip_object, int64_t n,
                                     int root, const int* qmeta,
                                     const float* qnodes, const float* ptris,
                                     int leaf, int drain_at, int ordered,
                                     bool* out_occ, void* stream) {
  if (drain_at < 1 || drain_at > kLQ - 4) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  auto m4 = reinterpret_cast<const int4*>(qmeta);
  auto q4 = reinterpret_cast<const float4*>(qnodes);
  auto t4 = reinterpret_cast<const float4*>(ptris);
  if (ordered) {
    occlusion4_queued_kernel<true><<<blocks_for(n), kThreads, 0, s>>>(
        origin, direction, t_max, skip_object, n, root, m4, q4, t4, leaf,
        drain_at, out_occ);
  } else {
    occlusion4_queued_kernel<false><<<blocks_for(n), kThreads, 0, s>>>(
        origin, direction, t_max, skip_object, n, root, m4, q4, t4, leaf,
        drain_at, out_occ);
  }
  return (int)cudaGetLastError();
}
