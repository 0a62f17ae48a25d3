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
// kGroup and kRefillAt were chosen on the card (PERF.md §6;
// lab/quad_variant_lab.py rebuilds this file with other values to time
// them).
//
// Per ray the walk pops the plain version's entries in its order
// (ops/quad_traverse.py), tests each leaf's triangles in slot order with a
// strictly smaller t kept, and uses the arithmetic of traverse_common.cuh
// (slab, moller) built with -fmad=false, so each kernel equals its plain
// version bit for bit. Only the interleaving of a warp's rays changes.

#include <climits>

#include "traverse_common.cuh"

using namespace traverse;

namespace {

constexpr int kGroup = 4;         // triangles of a leaf loaded together
constexpr int kRefillAt = 16;     // idle lanes of 32 at which a warp fetches
constexpr int kCap = 64;          // stack entries at most (q_stack_need)
constexpr float kTMin = 1e-3f;    // traceRayEXT t_min (simple.rgen:92-104)
constexpr int kNone = INT_MIN;    // no next entry; metas are > -(2^24 + 2)
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxRays = 1 << 30; // the int32 counter passes n by < 2^20

// The stack below the register entry, in shared memory: entry e of thread
// t at smem[e * kThreads + t], so the lanes of a warp use 32 banks.
struct Stack {
  int* p;
  int sp = 0;
  __device__ explicit Stack(int* smem) : p(smem + threadIdx.x) {}
  __device__ __forceinline__ void push(int m) { p[sp++ * kThreads] = m; }
  __device__ __forceinline__ int pop() {
    return sp > 0 ? p[--sp * kThreads] : kNone;
  }
  __device__ __forceinline__ void clear() { sp = 0; }
};

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

// The 3 float4 of the slots k..k+kGroup-1 of a leaf row that lie below
// `lim`.
__device__ __forceinline__ void load_group(const float4* __restrict__ row,
                                           int k, int lim,
                                           float4 (&a)[kGroup],
                                           float4 (&b)[kGroup],
                                           float4 (&c)[kGroup]) {
#pragma unroll
  for (int j = 0; j < kGroup; ++j) {
    if (k + j < lim) {
      a[j] = __ldg(row + 3 * (k + j));
      b[j] = __ldg(row + 3 * (k + j) + 1);
      c[j] = __ldg(row + 3 * (k + j) + 2);
    }
  }
}

// Closest-hit leaf: the row's first `count` triangles in slot order, each
// kept when its t is strictly below the best t, loaded kGroup at a time.
// The first group's loads are bounded by the row (`leaf`), not by the
// count, so they do not wait for it.
__device__ __forceinline__ void closest_leaf_grouped(
    const Ray& r, const float4* __restrict__ row, int count, int leaf,
    float& bt, int& btri, float& bu, float& bv) {
  float4 a[kGroup], b[kGroup], c[kGroup];
  load_group(row, 0, leaf, a, b, c);
  for (int k = 0;;) {
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      float t, u, v;
      if (k + j < count &&
          moller(r, a[j], b[j], c[j], kTMin, bt, &t, &u, &v)) {
        bt = t;
        btri = (int)c[j].y;
        bu = u;
        bv = v;
      }
    }
    k += kGroup;
    if (k >= count) return;
    load_group(row, k, count, a, b, c);
  }
}

// Any-hit leaf: whether one of the row's first `count` triangles, not of
// object `skip`, hits in (1e-3, t_max); loaded as in closest_leaf_grouped.
__device__ __forceinline__ bool occluded_leaf_grouped(
    const Ray& r, const float4* __restrict__ row, int count, int leaf,
    float t_max, float skip) {
  float4 a[kGroup], b[kGroup], c[kGroup];
  load_group(row, 0, leaf, a, b, c);
  for (int k = 0;;) {
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      float t, u, v;
      if (k + j < count &&
          moller(r, a[j], b[j], c[j], kTMin, t_max, &t, &u, &v) &&
          c[j].z != skip) {
        return true;
      }
    }
    k += kGroup;
    if (k >= count) return false;
    load_group(row, k, count, a, b, c);
  }
}

// A warp's fetch: once at least kRefillAt of its lanes are idle (ray < 0),
// the idle lanes take the next indices from `next_ray`, one atomicAdd for
// all of them, until none is idle or the counter has passed n. A lane
// whose ray is live calls start(i); one whose ray is inactive (t_max <=
// 1e-3) calls skip(i, t_max), which writes its outputs, and takes the next
// index. `drained` is warp-uniform. Returns the ballot of idle lanes.
template <class Start, class Skip>
__device__ __forceinline__ unsigned fetch(int& ray, bool& drained, int n,
                                          int* __restrict__ next_ray,
                                          const float* __restrict__ t_max,
                                          const Start& start,
                                          const Skip& skip) {
  const unsigned lane = threadIdx.x & 31u;
  unsigned idle = __ballot_sync(kFull, ray < 0);
  if (drained || __popc(idle) < kRefillAt) return idle;
  while (idle != 0 && !drained) {
    const int want = __popc(idle);
    int base = 0;
    if (lane == 0) base = atomicAdd(next_ray, want);
    base = __shfl_sync(kFull, base, 0);
    drained = base + want >= n;
    if (ray < 0) {
      const int i = base + __popc(idle & ((1u << lane) - 1u));
      if (i < n) {
        const float tm = t_max[i];
        if (tm > kTMin) {
          ray = i;
          start(i, tm);
        } else {
          skip(i, tm);
        }
      }
    }
    idle = __ballot_sync(kFull, ray < 0);
  }
  return idle;
}

__device__ __forceinline__ bool is_leaf(int meta) {
  return meta < 0 && meta != kNone;
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
  Stack st(smem);
  const int leaf_f4 = leaf * kTriStride / 4;
  int ray = -1;     // the lane's ray, -1 when idle
  int cur = kNone;  // the entry it visits next
  bool drained = false;
  Ray r{};
  float bt = 0.0f, bu = 0.0f, bv = 0.0f;
  int btri = -1;
  auto start = [&](int i, float tm) {
    r = load_ray(origin, direction, i);
    bt = tm;
    btri = -1;
    bu = bv = 0.0f;
    cur = root;
    st.clear();
  };
  auto skip = [&](int i, float tm) {
    out_t[i] = tm;
    out_tri[i] = -1;
    out_u[i] = 0.0f;
    out_v[i] = 0.0f;
  };
  for (;;) {
    if (fetch(ray, drained, n, next_ray, t_max, start, skip) == kFull) {
      return;  // drained, and no lane has a ray
    }
    while (__any_sync(kFull, cur >= 0)) {
      if (cur >= 0) cur = closest_node(r, qnodes + (int64_t)cur * 8, bt, st);
    }
    while (__any_sync(kFull, is_leaf(cur))) {
      if (is_leaf(cur)) {
        const int block = ~cur;
        closest_leaf_grouped(r, ptris + (int64_t)block * leaf_f4,
                             __ldg(counts + block), leaf, bt, btri, bu, bv);
        cur = st.pop();
      }
    }
    if (ray >= 0 && cur == kNone) {
      out_t[ray] = bt;
      out_tri[ray] = btri;
      out_u[ray] = bu;
      out_v[ray] = bv;
      ray = -1;
    }
  }
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
  Stack st(smem);
  const int leaf_f4 = leaf * kTriStride / 4;
  int ray = -1;
  int cur = kNone;
  bool drained = false;
  Ray r{};
  float tm = 0.0f, skip_f = 0.0f;
  bool occ = false;
  auto start = [&](int i, float t) {
    r = load_ray(origin, direction, i);
    tm = t;
    skip_f = (float)skip_object[i];
    occ = false;
    cur = root;
    st.clear();
  };
  auto skip = [&](int i, float) { out_occ[i] = false; };
  for (;;) {
    if (fetch(ray, drained, n, next_ray, t_max, start, skip) == kFull) {
      return;
    }
    while (__any_sync(kFull, cur >= 0)) {
      if (cur >= 0) cur = any_node(r, qnodes + (int64_t)cur * 8, tm, st);
    }
    while (__any_sync(kFull, is_leaf(cur))) {
      if (is_leaf(cur)) {
        const int block = ~cur;
        occ = occluded_leaf_grouped(r, ptris + (int64_t)block * leaf_f4,
                                    __ldg(counts + block), leaf, tm, skip_f);
        cur = occ ? kNone : st.pop();  // the first accepted hit ends it
      }
    }
    if (ray >= 0 && cur == kNone) {
      out_occ[ray] = occ;
      ray = -1;
    }
  }
}

// The persistent grid of a kernel: its dynamic shared memory (the stack,
// `need` entries a thread), the blocks of kThreads threads one SM holds at
// that, and SMs x that many blocks, but no more blocks than `n` rays fill.
struct Plan {
  int smem, per_sm, sms, grid;
};

template <class Fn>
cudaError_t plan(Fn fn, int need, int64_t n, Plan* p) {
  p->smem = need * kThreads * (int)sizeof(int);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&p->sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&p->per_sm, fn, kThreads,
                                                    p->smem);
  if (e != cudaSuccess) return e;
  if (p->per_sm < 1) return cudaErrorInvalidConfiguration;
  int64_t grid = (int64_t)p->sms * p->per_sm;
  int64_t fill = blocks_for(n);
  p->grid = (int)(grid < fill ? grid : fill);
  return cudaSuccess;
}

bool bad_args(int64_t n, int need) {
  return n < 1 || n > kMaxRays || need < 1 || need > kCap;
}

template <class Fn>
int info(Fn fn, int need, int* out) {
  if (need < 1 || need > kCap) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, fn);
  if (e != cudaSuccess) return (int)e;
  Plan p;
  e = plan(fn, need, kMaxRays, &p);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = p.smem;
  out[3] = p.per_sm;
  out[4] = p.sms;
  out[5] = p.grid;
  out[6] = kGroup;
  out[7] = kRefillAt;
  return 0;
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
  if (bad_args(n, need)) return (int)cudaErrorInvalidValue;
  Plan p;
  cudaError_t e = plan(closest_kernel, need, n, &p);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = (cudaStream_t)stream;
  e = cudaMemsetAsync(next_ray, 0, sizeof(int), s);
  if (e != cudaSuccess) return (int)e;
  closest_kernel<<<p.grid, kThreads, p.smem, s>>>(
      origin, direction, t_max, (int)n, root,
      reinterpret_cast<const float4*>(qnodes),
      reinterpret_cast<const float4*>(ptris), leaf_counts, leaf, next_ray,
      out_t, out_tri, out_u, out_v);
  return (int)cudaGetLastError();
}

extern "C" int quad_occlusion(const float* origin, const float* direction,
                              const float* t_max, const int* skip_object,
                              int64_t n, int root, const float* qnodes,
                              const float* ptris, const int* leaf_counts,
                              int leaf, int need, int* next_ray,
                              bool* out_occ, void* stream) {
  if (bad_args(n, need)) return (int)cudaErrorInvalidValue;
  Plan p;
  cudaError_t e = plan(occlusion_kernel, need, n, &p);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = (cudaStream_t)stream;
  e = cudaMemsetAsync(next_ray, 0, sizeof(int), s);
  if (e != cudaSuccess) return (int)e;
  occlusion_kernel<<<p.grid, kThreads, p.smem, s>>>(
      origin, direction, t_max, skip_object, (int)n, root,
      reinterpret_cast<const float4*>(qnodes),
      reinterpret_cast<const float4*>(ptris), leaf_counts, leaf, next_ray,
      out_occ);
  return (int)cudaGetLastError();
}

// What a launch of kernel `occlusion` (0 K1, 1 K2) at stack need `need`
// looks like on the current device: out[0..7] = registers a thread, local
// memory a thread (bytes), dynamic shared memory a block (bytes), resident
// blocks a SM, SMs, the persistent grid, kGroup, kRefillAt.
extern "C" int quad_launch_info(int occlusion, int need, int* out) {
  return occlusion ? info(occlusion_kernel, need, out)
                   : info(closest_kernel, need, out);
}
