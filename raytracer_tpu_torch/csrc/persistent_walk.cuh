// The persistent-warp walk shared by the render path's traversal kernels:
// K1/K2 (quad_traverse.cu, the 4-wide tree) and K3/K4 (binary_traverse.cu,
// the binary tree). A kernel brings its node step; everything else of the
// walk is here:
//
//   - fetch: a warp's idle lanes take live rays from a global counter, one
//     atomicAdd for all of them, once kRefillAt of its 32 lanes are idle;
//     an inactive ray (t_max <= t_min) is answered at fetch time
//     (fetch_with: the same for other work items, L5's ray pairs);
//   - Stack: the entries below the one a lane visits next (which stays in
//     a register), in shared memory laid out [entry][thread];
//   - the grouped leaf loops: the loads of kGroup triangles issued together,
//     and each leaf row tested up to its count (its last real triangle);
//   - the binary node step (binary_node: the far child to the stack, the
//     near one to the register entry), K3/K4's and L1/L9's;
//   - closest_walk / any_walk: while-while, node steps until no lane of the
//     warp has an internal node next, then leaf visits until none has a
//     leaf next; a per-ray hook (WalkHook, the default, counts nothing) may
//     count each ray's visits and, for closest hits, test its leaves;
//   - launch: the persistent grid (the occupancy calculator's blocks a SM
//     at the stack's dynamic shared memory, on every SM), and info, what a
//     launch looks like.
//
// kGroup and kRefillAt are template parameters, set by each kernel's
// source, and so is the block size, kBlock (kThreads unless a kernel says
// otherwise: the stack's stride, the launch and its plan). t_min is an
// argument: K1/K2 pass their fixed 1e-3, K3/K4 the launch's. Each helper
// keeps the plain versions' order of tests (slot order in a leaf, a
// strictly smaller t kept), so the kernels built on them equal their plain
// versions bit for bit.

#pragma once

#include <climits>

#include "traverse_common.cuh"

namespace traverse {

constexpr int kNone = INT_MIN;     // no next entry; metas are > -(2^24 + 2)
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxRays = 1 << 30;  // the int32 counter passes n by < 2^20

// The stack below the register entry, in shared memory: entry e of thread
// t at smem[e * kBlock + t], so the lanes of a warp use 32 banks.
template <int kBlock>
struct BlockStack {
  int* p;
  int sp = 0;
  __device__ explicit BlockStack(int* smem) : p(smem + threadIdx.x) {}
  __device__ __forceinline__ void push(int m) { p[sp++ * kBlock] = m; }
  __device__ __forceinline__ int pop() {
    return sp > 0 ? p[--sp * kBlock] : kNone;
  }
  __device__ __forceinline__ void clear() { sp = 0; }
};

using Stack = BlockStack<kThreads>;

__device__ __forceinline__ bool is_leaf(int meta) {
  return meta < 0 && meta != kNone;
}

// binary_visit's push policy on the persistent walk: the far child goes to
// the stack, the near one (the left one, !kOrdered) to the register entry.
template <class St>
struct NearInRegister {
  St& st;
  int& next;
  __device__ __forceinline__ void operator()(int meta) const { st.push(meta); }
  __device__ __forceinline__ void near(int meta) const { next = meta; }
};

// The binary node step (K3/K4, L1/L9): slab-test both children of pnodes
// row `p` against [t_min, t_cap], push them as binary_visit<kOrdered> says,
// and return the entry to visit next (kNone when the stack is empty).
template <bool kOrdered = true, class St>
__device__ __forceinline__ int binary_node(const Ray& r,
                                           const float4* __restrict__ p,
                                           float t_min, float t_cap,
                                           St& st) {
  int next = kNone;
  binary_visit<kOrdered>(r, p, t_min, t_cap, NearInRegister<St>{st, next});
  return next != kNone ? next : st.pop();
}

// The 3 float4 of the slots k..k+kGroup-1 of a leaf row that lie below
// `lim`.
template <int kGroup>
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
template <int kGroup>
__device__ __forceinline__ void closest_leaf_grouped(
    const Ray& r, const float4* __restrict__ row, int count, int leaf,
    float t_min, float& bt, int& btri, float& bu, float& bv) {
  float4 a[kGroup], b[kGroup], c[kGroup];
  load_group<kGroup>(row, 0, leaf, a, b, c);
  for (int k = 0;;) {
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      float t, u, v;
      if (k + j < count &&
          moller(r, a[j], b[j], c[j], t_min, bt, &t, &u, &v)) {
        bt = t;
        btri = (int)c[j].y;
        bu = u;
        bv = v;
      }
    }
    k += kGroup;
    if (k >= count) return;
    load_group<kGroup>(row, k, count, a, b, c);
  }
}

// Any-hit leaf: whether one of the row's first `count` triangles, not of
// object `skip`, hits in (t_min, t_max); loaded as in closest_leaf_grouped.
template <int kGroup>
__device__ __forceinline__ bool occluded_leaf_grouped(
    const Ray& r, const float4* __restrict__ row, int count, int leaf,
    float t_min, float t_max, float skip) {
  float4 a[kGroup], b[kGroup], c[kGroup];
  load_group<kGroup>(row, 0, leaf, a, b, c);
  for (int k = 0;;) {
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      float t, u, v;
      if (k + j < count &&
          moller(r, a[j], b[j], c[j], t_min, t_max, &t, &u, &v) &&
          c[j].z != skip) {
        return true;
      }
    }
    k += kGroup;
    if (k >= count) return false;
    load_group<kGroup>(row, k, count, a, b, c);
  }
}

// A warp's fetch: once at least kRefillAt of its lanes are idle (ray < 0),
// the idle lanes take the next indices from `next_ray`, one atomicAdd for
// all of them, until none is idle or the counter has passed n. A lane
// whose ray is live calls start(i, t_max); one whose ray is inactive (t_max
// <= t_min) calls skip(i, t_max), which writes its outputs, and takes the
// next index. `drained` is warp-uniform. Returns the ballot of idle lanes.
template <int kRefillAt, class Start, class Skip>
__device__ __forceinline__ unsigned fetch(int& ray, bool& drained, int n,
                                          int* __restrict__ next_ray,
                                          const float* __restrict__ t_max,
                                          float t_min, const Start& start,
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
        if (tm > t_min) {
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

// fetch over work items 0..n-1 other than rays (L5's ray pairs): a lane
// reads index i's record from t_max, records.load(t_max, i), and takes i
// when records.live(record, t_min), calling start(i, record), else calls
// skip(i, record) and takes the next index. fetch is not written on it:
// that compiled K1-K4 to other SASS.
template <int kRefillAt, class Records, class Start, class Skip>
__device__ __forceinline__ unsigned fetch_with(
    int& ray, bool& drained, int n, int* __restrict__ next_ray,
    const float* __restrict__ t_max, float t_min, const Records& records,
    const Start& start, const Skip& skip) {
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
        const auto tm = records.load(t_max, i);
        if (records.live(tm, t_min)) {
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

// A walk's per-ray hook: start() when a lane takes a ray, visit(leaf) at
// each entry it visits, finish(i) when ray i ends and skip(i) for an
// inactive ray i (after the walk has written its results), and the
// closest-hit leaf test. WalkHook, K1-K4's, counts nothing and tests the
// row up to its count, kGroup triangles at a time; the traversal lab's
// counting hook (lab_traverse.cu) writes visit and leaf counters.
template <int kGroup>
struct WalkHook {
  __device__ __forceinline__ void start() {}
  __device__ __forceinline__ void visit(bool) {}
  __device__ __forceinline__ void finish(int) const {}
  __device__ __forceinline__ void skip(int) const {}
  __device__ __forceinline__ void closest_leaf(
      const Ray& r, const float4* __restrict__ row, int count, int leaf,
      float t_min, float& bt, int& btri, float& bu, float& bv) const {
    closest_leaf_grouped<kGroup>(r, row, count, leaf, t_min, bt, btri, bu,
                                 bv);
  }
};

// The closest-hit walk of a persistent block of kBlock threads: `node(r,
// entry, best t, stack)` is the kernel's node step, which returns the entry
// to visit next (kNone when the stack is empty); `hook` as WalkHook. `smem`
// holds the block's stacks.
template <int kGroup, int kRefillAt, int kBlock = kThreads, class Node,
          class Hook = WalkHook<kGroup>>
__device__ __forceinline__ void closest_walk(
    int* smem, const float* __restrict__ origin,
    const float* __restrict__ direction, const float* __restrict__ t_max,
    int n, float t_min, int root, const float4* __restrict__ ptris,
    const int* __restrict__ counts, int leaf, int* __restrict__ next_ray,
    float* __restrict__ out_t, int* __restrict__ out_tri,
    float* __restrict__ out_u, float* __restrict__ out_v, const Node& node,
    Hook hook = {}) {
  BlockStack<kBlock> st(smem);
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
    hook.start();
  };
  auto skip = [&](int i, float tm) {
    out_t[i] = tm;
    out_tri[i] = -1;
    out_u[i] = 0.0f;
    out_v[i] = 0.0f;
    hook.skip(i);
  };
  for (;;) {
    if (fetch<kRefillAt>(ray, drained, n, next_ray, t_max, t_min, start,
                         skip) == kFull) {
      return;  // drained, and no lane has a ray
    }
    while (__any_sync(kFull, cur >= 0)) {
      if (cur >= 0) {
        hook.visit(false);
        cur = node(r, cur, bt, st);
      }
    }
    while (__any_sync(kFull, is_leaf(cur))) {
      if (is_leaf(cur)) {
        const int block = ~cur;
        hook.visit(true);
        hook.closest_leaf(r, ptris + (int64_t)block * leaf_f4,
                          __ldg(counts + block), leaf, t_min, bt, btri, bu,
                          bv);
        cur = st.pop();
      }
    }
    if (ray >= 0 && cur == kNone) {
      out_t[ray] = bt;
      out_tri[ray] = btri;
      out_u[ray] = bu;
      out_v[ray] = bv;
      hook.finish(ray);
      ray = -1;
    }
  }
}

// The any-hit walk of a persistent block, as closest_walk with t_max as
// the pruning bound; a ray ends at its first accepted hit by a triangle not
// of its skip_object. Of `hook` it takes all but the closest-hit leaf.
template <int kGroup, int kRefillAt, int kBlock = kThreads, class Node,
          class Hook = WalkHook<kGroup>>
__device__ __forceinline__ void any_walk(
    int* smem, const float* __restrict__ origin,
    const float* __restrict__ direction, const float* __restrict__ t_max,
    const int* __restrict__ skip_object, int n, float t_min, int root,
    const float4* __restrict__ ptris, const int* __restrict__ counts,
    int leaf, int* __restrict__ next_ray, bool* __restrict__ out_occ,
    const Node& node, Hook hook = {}) {
  BlockStack<kBlock> st(smem);
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
    hook.start();
  };
  auto skip = [&](int i, float) {
    out_occ[i] = false;
    hook.skip(i);
  };
  for (;;) {
    if (fetch<kRefillAt>(ray, drained, n, next_ray, t_max, t_min, start,
                         skip) == kFull) {
      return;
    }
    while (__any_sync(kFull, cur >= 0)) {
      if (cur >= 0) {
        hook.visit(false);
        cur = node(r, cur, tm, st);
      }
    }
    while (__any_sync(kFull, is_leaf(cur))) {
      if (is_leaf(cur)) {
        const int block = ~cur;
        hook.visit(true);
        occ = occluded_leaf_grouped<kGroup>(
            r, ptris + (int64_t)block * leaf_f4, __ldg(counts + block), leaf,
            t_min, tm, skip_f);
        cur = occ ? kNone : st.pop();  // the first accepted hit ends it
      }
    }
    if (ray >= 0 && cur == kNone) {
      out_occ[ray] = occ;
      hook.finish(ray);
      ray = -1;
    }
  }
}

// The persistent grid of a kernel: its dynamic shared memory (the stack,
// `need` entries a thread), the blocks of kBlock threads one SM holds at
// that, and SMs x that many blocks, but no more blocks than `n` rays fill.
// Above 48 KB a block's dynamic shared memory must be allowed before the
// launch, so plan() allows the kernel what it takes, every time.
struct Plan {
  int smem, per_sm, sms, grid;
};

template <int kBlock = kThreads, class Fn>
cudaError_t plan(Fn fn, int need, int64_t n, Plan* p) {
  p->smem = need * kBlock * (int)sizeof(int);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&p->sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           p->smem);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&p->per_sm, fn, kBlock,
                                                    p->smem);
  if (e != cudaSuccess) return e;
  if (p->per_sm < 1) return cudaErrorInvalidConfiguration;
  int64_t grid = (int64_t)p->sms * p->per_sm;
  int64_t fill = blocks_for(n, kBlock);
  p->grid = (int)(grid < fill ? grid : fill);
  return cudaSuccess;
}

// Launch `kernel` on `n` rays with `need` stack entries a thread (at most
// `cap`), in blocks of kBlock threads: zero the ray counter `next_ray` on
// `stream`, then the persistent grid. Returns the first cudaError_t;
// neither synchronises nor allocates.
template <int kBlock = kThreads, class... Params, class... Args>
int launch(void (*kernel)(Params...), int64_t n, int need, int cap,
           int* next_ray, void* stream, Args... args) {
  if (n < 1 || n > kMaxRays || need < 1 || need > cap) {
    return (int)cudaErrorInvalidValue;
  }
  Plan p;
  cudaError_t e = plan<kBlock>(kernel, need, n, &p);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = (cudaStream_t)stream;
  e = cudaMemsetAsync(next_ray, 0, sizeof(int), s);
  if (e != cudaSuccess) return (int)e;
  kernel<<<p.grid, kBlock, p.smem, s>>>(args...);
  return (int)cudaGetLastError();
}

// What a launch of `kernel` at stack need `need` (at most `cap`) looks like
// on the current device: out[0..8] = registers a thread, local memory a
// thread (bytes), dynamic shared memory a block (bytes), resident blocks a
// SM, SMs, the persistent grid, kGroup, kRefillAt, threads a block.
template <int kGroup, int kRefillAt, int kBlock = kThreads, class Fn>
int info(Fn kernel, int need, int cap, int* out) {
  if (need < 1 || need > cap) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, kernel);
  if (e != cudaSuccess) return (int)e;
  Plan p;
  e = plan<kBlock>(kernel, need, kMaxRays, &p);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = p.smem;
  out[3] = p.per_sm;
  out[4] = p.sms;
  out[5] = p.grid;
  out[6] = kGroup;
  out[7] = kRefillAt;
  out[8] = kBlock;
  return 0;
}

}  // namespace traverse
