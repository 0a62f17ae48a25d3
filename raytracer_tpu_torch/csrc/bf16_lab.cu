// The packed-bf16 throughput lab's kernels for Hopper (sm_90a): chains of
// K multiply-adds (or multiplies) per element in f32 and in packed bf16x2.
//
// Replaces the TPU lab kernels of tools/bf16_lab.py:73 (run): _kernel_f32
// :27, _kernel_bf16 :38, _kernel_f32_mul :47, _kernel_bf16_mul :57,
// _kernel_f32_ilp :96 and _kernel_bf16_ilp :108. The TPU kernels run a
// grid of tiles, f32 on two [8,128] inputs x, y and bf16 on one [16,128]
// input; here an f32 thread holds one element of x and one of y, and a
// bf16 thread one __nv_bfloat162 (two elements: the point is packing), so
// both forms cover the same elements with the same number of threads.
//
// The chains equal the JAX kernels bit for bit: f32 x*a+b is __fmul_rn
// then __fadd_rn (the library is built with -fmad=false besides), bf16 is
// __hmul2 then __hadd2, each rounding to bf16, as XLA rounds each bf16 op;
// the ILP forms keep sum(xs[1:], xs[0])'s left-to-right order. The
// constants are the JAX scalars' bit patterns (jnp.float32(c),
// jnp.bfloat16(c)). Two more timed forms measure the card's fused rate:
// f32_fma (fmaf) and bf16_fma (__hfma2), which round once per step.
//
// K is passed at run time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

enum Variant { kF32, kBf16, kF32Mul, kBf16Mul, kF32Ilp, kBf16Ilp, kF32Fma,
               kBf16Fma };

// jnp.float32(1.0000001), jnp.float32(1e-7), jnp.float32(1.0 + i * 1e-6)
constexpr uint32_t kF32A = 0x3f800001u, kF32B = 0x33d6bf95u;
__constant__ uint32_t kF32Scale[4] = {0x3f800000u, 0x3f800008u,
                                      0x3f800011u, 0x3f800019u};
// jnp.bfloat16(1.0078125), jnp.bfloat16(0.001), jnp.bfloat16(1.0 + i * 0.01)
constexpr unsigned short kBf16A = 0x3f81, kBf16B = 0x3a83;
__constant__ unsigned short kBf16Scale[8] = {0x3f80, 0x3f81, 0x3f83, 0x3f84,
                                             0x3f85, 0x3f86, 0x3f88, 0x3f89};

__device__ __forceinline__ float f32c(uint32_t bits) {
  return __uint_as_float(bits);
}

__device__ __forceinline__ __nv_bfloat162 bf2c(unsigned short bits) {
  const __nv_bfloat16 h = __ushort_as_bfloat16(bits);
  return __halves2bfloat162(h, h);
}

__device__ __forceinline__ float mad_rn(float x, float a, float b) {
  return __fadd_rn(__fmul_rn(x, a), b);
}

__device__ __forceinline__ __nv_bfloat162 mad_rn(__nv_bfloat162 x,
                                                 __nv_bfloat162 a,
                                                 __nv_bfloat162 b) {
  return __hadd2(__hmul2(x, a), b);
}

// f32 forms: out[i] = chain(x[i]) + chain(y[i]).
template <int kVariant>
__global__ void __launch_bounds__(kThreads)
f32_kernel(const float* __restrict__ x, const float* __restrict__ y,
           int64_t n, int k, float* __restrict__ out) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float a = f32c(kF32A), b = f32c(kF32B);
  if (kVariant == kF32Ilp) {
    float xs[4], ys[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      xs[j] = __fmul_rn(x[i], f32c(kF32Scale[j]));
      ys[j] = __fmul_rn(y[i], f32c(kF32Scale[j]));
    }
    const int steps = k / 4;
#pragma unroll 2
    for (int s = 0; s < steps; ++s) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        xs[j] = mad_rn(xs[j], a, b);
        ys[j] = mad_rn(ys[j], a, b);
      }
    }
    float sx = xs[0], sy = ys[0];
#pragma unroll
    for (int j = 1; j < 4; ++j) {
      sx = __fadd_rn(sx, xs[j]);
      sy = __fadd_rn(sy, ys[j]);
    }
    out[i] = __fadd_rn(sx, sy);
    return;
  }
  float xv = x[i], yv = y[i];
#pragma unroll 8
  for (int s = 0; s < k; ++s) {
    if (kVariant == kF32) {
      xv = mad_rn(xv, a, b);
      yv = mad_rn(yv, a, b);
    } else if (kVariant == kF32Mul) {
      xv = __fmul_rn(xv, a);
      yv = __fmul_rn(yv, a);
    } else {  // kF32Fma
      xv = fmaf(xv, a, b);
      yv = fmaf(yv, a, b);
    }
  }
  out[i] = __fadd_rn(xv, yv);
}

// bf16 forms over element pairs: out[i] = chain(x[i]).
template <int kVariant>
__global__ void __launch_bounds__(kThreads)
bf16_kernel(const __nv_bfloat162* __restrict__ x, int64_t n2, int k,
            __nv_bfloat162* __restrict__ out) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n2) return;
  const __nv_bfloat162 a = bf2c(kBf16A), b = bf2c(kBf16B);
  if (kVariant == kBf16Ilp) {
    __nv_bfloat162 xs[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) xs[j] = __hmul2(x[i], bf2c(kBf16Scale[j]));
    const int steps = k / 4;
#pragma unroll 2
    for (int s = 0; s < steps; ++s) {
#pragma unroll
      for (int j = 0; j < 8; ++j) xs[j] = mad_rn(xs[j], a, b);
    }
    __nv_bfloat162 sum = xs[0];
#pragma unroll
    for (int j = 1; j < 8; ++j) sum = __hadd2(sum, xs[j]);
    out[i] = sum;
    return;
  }
  __nv_bfloat162 xv = x[i];
#pragma unroll 8
  for (int s = 0; s < k; ++s) {
    if (kVariant == kBf16) {
      xv = mad_rn(xv, a, b);
    } else if (kVariant == kBf16Mul) {
      xv = __hmul2(xv, a);
    } else {  // kBf16Fma
      xv = __hfma2(xv, a, b);
    }
  }
  out[i] = xv;
}

unsigned blocks_for(int64_t n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

// Plain C entry point (loaded with ctypes): launches on `stream` and
// returns the launch's cudaError_t (cudaErrorInvalidValue for an argument
// no kernel takes); never synchronises or allocates. variant: 0 f32, 1
// bf16, 2 f32_mul, 3 bf16_mul, 4 f32_ilp, 5 bf16_ilp, 6 f32_fma, 7
// bf16_fma. `n` counts elements: of x and of y (f32[n] each) for the f32
// forms, of x (bf16[n], n even) for the bf16 forms; out has x's dtype and
// shape.
extern "C" int lab_bf16(const void* x, const void* y, int64_t n, int k,
                        int variant, void* out, void* stream) {
  if (n <= 0 || k < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  auto fx = static_cast<const float*>(x);
  auto fy = static_cast<const float*>(y);
  auto fo = static_cast<float*>(out);
  auto bx = static_cast<const __nv_bfloat162*>(x);
  auto bo = static_cast<__nv_bfloat162*>(out);
  const bool bf16 = variant == kBf16 || variant == kBf16Mul ||
                    variant == kBf16Ilp || variant == kBf16Fma;
  if (bf16 && n % 2) return (int)cudaErrorInvalidValue;
  if (!bf16 && y == nullptr) return (int)cudaErrorInvalidValue;
  const int64_t n2 = n / 2;
  switch (variant) {
    case kF32:
      f32_kernel<kF32><<<blocks_for(n), kThreads, 0, s>>>(fx, fy, n, k, fo);
      break;
    case kF32Mul:
      f32_kernel<kF32Mul><<<blocks_for(n), kThreads, 0, s>>>(fx, fy, n, k,
                                                             fo);
      break;
    case kF32Ilp:
      f32_kernel<kF32Ilp><<<blocks_for(n), kThreads, 0, s>>>(fx, fy, n, k,
                                                             fo);
      break;
    case kF32Fma:
      f32_kernel<kF32Fma><<<blocks_for(n), kThreads, 0, s>>>(fx, fy, n, k,
                                                             fo);
      break;
    case kBf16:
      bf16_kernel<kBf16><<<blocks_for(n2), kThreads, 0, s>>>(bx, n2, k, bo);
      break;
    case kBf16Mul:
      bf16_kernel<kBf16Mul><<<blocks_for(n2), kThreads, 0, s>>>(bx, n2, k,
                                                                bo);
      break;
    case kBf16Ilp:
      bf16_kernel<kBf16Ilp><<<blocks_for(n2), kThreads, 0, s>>>(bx, n2, k,
                                                                bo);
      break;
    case kBf16Fma:
      bf16_kernel<kBf16Fma><<<blocks_for(n2), kThreads, 0, s>>>(bx, n2, k,
                                                                bo);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
