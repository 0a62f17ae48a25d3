// NEE light selection for Hopper (sm_90a): one thread a lane walks the
// light table in the shader's order (simple.rchit:507-541).
//
// Replaces no TPU kernel: on the TPU the selection was plain jnp (the
// [N, L] power/dist² weights, a cumsum, an argmax and gathers,
// raytracer_tpu/integrator/wavefront.py _shade). In the port those torch
// ops made [N, L] tensors and ran torch's scan, about 12 ms a bounce at
// 2,073,600 lanes whatever L, far from what the card allows (PERF.md §6).
//
// A lane needs no [N, L] tensor: its weights are recomputed from the light
// rows, which every lane of a warp reads at the same address (one
// broadcast from L1 a row), so the kernel reads each lane's inputs and
// writes its outputs once. What bounds it: at small L those bytes, at
// large L the arithmetic (an IEEE division a weight, two passes).
//
// Per lane, over the first L lights:
//   1. w_l = power_l / max(|pos - center_l|², 0.001), summed in column
//      order twice: `total` with the lane's own object's lights at 0 (the
//      NEE pdf's; only with `draw`), and `total_all` without (emissive-hit
//      MIS's; only with `mis`).
//   2. Where `draw` and do_nee and total > 0: one LCG step of the seed
//      (the shader's rnd: the new state's low 24 bits / 2^24), r1 = r *
//      total, and the first column whose running sum reaches r1 (found:
//      r1 <= total, the last running sum, so a lane that draws always
//      finds one). The seed advances only there.
//   3. sel_pdf = w_sel / max(total, 1e-20) where found, else 0;
//      w_this = w at the lane's light_index clamped to [0, L).
// Every float operation is written in the plain version's order
// (ops/light_select.py) and the library is built with -fmad=false, so the
// kernel equals it bit for bit. max() is written as a select, which keeps
// a NaN as torch.clamp_min does.
//
// `drawn`, when not null, counts the lanes that drew: one atomicAdd a warp
// of its ballot.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float weight(float px, float py, float pz,
                                        const float* __restrict__ centers,
                                        const float* __restrict__ powers,
                                        int l) {
  float dx = px - __ldg(centers + 3 * l);
  float dy = py - __ldg(centers + 3 * l + 1);
  float dz = pz - __ldg(centers + 3 * l + 2);
  float d2 = dx * dx + dy * dy + dz * dz;
  return __ldg(powers + l) / (d2 < 0.001f ? 0.001f : d2);
}

__global__ void __launch_bounds__(kThreads)
select_kernel(const float* __restrict__ pos, const int* __restrict__ obj,
              const bool* __restrict__ do_nee,
              const int64_t* __restrict__ seed,
              const int* __restrict__ light_index,
              const float* __restrict__ centers,
              const float* __restrict__ powers,
              const int* __restrict__ objects, int num_lights, int64_t n,
              int draw, int mis, int* __restrict__ selected,
              bool* __restrict__ found, float* __restrict__ sel_pdf,
              int64_t* __restrict__ seed_out, float* __restrict__ total_all,
              float* __restrict__ w_this,
              unsigned long long* __restrict__ drawn) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  bool drew = false;
  if (i < n) {
    const float px = pos[3 * i], py = pos[3 * i + 1], pz = pos[3 * i + 2];
    const int own = draw ? obj[i] : 0;
    float total = 0.0f, total_un = 0.0f;
#pragma unroll 4
    for (int l = 0; l < num_lights; ++l) {
      const float w = weight(px, py, pz, centers, powers, l);
      if (mis) total_un = total_un + w;
      if (draw) total = total + (__ldg(objects + l) == own ? 0.0f : w);
    }
    if (draw) {
      const uint32_t s = (uint32_t)seed[i];
      drew = do_nee[i] && total > 0.0f;
      int sel = 0;
      bool hit = false;
      float pdf = 0.0f;
      if (drew) {
        const uint32_t next = s * 1664525u + 1013904223u;
        const float r1 =
            (float)(next & 0x00FFFFFFu) * (1.0f / 16777216.0f) * total;
        float run = 0.0f;
        for (int l = 0; l < num_lights; ++l) {
          float w = weight(px, py, pz, centers, powers, l);
          w = __ldg(objects + l) == own ? 0.0f : w;
          run = run + w;
          if (run >= r1) {
            sel = l;
            hit = true;
            pdf = w / (total < 1e-20f ? 1e-20f : total);
            break;
          }
        }
        seed_out[i] = (int64_t)next;
      } else {
        seed_out[i] = (int64_t)s;
      }
      selected[i] = sel;
      found[i] = hit;
      sel_pdf[i] = pdf;
    }
    if (mis) {
      total_all[i] = total_un;
      int li = light_index[i];
      li = li < 0 ? 0 : (li > num_lights - 1 ? num_lights - 1 : li);
      w_this[i] = weight(px, py, pz, centers, powers, li);
    }
  }
  if (drawn != nullptr) {
    const unsigned ballot = __ballot_sync(0xffffffffu, drew);
    if ((threadIdx.x & 31) == 0 && ballot != 0)
      atomicAdd(drawn, (unsigned long long)__popc(ballot));
  }
}

}  // namespace

// The plain C entry point (loaded with ctypes). Launches one thread a lane
// on `stream` and returns the launch's cudaError_t; neither synchronises
// nor allocates, and n = 0 launches nothing. With draw = 0, obj, do_nee,
// seed, selected, found, sel_pdf and seed_out may be null; with mis = 0,
// light_index, total_all and w_this; `drawn` may be null.
extern "C" int light_select(const float* pos, const int* obj,
                            const bool* do_nee, const int64_t* seed,
                            const int* light_index, const float* centers,
                            const float* powers, const int* objects,
                            int num_lights, int64_t n, int draw, int mis,
                            int* selected, bool* found, float* sel_pdf,
                            int64_t* seed_out, float* total_all,
                            float* w_this, int64_t* drawn, void* stream) {
  if (n <= 0) return 0;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  select_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      pos, obj, do_nee, seed, light_index, centers, powers, objects,
      num_lights, n, draw, mis, selected, found, sel_pdf, seed_out,
      total_all, w_this, reinterpret_cast<unsigned long long*>(drawn));
  return (int)cudaGetLastError();
}
