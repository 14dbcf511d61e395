// Per-port inactivity histograms: counts and value sums of the positive
// gaps, in linear or log-spaced bins.
//
// Replaces the TPU kernel hist_update_pallas (src/repro/kernels/
// hist_update.py, kernel body _kernel).  Its plain version is
// repro_torch/kernels/ref.py:hist_update_ref.
//
// Bound: bytes.  The gaps are read once, E*P*4 bytes, and the two (P, B)
// outputs written once; each gap costs a division (or a log) and two adds.
//
// Design: one thread per port, walking its port's gaps in event order.  A
// block of T threads keeps its T ports' B count and B sum accumulators in
// dynamic shared memory laid out [bin][thread], so the threads of a warp
// always hit distinct banks whatever bins they land in.  No atomics: each
// accumulator has one writer, and every sum adds its gaps in event order,
// so the result is deterministic.  At B = 200 and T = 64 the accumulators
// take 102,400 bytes, which needs the large-shared-memory opt-in.  The
// block's T output rows are contiguous in the row-major (P, B) outputs, so
// the block writes them cooperatively with coalesced stores.
//
// Binning follows the TPU kernel's float32 arithmetic: the linear index is
// (int)(g / bin_width), the log index (logf(max(g, log_min)) - lo) / den
// times B, with lo = f32(log(log_min)) and den = f32(log(log_max) -
// log(log_min)) rounded on the host; both are clipped to [0, B-1].  IEEE
// logf and division: the library is built without fast math.
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int clip_bin(float x, int B) {
  // x >= 0 or NaN-free slightly negative; a float past B-1 saturates
  if (x >= static_cast<float>(B - 1)) return B - 1;
  if (x > 0.f) return static_cast<int>(x);
  return 0;
}

__global__ void hist_update_kernel(const float* __restrict__ gaps,
                                   float* __restrict__ counts,
                                   float* __restrict__ sums, int E, int P,
                                   int B, int log_bins, float bin_width,
                                   float log_min, float lo, float den) {
  extern __shared__ float smem[];
  const int T = blockDim.x;
  const int t = threadIdx.x;
  float* c_sm = smem;          // [B][T]
  float* s_sm = smem + B * T;  // [B][T]
  for (int i = t; i < B * T; i += T) {
    c_sm[i] = 0.f;
    s_sm[i] = 0.f;
  }
  __syncthreads();
  const int p0 = blockIdx.x * T;
  const int p = p0 + t;
  if (p < P) {
    const float fB = static_cast<float>(B);
#pragma unroll 4
    for (int e = 0; e < E; ++e) {
      const float g = gaps[static_cast<size_t>(e) * P + p];
      if (g > 0.f) {
        int b;
        if (log_bins) {
          const float x = (logf(fmaxf(g, log_min)) - lo) / den;
          b = clip_bin(x * fB, B);
        } else {
          b = clip_bin(g / bin_width, B);
        }
        c_sm[b * T + t] = c_sm[b * T + t] + 1.f;
        s_sm[b * T + t] = s_sm[b * T + t] + g;
      }
    }
  }
  __syncthreads();
  const int rows = min(T, P - p0);
  const size_t base = static_cast<size_t>(p0) * B;
  for (int i = t; i < rows * B; i += T) {
    const int r = i / B;
    const int b = i - r * B;
    counts[base + i] = c_sm[b * T + r];
    sums[base + i] = s_sm[b * T + r];
  }
}

}  // namespace

// gaps: (E, P) f32 row-major; counts/sums: (P, B) f32.  `threads` ports per
// block, 2*B*threads*4 bytes of shared memory (the caller checks the fit).
// Launches on `stream`; returns the first CUDA error, else 0.
extern "C" int hist_update_launch(const float* gaps, float* counts,
                                  float* sums, int E, int P, int B,
                                  int threads, int log_bins, float bin_width,
                                  float log_min, float lo, float den,
                                  void* stream) {
  const size_t smem = 2 * static_cast<size_t>(B) * threads * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      hist_update_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (P > 0) {
    const int blocks = (P + threads - 1) / threads;
    hist_update_kernel<<<blocks, threads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
        gaps, counts, sums, E, P, B, log_bins, bin_width, log_min, lo, den);
  }
  return static_cast<int>(cudaGetLastError());
}
