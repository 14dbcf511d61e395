// PerfBound's t_PDT choice for every port: the leftmost histogram bin
// whose suffix count is within the port's budget N, and that bin's mean
// gap (its centre when the bin is empty).
//
// Replaces the TPU kernel tpdt_select_pallas (src/repro/kernels/
// tpdt_select.py, kernel body _kernel).  Its plain version is
// repro_torch/kernels/ref.py:tpdt_select_ref.
//
// Bound: bytes.  The (P, B) counts are read once and one sum per port; the
// work is one add and one compare per bin.
//
// Design: one thread per port.  The TPU kernel forms the reverse
// cumulative count as a product with a triangular matrix for its matrix
// unit; here a thread simply walks its port's bins from B-1 down to 0,
// accumulating the suffix count and recording every bin whose suffix is
// <= N.  The last bin recorded is the first True of the feasibility row,
// the plain version's argmax, with no monotonicity assumed.  Counts are
// integer-valued floats, so the suffix sums are exact in any order.  Then
// the mean / centre, max_tpdt (no feasible bin) and tpdt_init (empty
// history) selects of the plain version.  It gates on total > 0 alone, as
// the TPU kernel and its oracle do.
#include <cuda_runtime.h>

namespace {

__global__ void tpdt_select_kernel(const float* __restrict__ counts,
                                   const float* __restrict__ sums,
                                   const float* __restrict__ n_v,
                                   const float* __restrict__ total_v,
                                   const float* __restrict__ centers,
                                   float* __restrict__ out, int P, int B,
                                   float max_tpdt, float tpdt_init) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const float* c = counts + static_cast<size_t>(p) * B;
  const float n = n_v[p];
  float rcum = 0.f;
  int j = -1;
  for (int b = B - 1; b >= 0; --b) {
    rcum = rcum + c[b];
    if (rcum <= n) j = b;
  }
  float t = max_tpdt;
  if (j >= 0) {
    const float cj = c[j];
    const float sj = sums[static_cast<size_t>(p) * B + j];
    t = cj > 0.f ? sj / fmaxf(cj, 1e-30f) : centers[j];
  }
  out[p] = total_v[p] > 0.f ? t : tpdt_init;
}

}  // namespace

// counts/sums: (P, B) f32 row-major; N/total/out: (P,) f32; centers: (B,).
// Launches on `stream`; returns cudaGetLastError().
extern "C" int tpdt_select_launch(const float* counts, const float* sums,
                                  const float* n, const float* total,
                                  const float* centers, float* out, int P,
                                  int B, float max_tpdt, float tpdt_init,
                                  void* stream) {
  const int threads = 128;
  if (P > 0) {
    const int blocks = (P + threads - 1) / threads;
    tpdt_select_kernel<<<blocks, threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        counts, sums, n, total, centers, out, P, B, max_tpdt, tpdt_init);
  }
  return static_cast<int>(cudaGetLastError());
}
