// Decoupled per-port EEE/PDT energy replay over the two-row sleep ladder.
//
// Replaces the TPU kernel port_energy_pallas (src/repro/kernels/
// port_energy.py, kernel body _kernel).  Its plain version is
// repro_torch/kernels/ref.py:port_energy_ref.
//
// Bound: bytes.  Every port streams its E (gap, duration) pairs once,
// 2*E*P*4 bytes, and does a few dozen float operations per pair, far below
// the card's operations-per-byte balance.
//
// Design: one thread per port.  A thread walks its port's events in order
// (the FSM is sequential along events, independent across ports) and keeps
// the seven accounts in registers.  The (E, P) inputs are row-major, so at
// each event the threads of a warp read neighbouring addresses and every
// load is coalesced; the loop is unrolled so that several rows' loads are
// in flight at once.  Ports need no padding: threads past P exit.  The
// arithmetic keeps the plain version's operation order, and the library is
// built without fast math or FMA contraction, so results match it to the
// rounding of float32 sums.
#include <cuda_runtime.h>

namespace {

// max that propagates a NaN operand, as the plain version's maximum does
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

__global__ void port_energy_kernel(const float* __restrict__ gaps,
                                   const float* __restrict__ durs,
                                   const float* __restrict__ tpdt_v,
                                   const float* __restrict__ tds_v,
                                   const float* __restrict__ hold_v,
                                   const float* __restrict__ tail_v,
                                   float* __restrict__ out, int E, int P,
                                   float t_w, float t_s, float t_w2,
                                   float t_s2) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const float tpdt = tpdt_v[p];
  const float tds = tds_v[p];  // demotion timer, clamped >= t_s by the caller
  const float hold = hold_v[p];
  float wake = 0.f, sleep = 0.f, sleep2 = 0.f;
  float nw = 0.f, hit = 0.f, miss = 0.f, nd = 0.f;
#pragma unroll 8
  for (int e = 0; e < E; ++e) {
    const size_t i = static_cast<size_t>(e) * P + p;
    const float g = gaps[i];
    const float d = durs[i];
    const bool act = d > 0.f;
    const bool asleep = act && (g >= tpdt);
    const float ge = g + (asleep ? hold : 0.f);
    const bool deep = act && (ge >= tpdt + tds);
    const float wake_add =
        asleep ? (deep ? tpdt + t_s + t_s2 + t_w2 + d : tpdt + t_s + t_w + d)
               : g + d;
    const float sleep_add =
        asleep ? (deep ? tds - t_s : nan_max(ge - tpdt - t_s, 0.f)) : 0.f;
    const float sleep2_add =
        deep ? nan_max(ge - tpdt - tds - t_s2, 0.f) : 0.f;
    wake = wake + (act ? wake_add : 0.f);
    sleep = sleep + (act ? sleep_add : 0.f);
    sleep2 = sleep2 + sleep2_add;
    nw = nw + (asleep ? 1.f : 0.f);
    hit = hit + ((act && !asleep) ? 1.f : 0.f);
    miss = miss + (asleep ? 1.f : 0.f);
    nd = nd + (deep ? 1.f : 0.f);
  }
  // close-out tail
  const float tail = tail_v[p];
  const bool tail_sleeps = tail >= tpdt + t_s;
  const bool tail_deep = tail >= tpdt + tds + t_s2;
  wake = wake + (tail_sleeps ? tpdt + t_s + (tail_deep ? t_s2 : 0.f) : tail);
  sleep = sleep +
          (tail_sleeps ? (tail_deep ? tds - t_s : tail - tpdt - t_s) : 0.f);
  sleep2 = sleep2 + (tail_deep ? tail - tpdt - tds - t_s2 : 0.f);
  out[0 * static_cast<size_t>(P) + p] = wake;
  out[1 * static_cast<size_t>(P) + p] = sleep;
  out[2 * static_cast<size_t>(P) + p] = sleep2;
  out[3 * static_cast<size_t>(P) + p] = nw;
  out[4 * static_cast<size_t>(P) + p] = hit;
  out[5 * static_cast<size_t>(P) + p] = miss;
  out[6 * static_cast<size_t>(P) + p] = nd;
}

}  // namespace

// gaps/durs: (E, P) f32 row-major; tpdt/tds/hold/tail: (P,) f32;
// out: (7, P) f32.  Launches on `stream`; returns cudaGetLastError().
extern "C" int port_energy_launch(const float* gaps, const float* durs,
                                  const float* tpdt, const float* tds,
                                  const float* hold, const float* tail,
                                  float* out, int E, int P, float t_w,
                                  float t_s, float t_w2, float t_s2,
                                  void* stream) {
  const int threads = 64;
  if (P > 0) {
    const int blocks = (P + threads - 1) / threads;
    port_energy_kernel<<<blocks, threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        gaps, durs, tpdt, tds, hold, tail, out, E, P, t_w, t_s, t_w2, t_s2);
  }
  return static_cast<int>(cudaGetLastError());
}
