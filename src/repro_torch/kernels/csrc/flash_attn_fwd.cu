// Flash-attention forward with grouped-query heads, causal and
// sliding-window masks, and the row logsumexp for the backward pass.
//
// Replaces the TPU kernel flash_attention_fwd_pallas (src/repro/kernels/
// flash_attn.py, kernel body _kernel).  Its plain version is
// repro_torch/kernels/ref.py:flash_attention_fwd_ref.
//
// Bound: operations.  A causal prefill of S tokens does S*(S+1)/2
// multiply-adds per head and head-dim element for Q.K^T and as many for
// P.V, against reading q, k, v and writing o once.
//
// Common to both kernels below (simple and right first; no wgmma, no TMA):
//  * One block of 128 threads per (q tile, query head, batch row).  The
//    block walks the kv tiles in order, so the TPU kernel's sequential kv
//    grid axis becomes a loop, and the online-softmax state m, l and the
//    accumulator stay in registers from the first tile to the last.
//  * Arithmetic follows the TPU kernel: scores in float32 scaled by
//    1/sqrt(dh) rounded to float32; masked scores set to NEG = -0.7*FLT_MAX
//    and their p zeroed; l = max(l, 1e-30) at the end; lse = m + log(l).
//    kv tiles that a row block's masks cover completely are skipped: they
//    change neither m, l nor the accumulator.  exp and log are the
//    accurate expf/logf (the library is built without fast math).
//  * The q tiles are launched last first, so the long causal rows start
//    early and the short ones fill the tail.
//
// bfloat16 inputs (the serving path) take flash_fwd_mma_kernel: both
// products on the tensor cores with mma.sync m16n8k16 (bf16 in, float32
// accumulate).  Each of the four warps owns 16 query rows; Q, K and V
// tiles sit in shared memory as bf16, V read with ldmatrix.trans.  The
// products of bf16 q and k are exact in float32.  p is float32, as in the
// TPU kernel; to keep it so through a bf16 product it is split into
// p_hi + p_lo, two bf16 numbers (~16 significant bits together), and P.V
// is two products.
//
// float32 inputs take flash_fwd_f32_kernel, float32 CUDA-core arithmetic
// with explicit fmaf (the library is built with --fmad=false): 8 row
// groups of 16 lanes; a thread owns RQ query rows (8, or 4 at dh = 256),
// 4 of the 64 scores of a tile and dh/16 accumulator columns, so dh is
// split across the lanes of a row group.  Row max and sum are butterfly
// shuffles over those 16 lanes.  Q, K, V and P tiles sit in shared memory
// as float32, K and V taking turns in one buffer; row strides are padded
// so the float4 reads of K and the reads of P hit distinct banks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kLanes = 16;                       // lanes of one row group
constexpr int kGroups = kThreads / kLanes;       // 8 row groups
constexpr int kColsPerLane = 4;
constexpr int kBKV = kLanes * kColsPerLane;      // 64 keys per kv tile

template <int DH>
struct Tile {
  static constexpr int RQ = DH > 128 ? 4 : 8;    // query rows per thread
  static constexpr int BQ = kGroups * RQ;        // query rows per block
  static constexpr int LD = DH + 4;              // Q/K/V row stride (floats)
  // P row stride: rows RQ apart (the two row groups of a warp) land 16
  // banks apart
  static constexpr int LDP = kBKV + 16 / RQ;
  static constexpr int DC = DH / kLanes;         // accumulator columns
  static constexpr size_t kSmem =
      (size_t(BQ) * LD + size_t(kBKV) * LD + size_t(BQ) * LDP) *
      sizeof(float);
};

// rows x DH elements starting at sequence row `row0` of one head into a
// padded float tile; rows past `n` are zero
template <int DH>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long row_stride, int row0,
                                          int rows, int n) {
  constexpr int LD = Tile<DH>::LD;
  for (int idx = threadIdx.x; idx < rows * DH; idx += kThreads) {
    const int r = idx / DH;
    const int d = idx - r * DH;
    const int g = row0 + r;
    dst[r * LD + d] = g < n ? src[g * row_stride + d] : 0.f;
  }
}

template <int DH>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int Sq, int Skv, int H,
                     int Hkv, int causal, int window, float scale,
                     float neg) {
  using Tl = Tile<DH>;
  constexpr int RQ = Tl::RQ, BQ = Tl::BQ, LD = Tl::LD, LDP = Tl::LDP,
                DC = Tl::DC;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* KVs = Qs + BQ * LD;
  float* Ps = KVs + kBKV * LD;

  const int nq = (Sq + BQ - 1) / BQ;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / Hkv;
  const int hk = h / G;
  const int t = threadIdx.x;
  const int tr = t / kLanes;
  const int tc = t - tr * kLanes;
  const int row0 = tr * RQ;                      // first row of this thread

  // (B, S, heads, DH) row-major
  const long long q_row = static_cast<long long>(H) * DH;
  const long long kv_row = static_cast<long long>(Hkv) * DH;
  const float* qb = q + (static_cast<long long>(b) * Sq * H + h) * DH;
  const float* kb = k + (static_cast<long long>(b) * Skv * Hkv + hk) * DH;
  const float* vb = v + (static_cast<long long>(b) * Skv * Hkv + hk) * DH;

  load_tile<DH>(Qs, qb, q_row, q0, BQ, Sq);

  // kv tiles that hold at least one unmasked key for this row block
  const int q_last = min(q0 + BQ, Sq) - 1;
  int kv_end = Skv;
  if (causal) kv_end = min(kv_end, q_last + 1);
  int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  kv_begin = kv_begin / kBKV * kBKV;

  float m[RQ], l[RQ], acc[RQ][DC];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = neg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }
  __syncthreads();

  for (int kv0 = kv_begin; kv0 < kv_end; kv0 += kBKV) {
    load_tile<DH>(KVs, kb, kv_row, kv0, kBKV, Skv);
    __syncthreads();

    // s = Q K^T for rows row0.., keys tc + 16 j
    float s[RQ][kColsPerLane];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j) s[i][j] = 0.f;
    const float4* Q4 = reinterpret_cast<const float4*>(Qs);
    const float4* K4 = reinterpret_cast<const float4*>(KVs);
#pragma unroll 4
    for (int d4 = 0; d4 < DH / 4; ++d4) {
      float4 kk[kColsPerLane];
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j)
        kk[j] = K4[(tc + kLanes * j) * (LD / 4) + d4];
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const float4 qq = Q4[(row0 + i) * (LD / 4) + d4];
#pragma unroll
        for (int j = 0; j < kColsPerLane; ++j) {
          float a = s[i][j];
          a = __fmaf_rn(qq.x, kk[j].x, a);
          a = __fmaf_rn(qq.y, kk[j].y, a);
          a = __fmaf_rn(qq.z, kk[j].z, a);
          a = __fmaf_rn(qq.w, kk[j].w, a);
          s[i][j] = a;
        }
      }
    }

    // masks, online softmax, P to shared memory
    unsigned ok = 0u;
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int qp = q0 + row0 + i;
      float rmax = neg;
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j) {
        const int kp = kv0 + tc + kLanes * j;
        const bool keep = qp < Sq && kp < Skv && (!causal || kp <= qp) &&
                          (window <= 0 || qp - kp < window);
        s[i][j] = keep ? s[i][j] * scale : neg;
        if (keep) ok |= 1u << (i * kColsPerLane + j);
        rmax = fmaxf(rmax, s[i][j]);
      }
#pragma unroll
      for (int off = kLanes / 2; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(m[i], rmax);
      const float corr = expf(m[i] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j) {
        const float p = (ok >> (i * kColsPerLane + j)) & 1u
                            ? expf(s[i][j] - m_new)
                            : 0.f;
        Ps[(row0 + i) * LDP + tc + kLanes * j] = p;
        rsum += p;
      }
#pragma unroll
      for (int off = kLanes / 2; off > 0; off >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      l[i] = l[i] * corr + rsum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();                 // P complete; K no longer read

    load_tile<DH>(KVs, vb, kv_row, kv0, kBKV, Skv);
    __syncthreads();

    // acc += P V for rows row0.., columns tc + 16 c
#pragma unroll 4
    for (int j = 0; j < kBKV; ++j) {
      float vv[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = KVs[j * LD + tc + kLanes * c];
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const float p = Ps[(row0 + i) * LDP + j];
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = __fmaf_rn(p, vv[c], acc[i][c]);
      }
    }
    __syncthreads();                 // before the next tile overwrites
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int qp = q0 + row0 + i;
    if (qp >= Sq) continue;
    const float li = fmaxf(l[i], 1e-30f);
    float* orow = o + (static_cast<long long>(b) * Sq + qp) * q_row +
                  static_cast<long long>(h) * DH;
#pragma unroll
    for (int c = 0; c < DC; ++c) orow[tc + kLanes * c] = acc[i][c] / li;
    // lse (B*Hkv, G, Sq) is (B, H, Sq) row-major
    if (tc == 0)
      lse[(static_cast<long long>(b) * H + h) * Sq + qp] = m[i] + logf(li);
  }
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kMmaBQ = (kThreads / 32) * 16;     // 16 query rows a warp

template <int DH>
struct MmaTile {
  static constexpr int LD = DH + 8;              // Q/K/V row stride (bf16)
  static constexpr size_t kSmem =
      (size_t(kMmaBQ) + 2 * size_t(kBKV)) * LD * sizeof(__nv_bfloat16);
};

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x0, x1) = hi + lo as two bf16 pairs
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 f = __bfloat1622float2(h);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = pack_bf16(x0 - f.x, x1 - f.y);
}

// c += a.b on a 16x8x16 tile: bf16 operands, float32 accumulator
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the B fragment of a 16x8 (k x n) tile stored k-major: rows are k
__device__ __forceinline__ void ldsm_x2_trans(uint32_t& r0, uint32_t& r1,
                                              const __nv_bfloat16* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r0), "=r"(r1)
      : "r"(addr));
}

// rows x DH bf16 of one head into a [row][LD] tile, 16 bytes a thread at a
// time; rows past n are zero
template <int DH>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst,
                                               const __nv_bfloat16* src,
                                               long long row_stride, int row0,
                                               int rows, int n) {
  constexpr int LD = MmaTile<DH>::LD;
  constexpr int V8 = DH / 8;
  for (int idx = threadIdx.x; idx < rows * V8; idx += kThreads) {
    const int r = idx / V8;
    const int c8 = idx - r * V8;
    const int g = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (g < n)
      val = *reinterpret_cast<const uint4*>(src + g * row_stride + c8 * 8);
    *reinterpret_cast<uint4*>(dst + r * LD + c8 * 8) = val;
  }
}

template <int DH>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                     int Sq, int Skv, int H, int Hkv, int causal, int window,
                     float scale, float neg) {
  constexpr int LD = MmaTile<DH>::LD;
  constexpr int NS = kBKV / 8;                   // score n-tiles
  constexpr int NO = DH / 8;                     // output n-tiles
  extern __shared__ uint4 smem_u4[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_u4);
  __nv_bfloat16* Ks = Qs + kMmaBQ * LD;
  __nv_bfloat16* Vs = Ks + kBKV * LD;

  const int nq = (Sq + kMmaBQ - 1) / kMmaBQ;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * kMmaBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;                        // fragment row (and row + 8)
  const int tig = lane % 4;                      // fragment column pair
  const int wr = (threadIdx.x / 32) * 16;        // the warp's first row

  const long long q_row = static_cast<long long>(H) * DH;
  const long long kv_row = static_cast<long long>(Hkv) * DH;
  const __nv_bfloat16* qb = q + (static_cast<long long>(b) * Sq * H + h) * DH;
  const __nv_bfloat16* kb =
      k + (static_cast<long long>(b) * Skv * Hkv + hk) * DH;
  const __nv_bfloat16* vb =
      v + (static_cast<long long>(b) * Skv * Hkv + hk) * DH;

  load_tile_bf16<DH>(Qs, qb, q_row, q0, kMmaBQ, Sq);

  const int q_last = min(q0 + kMmaBQ, Sq) - 1;
  int kv_end = Skv;
  if (causal) kv_end = min(kv_end, q_last + 1);
  int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  kv_begin = kv_begin / kBKV * kBKV;

  // rows wr + g (half 0) and wr + g + 8 (half 1)
  float m[2] = {neg, neg}, l[2] = {0.f, 0.f};
  float oacc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;

  for (int kv0 = kv_begin; kv0 < kv_end; kv0 += kBKV) {
    load_tile_bf16<DH>(Ks, kb, kv_row, kv0, kBKV, Skv);
    load_tile_bf16<DH>(Vs, vb, kv_row, kv0, kBKV, Skv);
    __syncthreads();

    // s = Q K^T: 16 rows x 64 keys a warp
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < DH / 16; ++ks) {
      const int c = ks * 16 + tig * 2;
      const uint32_t a[4] = {ld32(Qs + (wr + g) * LD + c),
                             ld32(Qs + (wr + g + 8) * LD + c),
                             ld32(Qs + (wr + g) * LD + c + 8),
                             ld32(Qs + (wr + g + 8) * LD + c + 8)};
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const __nv_bfloat16* kr = Ks + (n * 8 + g) * LD + c;
        mma_bf16(s[n], a, ld32(kr), ld32(kr + 8));
      }
    }

    // masks and online softmax; s becomes p
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int qp = q0 + wr + g + 8 * hf;
      float rmax = neg;
      unsigned ok = 0u;
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kp = kv0 + n * 8 + tig * 2 + e;
          const bool keep = qp < Sq && kp < Skv && (!causal || kp <= qp) &&
                            (window <= 0 || qp - kp < window);
          float& x = s[n][2 * hf + e];
          x = keep ? x * scale : neg;
          if (keep) ok |= 1u << (n * 2 + e);
          rmax = fmaxf(rmax, x);
        }
      rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, 1));
      rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, 2));
      const float m_new = fmaxf(m[hf], rmax);
      const float corr = expf(m[hf] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[n][2 * hf + e];
          x = (ok >> (n * 2 + e)) & 1u ? expf(x - m_new) : 0.f;
          rsum += x;
        }
      rsum += __shfl_xor_sync(0xffffffffu, rsum, 1);
      rsum += __shfl_xor_sync(0xffffffffu, rsum, 2);
      l[hf] = l[hf] * corr + rsum;
      m[hf] = m_new;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        oacc[n][2 * hf] *= corr;
        oacc[n][2 * hf + 1] *= corr;
      }
    }

    // o += (p_hi + p_lo) V; the score fragments of n-tiles 2j, 2j+1 are
    // the A fragment of k-step j
#pragma unroll
    for (int j = 0; j < kBKV / 16; ++j) {
      uint32_t ph[4], pl[4];
      split_bf16(s[2 * j][0], s[2 * j][1], ph[0], pl[0]);
      split_bf16(s[2 * j][2], s[2 * j][3], ph[1], pl[1]);
      split_bf16(s[2 * j + 1][0], s[2 * j + 1][1], ph[2], pl[2]);
      split_bf16(s[2 * j + 1][2], s[2 * j + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        uint32_t b0, b1;
        ldsm_x2_trans(b0, b1, Vs + (j * 16 + (lane & 15)) * LD + n * 8);
        mma_bf16(oacc[n], ph, b0, b1);
        mma_bf16(oacc[n], pl, b0, b1);
      }
    }
    __syncthreads();                 // before the next tile overwrites
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int qp = q0 + wr + g + 8 * hf;
    if (qp >= Sq) continue;
    const float li = fmaxf(l[hf], 1e-30f);
    __nv_bfloat16* orow = o + (static_cast<long long>(b) * Sq + qp) * q_row +
                          static_cast<long long>(h) * DH;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8 + tig * 2) =
          pack_bf16(oacc[n][2 * hf] / li, oacc[n][2 * hf + 1] / li);
    if (tig == 0)
      lse[(static_cast<long long>(b) * H + h) * Sq + qp] = m[hf] + logf(li);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename T, typename Kernel>
int launch(Kernel kernel, size_t smem, int bq, const void* q, const void* k,
           const void* v, void* o, float* lse, int B, int Sq, int Skv, int H,
           int Hkv, int causal, int window, float scale, float neg,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + bq - 1) / bq, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, Sq, Skv, H, Hkv,
      causal, window, scale, neg);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int launch_dh(int dtype, const void* q, const void* k, const void* v,
              void* o, float* lse, int B, int Sq, int Skv, int H, int Hkv,
              int causal, int window, float scale, float neg,
              cudaStream_t stream) {
  if (dtype == 0)
    return launch<float>(flash_fwd_f32_kernel<DH>, Tile<DH>::kSmem,
                         Tile<DH>::BQ, q, k, v, o, lse, B, Sq, Skv, H, Hkv,
                         causal, window, scale, neg, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(flash_fwd_mma_kernel<DH>,
                                 MmaTile<DH>::kSmem, kMmaBQ, q, k, v, o, lse,
                                 B, Sq, Skv, H, Hkv, causal, window, scale,
                                 neg, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q/o: (B, Sq, H, dh) and k/v: (B, Skv, Hkv, dh), contiguous, float32
// (dtype 0) or bfloat16 (dtype 1); lse: (B*Hkv, H/Hkv, Sq) float32.
// window <= 0 means no window.  Launches on `stream`; returns the
// cudaError_t of the launch.
extern "C" int flash_attn_fwd_launch(const void* q, const void* k,
                                     const void* v, void* o, float* lse,
                                     int dtype, int B, int Sq, int Skv,
                                     int H, int Hkv, int dh, int causal,
                                     int window, float scale, float neg,
                                     void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0) return static_cast<int>(cudaSuccess);
  auto s = static_cast<cudaStream_t>(stream);
#define FLASH_DH(D)                                                       \
  case D:                                                                 \
    return launch_dh<D>(dtype, q, k, v, o, lse, B, Sq, Skv, H, Hkv,       \
                        causal, window, scale, neg, s);
  switch (dh) {
    FLASH_DH(16)
    FLASH_DH(32)
    FLASH_DH(64)
    FLASH_DH(112)
    FLASH_DH(128)
    FLASH_DH(256)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FLASH_DH
}
