// Paged decode attention for NVIDIA Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel `paged_attention_pallas` in
// src/repro/kernels/paged_attention/paged_attention.py (body `_kernel`).
// One query token per sequence attends over a KV cache held in
// non-contiguous pages of the arena's page pool, found through a page
// table padded with -1.
//
// Layouts (all contiguous, as the model's public functions keep them):
//   q        (B, K*G, HD)          query heads are KV-major: head h serves
//                                   kv head h / G
//   k_pages  (P, page, K, HD)      one layer's page pool
//   v_pages  (P, page, K, HD)
//   table    (B, W) int32          physical page of each logical page, -1 pad
//   lens     (B,)   int32          live rows of each sequence
//   part     (B, K, NS, G, HD + 2) fp32 scratch: each split's (acc, m, l)
//   out      (B, K*G, HD)          q's dtype
//
// What bounds it on this card: bytes.  Every live K/V row is read once and
// serves G query heads, so a step does ~4*G flops per byte read -- far below
// the ~295 flops/byte where an H100 turns compute-bound in bf16.  So the
// design reads each K/V row exactly once and spreads those reads over the
// whole card (split-KV):
//   * a split is a fixed run of kSplitRows rows of logical pages (P_S =
//     max(1, kSplitRows / page) pages): split s covers pages [s * P_S,
//     (s + 1) * P_S).  One block per (kv head, sequence, split) holds all G
//     query rows of that kv head, so one row load serves every query head
//     that reads it.  The grid's split axis is ceil(W / P_S) long; a block
//     whose first page starts at or past lens[b] exits at once, so padding
//     pages are never visited, and a batch of short sequences beside one
//     long one still fills the SMs;
//   * inside a split the block's NW warps take the pages in turn (warp w
//     takes pages s * P_S + w, + NW, ...; the split's page ids are staged
//     in shared memory first, so no step waits on a table load) with no
//     block-wide barrier: each
//     warp keeps its own online-softmax state (m, l) and fp32 accumulator
//     in registers, loads kR rows of K and V at a time as one vector load per
//     lane (lane i owns HD/32 adjacent dims), and issues the next kR rows'
//     loads before it computes on these;
//   * the kernel is bound by instructions before bytes (one step of a warp
//     is kR * G dot products of HD), so the kR partial dot products of a
//     head reduce together (`rows_sum`: kR + ~2 shuffles, not 5 per row),
//     which leaves each lane one row's score: the softmax of the kR rows
//     is then one exp2 per lane, scores being kept in the log2 domain
//     (q * scale * log2 e), and p reaches P V by one shuffle per row;
//   * the NW partial states meet in shared memory and combine in warp order
//     into the split's (acc, m, l), written to `part`;
//   * a second kernel combines splits 0 .. n_b - 1 in split order, n_b =
//     ceil(ceil(lens[b] / page) / P_S), and writes acc / max(l, 1e-30).
//
// Contract carried over from the TPU kernel:
//   * a page is skipped when its table entry is < 0 or it starts at or past
//     lens[b]; rows >= lens[b] inside the last page are masked (p = 0);
//   * the output is acc / max(l, 1e-30), so a dead row (all -1, or
//     lens == 0) comes out exactly 0;
//   * which split and warp take which page, and the order of every sum,
//     follow from the page index and lens[b] alone, never from W.  So a live
//     row's output is bitwise identical at any table width (the serving
//     engine pads widths to powers of two).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kNegInf = -2.0e38f;  // finite, as in the reference
constexpr int kMaxG = 16;            // query heads per kv head
constexpr int kWarps = 8;            // warps per block
constexpr int kSplitRows = 256;      // rows of one split (a constant, not W)
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ __forceinline__ int split_pages(int page_size) {
  return page_size >= kSplitRows ? 1 : kSplitRows / page_size;
}

// kVec adjacent elements of one row: loaded raw in one vector load, widened
// to fp32 where they are used, so a load in flight holds few registers.
template <typename T, int kVec>
struct Row;
template <>
struct Row<float, 2> {
  float2 raw;
  __device__ __forceinline__ void load(const float* p) {
    raw = *reinterpret_cast<const float2*>(p);
  }
  __device__ __forceinline__ void widen(float* out) const {
    out[0] = raw.x; out[1] = raw.y;
  }
};
template <>
struct Row<float, 4> {
  float4 raw;
  __device__ __forceinline__ void load(const float* p) {
    raw = *reinterpret_cast<const float4*>(p);
  }
  __device__ __forceinline__ void widen(float* out) const {
    out[0] = raw.x; out[1] = raw.y; out[2] = raw.z; out[3] = raw.w;
  }
};
template <>
struct Row<__nv_bfloat16, 2> {
  uint32_t raw;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    raw = *reinterpret_cast<const uint32_t*>(p);
  }
  __device__ __forceinline__ void widen(float* out) const {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&raw));
    out[0] = f.x; out[1] = f.y;
  }
};
template <>
struct Row<__nv_bfloat16, 4> {
  uint2 raw;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    raw = *reinterpret_cast<const uint2*>(p);
  }
  __device__ __forceinline__ void widen(float* out) const {
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
  }
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Sums each of the kR rows' partial dot products over the warp's 32 lanes
// and leaves row lane / (32 / kR)'s sum in each lane: log2(kR) halving
// steps (each lane sends the half of its rows its partner keeps), then
// plain butterfly steps over the lanes that share a row.  kR + ~2 shuffles
// instead of 5 per row; the order of the sums depends on the lane only.
template <int kR>
__device__ __forceinline__ float rows_sum(float (&d)[kR], int lane) {
#pragma unroll
  for (int n = kR, off = 16; n > 1; n >>= 1, off >>= 1) {
    const bool upper = lane & off;
#pragma unroll
    for (int j = 0; j < n / 2; ++j) {
      const float send = upper ? d[j] : d[j + n / 2];
      const float keep = upper ? d[j + n / 2] : d[j];
      d[j] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
  }
  float x = d[0];
#pragma unroll
  for (int off = 16 / kR; off > 0; off >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, off);
  }
  return x;
}

// The pages of live rows a sequence has in a table of width W.
__device__ __forceinline__ int live_pages(int len, int page_size, int W) {
  return len > 0 ? min(W, (len + page_size - 1) / page_size) : 0;
}

// One block per (kv head, sequence, split), kWarps warps; in bf16 with up
// to 5 query heads a kv head, two blocks an SM (at most 128 registers a
// thread, which is why a step holds only 4 rows).  GMAX >= G is the
// compile-time count of the query heads held in registers: exact up to 8;
// above, heads g >= G are skipped by a branch uniform across the block.
template <typename T, int HD, int GMAX>
__global__ void __launch_bounds__(kWarps * 32,
                                  (GMAX <= 5 && sizeof(T) == 2) ? 2 : 1)
paged_split_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                   const T* __restrict__ v_pages,
                   const int* __restrict__ table,
                   const int* __restrict__ lens, float* __restrict__ part,
                   int K, int G, int page_size, int W, int NS, float scale) {
  constexpr int kVec = HD / 32;             // adjacent dims owned by a lane
  constexpr int kR = GMAX <= 2 ? 8 : 4;     // rows loaded per warp step
  constexpr int kGC = GMAX < 8 ? GMAX : 8;  // heads combined per round
  constexpr int kLanesPerRow = 32 / kR;     // lanes holding one row's score
  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int len = lens[b];
  const int n_pages = live_pages(len, page_size, W);
  const int p_lo = split * split_pages(page_size);
  if (p_lo >= n_pages) return;              // no live page: never visited
  const int p_hi = min(p_lo + split_pages(page_size), n_pages);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int d0 = lane * kVec;
  const int my_row = lane / kLanesPerRow;

  __shared__ float m_s[kWarps][GMAX];
  __shared__ float l_s[kWarps][GMAX];
  __shared__ float acc_s[kWarps][kGC][HD];
  __shared__ int page_s[kSplitRows];        // the split's physical pages
  for (int i = threadIdx.x; i < p_hi - p_lo; i += kWarps * 32) {
    page_s[i] = table[(size_t)b * W + p_lo + i];
  }
  __syncthreads();

  const size_t head_off = ((size_t)b * K * G + (size_t)kh * G) * HD;
  // scores in the log2 domain, so each probability is one exp2
  const float scale_log2 = scale * kLog2e;
  float qr[GMAX][kVec];
  float acc[GMAX][kVec];
  float m[GMAX];
  float l[GMAX];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      qr[g][i] = g < G ? to_float(q[head_off + (size_t)g * HD + d0 + i]) *
                             scale_log2
                       : 0.f;
      acc[g][i] = 0.f;
    }
    m[g] = kNegInf;
    l[g] = 0.f;
  }

  // The warp's steps of kR rows: pages p_lo + warp, + kWarps, ... below
  // p_hi whose table entry is >= 0, rows t0 = 0, kR, ... below the page's
  // live rows.  `advance` moves to the next step and says if there is one.
  const size_t row_stride = (size_t)K * HD;  // between token rows of a page
  int p = p_lo + warp - kWarps;
  int t0 = 0;
  int live = 0;
  const T* kp = nullptr;
  const T* vp = nullptr;
  auto advance = [&]() -> bool {
    t0 += kR;
    while (t0 >= live) {
      p += kWarps;
      if (p >= p_hi) return false;
      const int page = page_s[p - p_lo];
      if (page < 0) continue;                // uniform across the warp
      live = min(page_size, len - p * page_size);
      t0 = 0;
      kp = k_pages + (size_t)page * page_size * row_stride + (size_t)kh * HD + d0;
      vp = v_pages + (size_t)page * page_size * row_stride + (size_t)kh * HD + d0;
    }
    return true;
  };
  Row<T, kVec> kraw[kR];
  Row<T, kVec> vraw[kR];
  auto issue = [&]() {
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      if (t0 + r < live) {
        kraw[r].load(kp + (size_t)(t0 + r) * row_stride);
        vraw[r].load(vp + (size_t)(t0 + r) * row_stride);
      }
    }
  };

  bool more = advance();
  if (more) issue();
  while (more) {
    const int rows = live - t0;              // rows r < rows are live
    float kf[kR][kVec];
    float vf[kR][kVec];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      if (r < rows) {
        kraw[r].widen(kf[r]);
        vraw[r].widen(vf[r]);
      } else {
#pragma unroll
        for (int i = 0; i < kVec; ++i) kf[r][i] = vf[r][i] = 0.f;
      }
    }
    more = advance();
    if (more) issue();                       // in flight while these compute
    const bool row_live = my_row < rows;
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      // G == GMAX below kMaxG, so the heads are straight-line code whose
      // dependency chains (shuffles, exp2) interleave
      if (GMAX == kMaxG && g >= G) break;
      float dot[kR];
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        dot[r] = 0.f;
#pragma unroll
        for (int i = 0; i < kVec; ++i) dot[r] = fmaf(qr[g][i], kf[r][i], dot[r]);
      }
      // this lane's row's score (every lane shuffles), the rows' max and
      // this lane's probability
      const float sum = rows_sum<kR>(dot, lane);
      const float sc = row_live ? sum : kNegInf;
      float m_tile = sc;
#pragma unroll
      for (int off = kLanesPerRow; off < 32; off <<= 1) {
        m_tile = fmaxf(m_tile, __shfl_xor_sync(0xffffffffu, m_tile, off));
      }
      const float m_new = fmaxf(m[g], m_tile);
      const float corr = exp2f(m[g] - m_new);
      const float pe = row_live ? exp2f(sc - m_new) : 0.f;
      l[g] = fmaf(l[g], corr, pe);             // this lane's rows only
      m[g] = m_new;
      if (corr != 1.f) {                       // uniform: m is the warp's
#pragma unroll
        for (int i = 0; i < kVec; ++i) acc[g][i] *= corr;
      }
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const float pr = __shfl_sync(0xffffffffu, pe, r * kLanesPerRow);
#pragma unroll
        for (int i = 0; i < kVec; ++i) acc[g][i] = fmaf(pr, vf[r][i], acc[g][i]);
      }
    }
  }
  // l over every row: one lane of each row adds in
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
#pragma unroll
    for (int off = kLanesPerRow; off < 32; off <<= 1) {
      l[g] += __shfl_xor_sync(0xffffffffu, l[g], off);
    }
  }

  // the warps' partial states meet in shared memory, kGC heads at a time
  // (all GMAX accumulators of every warp would not fit in 48 KB), and the
  // split's (acc, m, l) goes to `part`
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      m_s[warp][g] = m[g];
      l_s[warp][g] = l[g];
    }
  }
  float* const part_b = part + (((size_t)b * K + kh) * NS + split) * G * (HD + 2);
#pragma unroll
  for (int c = 0; c < GMAX / kGC; ++c) {
    if (c * kGC >= G) break;                 // uniform across the block
#pragma unroll
    for (int gg = 0; gg < kGC; ++gg) {
#pragma unroll
      for (int i = 0; i < kVec; ++i) acc_s[warp][gg][d0 + i] = acc[c * kGC + gg][i];
    }
    __syncthreads();
    // combine in warp order; thread idx owns one (head, dim) pair
    const int heads = min(kGC, G - c * kGC);
    for (int idx = threadIdx.x; idx < heads * HD; idx += kWarps * 32) {
      const int gg = idx / HD;
      const int g = c * kGC + gg;
      const int d = idx % HD;
      float m_all = kNegInf;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) m_all = fmaxf(m_all, m_s[w][g]);
      float l_all = 0.f;
      float a_all = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float e = exp2f(m_s[w][g] - m_all);
        l_all = fmaf(l_s[w][g], e, l_all);
        a_all = fmaf(acc_s[w][gg][d], e, a_all);
      }
      float* const row = part_b + (size_t)g * (HD + 2);
      row[d] = a_all;
      if (d == 0) {
        row[HD] = m_all;
        row[HD + 1] = l_all;
      }
    }
    __syncthreads();                         // acc_s is rewritten next round
  }
}

// One block per (kv head, sequence): combines the sequence's live splits in
// split order and writes acc / max(l, 1e-30); a dead row has no live split
// and comes out 0.
template <typename T>
__global__ void __launch_bounds__(256)
paged_combine_kernel(const float* __restrict__ part,
                     const int* __restrict__ lens, T* __restrict__ out, int K,
                     int G, int hd, int page_size, int W, int NS) {
  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int n_pages = live_pages(lens[b], page_size, W);
  const int P_S = split_pages(page_size);
  const int n_splits = (n_pages + P_S - 1) / P_S;
  const float* const part_b = part + ((size_t)b * K + kh) * NS * G * (hd + 2);
  const size_t split_stride = (size_t)G * (hd + 2);
  for (int idx = threadIdx.x; idx < G * hd; idx += blockDim.x) {
    const int g = idx / hd;
    const int d = idx % hd;
    const float* const row = part_b + (size_t)g * (hd + 2);
    float m_all = kNegInf;
    for (int s = 0; s < n_splits; ++s) {
      m_all = fmaxf(m_all, row[s * split_stride + hd]);
    }
    float l_all = 0.f;
    float a_all = 0.f;
    for (int s = 0; s < n_splits; ++s) {
      const float* const r = row + s * split_stride;
      const float e = exp2f(r[hd] - m_all);
      l_all = fmaf(r[hd + 1], e, l_all);
      a_all = fmaf(r[d], e, a_all);
    }
    out[((size_t)b * K * G + (size_t)kh * G + g) * hd + d] =
        from_float<T>(a_all / fmaxf(l_all, 1e-30f));
  }
}

template <typename T, int HD, int GMAX>
void launch_g(const void* q, const void* kp, const void* vp, const int* table,
              const int* lens, float* part, int B, int K, int G,
              int page_size, int W, int NS, float scale, cudaStream_t stream) {
  const dim3 grid(K, B, NS);
  paged_split_kernel<T, HD, GMAX><<<grid, kWarps * 32, 0, stream>>>(
      (const T*)q, (const T*)kp, (const T*)vp, table, lens, part, K, G,
      page_size, W, NS, scale);
}

template <typename T, int HD>
void launch_hd(const void* q, const void* kp, const void* vp, const int* table,
               const int* lens, float* part, int B, int K, int G,
               int page_size, int W, int NS, float scale,
               cudaStream_t stream) {
#define REPRO_PAGED_G(GM)                                                   \
  launch_g<T, HD, GM>(q, kp, vp, table, lens, part, B, K, G, page_size, W, \
                      NS, scale, stream)
  switch (G) {  // the heads of a kv head held in registers, exactly to 8
    case 1: REPRO_PAGED_G(1); break;
    case 2: REPRO_PAGED_G(2); break;
    case 3: REPRO_PAGED_G(3); break;
    case 4: REPRO_PAGED_G(4); break;
    case 5: REPRO_PAGED_G(5); break;
    case 6: REPRO_PAGED_G(6); break;
    case 7: REPRO_PAGED_G(7); break;
    case 8: REPRO_PAGED_G(8); break;
    default: REPRO_PAGED_G(kMaxG); break;
  }
#undef REPRO_PAGED_G
}

template <typename T>
void launch(const void* q, const void* kp, const void* vp, const int* table,
            const int* lens, float* part, void* out, int B, int K, int G,
            int hd, int page_size, int W, int NS, float scale,
            cudaStream_t stream) {
  if (NS > 0) {
    if (hd == 64) {
      launch_hd<T, 64>(q, kp, vp, table, lens, part, B, K, G, page_size, W, NS, scale, stream);
    } else {
      launch_hd<T, 128>(q, kp, vp, table, lens, part, B, K, G, page_size, W, NS, scale, stream);
    }
  }
  paged_combine_kernel<T><<<dim3(K, B), 256, 0, stream>>>(
      part, lens, (T*)out, K, G, hd, page_size, W, NS);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  hd in {64, 128}, 1 <= G <= 16, every
// pointer 16-byte aligned, `part` of (B, K, n_splits, G, hd + 2) fp32 with
// n_splits = ceil(W / split pages); the Python wrapper checks all of them.
// Returns cudaGetLastError() after the launches.
extern "C" int repro_paged_attention(const void* q, const void* k_pages,
                                     const void* v_pages, const void* table,
                                     const void* lens, void* out, void* part,
                                     int B, int K, int G, int hd,
                                     int page_size, int W, int n_splits,
                                     float scale, int dtype, void* stream) {
  if (hd != 64 && hd != 128) return (int)cudaErrorInvalidValue;
  if (G < 1 || G > kMaxG || page_size < 1) return (int)cudaErrorInvalidValue;
  if (n_splits != (W + split_pages(page_size) - 1) / split_pages(page_size)) {
    return (int)cudaErrorInvalidValue;
  }
  if (B == 0 || K == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    launch<float>(q, k_pages, v_pages, (const int*)table, (const int*)lens,
                  (float*)part, out, B, K, G, hd, page_size, W, n_splits,
                  scale, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(q, k_pages, v_pages, (const int*)table,
                          (const int*)lens, (float*)part, out, B, K, G, hd,
                          page_size, W, n_splits, scale, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
