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
//   out      (B, K*G, HD)          q's dtype
//
// What bounds it on this card: bytes.  Every live K/V row is read once and
// serves G query heads, so a step does ~4*G flops per byte read -- far below
// the ~295 flops/byte where an H100 turns compute-bound in bf16.  So the
// design reads each K/V row exactly once and keeps as many of those reads in
// flight as one block can:
//   * one block per (kv head, sequence) holds all G query rows of that kv
//     head, so one row load serves every query head that reads it;
//   * the block's NW warps split the sequence's pages among themselves
//     (warp w takes logical pages w, w + NW, ...) and run with no block-wide
//     barrier: each warp keeps its own online-softmax state (m, l) and fp32
//     accumulator in registers, loads kR rows of K and V at a time as one
//     vector load per lane (lane i owns HD/32 adjacent dims), and only then
//     reduces the kR * G dot products with warp shuffles;
//   * at the end the NW partial states meet in shared memory and are
//     combined in warp order.
//
// Contract carried over from the TPU kernel:
//   * a page is skipped when its table entry is < 0 or it starts at or past
//     lens[b]; rows >= lens[b] inside the last page are masked (p = 0);
//   * the output is acc / max(l, 1e-30), so a dead row (all -1, or
//     lens == 0) comes out exactly 0;
//   * which warp takes which page, and the order of every sum, follow from
//     the page index and lens[b] alone; padding pages are never visited.  So
//     a live row's output is bitwise identical at any table width (the
//     serving engine pads widths to powers of two).
//
// Known limit: B*K blocks (32 at batch 4 with K = 8) under-fill the 132
// SMs, so one decode step cannot reach the card's memory rate.  A later
// split-KV design must take its split count from `lens`, never from the
// table width, or the width invariance above breaks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kNegInf = -2.0e38f;  // finite, as in the reference
constexpr int kMaxG = 16;            // query heads per kv head
constexpr int kWarps = 8;            // warps per block

// kVec adjacent elements of one row, widened to fp32, in one vector load.
template <typename T, int kVec>
struct Row;
template <>
struct Row<float, 2> {
  static __device__ __forceinline__ void load(const float* p, float* out) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    out[0] = v.x; out[1] = v.y;
  }
};
template <>
struct Row<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
};
template <>
struct Row<__nv_bfloat16, 2> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* out) {
    const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(p);
    const float2 f = __bfloat1622float2(v);
    out[0] = f.x; out[1] = f.y;
  }
};
template <>
struct Row<__nv_bfloat16, 4> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* out) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
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

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// One block per (kv head, sequence), kWarps warps.  GMAX >= G is the
// compile-time bound of the query heads held in registers; heads g >= G
// are skipped by a branch uniform across the block.
template <typename T, int HD, int GMAX>
__global__ void __launch_bounds__(kWarps * 32)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages,
                    const int* __restrict__ table,
                    const int* __restrict__ lens, T* __restrict__ out, int K,
                    int G, int page_size, int W, float scale) {
  constexpr int kVec = HD / 32;             // adjacent dims owned by a lane
  constexpr int kR = GMAX >= 16 ? 4 : 8;    // rows loaded per warp step
  constexpr int kGC = GMAX < 8 ? GMAX : 8;  // heads combined per round
  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int d0 = lane * kVec;

  __shared__ float m_s[kWarps][GMAX];
  __shared__ float l_s[kWarps][GMAX];
  __shared__ float acc_s[kWarps][kGC][HD];

  const size_t head_off = ((size_t)b * K * G + (size_t)kh * G) * HD;
  float qr[GMAX][kVec];
  float acc[GMAX][kVec];
  float m[GMAX];
  float l[GMAX];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      qr[g][i] = g < G ? to_float(q[head_off + (size_t)g * HD + d0 + i]) * scale
                       : 0.f;
      acc[g][i] = 0.f;
    }
    m[g] = kNegInf;
    l[g] = 0.f;
  }

  const int len = lens[b];
  const int n_pages = len > 0 ? min(W, (len + page_size - 1) / page_size) : 0;
  const size_t row_stride = (size_t)K * HD;  // between token rows of a page
  for (int p = warp; p < n_pages; p += kWarps) {
    const int page = table[(size_t)b * W + p];
    if (page < 0) continue;                  // uniform across the warp
    const int live = min(page_size, len - p * page_size);
    const T* kp = k_pages + (size_t)page * page_size * row_stride +
                  (size_t)kh * HD + d0;
    const T* vp = v_pages + (size_t)page * page_size * row_stride +
                  (size_t)kh * HD + d0;
    for (int t0 = 0; t0 < live; t0 += kR) {
      float kf[kR][kVec];
      float vf[kR][kVec];
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        if (t0 + r < live) {
          Row<T, kVec>::load(kp + (size_t)(t0 + r) * row_stride, kf[r]);
          Row<T, kVec>::load(vp + (size_t)(t0 + r) * row_stride, vf[r]);
        } else {
#pragma unroll
          for (int i = 0; i < kVec; ++i) kf[r][i] = vf[r][i] = 0.f;
        }
      }
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        if (g >= G) break;
        float s[kR];
        float m_tile = kNegInf;
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          float part = 0.f;
#pragma unroll
          for (int i = 0; i < kVec; ++i) part = fmaf(qr[g][i], kf[r][i], part);
          s[r] = t0 + r < live ? warp_sum(part) : kNegInf;
          m_tile = fmaxf(m_tile, s[r]);
        }
        const float m_new = fmaxf(m[g], m_tile);
        const float corr = expf(m[g] - m_new);
        float sum = 0.f;
        float pv[kVec];
#pragma unroll
        for (int i = 0; i < kVec; ++i) pv[i] = 0.f;
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          const float pe = t0 + r < live ? expf(s[r] - m_new) : 0.f;
          sum += pe;
#pragma unroll
          for (int i = 0; i < kVec; ++i) pv[i] = fmaf(pe, vf[r][i], pv[i]);
        }
        l[g] = corr * l[g] + sum;
        m[g] = m_new;
#pragma unroll
        for (int i = 0; i < kVec; ++i) acc[g][i] = fmaf(acc[g][i], corr, pv[i]);
      }
    }
  }

  // the warps' partial states meet in shared memory, kGC heads at a time
  // (all GMAX accumulators of every warp would not fit in 48 KB)
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      m_s[warp][g] = m[g];
      l_s[warp][g] = l[g];
    }
  }
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
        const float e = expf(m_s[w][g] - m_all);
        l_all = fmaf(l_s[w][g], e, l_all);
        a_all = fmaf(acc_s[w][gg][d], e, a_all);
      }
      out[head_off + (size_t)g * HD + d] =
          from_float<T>(a_all / fmaxf(l_all, 1e-30f));
    }
    __syncthreads();                         // acc_s is rewritten next round
  }
}

template <typename T, int HD, int GMAX>
void launch_g(const void* q, const void* kp, const void* vp, const int* table,
              const int* lens, void* out, int B, int K, int G, int page_size,
              int W, float scale, cudaStream_t stream) {
  const dim3 grid(K, B);
  paged_decode_kernel<T, HD, GMAX><<<grid, kWarps * 32, 0, stream>>>(
      (const T*)q, (const T*)kp, (const T*)vp, table, lens, (T*)out, K, G,
      page_size, W, scale);
}

template <typename T, int HD>
void launch_hd(const void* q, const void* kp, const void* vp, const int* table,
               const int* lens, void* out, int B, int K, int G, int page_size,
               int W, float scale, cudaStream_t stream) {
  if (G <= 1) {
    launch_g<T, HD, 1>(q, kp, vp, table, lens, out, B, K, G, page_size, W, scale, stream);
  } else if (G <= 2) {
    launch_g<T, HD, 2>(q, kp, vp, table, lens, out, B, K, G, page_size, W, scale, stream);
  } else if (G <= 4) {
    launch_g<T, HD, 4>(q, kp, vp, table, lens, out, B, K, G, page_size, W, scale, stream);
  } else if (G <= 8) {
    launch_g<T, HD, 8>(q, kp, vp, table, lens, out, B, K, G, page_size, W, scale, stream);
  } else {
    launch_g<T, HD, kMaxG>(q, kp, vp, table, lens, out, B, K, G, page_size, W, scale, stream);
  }
}

template <typename T>
void launch(const void* q, const void* kp, const void* vp, const int* table,
            const int* lens, void* out, int B, int K, int G, int hd,
            int page_size, int W, float scale, cudaStream_t stream) {
  if (hd == 64) {
    launch_hd<T, 64>(q, kp, vp, table, lens, out, B, K, G, page_size, W, scale, stream);
  } else {
    launch_hd<T, 128>(q, kp, vp, table, lens, out, B, K, G, page_size, W, scale, stream);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  hd in {64, 128}, 1 <= G <= 16, every
// pointer 16-byte aligned; the Python wrapper checks all three.  Returns
// cudaGetLastError() after the launch.
extern "C" int repro_paged_attention(const void* q, const void* k_pages,
                                     const void* v_pages, const void* table,
                                     const void* lens, void* out, int B, int K,
                                     int G, int hd, int page_size, int W,
                                     float scale, int dtype, void* stream) {
  if (hd != 64 && hd != 128) return (int)cudaErrorInvalidValue;
  if (G < 1 || G > kMaxG) return (int)cudaErrorInvalidValue;
  if (B == 0 || K == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    launch<float>(q, k_pages, v_pages, (const int*)table, (const int*)lens,
                  out, B, K, G, hd, page_size, W, scale, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(q, k_pages, v_pages, (const int*)table,
                          (const int*)lens, out, B, K, G, hd, page_size, W,
                          scale, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
