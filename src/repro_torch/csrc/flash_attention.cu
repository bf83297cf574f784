// Prefill flash attention for NVIDIA Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel `flash_attention_pallas` in
// src/repro/kernels/flash_attention/flash_attention.py (body `_kernel`).
// Computes causal or non-causal GQA attention with a sliding window
// (`q - k < window`, 0 = global) and a logit softcap `cap * tanh(s / cap)`,
// positions implicitly arange, with an online softmax across KV tiles.
//
// Layouts (contiguous, the model's own):
//   q    (B, Sq, K*G, HD)    query head h reads kv head h / G
//   k    (B, Sk, K, HD)      read by stride, no transposed copy
//   v    (B, Sk, K, HD)
//   out  (B, Sq, K*G, HD)    q's dtype
//
// What bounds it on this card: operations.  Causal prefill of S tokens does
// ~2*S*S*HD flops per head against ~4*S*HD bytes per head, so above a few
// hundred tokens it sits far above the ridge point; the card's answer to
// that is the tensor cores (wgmma), which this first kernel does not use
// yet -- it runs the contractions on CUDA cores with fp32 FMA, the
// right-before-fast version.  What the design does about the bound:
//   * one block per (q tile of 32 rows, q head, batch); the TPU grid's
//     sequential KV axis, which carried the softmax state in VMEM scratch,
//     becomes a loop inside the block that carries (m, l, acc) in registers;
//   * each KV tile is staged once in shared memory as fp32 and serves all 32
//     query rows of the block;
//   * KV tiles entirely in the future (causal) or entirely outside the window
//     are never visited, so causal prefill does about half the work;
//   * 8 threads share one query row, each owning dims d = c + 8*i, so the
//     shared-memory reads of a KV row hit 8 distinct banks and broadcast
//     across the 4 rows of a warp; the 8 partial dot products reduce with 3
//     shuffles.
// Softcap is applied before the mask, masked scores are the finite
// -2e38 of the reference, masked probabilities are exactly 0, and the
// output is acc / max(l, 1e-30).  A ragged tail (Sq or Sk not a multiple of
// the tiles) is masked, so prompts of any length prefill; the TPU version
// asserts divisibility instead, and both compute the same function wherever
// both are defined.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -2.0e38f;
constexpr int kBQ = 32;            // query rows per block
constexpr int kBK = 32;            // kv rows per tile
constexpr int kSplit = 8;          // threads per query row
constexpr int kThreads = kBQ * kSplit;

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

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out, int Sq,
                     int Sk, int K, int G, int window, float scale,
                     float logit_cap, int causal) {
  constexpr int kDims = HD / kSplit;  // dims owned by one thread
  __shared__ float k_s[kBK][HD];
  __shared__ float v_s[kBK][HD];

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int H = K * G;
  const int kh = h / G;
  const int tid = threadIdx.x;
  const int r = tid / kSplit;        // query row within the tile
  const int c = tid % kSplit;        // dims c, c + 8, c + 16, ...
  const int qi = q0 + r;
  const bool q_valid = qi < Sq;

  float qv[kDims];
  float acc[kDims];
  const size_t q_off = (((size_t)b * Sq + qi) * H + h) * HD;
#pragma unroll
  for (int i = 0; i < kDims; ++i) {
    qv[i] = q_valid ? to_float(q[q_off + c + kSplit * i]) * scale : 0.f;
    acc[i] = 0.f;
  }
  float m = kNegInf;
  float l = 0.f;

  // KV range this tile of queries can see
  const int q_last = min(q0 + kBQ, Sq) - 1;
  const int k_hi = causal ? min(Sk, q_last + 1) : Sk;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const size_t kv_row = (size_t)K * HD;
  const T* kb = k + (size_t)b * Sk * kv_row + (size_t)kh * HD;
  const T* vb = v + (size_t)b * Sk * kv_row + (size_t)kh * HD;

  for (int j0 = (k_lo / kBK) * kBK; j0 < k_hi; j0 += kBK) {
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < kBK * HD; idx += kThreads) {
      const int j = idx / HD;
      const int d = idx % HD;
      const bool in = j0 + j < Sk;
      k_s[j][d] = in ? to_float(kb[(size_t)(j0 + j) * kv_row + d]) : 0.f;
      v_s[j][d] = in ? to_float(vb[(size_t)(j0 + j) * kv_row + d]) : 0.f;
    }
    __syncthreads();

    float s[kBK];
    float m_tile = kNegInf;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < kDims; ++i) part = fmaf(qv[i], k_s[j][c + kSplit * i], part);
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      part += __shfl_xor_sync(0xffffffffu, part, 4);
      if (logit_cap != 0.f) part = logit_cap * tanhf(part / logit_cap);
      const int kj = j0 + j;
      bool ok = q_valid && kj < Sk;
      if (causal) ok = ok && kj <= qi;
      if (window > 0) ok = ok && qi - kj < window;
      s[j] = ok ? part : kNegInf;
      m_tile = fmaxf(m_tile, s[j]);
    }
    const float m_new = fmaxf(m, m_tile);
    const float corr = expf(m - m_new);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      s[j] = s[j] == kNegInf ? 0.f : expf(s[j] - m_new);
      sum += s[j];
    }
    l = corr * l + sum;
#pragma unroll
    for (int i = 0; i < kDims; ++i) {
      float pv = 0.f;
#pragma unroll
      for (int j = 0; j < kBK; ++j) pv = fmaf(s[j], v_s[j][c + kSplit * i], pv);
      acc[i] = acc[i] * corr + pv;
    }
    m = m_new;
  }

  if (q_valid) {
    const float denom = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < kDims; ++i) {
      out[q_off + c + kSplit * i] = from_float<T>(acc[i] / denom);
    }
  }
}

template <typename T>
void launch(const void* q, const void* k, const void* v, void* out, int B,
            int Sq, int Sk, int K, int G, int hd, int window, float scale,
            float logit_cap, int causal, cudaStream_t stream) {
  const dim3 grid((Sq + kBQ - 1) / kBQ, K * G, B);
  if (hd == 64) {
    flash_prefill_kernel<T, 64><<<grid, kThreads, 0, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (T*)out, Sq, Sk, K, G, window,
        scale, logit_cap, causal);
  } else {
    flash_prefill_kernel<T, 128><<<grid, kThreads, 0, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (T*)out, Sq, Sk, K, G, window,
        scale, logit_cap, causal);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; hd in {64, 128} (the Python wrapper
// checks both).  Returns cudaGetLastError() after the launch.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int B, int Sq,
                                     int Sk, int K, int G, int hd, int window,
                                     float scale, float logit_cap, int causal,
                                     int dtype, void* stream) {
  if (hd != 64 && hd != 128) return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0 || K == 0 || G == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    launch<float>(q, k, v, out, B, Sq, Sk, K, G, hd, window, scale, logit_cap,
                  causal, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(q, k, v, out, B, Sq, Sk, K, G, hd, window, scale,
                          logit_cap, causal, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
