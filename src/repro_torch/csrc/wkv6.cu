// WKV6 recurrence (RWKV6 "Finch" time mix) for NVIDIA Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel `wkv6_pallas` in
// src/repro/kernels/wkv6/wkv6.py (body `_kernel`).  Computes, per (batch,
// head), the exact per-token recurrence over an (HD x HD) fp32 state S
// with the decay on the key axis i:
//
//   y_t[j] = sum_i r_t[i] * (S[i][j] + u[i] * k_t[i] * v_t[j])
//   S[i][j] <- w_t[i] * S[i][j] + k_t[i] * v_t[j]
//
// Layouts (contiguous, the model's own; read by stride, no transposed copy):
//   r, k, v  (B, T, H, HD)   float32 or bfloat16, one dtype
//   w        (B, T, H, HD)   float32 decay in (0, 1)
//   u        (H, HD)         float32 bonus
//   s0       (B, H, HD, HD)  float32 initial state, S[i][j] at [..., i, j]
//   y        (B, T, H, HD)   r's dtype
//   s_out    (B, H, HD, HD)  float32 final state
//
// What bounds it on this card.  At B=1, T=2048, H=40, HD=64 the bytes it
// must move are ~64 MB (r/k/v/y in bf16, w in fp32, the states): 19 us at
// 3.35 TB/s; its ~1.3 GFLOP of fp32 FMA take 20 us at 67 TFLOP/s.  Neither
// is what limits it: the recurrence is a serial chain of T dependent steps
// per state element, so the time is T x (the latency of one step), and
// only the (batch, head, column) parallelism is free.  What the design does
// about that:
//   * the TPU kernel carried S in VMEM scratch across a sequential chunk
//     grid axis; here a loop over T inside the block carries S in
//     registers, and nothing crosses blocks;
//   * the columns j of S evolve independently (column j reads only v[j]),
//     so one block takes 16 columns of one (b, h): HD / 16 blocks per head,
//     160 blocks at B=1, H=40, HD=64, to fill the 132 SMs;
//   * inside a block, 8 lanes share a column, each holding HD / 8 rows of
//     it in registers (8 at HD=64), so one step is 8 dependent FMAs and a
//     3-shuffle reduction of y, not HD;
//   * r, k, w and u*k of a tile of 2048 / HD tokens are staged once per
//     block in shared memory as one float4 per (token, row), by coalesced
//     loads; the 8 lanes of a column read 8 consecutive float4 (128 bytes,
//     no bank conflict) that broadcast across the warp's 4 columns;
//   * the next tile's loads are issued into registers before the current
//     tile's tokens run, so their latency hides behind that compute (the
//     first design loaded each tile after the last one's compute, one
//     load round after another, and spent most of its time waiting);
//   * the state update never waits for the y reduction, so consecutive
//     tokens overlap.
// Exact recurrence in fp32, no exponent factorisation (the TPU kernel's own
// choice, for the same reason: cumulative decay products underflow fp32).
// Any T: a ragged last tile is simply shorter.  The TPU kernel and the
// reference's XLA scan assert that their chunk divides T; the chunking
// never changes the per-token function, which this kernel computes for
// every T.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kCols = 16;                  // state columns per block
constexpr int kGroups = 8;                 // lanes sharing one column
constexpr int kThreads = kCols * kGroups;  // 128
constexpr int kTileElems = 2048;           // tokens per tile = this / HD

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

// One tile's worth of this thread's loads, held in registers in their own
// dtype until they are stored to shared memory (converting at load time
// would make every load wait where it is issued).  Thread tid reads row
// i = tid % HD of tokens tid / HD + q * (kThreads / HD), and v of column
// c = tid % kCols of tokens tid / kCols + q * (kThreads / kCols).
template <typename T, int HD>
struct Staged {
  static constexpr int kLoads = kTileElems / kThreads;        // 16
  static constexpr int kVLoads = kTileElems / HD * kCols / kThreads;
  T r[kLoads], k[kLoads], v[kVLoads];
  float w[kLoads];
};

template <typename T, int HD>
__device__ __forceinline__ void fetch(Staged<T, HD>& st,
                                      const T* __restrict__ r,
                                      const T* __restrict__ k,
                                      const T* __restrict__ v,
                                      const float* __restrict__ w,
                                      size_t base, size_t row, int cb, int t0,
                                      int n, int tid) {
#pragma unroll
  for (int q = 0; q < Staged<T, HD>::kLoads; ++q) {
    const int t = (tid + q * kThreads) / HD;
    if (t < n) {
      const size_t off = base + (size_t)(t0 + t) * row + tid % HD;
      st.r[q] = r[off];
      st.k[q] = k[off];
      st.w[q] = w[off];
    }
  }
#pragma unroll
  for (int q = 0; q < Staged<T, HD>::kVLoads; ++q) {
    const int t = (tid + q * kThreads) / kCols;
    if (t < n) {
      st.v[q] = v[base + (size_t)(t0 + t) * row + cb * kCols + tid % kCols];
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ s0,
            T* __restrict__ y, float* __restrict__ s_out, int T_len, int H) {
  constexpr int kRows = HD / kGroups;       // state rows held by one lane
  constexpr int kTile = kTileElems / HD;    // tokens per staged tile
  __shared__ float4 rkwu_s[kTile][HD];      // (r_i, k_i, w_i, u_i * k_i)
  __shared__ float v_s[kTile][kCols];

  const int cb = blockIdx.x;                // column block
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int g = tid % kGroups;              // rows g, g + 8, g + 16, ...
  const int jl = tid / kGroups;             // column within the block
  const int j = cb * kCols + jl;

  const size_t row = (size_t)H * HD;        // stride between tokens
  const size_t base = (size_t)b * T_len * row + (size_t)h * HD;
  const size_t s_base = ((size_t)b * H + h) * HD * HD;
  const float* u_h = u + (size_t)h * HD;

  const float u_i = u_h[tid % HD];          // this thread's staged row

  float S[kRows];
#pragma unroll
  for (int ii = 0; ii < kRows; ++ii) {
    S[ii] = s0[s_base + (size_t)(ii * kGroups + g) * HD + j];
  }

  Staged<T, HD> st;
  fetch<T, HD>(st, r, k, v, w, base, row, cb, 0, min(kTile, T_len), tid);
  for (int t0 = 0; t0 < T_len; t0 += kTile) {
    const int n = min(kTile, T_len - t0);
    __syncthreads();  // the previous tile's readers are done
#pragma unroll
    for (int q = 0; q < Staged<T, HD>::kLoads; ++q) {
      const int t = (tid + q * kThreads) / HD;
      if (t < n) {
        const float kk = to_float(st.k[q]);
        rkwu_s[t][tid % HD] =
            make_float4(to_float(st.r[q]), kk, st.w[q], u_i * kk);
      }
    }
#pragma unroll
    for (int q = 0; q < Staged<T, HD>::kVLoads; ++q) {
      const int t = (tid + q * kThreads) / kCols;
      if (t < n) v_s[t][tid % kCols] = to_float(st.v[q]);
    }
    __syncthreads();
    if (t0 + kTile < T_len) {  // in flight while this tile computes
      fetch<T, HD>(st, r, k, v, w, base, row, cb, t0 + kTile,
                   min(kTile, T_len - t0 - kTile), tid);
    }

#pragma unroll 2
    for (int t = 0; t < n; ++t) {
      const float vj = v_s[t][jl];
      float acc = 0.f;
#pragma unroll
      for (int ii = 0; ii < kRows; ++ii) {
        const float4 q = rkwu_s[t][ii * kGroups + g];
        acc = fmaf(q.x, fmaf(q.w, vj, S[ii]), acc);  // r_i (S_ij + u_i k_i v_j)
        S[ii] = fmaf(S[ii], q.z, q.y * vj);          // w_i S_ij + k_i v_j
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      acc += __shfl_xor_sync(0xffffffffu, acc, 4);
      if (g == 0) y[base + (size_t)(t0 + t) * row + j] = from_float<T>(acc);
    }
  }

#pragma unroll
  for (int ii = 0; ii < kRows; ++ii) {
    s_out[s_base + (size_t)(ii * kGroups + g) * HD + j] = S[ii];
  }
}

template <typename T, int HD>
void launch_hd(const void* r, const void* k, const void* v, const void* w,
               const void* u, const void* s0, void* y, void* s_out, int B,
               int T_len, int H, cudaStream_t stream) {
  const dim3 grid(HD / kCols, H, B);
  wkv6_kernel<T, HD><<<grid, kThreads, 0, stream>>>(
      (const T*)r, (const T*)k, (const T*)v, (const float*)w,
      (const float*)u, (const float*)s0, (T*)y, (float*)s_out, T_len, H);
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* s0, void* y, void* s_out, int B,
           int T_len, int H, int hd, cudaStream_t s) {
  switch (hd) {
    case 16: launch_hd<T, 16>(r, k, v, w, u, s0, y, s_out, B, T_len, H, s); break;
    case 32: launch_hd<T, 32>(r, k, v, w, u, s0, y, s_out, B, T_len, H, s); break;
    case 64: launch_hd<T, 64>(r, k, v, w, u, s0, y, s_out, B, T_len, H, s); break;
    case 128: launch_hd<T, 128>(r, k, v, w, u, s0, y, s_out, B, T_len, H, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return 0;
}

}  // namespace

// dtype of r/k/v/y: 0 = float32, 1 = bfloat16; hd in {16, 32, 64, 128}
// (the Python wrapper checks both).  Returns cudaGetLastError() after the
// launch.
extern "C" int repro_wkv6(const void* r, const void* k, const void* v,
                          const void* w, const void* u, const void* s0,
                          void* y, void* s_out, int B, int T, int H, int hd,
                          int dtype, void* stream) {
  if (B == 0 || H == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  int rc;
  if (dtype == 0) {
    rc = launch<float>(r, k, v, w, u, s0, y, s_out, B, T, H, hd, s);
  } else if (dtype == 1) {
    rc = launch<__nv_bfloat16>(r, k, v, w, u, s0, y, s_out, B, T, H, hd, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
