// WKV6 recurrence (RWKV6 "Finch" time mix) for NVIDIA Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel `wkv6_pallas` in
// src/repro/kernels/wkv6/wkv6.py (body `_kernel`).  Computes, per (batch,
// head), the recurrence over an (HD x HD) fp32 state S with the decay on
// the key axis i:
//
//   y_t[j] = sum_i r_t[i] * (S[i][j] + u[i] * k_t[i] * v_t[j])
//   S[i][j] <- w_t[i] * S[i][j] + k_t[i] * v_t[j]
//
// Layouts (contiguous, the model's own; read by stride, no transposed copy):
//   r, k, v  (B, T, H, HD)   float32 or bfloat16, one dtype
//   w        (B, T, H, HD)   float32 decay in [0, 1)
//   u        (H, HD)         float32 bonus
//   s0       (B, H, HD, HD)  float32 initial state, S[i][j] at [..., i, j]
//   y        (B, T, H, HD)   r's dtype
//   s_out    (B, H, HD, HD)  float32 final state
//
// What bounds it on this card.  At B=1, T=2048, H=40, HD=64 the bytes it
// must move are ~64 MB (r/k/v/y in bf16, w in fp32, the states): 19 us at
// 3.35 TB/s; its ~1.3 GFLOP of fp32 FMA take 20 us at 67 TFLOP/s.  Run as
// the exact per-token recurrence it is neither: it is a serial chain of T
// dependent steps per state element, so the time is T x (one step's
// latency).  Two routes:
//
// bf16 r/k/v (the served path): the chunked form, on the tensor cores, in
// three launches.  Chunks of kChunk = 64 tokens, cut into kSub = 16-token
// sub-chunks.
//   1. wkv6_chunk_state, one 4-warp block per (b, h, chunk), all chunks at
//      once:
//      dS = (k (.) 2^(sum of log2 w after s in the chunk))^T V and
//      D = 2^(sum of log2 w over the chunk), to a scratch the wrapper
//      allocates (B, H, chunks, HD, HD) and (B, H, chunks, HD);
//   2. wkv6_chunk_scan, one thread per 4 state elements: S_{n+1} =
//      D_n (.) S_n + dS_n in fp32, serial over the T / 64 chunks only; it
//      writes each chunk's incoming S_n over dS_n (each thread reads its
//      own elements before it writes them), and S after the last chunk to
//      s_out.  The dS loads of 8 chunks are issued before their steps run;
//   3. wkv6_chunk_out, one 8-warp block per (b, h, chunk):
//      y = (r (.) 2^(prefix)) S_n + A V with A[t][s] (s <= t) the
//      intra-chunk weights, parallel over chunks; two warps a sub-chunk
//      on the CUDA-core diagonal, and on the tensor cores groups of four
//      warps that each take a light and a heavy sub-chunk (J, 3 - J).
// The chain of T dependent steps becomes T / 64 (32 at T=2048), and B=1,
// H=40 gives 1,280 blocks in each chunk kernel, not 160.  What limits it
// now: the three launches move ~190 MB (k, v and w twice, and the fp32
// chunk states written, scanned and read: ~85 MB), ~56 us at 3.35 TB/s,
// and launch 3's phases run between block barriers at two blocks an SM.
//
// Numerics: no decay factor above 1 is ever formed.  The closed form that
// factorises 2^(c[t]) 2^(-c[s]) over a cumulative log decay c overflows
// fp32 for strong decays, which is why the TPU kernel stayed exact; and
// even 2^(c[a] - c[b]) with a >= b loses the digits of a small difference
// of two large sums after a strong decay.  Here every factor is 2^x of a
// sum x <= 0 taken from 0 over exactly the tokens it spans (a running
// prefix or suffix sum inside a sub-chunk or chunk, or a sum of whole
// sub-chunks), so its relative error is that of x, and x is never a
// difference.
//   * log2 w is clamped at kLog2Floor = -126: w reaches exact 0 in the
//     model (w = exp(-exp(dec)) underflows), and log2 0 = -inf.  A clamped
//     decay keeps 2^-126 ~ 1.2e-38 of the state where the exact product
//     keeps 0, far below the fp32 limit for any state below 1e32; and every
//     sum stays finite (>= 64 x -126), so no inf - inf can arise anywhere.
//   * A[t][s], s in an earlier sub-chunk than t's, goes through the
//     boundary B = the last token before t's sub-chunk:
//     (r_t 2^(sum over (B, t))) . (k_s 2^(sum over (s, B])), where the
//     second factor is k_s 2^(sum to its own sub-chunk's end) times
//     2^(sum of the whole sub-chunks between): tensor-core products;
//   * the diagonal 16 x 16 sub-blocks are taken pairwise on the CUDA
//     cores: f(t, s) = prod of the clamped w over (s, t), a running product
//     of factors <= 1, and the bonus r_t . (u (.) k_t) on the diagonal.
// Precision: the decay-scaled operands and S are fp32, not bf16-exact.
// Rounded once to TF32 they would miss the bf16 limit by 100-500 x on
// outputs that cancel towards 0, so every such product runs as 3xTF32 on
// mma.sync m16n8k8 (x_hi = cvt.rna.tf32(x), x_lo = cvt.rna.tf32(x - x_hi);
// a_hi b_hi + a_hi b_lo + a_lo b_hi), and as 2xTF32 where one side is the
// bf16 V (exact in TF32); each k-step's terms meet the running sum in an
// fp32 add that rounds to nearest (mma_step).  The tiles are 64 x 64 x 64:
// mma.sync is enough; the gain is the parallelism over chunks.
// tests/helpers/torch_kernel_emul.py `wkv6_chunk_emul` follows this design
// on the CPU: its chunking, sums, clamp, splits and scan (the order of
// some fp32 sums differs).
//
// float32 r/k/v (the card-vs-CPU check) stays on the exact per-token
// kernel, wkv6_kernel below:
//   * a loop over T inside the block carries S in registers, and nothing
//     crosses blocks; one block takes 16 state columns of one (b, h)
//     (column j reads only v[j]): HD / 16 blocks per head;
//   * inside a block, 8 lanes share a column, each holding HD / 8 rows of
//     it in registers, so one step is 8 dependent FMAs and a 3-shuffle
//     reduction of y, not HD;
//   * r, k, w and u*k of a tile of 2048 / HD tokens are staged once per
//     block in shared memory as one float4 per (token, row), and the next
//     tile's loads are issued into registers before the current tile's
//     tokens run;
//   * the state update never waits for the y reduction.
// Any T on both routes: a ragged last chunk or tile is padded (w = 1,
// k = 0: a padded token changes nothing) or simply shorter.  The TPU
// kernel and the reference's XLA scan assert that their chunk divides T;
// the chunking never changes the per-token function.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 16;                  // state columns per block
constexpr int kGroups = 8;                 // lanes sharing one column
constexpr int kThreads = kCols * kGroups;  // 128
constexpr int kTileElems = 2048;           // tokens per tile = this / HD

// One tile's worth of this thread's loads, held in registers until they
// are stored to shared memory (using them at load time would make every
// load wait where it is issued).  Thread tid reads row i = tid % HD of
// tokens tid / HD + q * (kThreads / HD), and v of column c = tid % kCols of
// tokens tid / kCols + q * (kThreads / kCols).
template <int HD>
struct Staged {
  static constexpr int kLoads = kTileElems / kThreads;        // 16
  static constexpr int kVLoads = kTileElems / HD * kCols / kThreads;
  float r[kLoads], k[kLoads], v[kVLoads], w[kLoads];
};

template <int HD>
__device__ __forceinline__ void fetch(Staged<HD>& st,
                                      const float* __restrict__ r,
                                      const float* __restrict__ k,
                                      const float* __restrict__ v,
                                      const float* __restrict__ w,
                                      size_t base, size_t row, int cb, int t0,
                                      int n, int tid) {
#pragma unroll
  for (int q = 0; q < Staged<HD>::kLoads; ++q) {
    const int t = (tid + q * kThreads) / HD;
    if (t < n) {
      const size_t off = base + (size_t)(t0 + t) * row + tid % HD;
      st.r[q] = r[off];
      st.k[q] = k[off];
      st.w[q] = w[off];
    }
  }
#pragma unroll
  for (int q = 0; q < Staged<HD>::kVLoads; ++q) {
    const int t = (tid + q * kThreads) / kCols;
    if (t < n) {
      st.v[q] = v[base + (size_t)(t0 + t) * row + cb * kCols + tid % kCols];
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ s0,
            float* __restrict__ y, float* __restrict__ s_out, int T_len,
            int H) {
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

  Staged<HD> st;
  fetch<HD>(st, r, k, v, w, base, row, cb, 0, min(kTile, T_len), tid);
  for (int t0 = 0; t0 < T_len; t0 += kTile) {
    const int n = min(kTile, T_len - t0);
    __syncthreads();  // the previous tile's readers are done
#pragma unroll
    for (int q = 0; q < Staged<HD>::kLoads; ++q) {
      const int t = (tid + q * kThreads) / HD;
      if (t < n) {
        rkwu_s[t][tid % HD] =
            make_float4(st.r[q], st.k[q], st.w[q], u_i * st.k[q]);
      }
    }
#pragma unroll
    for (int q = 0; q < Staged<HD>::kVLoads; ++q) {
      const int t = (tid + q * kThreads) / kCols;
      if (t < n) v_s[t][tid % kCols] = st.v[q];
    }
    __syncthreads();
    if (t0 + kTile < T_len) {  // in flight while this tile computes
      fetch<HD>(st, r, k, v, w, base, row, cb, t0 + kTile,
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
      if (g == 0) y[base + (size_t)(t0 + t) * row + j] = acc;
    }
  }

#pragma unroll
  for (int ii = 0; ii < kRows; ++ii) {
    s_out[s_base + (size_t)(ii * kGroups + g) * HD + j] = S[ii];
  }
}

template <int HD>
void launch_hd(const void* r, const void* k, const void* v, const void* w,
               const void* u, const void* s0, void* y, void* s_out, int B,
               int T_len, int H, cudaStream_t stream) {
  const dim3 grid(HD / kCols, H, B);
  wkv6_kernel<HD><<<grid, kThreads, 0, stream>>>(
      (const float*)r, (const float*)k, (const float*)v, (const float*)w,
      (const float*)u, (const float*)s0, (float*)y, (float*)s_out, T_len, H);
}

int launch_fp32(const void* r, const void* k, const void* v, const void* w,
                const void* u, const void* s0, void* y, void* s_out, int B,
                int T_len, int H, int hd, cudaStream_t s) {
  switch (hd) {
    case 16: launch_hd<16>(r, k, v, w, u, s0, y, s_out, B, T_len, H, s); break;
    case 32: launch_hd<32>(r, k, v, w, u, s0, y, s_out, B, T_len, H, s); break;
    case 64: launch_hd<64>(r, k, v, w, u, s0, y, s_out, B, T_len, H, s); break;
    case 128: launch_hd<128>(r, k, v, w, u, s0, y, s_out, B, T_len, H, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return 0;
}

// ----------------------------------------- bf16 route: the chunked form

constexpr int kChunk = 64;               // tokens of a chunk
constexpr int kSub = 16;                 // tokens of a sub-chunk: one warp
constexpr int kSubs = kChunk / kSub;     // 4 warps
constexpr int kChunkThreads = kSubs * 32;
constexpr int kScanThreads = 128;
constexpr int kScanAhead = 8;            // chunks whose dS loads are in flight
constexpr float kLog2Floor = -126.f;     // log2 w clamp: see the note above

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo to ~2^-22 |x|, both TF32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// d = a b + d on the tensor cores, m16n8k8, TF32 in, fp32 accumulate.
// With g = lane / 4 and c = lane % 4 a lane holds a at (row, col) (g, c),
// (g + 8, c), (g, c + 4), (g + 8, c + 4); b at (k, n) (c, g), (c + 4, g);
// d at (g, 2c), (g, 2c + 1), (g + 8, 2c), (g + 8, 2c + 1).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc += a b for one k-step of 8, with a and b given as TF32 (hi, lo)
// pairs (b_lo = nullptr for a bf16 b, exact in TF32).  The k-step's terms
// are summed on the tensor cores from 0 and then added to acc by an fp32
// add that rounds to nearest: the tensor cores' own accumulation does not
// round to nearest, and a running sum of many k-steps would carry that
// bias along.
__device__ __forceinline__ void mma_step(float (&acc)[4],
                                         const uint32_t (&ahi)[4],
                                         const uint32_t (&alo)[4],
                                         uint32_t b0h, uint32_t b1h,
                                         const uint32_t* blo) {
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(d, alo, b0h, b1h);
  if (blo) mma_tf32(d, ahi, blo[0], blo[1]);
  mma_tf32(d, ahi, b0h, b1h);
#pragma unroll
  for (int q = 0; q < 4; ++q) acc[q] += d[q];
}

// A fragment of rows (row0 + g, row0 + g + 8) and columns (col0 + c,
// col0 + c + 4) of a row-major fp32 tile, each element times scale[col]
// where scale is given, split into TF32 hi and lo.
__device__ __forceinline__ void a_split(const float* x, int ld, int row0,
                                        int col0, int g, int c,
                                        const float* scale, uint32_t (&hi)[4],
                                        uint32_t (&lo)[4]) {
  const float* p = x + (row0 + g) * ld + col0 + c;
  float v[4] = {p[0], p[8 * ld], p[4], p[8 * ld + 4]};
  if (scale) {
    const float s0 = scale[col0 + c], s4 = scale[col0 + c + 4];
    v[0] *= s0; v[1] *= s0; v[2] *= s4; v[3] *= s4;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) split(v[q], hi[q], lo[q]);
}

// One chunk of one (b, h): NB bf16 tensors of (B, T, H, HD) and the decay
// w, rows t0 .. t0 + 63, by THREADS threads.  Every load of the chunk is
// issued before any is used, 16 bytes a load, so the block waits for
// memory once.
template <int HD, int NB, int THREADS>
struct ChunkLoads {
  static constexpr int kV = (kChunk * HD / 8 + THREADS - 1) / THREADS;
  static constexpr int kW = (kChunk * HD / 4 + THREADS - 1) / THREADS;
  uint4 raw[NB][kV];
  float4 w[kW];

  __device__ __forceinline__ void issue(const __nv_bfloat16* const* x,
                                        const float* __restrict__ wp,
                                        size_t base, size_t row, int t0,
                                        int T_len) {
#pragma unroll
    for (int q = 0; q < kV; ++q) {
      const int e = (threadIdx.x + q * THREADS) * 8;
      const int t = e / HD, i = e % HD;
      const size_t off = base + (size_t)(t0 + t) * row + i;
      const bool live = e < kChunk * HD && t0 + t < T_len;
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        raw[n][q] = live ? *reinterpret_cast<const uint4*>(x[n] + off)
                         : make_uint4(0u, 0u, 0u, 0u);       // bf16 zeros
      }
    }
#pragma unroll
    for (int q = 0; q < kW; ++q) {
      const int e = (threadIdx.x + q * THREADS) * 4;
      const int t = e / HD, i = e % HD;
      w[q] = e < kChunk * HD && t0 + t < T_len
                 ? *reinterpret_cast<const float4*>(wp + base +
                                                    (size_t)(t0 + t) * row + i)
                 : make_float4(1.f, 1.f, 1.f, 1.f);  // a padded token: w = 1
    }
  }

  // tensor n to dst[n] as fp32 (rows of ld[n] floats), but the last to
  // raw_dst as the bf16 it is (rows of raw_ld bf16) where raw_dst is
  // given; log2 w, clamped, to lw (rows of HD) and 2^(that) to wc (rows
  // of wc_ld) where given
  __device__ __forceinline__ void store(float* const* dst, const int* ld,
                                        __nv_bfloat16* raw_dst, int raw_ld,
                                        float* lw, float* wc,
                                        int wc_ld) const {
#pragma unroll
    for (int q = 0; q < kV; ++q) {
      const int e = (threadIdx.x + q * THREADS) * 8;
      if (e >= kChunk * HD) continue;
      const int t = e / HD, i = e % HD;
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        if (raw_dst && n == NB - 1) {
          *reinterpret_cast<uint4*>(raw_dst + t * raw_ld + i) = raw[n][q];
          continue;
        }
        const __nv_bfloat162* h2 =
            reinterpret_cast<const __nv_bfloat162*>(&raw[n][q]);
        const float2 a = __bfloat1622float2(h2[0]);
        const float2 b = __bfloat1622float2(h2[1]);
        const float2 c = __bfloat1622float2(h2[2]);
        const float2 d = __bfloat1622float2(h2[3]);
        float* o = dst[n] + t * ld[n] + i;
        *reinterpret_cast<float4*>(o) = make_float4(a.x, a.y, b.x, b.y);
        *reinterpret_cast<float4*>(o + 4) = make_float4(c.x, c.y, d.x, d.y);
      }
    }
#pragma unroll
    for (int q = 0; q < kW; ++q) {
      const int e = (threadIdx.x + q * THREADS) * 4;
      if (e >= kChunk * HD) continue;
      const float4 x = w[q];
      const float4 l = make_float4(
          fmaxf(log2f(x.x), kLog2Floor), fmaxf(log2f(x.y), kLog2Floor),
          fmaxf(log2f(x.z), kLog2Floor), fmaxf(log2f(x.w), kLog2Floor));
      *reinterpret_cast<float4*>(lw + e) = l;
      if (wc) {
        *reinterpret_cast<float4*>(wc + e / HD * wc_ld + e % HD) =
            make_float4(exp2f(l.x), exp2f(l.y), exp2f(l.z), exp2f(l.w));
      }
    }
  }
};

// A bf16 value as the TF32 operand it is exactly: its bits, shifted up
__device__ __forceinline__ uint32_t bf16_tf32(const __nv_bfloat16* p) {
  return (uint32_t)(*reinterpret_cast<const unsigned short*>(p)) << 16;
}

// Row pitch of V kept in bf16: (HD + 8) / 2 words is 4 mod 32, so a B
// fragment's (c, g) reads fall on distinct banks
template <int HD>
constexpr int kVPitch = HD + 8;

template <int HD>
constexpr size_t state_smem_bytes() {
  return kChunk * (HD + 8) * sizeof(float) +
         kChunk * kVPitch<HD> * sizeof(__nv_bfloat16) +
         kChunk * HD * sizeof(float);
}

// Launch 1, one block per (chunk, h, b): dS = kd^T V with
// kd[s][i] = k_s[i] 2^(sum of log2 w[i] over (s, chunk end]), and
// D[i] = 2^(sum over the chunk), to states[b][h][chunk] and dec.
template <int HD>
__global__ void __launch_bounds__(kChunkThreads)
wkv6_chunk_state(const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const float* __restrict__ w, float* __restrict__ states,
                 float* __restrict__ dec, int T_len, int H) {
  constexpr int LD = HD + 8;  // fragment reads (k, m) = (c, g) hit 32 banks
  constexpr int LDV = kVPitch<HD>;
  constexpr int kHalf = kChunk / 2;
  extern __shared__ float4 smem_state[];
  float* kd = reinterpret_cast<float*>(smem_state);   // [64][LD]
  float* lw = kd + kChunk * LD;                        // [64][HD]
  __nv_bfloat16* vs =
      reinterpret_cast<__nv_bfloat16*>(lw + kChunk * HD);  // [64][LDV]
  const int n = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const size_t row = (size_t)H * HD;
  const size_t base = (size_t)b * T_len * row + (size_t)h * HD;
  const size_t chunk_id = ((size_t)b * H + h) * gridDim.x + n;
  {
    ChunkLoads<HD, 2, kChunkThreads> ld;
    const __nv_bfloat16* src[2] = {k, v};
    float* dst[2] = {kd, nullptr};
    const int pitch[2] = {LD, 0};
    ld.issue(src, w, base, row, n * kChunk, T_len);
    ld.store(dst, pitch, vs, LDV, lw, nullptr, 0);
  }
  __syncthreads();
  // the suffix sums, two threads a row: the upper half of the chunk, and
  // the lower half, which first sums the upper half in the same order
  for (int task = threadIdx.x; task < 2 * HD; task += kChunkThreads) {
    const int i = task % HD;
    float q = 0.f;                        // sum over (s, chunk end]
    if (task < HD) {
#pragma unroll
      for (int s = kChunk - 1; s >= kHalf; --s) {
        kd[s * LD + i] *= exp2f(q);
        q += lw[s * HD + i];
      }
    } else {
#pragma unroll
      for (int s = kChunk - 1; s >= kHalf; --s) q += lw[s * HD + i];
#pragma unroll
      for (int s = kHalf - 1; s >= 0; --s) {
        kd[s * LD + i] *= exp2f(q);
        q += lw[s * HD + i];
      }
      dec[chunk_id * HD + i] = exp2f(q);
    }
  }
  __syncthreads();
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, c = lane % 4;
  float* out = states + chunk_id * HD * HD;
  constexpr int NT = HD / 8;
  for (int m0 = warp * 16; m0 < HD; m0 += kSubs * 16) {  // a warp: 16 rows i
    float acc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll
    for (int k0 = 0; k0 < kChunk; k0 += 8) {
      uint32_t hi[4], lo[4];    // kd^T: (m, k) = (i, s) lies at kd[s][i]
      split(kd[(k0 + c) * LD + m0 + g], hi[0], lo[0]);
      split(kd[(k0 + c) * LD + m0 + g + 8], hi[1], lo[1]);
      split(kd[(k0 + c + 4) * LD + m0 + g], hi[2], lo[2]);
      split(kd[(k0 + c + 4) * LD + m0 + g + 8], hi[3], lo[3]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        mma_step(acc[nt], hi, lo, bf16_tf32(vs + (k0 + c) * LDV + nt * 8 + g),
                 bf16_tf32(vs + (k0 + c + 4) * LDV + nt * 8 + g), nullptr);
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      *reinterpret_cast<float2*>(out + (m0 + g) * HD + nt * 8 + 2 * c) =
          make_float2(acc[nt][0], acc[nt][1]);
      *reinterpret_cast<float2*>(out + (m0 + g + 8) * HD + nt * 8 + 2 * c) =
          make_float2(acc[nt][2], acc[nt][3]);
    }
  }
}

// Launch 2: S_{n+1} = D_n (.) S_n + dS_n over the chunks in order, one
// thread per 4 state elements; S_n goes over dS_n, the last S to s_out.
template <int HD>
__global__ void __launch_bounds__(kScanThreads)
wkv6_chunk_scan(const float* __restrict__ s0, float* states,
                const float* __restrict__ dec, float* __restrict__ s_out,
                int nc, int total4) {
  constexpr int kPer = HD * HD / 4;       // float4 of one (b, h) state
  const int idx = blockIdx.x * kScanThreads + threadIdx.x;
  if (idx >= total4) return;
  const int bh = idx / kPer, e = idx % kPer;
  float4 S = reinterpret_cast<const float4*>(s0)[idx];
  float4* st = reinterpret_cast<float4*>(states) + (size_t)bh * nc * kPer + e;
  const float* dc = dec + (size_t)bh * nc * HD + e * 4 / HD;
  for (int n0 = 0; n0 < nc; n0 += kScanAhead) {
    float4 dS[kScanAhead];
    float D[kScanAhead];
#pragma unroll
    for (int q = 0; q < kScanAhead; ++q) {
      if (n0 + q < nc) {
        dS[q] = st[(size_t)(n0 + q) * kPer];
        D[q] = dc[(size_t)(n0 + q) * HD];
      }
    }
#pragma unroll
    for (int q = 0; q < kScanAhead; ++q) {
      if (n0 + q < nc) {
        st[(size_t)(n0 + q) * kPer] = S;
        S = make_float4(fmaf(D[q], S.x, dS[q].x), fmaf(D[q], S.y, dS[q].y),
                        fmaf(D[q], S.z, dS[q].z), fmaf(D[q], S.w, dS[q].w));
      }
    }
  }
  reinterpret_cast<float4*>(s_out)[idx] = S;
}

constexpr int kOutWarps = 2 * kSubs;     // two warps a sub-chunk
constexpr int kOutThreads = kOutWarps * 32;

// Shared memory of launch 3, in floats.  Row pitches put the fragment
// reads on 32 banks: rq and ks are read at (row, col) = (g, c), so their
// pitch is 4 mod 32; S at (c, g), so its pitch is 8 mod 32; V stays bf16
// (kVPitch).  wc shares rq's pitch: the diagonal's lanes read rows in
// steps of one.
template <int HD>
struct OutSmem {
  static constexpr int LDR = HD + 4, LDS = HD + 8, LDA = kChunk + 4;
  static constexpr int LDV = kVPitch<HD>;
  static constexpr int kRq = 0;
  static constexpr int kA = kRq + kChunk * LDR;
  static constexpr int kAd = kA + kChunk * LDA;  // the second warps' diagonals
  static constexpr int kKs = kAd + kSubs * kSub * kSub;  // S_n overlays ks..wc
  static constexpr int kLw = kKs + kChunk * LDR;
  static constexpr int kWc = kLw + kChunk * HD;
  static constexpr int kU = kWc + kChunk * LDR;
  static constexpr int kTot = kU + HD;
  static constexpr int kPre = kTot + kSubs * HD;
  static constexpr int kMid = kPre + kSubs * HD;
  static constexpr int kV = kMid + kSubs * kSubs * HD;   // bf16 from here
  static constexpr int kFloats = kV + kChunk * LDV / 2;
  static_assert(HD * LDS <= kU - kKs, "S_n fits over ks, lw and wc");
  // S_n split into TF32 hi and lo once, where both fit (hd <= 64)
  static constexpr bool kSplitS = 2 * HD * LDS <= kU - kKs;
};

// S_n of one chunk, HD x HD fp32, in float4 loads a thread: all issued at
// once, held in registers until shared memory is free for them.
template <int HD, int kLoads>
struct StateLoads {
  float4 x[kLoads];
  __device__ __forceinline__ void issue(const float* src, int first) {
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      const int e = threadIdx.x + (first + q) * kOutThreads;
      if (e < HD * HD / 4) x[q] = reinterpret_cast<const float4*>(src)[e];
    }
  }
  // to Ss as it is, or, where lo is given, split: TF32 hi to Ss, lo to lo
  __device__ __forceinline__ void store(float* Ss, float* lo, int ld,
                                        int first) const {
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      const int e = threadIdx.x + (first + q) * kOutThreads;
      if (e >= HD * HD / 4) continue;
      const int at = (e * 4 / HD) * ld + e * 4 % HD;
      if (!lo) {
        *reinterpret_cast<float4*>(Ss + at) = x[q];
        continue;
      }
      const float v[4] = {x[q].x, x[q].y, x[q].z, x[q].w};
      uint32_t h[4], l[4];
#pragma unroll
      for (int z = 0; z < 4; ++z) split(v[z], h[z], l[z]);
      *reinterpret_cast<uint4*>(Ss + at) = make_uint4(h[0], h[1], h[2], h[3]);
      *reinterpret_cast<uint4*>(lo + at) = make_uint4(l[0], l[1], l[2], l[3]);
    }
  }
};

template <int N>
__device__ __forceinline__ void load_f(const float* p, float (&x)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N; q += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + q);
      x[q] = v.x; x[q + 1] = v.y; x[q + 2] = v.z; x[q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < N; ++q) x[q] = p[q];
  }
}

// Launch 3, one block per (chunk, h, b); warps 2J and 2J + 1 compute the
// output rows of sub-chunk J, each half of the columns:
//   y = A V + (r (.) 2^(sum over [chunk start, t))) S_n
// with A[t][s] (s <= t) the intra-chunk weights: the diagonal sub-block
// pairwise on the CUDA cores, the sub-blocks left of it on the tensor
// cores.
template <int HD>
__global__ void __launch_bounds__(kOutThreads)
wkv6_chunk_out(const __nv_bfloat16* __restrict__ r,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               const float* __restrict__ w, const float* __restrict__ u,
               const float* __restrict__ states,
               __nv_bfloat16* __restrict__ y, int T_len, int H) {
  using L = OutSmem<HD>;
  constexpr int LDR = L::LDR, LDS = L::LDS, LDA = L::LDA, LDV = L::LDV;
  // S_n's loads: issued first and held in registers where they are few
  // (hd <= 64), else issued once shared memory is free for them
  constexpr int kSLoads = (HD * HD / 4 + kOutThreads - 1) / kOutThreads;
  constexpr bool kEarlyS = kSLoads <= 4;
  extern __shared__ float4 smem_out[];
  float* sm = reinterpret_cast<float*>(smem_out);
  float* rq = sm + L::kRq;    // r, then r_t 2^(sum over [sub start, t))
  float* A = sm + L::kA;      // [t][s]
  float* Ad = sm + L::kAd;    // [J][t][s]: the diagonal's second halves
  float* ks = sm + L::kKs;    // k, then k_s 2^(sum over (s, sub end])
  float* lw = sm + L::kLw;
  float* wc = sm + L::kWc;    // the clamped decay 2^lw
  float* us = sm + L::kU;
  float* tot = sm + L::kTot;  // [sub][i]: sum over the sub-chunk
  float* pre = sm + L::kPre;  // [sub][i]: 2^(sum over the sub-chunks before)
  float* mid = sm + L::kMid;  // [j][J][i]: 2^(sum over sub-chunks j+1..J-1)
  float* Ss = sm + L::kKs;    // S_n [i][j], once ks, lw, wc are done with
  __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(sm + L::kV);
  const int n = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const size_t row = (size_t)H * HD;
  const size_t base = (size_t)b * T_len * row + (size_t)h * HD;
  const size_t chunk_id = ((size_t)b * H + h) * gridDim.x + n;
  const float* S_n = states + chunk_id * HD * HD;
  StateLoads<HD, kEarlyS ? kSLoads : 1> s_early;
  {
    ChunkLoads<HD, 3, kOutThreads> ld;
    const __nv_bfloat16* src[3] = {r, k, v};
    float* dst[3] = {rq, ks, nullptr};
    const int pitch[3] = {LDR, LDR, 0};
    ld.issue(src, w, base, row, n * kChunk, T_len);
    if (kEarlyS) s_early.issue(S_n, 0);
    ld.store(dst, pitch, vs, LDV, lw, wc, LDR);
  }
  for (int i = threadIdx.x; i < HD; i += kOutThreads) {
    us[i] = u[(size_t)h * HD + i];
  }
  __syncthreads();

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int J = warp / 2, p = warp % 2;
  const int g = lane / 4, c = lane % 4;

  {  // the diagonal sub-block.  A lane takes rows t1 and 15 - t1, whose
     // pairs below the diagonal number 15 together, and one of the 8
     // slices of the i (4 a warp); each step's slice sums meet by shuffles
    constexpr int kI = HD / 8;
    const int t1 = lane % 8, t2 = kSub - 1 - t1, q = lane / 8;
    const int i0 = (p * 4 + q) * kI;
    float* out = p ? Ad + J * kSub * kSub : A + J * kSub * LDA + J * kSub;
    const int ld_out = p ? kSub : LDA;
    float rt[kI], kt[kI], f[kI], x[kI];
    float bonus[2];
#pragma unroll
    for (int which = 0; which < 2; ++which) {
      const int t = J * kSub + (which ? t2 : t1);
      load_f(rq + t * LDR + i0, rt);
      load_f(ks + t * LDR + i0, kt);
      load_f(us + i0, x);
      float bsum = 0.f;
#pragma unroll
      for (int ii = 0; ii < kI; ++ii) bsum = fmaf(rt[ii], x[ii] * kt[ii], bsum);
      bsum += __shfl_xor_sync(0xffffffffu, bsum, 8);
      bsum += __shfl_xor_sync(0xffffffffu, bsum, 16);
      bonus[which] = bsum;
    }
    if (q == 0) {
      out[t1 * ld_out + t1] = bonus[0];
      out[t2 * ld_out + t2] = bonus[1];
    }
    load_f(rq + (J * kSub + t1) * LDR + i0, rt);
#pragma unroll
    for (int ii = 0; ii < kI; ++ii) f[ii] = 1.f;   // prod of w over (s, t)
    float res[kSub - 1];      // stored after the loop: no store may alias
#pragma unroll                // the loads of the steps after it
    for (int it = 0; it < kSub - 1; ++it) {
      if (it == t1) {                       // row t2 from here on
        load_f(rq + (J * kSub + t2) * LDR + i0, rt);
#pragma unroll
        for (int ii = 0; ii < kI; ++ii) f[ii] = 1.f;
      }
      const int s = it >= t1 ? t2 - 1 - (it - t1) : t1 - 1 - it;
      load_f(ks + (J * kSub + s) * LDR + i0, kt);
      load_f(wc + (J * kSub + s) * LDR + i0, x);
      float part[2] = {0.f, 0.f};
#pragma unroll
      for (int ii = 0; ii < kI; ++ii) {
        part[ii % 2] = fmaf(rt[ii] * kt[ii], f[ii], part[ii % 2]);
        f[ii] *= x[ii];
      }
      float sum = part[0] + part[1];
      sum += __shfl_xor_sync(0xffffffffu, sum, 8);
      sum += __shfl_xor_sync(0xffffffffu, sum, 16);
      res[it] = sum;
    }
    if (q == 0) {
#pragma unroll
      for (int it = 0; it < kSub - 1; ++it) {
        const int t = it >= t1 ? t2 : t1;
        const int s = it >= t1 ? t2 - 1 - (it - t1) : t1 - 1 - it;
        out[t * ld_out + s] = res[it];
      }
    }
  }
  __syncthreads();  // the raw r and k are read: scale them in place

  // per row i, four threads: the prefix sums (r side) and the suffix sums
  // (k side) of two sub-chunks each; and the diagonals' halves summed
  for (int task = threadIdx.x; task < 4 * HD; task += kOutThreads) {
    const int i = task % HD, kind = task / HD;
    float* x = kind < 2 ? rq : ks;
#pragma unroll
    for (int q = kind % 2 * 2; q < kind % 2 * 2 + 2; ++q) {
      float l[kSub], val[kSub];       // all loads first: the stores below
#pragma unroll                        // could alias them
      for (int tt = 0; tt < kSub; ++tt) {
        l[tt] = lw[(q * kSub + tt) * HD + i];
        val[tt] = x[(q * kSub + tt) * LDR + i];
      }
      float e = 0.f;
      if (kind < 2) {                 // r side: sum over [sub start, t)
#pragma unroll
        for (int tt = 0; tt < kSub; ++tt) {
          val[tt] *= exp2f(e);
          e += l[tt];
        }
        tot[q * HD + i] = e;
      } else {                        // k side: sum over (s, sub end]
#pragma unroll
        for (int tt = kSub - 1; tt >= 0; --tt) {
          val[tt] *= exp2f(e);
          e += l[tt];
        }
      }
#pragma unroll
      for (int tt = 0; tt < kSub; ++tt) x[(q * kSub + tt) * LDR + i] = val[tt];
    }
  }
  for (int e = threadIdx.x; e < kSubs * kSub * kSub; e += kOutThreads) {
    const int J2 = e / (kSub * kSub), t = e / kSub % kSub, s = e % kSub;
    float* a = A + (J2 * kSub + t) * LDA + J2 * kSub + s;
    *a = s <= t ? *a + Ad[e] : 0.f;       // A V reads the zeros above
  }
  __syncthreads();
  for (int i = threadIdx.x; i < HD; i += kOutThreads) {
    float pp = 0.f;
#pragma unroll
    for (int q = 0; q < kSubs; ++q) {
      pre[q * HD + i] = exp2f(pp);
      pp += tot[q * HD + i];
    }
#pragma unroll
    for (int j = 0; j < kSubs; ++j) {
#pragma unroll
      for (int q = j + 2; q < kSubs; ++q) {
        float m = 0.f;
#pragma unroll
        for (int x = j + 1; x < q; ++x) m += tot[x * HD + i];
        mid[(j * kSubs + q) * HD + i] = exp2f(m);
      }
    }
  }
  __syncthreads();

  // The tensor-core phases: row block J costs in proportion to J + 1, so
  // the warps go in two groups of four, each with a light and a heavy row
  // block (J and 3 - J), and split their columns and tiles evenly.
  const int grp = warp / 4, sub = warp % 4;

  {  // A[t][s] for s before t's sub-chunk, through its start: 3xTF32.  The
     // 12 tiles of 16 t x 8 s are 6 a group: J = 3's, or J = 1's and 2's
    float d[2][4];
    int tile_J[2], tile_n[2];
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int idx = sub + 4 * x;
      tile_J[x] = idx >= 6 ? 0 : grp == 0 ? 3 : idx < 2 ? 1 : 2;
      tile_n[x] = grp == 0 || idx < 2 ? idx : idx - 2;
      d[x][0] = d[x][1] = d[x][2] = d[x][3] = 0.f;
    }
#pragma unroll
    for (int k0 = 0; k0 < HD; k0 += 8) {
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int TJ = tile_J[x], nt = tile_n[x];
        if (TJ == 0) continue;                 // no tile: 6 a group
        uint32_t ahi[4], alo[4];
        a_split(rq, LDR, TJ * kSub, k0, g, c, nullptr, ahi, alo);
        const int s = nt * 8 + g, j = nt / 2;
        float x0 = ks[s * LDR + k0 + c], x1 = ks[s * LDR + k0 + c + 4];
        if (j < TJ - 1) {
          const float* m = mid + (j * kSubs + TJ) * HD + k0 + c;
          x0 *= m[0];
          x1 *= m[4];
        }
        uint32_t b0h, b1h, blo[2];
        split(x0, b0h, blo[0]);
        split(x1, b1h, blo[1]);
        mma_step(d[x], ahi, alo, b0h, b1h, blo);
      }
    }
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      if (tile_J[x] == 0) continue;
      float* a = A + (tile_J[x] * kSub + g) * LDA + tile_n[x] * 8 + 2 * c;
      *reinterpret_cast<float2*>(a) = make_float2(d[x][0], d[x][1]);
      *reinterpret_cast<float2*>(a + 8 * LDA) = make_float2(d[x][2], d[x][3]);
    }
  }
  __syncthreads();  // A is whole

  constexpr int NT = HD / 8;                  // n-tiles of 8 columns a row
  constexpr int NTW = NT >= 4 ? NT / 4 : 1;   // of them a warp takes
  const bool has_cols = sub * NTW < NT;       // hd 16: two warps a group
  float acc[2][NTW][4];                       // [row block J, 3 - J]
#pragma unroll
  for (int rb = 0; rb < 2; ++rb) {
#pragma unroll
    for (int x = 0; x < NTW; ++x) {
      acc[rb][x][0] = acc[rb][x][1] = acc[rb][x][2] = acc[rb][x][3] = 0.f;
    }
  }
  if (has_cols) {
#pragma unroll
    for (int rb = 0; rb < 2; ++rb) {
      const int RJ = rb ? kSubs - 1 - grp : grp;
#pragma unroll
      for (int kk = 0; kk < 2 * kSubs; ++kk) {  // A V, s < 16 (J + 1): 2xTF32
        if (kk < 2 * (RJ + 1)) {
          uint32_t ahi[4], alo[4];
          a_split(A, LDA, RJ * kSub, kk * 8, g, c, nullptr, ahi, alo);
#pragma unroll
          for (int x = 0; x < NTW; ++x) {
            const int col = (sub * NTW + x) * 8 + g;
            mma_step(acc[rb][x], ahi, alo,
                     bf16_tf32(vs + (kk * 8 + c) * LDV + col),
                     bf16_tf32(vs + (kk * 8 + c + 4) * LDV + col), nullptr);
          }
        }
      }
    }
  }
  __syncthreads();  // every warp is done with ks: S_n goes over it

  float* Slo = L::kSplitS ? Ss + HD * LDS : nullptr;
  if (kEarlyS) {
    s_early.store(Ss, Slo, LDS, 0);
  } else {
#pragma unroll 1
    for (int first = 0; first < kSLoads; first += 8) {
      StateLoads<HD, 8> s_late;
      s_late.issue(S_n, first);
      s_late.store(Ss, Slo, LDS, first);
    }
  }
  __syncthreads();
  if (has_cols) {
#pragma unroll
    for (int rb = 0; rb < 2; ++rb) {
      const int RJ = rb ? kSubs - 1 - grp : grp;
#pragma unroll
      for (int k0 = 0; k0 < HD; k0 += 8) {  // (rq 2^(pre)) S_n: 3xTF32
        uint32_t ahi[4], alo[4];
        a_split(rq, LDR, RJ * kSub, k0, g, c, pre + RJ * HD, ahi, alo);
#pragma unroll
        for (int x = 0; x < NTW; ++x) {
          const int col = (sub * NTW + x) * 8 + g;
          const int at0 = (k0 + c) * LDS + col, at1 = at0 + 4 * LDS;
          uint32_t b0h, b1h, blo[2];
          if (L::kSplitS) {
            b0h = __float_as_uint(Ss[at0]);
            b1h = __float_as_uint(Ss[at1]);
            blo[0] = __float_as_uint(Slo[at0]);
            blo[1] = __float_as_uint(Slo[at1]);
          } else {
            split(Ss[at0], b0h, blo[0]);
            split(Ss[at1], b1h, blo[1]);
          }
          mma_step(acc[rb][x], ahi, alo, b0h, b1h, blo);
        }
      }
      const int t = n * kChunk + RJ * kSub + g;
#pragma unroll
      for (int x = 0; x < NTW; ++x) {
        __nv_bfloat16* o =
            y + base + (size_t)t * row + (sub * NTW + x) * 8 + 2 * c;
        if (t < T_len) {
          *reinterpret_cast<__nv_bfloat162*>(o) =
              __floats2bfloat162_rn(acc[rb][x][0], acc[rb][x][1]);
        }
        if (t + 8 < T_len) {
          *reinterpret_cast<__nv_bfloat162*>(o + 8 * row) =
              __floats2bfloat162_rn(acc[rb][x][2], acc[rb][x][3]);
        }
      }
    }
  }
}

template <int HD>
int launch_chunked(const void* r, const void* k, const void* v, const void* w,
                   const void* u, const void* s0, void* y, void* s_out,
                   void* states, void* dec, int B, int T_len, int H,
                   cudaStream_t stream) {
  const int nc = (T_len + kChunk - 1) / kChunk;
  const size_t out_bytes = OutSmem<HD>::kFloats * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      wkv6_chunk_state<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)state_smem_bytes<HD>());
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(wkv6_chunk_out<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)out_bytes);
  }
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(nc, H, B);
  const auto* rb = (const __nv_bfloat16*)r;
  const auto* kb = (const __nv_bfloat16*)k;
  const auto* vb = (const __nv_bfloat16*)v;
  if (nc > 0) {
    wkv6_chunk_state<HD><<<grid, kChunkThreads, state_smem_bytes<HD>(), stream>>>(
        kb, vb, (const float*)w, (float*)states, (float*)dec, T_len, H);
  }
  const int total4 = B * H * HD * HD / 4;
  wkv6_chunk_scan<HD><<<(total4 + kScanThreads - 1) / kScanThreads,
                        kScanThreads, 0, stream>>>(
      (const float*)s0, (float*)states, (const float*)dec, (float*)s_out, nc,
      total4);
  if (nc > 0) {
    wkv6_chunk_out<HD><<<grid, kOutThreads, out_bytes, stream>>>(
        rb, kb, vb, (const float*)w, (const float*)u, (const float*)states,
        (__nv_bfloat16*)y, T_len, H);
  }
  return 0;
}

int launch_bf16(const void* r, const void* k, const void* v, const void* w,
                const void* u, const void* s0, void* y, void* s_out,
                void* states, void* dec, int B, int T_len, int H, int hd,
                cudaStream_t s) {
  switch (hd) {
    case 16: return launch_chunked<16>(r, k, v, w, u, s0, y, s_out, states, dec, B, T_len, H, s);
    case 32: return launch_chunked<32>(r, k, v, w, u, s0, y, s_out, states, dec, B, T_len, H, s);
    case 64: return launch_chunked<64>(r, k, v, w, u, s0, y, s_out, states, dec, B, T_len, H, s);
    case 128: return launch_chunked<128>(r, k, v, w, u, s0, y, s_out, states, dec, B, T_len, H, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype of r/k/v/y: 0 = float32 (the exact per-token kernel), 1 = bfloat16
// (the chunked kernels, three launches); hd in {16, 32, 64, 128} (the
// Python wrapper checks both).  For bfloat16, `states` is fp32 scratch of
// B * H * ceil(T / 64) * hd * hd floats and `dec` of B * H * ceil(T / 64) *
// hd floats; the float32 route ignores both.  Returns cudaGetLastError()
// after the launches.
extern "C" int repro_wkv6(const void* r, const void* k, const void* v,
                          const void* w, const void* u, const void* s0,
                          void* y, void* s_out, void* states, void* dec,
                          int B, int T, int H, int hd, int dtype,
                          void* stream) {
  if (B == 0 || H == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  int rc;
  if (dtype == 0) {
    rc = launch_fp32(r, k, v, w, u, s0, y, s_out, B, T, H, hd, s);
  } else if (dtype == 1) {
    rc = launch_bf16(r, k, v, w, u, s0, y, s_out, states, dec, B, T, H, hd, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
