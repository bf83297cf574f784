// Prefill flash attention for NVIDIA Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel `flash_attention_pallas` in
// src/repro/kernels/flash_attention/flash_attention.py (body `_kernel`).
// Computes causal or non-causal GQA attention with a sliding window
// (`q - k < window`, 0 = global) and a logit softcap `cap * tanh(s / cap)`,
// with an online softmax across KV tiles.  Keys sit at positions 0..Sk-1
// and query row i at position q_offset + i (0 in the reference's kernel;
// a serving rank's chunk of the sequence starts later), so Sq < Sk works.
// Rows in memory (loads and stores of q and out, the TMA boxes) stay row
// indices; only the masks and the KV-tile ranges read positions.
//
// Layouts (contiguous, the model's own):
//   q    (B, Sq, K*G, HD)    query head h reads kv head h / G
//   k    (B, Sk, K, HD)      read by stride or by coordinate, no transposed copy
//   v    (B, Sk, K, HD)
//   out  (B, Sq, K*G, HD)    q's dtype
//
// What bounds it on this card: operations.  Causal prefill of S tokens does
// ~2*S*S*HD flops per head against ~4*S*HD bytes per head, so above a few
// hundred tokens it sits far above the ridge point, and the card's answer
// is the tensor cores.  Two routes behind one entry point:
//
// bf16 (`flash_prefill_tc`, the serving dtype): both contractions on the
// tensor cores through `wgmma`, operands brought in by TMA.
//   * one block per (q tile of 128 rows, q head, batch), two consumer
//     warpgroups of 64 query rows each (wgmma's M); the grid walks the q tiles heaviest
//     (latest, under causal masking) first, so the last wave is short;
//   * Q, K and V come in by TMA through 4-D tensor maps over the model's
//     own layout (HD, heads, S, B): kv head h / G is a coordinate, a ragged
//     tail is zero-filled by the hardware and then masked.  A 128-byte
//     swizzled box is at most 64 bf16 wide, so a row of HD is HD / 64
//     boxes and the wgmma descriptors step over them as consecutive
//     K-blocks (Q K^T) or N-blocks (P V);
//   * K/V tiles of 64 rows run through a ring of stages: a producer issues
//     the loads as stages come free (a "full" and an "empty" mbarrier per
//     stage), so the two warpgroups never meet at a block barrier and
//     drift apart, one's softmax overlapping the other's wgmma;
//   * S = Q K^T by wgmma (bf16 in, fp32 accumulate; products of bf16 are
//     exact in fp32).  `scale` multiplies the fp32 S, never bf16 q: hd^-0.5
//     is not a power of two, and rounding q * scale to bf16 would change the
//     function the TPU kernel computes in fp32.  Without a softcap the
//     scale meets S only inside the exponent, p = 2^(s * scale * log2 e -
//     m * scale * log2 e), one FMA and one exp2 per score;
//   * O += P V by wgmma with P from registers (the S accumulator fragment
//     is the A fragment).  The TPU kernel keeps p in fp32; one bf16 rounding
//     of p would add errors of order 2^-9 * sum|p v| / l, beyond one bf16
//     ulp on outputs that cancel towards 0.  So p goes in as two terms,
//     P_hi = bf16(p) and P_lo = bf16(p - P_hi), which carry it to ~2^-17;
//     this costs 1.5x the flops of a single-rounded P;
//   * tiles wholly in the future (causal) or outside the window are never
//     loaded, and a warpgroup skips the tiles none of its rows can see;
//     masks are applied only on tiles that straddle a boundary;
//   * two instances a head dim: one reads q_offset, the other takes it as 0
//     (a whole prompt's prefill), so the offset costs a whole prompt
//     nothing;
//   * the output, acc / max(l, 1e-30) rounded once to bf16, is staged in
//     the warpgroup's own Q region (free once its last wgmma is done; 16-byte
//     chunks XOR-swizzled by row, so neither side conflicts on banks) and
//     stored as 16-byte vectors.
// Two plans of the same kernel (`Plan<HD>`):
//   * head dims 64 and 128: a 3-stage ring fed by one producer warp;
//   * head dim 256 (gemma2/3): a consumer thread holds O (64 x 256 fp32 over
//     a warpgroup: 128 registers), S (32) and P_hi/P_lo (32), past the ~170
//     registers a thread of 384 gets at launch.  So the producer is a whole
//     warpgroup that gives its registers away (`setmaxnreg.dec` to 24) and
//     the consumers take them (`setmaxnreg.inc` to 240: 2 x 128 x 240 +
//     128 x 24 = 64,512 of the SM's 65,536).  A 64 x 256 bf16 tile is 32
//     KB, so Q (2 x 32 KB) and a 2-stage K/V ring (4 x 32 KB) fill 192 KB
//     of the 227 KB a block may have; P V is one m64n256k16 per K-step.
//
// fp32 (`flash_prefill_kernel`): the tensor cores would reach fp32 only
// through TF32, a different function, so this route runs both contractions
// on CUDA cores in fp32 FMA:
//   * one block per (q tile of 32 rows, q head, batch); the TPU grid's
//     sequential KV axis, which carried the softmax state in VMEM scratch,
//     becomes a loop inside the block that carries (m, l, acc) in registers;
//   * each KV tile is staged once in shared memory and serves all 32 query
//     rows of the block;
//   * 8 threads share one query row, each owning dims d = c + 8*i, so the
//     shared-memory reads of a KV row hit 8 distinct banks and broadcast
//     across the 4 rows of a warp; the 8 partial dot products reduce with 3
//     shuffles;
//   * KV tiles of 32 rows, and of 16 at head dim 256 (gemma2/3), so the K/V
//     tiles stay at 32 KB of static shared memory (32 rows would need 64
//     KB, past the 48 KB static limit).
//
// Both routes: softcap is applied before the mask, masked scores are the
// finite -2e38 of the reference, masked probabilities are exactly 0, and
// the output is acc / max(l, 1e-30).  A ragged tail (Sq or Sk not a
// multiple of the tiles) is masked, so prompts of any length prefill; the
// TPU version asserts divisibility instead, and both compute the same
// function wherever both are defined.  Head dims 64, 128 and 256 have
// instances; the Python binding zero-pads a smaller head dim up to one.

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kNegInf = -2.0e38f;

// ------------------------------------------------------------ fp32 route

constexpr int kBQ = 32;            // query rows per block
constexpr int kSplit = 8;          // threads per query row
constexpr int kThreads = kBQ * kSplit;

// kBK: kv rows per tile (32, and 16 at head dim 256)
template <int HD, int kBK>
__global__ void __launch_bounds__(kThreads)
flash_prefill_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out, int Sq,
                     int Sk, int K, int G, int window, float scale,
                     float logit_cap, int causal, int q_offset) {
  constexpr int kDims = HD / kSplit;  // dims owned by one thread
  static_assert(2 * kBK * HD * sizeof(float) <= 48 * 1024,
                "K/V tiles past the static shared-memory limit");
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
  const int qp = q_offset + qi;      // its position

  float qv[kDims];
  float acc[kDims];
  const size_t q_off = (((size_t)b * Sq + qi) * H + h) * HD;
#pragma unroll
  for (int i = 0; i < kDims; ++i) {
    qv[i] = q_valid ? q[q_off + c + kSplit * i] * scale : 0.f;
    acc[i] = 0.f;
  }
  float m = kNegInf;
  float l = 0.f;

  // KV range this tile of queries can see (by position)
  const int q_last = q_offset + min(q0 + kBQ, Sq) - 1;
  const int k_hi = causal ? min(Sk, q_last + 1) : Sk;
  const int k_lo = window > 0 ? max(0, q_offset + q0 - window + 1) : 0;
  const size_t kv_row = (size_t)K * HD;
  const float* kb = k + (size_t)b * Sk * kv_row + (size_t)kh * HD;
  const float* vb = v + (size_t)b * Sk * kv_row + (size_t)kh * HD;

  for (int j0 = (k_lo / kBK) * kBK; j0 < k_hi; j0 += kBK) {
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < kBK * HD; idx += kThreads) {
      const int j = idx / HD;
      const int d = idx % HD;
      const bool in = j0 + j < Sk;
      k_s[j][d] = in ? kb[(size_t)(j0 + j) * kv_row + d] : 0.f;
      v_s[j][d] = in ? vb[(size_t)(j0 + j) * kv_row + d] : 0.f;
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
      if (causal) ok = ok && kj <= qp;
      if (window > 0) ok = ok && qp - kj < window;
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
      out[q_off + c + kSplit * i] = acc[i] / denom;
    }
  }
}

// ------------------------------------------------------------ bf16 route

namespace tc {

constexpr int kRows = 64;                  // query rows of a warpgroup
constexpr int kGroups = 2;                 // consumer warpgroups
constexpr int kBQ = kRows * kGroups;       // query rows of a block
constexpr int kBK = 64;                    // kv rows of a tile
constexpr int kConsumers = 128 * kGroups;  // threads of the warpgroups
constexpr int kBoxBytes = 64 * 128;        // one TMA box: 64 rows x 128 bytes
constexpr float kLog2e = 1.4426950408889634f;
// registers a thread keeps after `setmaxnreg` where the producer is a whole
// warpgroup: 2 x 128 x 240 + 128 x 24 = 64,512 <= 65,536
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

// The plan of the block at head dim HD, and its dynamic shared memory in
// bytes from a 1024-aligned base (the 128-byte swizzle repeats every 1024
// bytes).  Each warpgroup's Q region later stages its output.
template <int HD>
struct Plan {
  static constexpr bool kProducerGroup = HD == 256;  // a warpgroup, not a warp
  static constexpr int kStages = kProducerGroup ? 2 : 3;  // K/V tiles in flight
  static constexpr int kThreads = kConsumers + (kProducerGroup ? 128 : 32);
  static constexpr int kHalves = HD / 64;            // boxes across a row
  static constexpr int kTile = kHalves * kBoxBytes;  // 64 rows of one tensor
  static constexpr int q = 0;                        // [group][half] boxes
  static constexpr int k = q + kGroups * kTile;      // [stage][half]
  static constexpr int v = k + kStages * kTile;      // [stage][half]
  // mbarriers: Q loaded, K/V stage full, K/V stage empty
  static constexpr int bar = v + kStages * kTile;
  static constexpr int bytes = bar + (1 + 2 * kStages) * 8 + 1024;
  static_assert(bytes <= 232448, "past the shared memory of a block");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

// arrive once and expect `bytes` of TMA transactions in this phase
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// one box of a 4-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// K and V rows j0 .. j0 + 63 of kv head kh into `stage`, completing on `bar`
template <int kHalves>
__device__ __forceinline__ void load_kv(uint32_t k_smem, uint32_t v_smem,
                                        uint32_t bar, const CUtensorMap* tk,
                                        const CUtensorMap* tv, int stage,
                                        int j0, int kh, int b) {
  const uint32_t tile = kHalves * kBoxBytes;
  mbar_expect_tx(bar, 2 * tile);
#pragma unroll
  for (int hf = 0; hf < kHalves; ++hf) {
    tma_load(k_smem + stage * tile + hf * kBoxBytes, tk, bar, hf * 64, kh, j0,
             b);
    tma_load(v_smem + stage * tile + hf * kBoxBytes, tv, bar, hf * 64, kh, j0,
             b);
  }
}

// wgmma shared-memory descriptor, 128-byte swizzle.  K-major operands (Q,
// K): 8-row groups 1024 bytes apart (SBO), LBO unused; a K-step of 16 bf16
// moves the start address by 32 bytes inside the swizzle atom.  N-major
// operand (V): K-row groups of 8 are 1024 bytes apart (SBO) and the next 64
// columns of N start one box later (LBO).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// hand registers back to the SM's pool, or take them from it, for the
// whole warpgroup (every thread of it executes the instruction)
template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}
template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

// Keep the compiler from moving register reads or writes of a wgmma
// operand across the asynchronous instruction's issue and wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j]) :: "memory");
  }
}

// D (64 x 64, fp32) += A (64 x 16, smem) * B^T (B: 64 x 16, smem), both
// K-major, scale_d = 0 overwrites D
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32],
                                                   uint64_t desc_a,
                                                   uint64_t desc_b,
                                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D (64 x 64, fp32) += A (64 x 16, registers) * B (16 x 64, smem, N-major)
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32],
                                                   const uint32_t (&a)[4],
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(1));
}

// D (64 x 128, fp32) += A (64 x 16, registers) * B (16 x 128, smem, N-major)
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64],
                                                   const uint32_t (&a)[4],
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(1));
}

// D (64 x 256, fp32) += A (64 x 16, registers) * B (16 x 256, smem, N-major)
__device__ __forceinline__ void wgmma_m64n256k16_rs(float (&d)[128],
                                                   const uint32_t (&a)[4],
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(1));
}

template <int HD>
__device__ __forceinline__ void wgmma_pv(float (&o)[HD / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_v);
template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&o)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_v) {
  wgmma_m64n64k16_rs(o, a, desc_v);
}
template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&o)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t desc_v) {
  wgmma_m64n128k16_rs(o, a, desc_v);
}
template <>
__device__ __forceinline__ void wgmma_pv<256>(float (&o)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t desc_v) {
  wgmma_m64n256k16_rs(o, a, desc_v);
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// Accumulator fragments (wgmma m64nN, fp32): thread t of a warpgroup holds,
// for each 8-column chunk i, elements 4i + r at row 16 * (t / 32) +
// (t % 32) / 4 + 8 * (r >> 1) and column 8i + 2 * (t % 4) + (r & 1).
// kOffset: an instance that reads q_offset; the other takes it as 0, so a
// whole prompt's prefill keeps the code it had without the offset.
template <int HD, bool kOffset>
__global__ void __launch_bounds__(Plan<HD>::kThreads, 1)
flash_prefill_tc(__grid_constant__ const CUtensorMap tq,
                 __grid_constant__ const CUtensorMap tk,
                 __grid_constant__ const CUtensorMap tv,
                 __nv_bfloat16* __restrict__ out, int Sq, int Sk, int H,
                 int G, int window, float scale, float logit_cap,
                 int causal, int q_offset_arg) {
  using L = Plan<HD>;
  const int q_offset = kOffset ? q_offset_arg : 0;
  constexpr int kHalves = L::kHalves;
  constexpr int kStages = L::kStages;
  constexpr int kSteps = HD / 16;          // K-steps of Q K^T
  constexpr int kPSteps = kBK / 16;        // K-steps of P V
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;  // heaviest tile first
  const int kh = h / G;
  const int tid = threadIdx.x;
  const int grp = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int quad = lane % 4;
  const int g_lo = q0 + grp * kRows;               // the group's first row
  const int g_hi = min(g_lo + kRows, Sq) - 1;      // and last live row
  const bool live = g_lo < Sq;
  const int row0 = g_lo + warp * 16 + lane / 4;    // rows row0, row0 + 8
  const int pos_lo = q_offset + g_lo;              // their positions
  const int pos_hi = q_offset + g_hi;

  const uint32_t bar_q = base + L::bar;
  const uint32_t bar_full = bar_q + 8;             // + 8 * stage
  const uint32_t bar_empty = bar_full + 8 * kStages;

  // the kv tiles any row of the block can see (by position)
  const int q_last = q_offset + min(q0 + kBQ, Sq) - 1;
  const int k_hi = causal ? min(Sk, q_last + 1) : Sk;
  const int k_lo = window > 0 ? max(0, q_offset + q0 - window + 1) : 0;
  const int j_first = (k_lo / kBK) * kBK;
  const int n_tiles = k_hi > j_first ? (k_hi - j_first + kBK - 1) / kBK : 0;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bar_full + 8 * st, 1);
      mbar_init(bar_empty + 8 * st, kConsumers / 32);  // one arrival a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  // two roles that never meet again: `setmaxnreg` needs each warpgroup's
  // path to be known from here to the end
  if (tid >= kConsumers) {
    if constexpr (L::kProducerGroup) regs_dec<kProducerRegs>();
    // producer: Q, then every K/V tile as soon as its stage is empty
    if (tid == kConsumers) {
      const int groups = q0 + kRows < Sq ? 2 : 1;  // a group past Sq loads none
      mbar_expect_tx(bar_q, groups * L::kTile);
      for (int g = 0; g < groups; ++g) {
#pragma unroll
        for (int hf = 0; hf < kHalves; ++hf) {
          tma_load(base + L::q + (g * kHalves + hf) * kBoxBytes, &tq, bar_q,
                   hf * 64, h, q0 + g * kRows, b);
        }
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int stage = it % kStages;
        if (it >= kStages) {
          mbar_wait(bar_empty + 8 * stage, (it / kStages - 1) & 1);
        }
        load_kv<kHalves>(base + L::k, base + L::v, bar_full + 8 * stage, &tk,
                         &tv, stage, j_first + it * kBK, kh, b);
      }
    }
    return;
  }
  if constexpr (L::kProducerGroup) regs_inc<kConsumerRegs>();

  float o[HD / 2];
#pragma unroll
  for (int e = 0; e < HD / 2; ++e) o[e] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};                         // this thread's columns
  const uint32_t q_base = base + L::q + grp * L::kTile;
  if (live) mbar_wait(bar_q, 0);
  // scores stay in raw units (or capped ones) and meet log2 e and the scale
  // inside the exp2: p = 2^(x * unit - m * unit)
  const float unit = logit_cap != 0.f ? kLog2e : scale * kLog2e;

  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it % kStages;
    const int j0 = j_first + it * kBK;
    bool run = live;
    if (causal) run = run && j0 <= pos_hi;
    if (window > 0) run = run && j0 + kBK - 1 > pos_lo - window;
    // wait for the tile even where it is skipped: a release may only count
    // towards the fill it follows
    mbar_wait(bar_full + 8 * stage, (it / kStages) & 1);
    __syncwarp();
    if (run) {                                     // uniform across the group
      const uint32_t k_base = base + L::k + stage * L::kTile;
      const uint32_t v_base = base + L::v + stage * L::kTile;

      // S = Q K^T
      float s[kBK / 2];
#pragma unroll
      for (int e = 0; e < kBK / 2; ++e) s[e] = 0.f;
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
        wgmma_m64n64k16_ss(s, desc_sw128(q_base + off, 16, 1024),
                           desc_sw128(k_base + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);

      // the softcap (of the scaled score) in fp32, then the masks where the
      // tile straddles one; the online softmax state of rows row0, row0 + 8
      const bool inside = j0 + kBK <= Sk && g_hi == g_lo + kRows - 1 &&
                          (!causal || j0 + kBK - 1 <= pos_lo) &&
                          (window <= 0 || pos_hi - j0 < window);
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int e = 0; e < kBK / 2; ++e) {
        float x = s[e];
        if (logit_cap != 0.f) x = logit_cap * tanhf(x * scale / logit_cap);
        if (!inside) {
          const int qi = row0 + 8 * ((e >> 1) & 1);
          const int qp = q_offset + qi;
          const int kj = j0 + 8 * (e >> 2) + 2 * quad + (e & 1);
          bool ok = qi < Sq && kj < Sk;
          if (causal) ok = ok && kj <= qp;
          if (window > 0) ok = ok && qp - kj < window;
          x = ok ? x : kNegInf;
        }
        s[e] = x;
        mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], x);
      }
      float corr[2];
      float m_unit[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        corr[r] = exp2f((m[r] - m_new) * unit);
        m[r] = m_new;
        m_unit[r] = m_new * unit;
      }
      float sum[2] = {0.f, 0.f};
      if (inside) {                                // no score is masked
#pragma unroll
        for (int e = 0; e < kBK / 2; ++e) {
          s[e] = exp2f(fmaf(s[e], unit, -m_unit[(e >> 1) & 1]));
          sum[(e >> 1) & 1] += s[e];
        }
      } else {
#pragma unroll
        for (int e = 0; e < kBK / 2; ++e) {
          const int r = (e >> 1) & 1;
          s[e] = s[e] == kNegInf ? 0.f : exp2f(fmaf(s[e], unit, -m_unit[r]));
          sum[r] += s[e];
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + sum[r];
      // once the rows' maxima settle, corr is 1 and O needs no rescale
      if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
        for (int e = 0; e < HD / 2; ++e) o[e] *= corr[(e >> 1) & 1];
      }

      // P as A fragments, p = P_hi + P_lo to ~2^-17
      uint32_t p_hi[kPSteps][4];
      uint32_t p_lo[kPSteps][4];
#pragma unroll
      for (int kk = 0; kk < kPSteps; ++kk) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float x0 = s[8 * kk + 2 * j];
          const float x1 = s[8 * kk + 2 * j + 1];
          const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
          const float2 hf = __bfloat1622float2(hi);
          p_hi[kk][j] = bf16x2_bits(hi);
          p_lo[kk][j] = bf16x2_bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
        }
      }

      // O += P_hi V + P_lo V
      fence_regs(o);
      fence_regs(p_hi);
      fence_regs(p_lo);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kPSteps; ++kk) {
        const uint64_t dv = desc_sw128(v_base + kk * 16 * 128, kBoxBytes, 1024);
        wgmma_pv<HD>(o, p_hi[kk], dv);
        wgmma_pv<HD>(o, p_lo[kk], dv);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
      fence_regs(p_hi);
      fence_regs(p_lo);
    }
    __syncwarp();                                  // this warp is done with
    if (lane == 0) mbar_arrive(bar_empty + 8 * stage);  // the stage
  }

  if (!live) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
  // the output through the group's Q region, which its last wgmma has
  // read: row r's 16-byte chunk c at chunk c ^ (r % 8), so the fragment's
  // 8 rows of a store and the vector reads of a row hit distinct banks
  __nv_bfloat16* stage_o =
      reinterpret_cast<__nv_bfloat16*>(gbase + L::q + grp * L::kTile);
#pragma unroll
  for (int e = 0; e < HD / 2; e += 2) {
    const int r = (e >> 1) & 1;
    const int row = warp * 16 + lane / 4 + 8 * r;
    const int col = 8 * ((e >> 2) ^ (row & 7)) + 2 * quad;
    *reinterpret_cast<__nv_bfloat162*>(stage_o + row * HD + col) =
        __floats2bfloat162_rn(o[e] / l[r], o[e + 1] / l[r]);
  }
  asm volatile("bar.sync %0, 128;\n" :: "r"(grp + 1) : "memory");
  constexpr int kVecs = HD / 8;                    // 16-byte vectors per row
  for (int idx = tid % 128; idx < kRows * kVecs; idx += 128) {
    const int row = idx / kVecs;
    const int c = idx % kVecs;
    const int qi = g_lo + row;
    if (qi < Sq) {
      *reinterpret_cast<uint4*>(out + (((size_t)b * Sq + qi) * H + h) * HD +
                                c * 8) =
          *reinterpret_cast<const uint4*>(stage_o + row * HD +
                                          8 * (c ^ (row & 7)));
    }
  }
}

// cuTensorMapEncodeTiled, found through the runtime so the library needs
// no link against the driver library
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(ptr);
    }
  }
  return fn;
}

// (HD, heads, S, B) over a contiguous (B, S, heads, HD) bf16 tensor; boxes
// of 64 columns x 64 rows, swizzled as wgmma reads them
bool make_map(CUtensorMap* map, const void* ptr, int B, int S, int heads,
              int hd) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads,
                              (cuuint64_t)(S > 0 ? S : 1), (cuuint64_t)B};
  const cuuint64_t row = (cuuint64_t)hd * 2;
  const cuuint64_t strides[3] = {row, row * heads, row * heads * S};
  const cuuint32_t box[4] = {64, 1, 64, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD, bool kOffset>
int launch_tc(const CUtensorMap& tq, const CUtensorMap& tk,
              const CUtensorMap& tv, void* out, int B, int Sq, int Sk, int K,
              int G, int window, float scale, float logit_cap, int causal,
              int q_offset, cudaStream_t stream) {
  using L = Plan<HD>;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_prefill_tc<HD, kOffset>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, L::bytes);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const dim3 grid(K * G, B, (Sq + kBQ - 1) / kBQ);
  flash_prefill_tc<HD, kOffset><<<grid, L::kThreads, L::bytes, stream>>>(
      tq, tk, tv, (__nv_bfloat16*)out, Sq, Sk, K * G, G, window, scale,
      logit_cap, causal, q_offset);
  return (int)cudaGetLastError();
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Sk, int K, int G, int window, float scale,
           float logit_cap, int causal, int q_offset, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, B, Sq, K * G, HD) ||
      !make_map(&tk, k, B, Sk, K, HD) || !make_map(&tv, v, B, Sk, K, HD)) {
    return (int)cudaErrorInvalidValue;
  }
  if (q_offset) {
    return launch_tc<HD, true>(tq, tk, tv, out, B, Sq, Sk, K, G, window,
                               scale, logit_cap, causal, q_offset, stream);
  }
  return launch_tc<HD, false>(tq, tk, tv, out, B, Sq, Sk, K, G, window,
                              scale, logit_cap, causal, 0, stream);
}

}  // namespace tc

template <int HD, int kBK>
void launch_cc(const void* q, const void* k, const void* v, void* out, int B,
               int Sq, int Sk, int K, int G, int window, float scale,
               float logit_cap, int causal, int q_offset,
               cudaStream_t stream) {
  const dim3 grid((Sq + kBQ - 1) / kBQ, K * G, B);
  flash_prefill_kernel<HD, kBK><<<grid, kThreads, 0, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, Sq, Sk,
      K, G, window, scale, logit_cap, causal, q_offset);
}

}  // namespace

// dtype: 0 = float32 (CUDA-core route), 1 = bfloat16 (tensor-core route;
// every pointer 16-byte aligned); hd in {64, 128, 256} (the Python wrapper
// pads a smaller head dim up to one of them and checks the rest); query row
// i at position q_offset + i (>= 0).  Returns cudaGetLastError() after the
// launch.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int B, int Sq,
                                     int Sk, int K, int G, int hd, int window,
                                     float scale, float logit_cap, int causal,
                                     int q_offset, int dtype, void* stream) {
  if (hd != 64 && hd != 128 && hd != 256) return (int)cudaErrorInvalidValue;
  if (q_offset < 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0 || K == 0 || G == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    if (hd == 64) {
      launch_cc<64, 32>(q, k, v, out, B, Sq, Sk, K, G, window, scale,
                        logit_cap, causal, q_offset, s);
    } else if (hd == 128) {
      launch_cc<128, 32>(q, k, v, out, B, Sq, Sk, K, G, window, scale,
                         logit_cap, causal, q_offset, s);
    } else {
      launch_cc<256, 16>(q, k, v, out, B, Sq, Sk, K, G, window, scale,
                         logit_cap, causal, q_offset, s);
    }
    return (int)cudaGetLastError();
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  const uintptr_t align = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v |
                          (uintptr_t)out;
  if (align % 16) return (int)cudaErrorMisalignedAddress;
  if (hd == 64) {
    return tc::launch<64>(q, k, v, out, B, Sq, Sk, K, G, window, scale,
                          logit_cap, causal, q_offset, s);
  }
  if (hd == 128) {
    return tc::launch<128>(q, k, v, out, B, Sq, Sk, K, G, window, scale,
                           logit_cap, causal, q_offset, s);
  }
  return tc::launch<256>(q, k, v, out, B, Sq, Sk, K, G, window, scale,
                         logit_cap, causal, q_offset, s);
}
