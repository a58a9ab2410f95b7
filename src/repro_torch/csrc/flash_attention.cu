// Flash attention (forward, online softmax) of the PyTorch port, written by
// hand for Hopper (sm_90a).  It replaces the Pallas kernel of the JAX
// package's kernels/flash_attention.py (_kernel, launched by
// flash_attention) and computes the same function:
//
//   q (B, H, Sq, D), k and v (B, Hkv, Sk, D), Hkv | H; query head h of
//   batch b reads kv head h / (H / Hkv) of batch b (K/V never expanded);
//   s    = (q . k) * scale, then softcap * tanh(s / softcap) if a softcap;
//   mask = col < Sk  &  (causal: col <= row)  &  (window > 0: row-col < window)
//   masked scores are NEG_BIG and their p is 0 by a select, not by exp;
//   m_new = max(m, rowmax(s)), alpha = exp(m - m_new), p = exp(s - m_new),
//   l = alpha * l + sum(p), acc = alpha * acc + p . v   (all f32);
//   o = acc / max(l, 1e-30) in the input dtype, so a row with no valid key
//   outputs 0.  D is a multiple of 8 up to 256.
//
// Two kernels, chosen by dtype (flash_attention_bf16 / flash_attention_f32):
//
// * bf16: flash_wgmma_kernel, on the tensor cores.  At serving shapes
//   (llama3.2-1b prefill, D = 64, S = 1024) the work is 4 * D FLOPs per kept
//   (row, key) pair, far above the bytes of q, k, v and o, so the bound is
//   dense bf16 tensor-core FLOPs (989 TFLOP/s); at D = 64 the softmax's
//   per-element work (one MUFU ex2 per score) competes with the products.
//   Work items are (batch * head, 128-query block) pairs, longest causal
//   rows first; one persistent CTA per SM walks its items in a snake
//   order.  Warpgroup 0 is the producer (one thread starts every TMA load, the
//   warpgroup gives its registers away with setmaxnreg); warpgroups 1 and
//   2 are consumers of 64 query rows each.  Q (128 rows) is loaded once an
//   item, into a buffer freed as soon as the item's last Q.K^T is read;
//   K and V tiles of BK keys (128 at D <= 128, 64 above) stream through a
//   ring of 3 stages (2 at D > 192) signalled by mbarriers, across items.
//   Every tile lives in shared memory as 64-column chunks of 128-byte rows
//   with the 128-byte swizzle, as TMA writes them and as the wgmma
//   descriptors read them.  GQA is the kv-head coordinate of the K/V
//   tensor maps; TMA's zero fill pads keys beyond Sk (masked), rows beyond
//   Sq (never stored) and D up to the 64-column chunk (zero columns add
//   nothing to q . k; output columns past D are not stored).
//   S = Q.K^T is wgmma m64nBKk16 with A (Q) and B (K, K-major) in shared
//   memory; the softmax runs on the accumulator fragment in registers (a
//   thread holds rows r and r + 8 of its warp's 16; a row's four threads
//   are a quad, reduced by two shuffles), in the log2 domain with the
//   MUFU's ex2; softcap and mask are chosen once per tile, so the element
//   loop has no branch, and the mask is applied only on blocks that cross
//   the diagonal, the window edge or Sk.  Blocks wholly outside the causal
//   triangle or the window are not visited (tile_schedule in
//   kernels/flash_attention.py gives the same blocks).  P is rounded to
//   bf16 in registers, where the accumulator fragment is already the
//   A-operand fragment of the next product, and O += P.V is wgmma
//   m64n64k16 per 64-column chunk of D with V (MN-major, the transpose
//   bit) from shared memory.  Each consumer overlaps the P.V of tile j - 1
//   with the Q.K^T and softmax of tile j.  Tensor maps are encoded on the
//   host by cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint,
//   so the library does not link -lcuda.
//
// * f32: flash_fwd_kernel, SIMT on the CUDA cores (TF32 would break the f32
//   tolerance of 2e-5, and f32 is not on the serving path).  One CTA per
//   (batch * head, 64-row query block), 8 warps of 8 query rows each; a
//   loop over 64-key blocks stages K and V in shared memory (K rows padded
//   to D + 1 floats, so lane j reading key j is free of bank conflicts);
//   lane j scores keys j and j + 32 for the warp's rows, the row max and
//   sum are warp reductions, p goes through shared memory, and lane i
//   accumulates output columns i, i + 32, ... of its warp's rows in
//   registers.  Same skipped blocks, tails masked in the kernel.
//
// Offsets are 64-bit.  No fast math: the bf16 kernel's ex2.approx (2 ulp)
// and FMA contraction are inside its 2e-2 tolerance, the SIMT kernel uses
// expf.  Every entry point returns cudaGetLastError().

#include <algorithm>
#include <cfloat>
#include <climits>
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kNegBig = static_cast<float>(-0.7 * static_cast<double>(FLT_MAX));

// ---------------------------------------------------------------------------
// f32: the SIMT kernel
// ---------------------------------------------------------------------------

namespace simt {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 8;                    // query rows per warp
constexpr int kBlockQ = kWarps * kRows;     // 64 query rows per CTA
constexpr int kBlockK = 64;                 // keys per staged tile
constexpr int kKeysPerLane = kBlockK / 32;

// Dynamic shared memory of one CTA: Q [kBlockQ][D], K [kBlockK][D + 1],
// V [kBlockK][D], P [kBlockQ][kBlockK], all f32.
inline size_t smem_bytes(int D) {
  return sizeof(float) * (static_cast<size_t>(kBlockQ) * D +
                          static_cast<size_t>(kBlockK) * (D + 1) +
                          static_cast<size_t>(kBlockK) * D +
                          static_cast<size_t>(kBlockQ) * kBlockK);
}

// NA = ceil(D / 32): output columns each lane accumulates per row.
template <int NA>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o, long long BH, int H,
    int Hkv, int Sq, int Sk, int D, int n_qb, int causal, int window,
    int has_softcap, float softcap, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBlockQ * D;
  float* Vs = Ks + kBlockK * (D + 1);
  float* Ps = Vs + kBlockK * D;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // The last query blocks (the longest causal rows) are scheduled first.
  const long long bh = static_cast<long long>(blockIdx.x) % BH;
  const int qb = n_qb - 1 - static_cast<int>(blockIdx.x / BH);
  const int q0 = qb * kBlockQ;
  const long long kvh =
      (bh / H) * Hkv + static_cast<long long>(bh % H) / (H / Hkv);
  const float* qp = q + (bh * Sq + q0) * D;
  const float* kp = k + kvh * Sk * D;
  const float* vp = v + kvh * Sk * D;

  const int q_rows = min(kBlockQ, Sq - q0);
  for (int e = tid; e < kBlockQ * D; e += kThreads) {
    Qs[e] = e / D < q_rows ? qp[e] : 0.f;
  }

  int kb_begin = 0;
  int kb_end = (Sk + kBlockK - 1) / kBlockK;
  if (causal) kb_end = min(kb_end, (q0 + kBlockQ - 1) / kBlockK + 1);
  if (window > 0) kb_begin = max(0, q0 - window + 1) / kBlockK;

  const int row0 = q0 + warp * kRows;
  const float* Qw = Qs + warp * kRows * D;
  float* Pw = Ps + warp * kRows * kBlockK;
  float m[kRows], l[kRows], acc[kRows][NA];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegBig;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < NA; ++i) acc[r][i] = 0.f;
  }

  for (int kb = kb_begin; kb < kb_end; ++kb) {
    const int c0 = kb * kBlockK;
    const int k_rows = min(kBlockK, Sk - c0);
    __syncthreads();  // the previous tile is consumed (and Q is staged)
    for (int e = tid; e < kBlockK * D; e += kThreads) {
      const int j = e / D;
      const int d = e - j * D;
      const long long g = static_cast<long long>(c0 + j) * D + d;
      const bool in = j < k_rows;
      Ks[j * (D + 1) + d] = in ? kp[g] : 0.f;
      Vs[e] = in ? vp[g] : 0.f;
    }
    __syncthreads();

    // scores of the warp's rows against keys lane and lane + 32
    float s[kRows][kKeysPerLane];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int kk = 0; kk < kKeysPerLane; ++kk) s[r][kk] = 0.f;
    for (int d = 0; d < D; d += 4) {
      float kv[kKeysPerLane][4];
#pragma unroll
      for (int kk = 0; kk < kKeysPerLane; ++kk) {
        const float* kr = Ks + (lane + 32 * kk) * (D + 1) + d;
#pragma unroll
        for (int t = 0; t < 4; ++t) kv[kk][t] = kr[t];
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(Qw + r * D + d);
#pragma unroll
        for (int kk = 0; kk < kKeysPerLane; ++kk) {
          s[r][kk] += qv.x * kv[kk][0] + qv.y * kv[kk][1] +
                      qv.z * kv[kk][2] + qv.w * kv[kk][3];
        }
      }
    }

    // online softmax update of each row
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = row0 + r;
      float x[kKeysPerLane];
      bool ok[kKeysPerLane];
      float mx = kNegBig;
#pragma unroll
      for (int kk = 0; kk < kKeysPerLane; ++kk) {
        const int col = c0 + lane + 32 * kk;
        float t = s[r][kk] * scale;
        if (has_softcap) t = softcap * tanhf(t / softcap);
        bool valid = col < Sk;
        if (causal) valid = valid && col <= row;
        if (window > 0) valid = valid && (row - col) < window;
        ok[kk] = valid;
        x[kk] = valid ? t : kNegBig;
        mx = fmaxf(mx, x[kk]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      const float m_new = fmaxf(m[r], mx);
      float psum = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKeysPerLane; ++kk) {
        const float p = ok[kk] ? expf(x[kk] - m_new) : 0.f;
        Pw[r * kBlockK + lane + 32 * kk] = p;
        psum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        psum += __shfl_xor_sync(kFull, psum, off);
      const float alpha = expf(m[r] - m_new);
      l[r] = alpha * l[r] + psum;
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < NA; ++i) acc[r][i] *= alpha;
    }
    __syncwarp();

    // acc += p . v
    for (int j = 0; j < kBlockK; j += 4) {
      float4 pv[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        pv[r] = *reinterpret_cast<const float4*>(Pw + r * kBlockK + j);
#pragma unroll
      for (int i = 0; i < NA; ++i) {
        const int d = lane + 32 * i;
        if (d < D) {
          const float v0 = Vs[j * D + d];
          const float v1 = Vs[(j + 1) * D + d];
          const float v2 = Vs[(j + 2) * D + d];
          const float v3 = Vs[(j + 3) * D + d];
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            acc[r][i] +=
                pv[r].x * v0 + pv[r].y * v1 + pv[r].z * v2 + pv[r].w * v3;
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = row0 + r;
    if (row >= Sq) continue;
    const float den = fmaxf(l[r], 1e-30f);
    float* orow = o + (bh * Sq + row) * D;
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const int d = lane + 32 * i;
      if (d < D) orow[d] = acc[r][i] / den;
    }
  }
}

template <int NA>
int launch(void* stream, const void* q, const void* k, const void* v,
           void* o, int B, int H, int Hkv, int Sq, int Sk, int D, int causal,
           int window, int has_softcap, float softcap, float scale) {
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<NA>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qb = (Sq + kBlockQ - 1) / kBlockQ;
  const long long BH = static_cast<long long>(B) * H;
  if (BH * n_qb > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  flash_fwd_kernel<NA><<<static_cast<unsigned>(BH * n_qb), kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), BH, H, Hkv, Sq,
      Sk, D, n_qb, causal, window, has_softcap, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(void* stream, const void* q, const void* k, const void* v,
             void* o, int B, int H, int Hkv, int Sq, int Sk, int D,
             int causal, int window, int has_softcap, float softcap,
             float scale) {
#define FLASH_CASE(NA)                                                       \
  case NA:                                                                   \
    return launch<NA>(stream, q, k, v, o, B, H, Hkv, Sq, Sk, D, causal,      \
                      window, has_softcap, softcap, scale);
  switch ((D + 31) / 32) {
    FLASH_CASE(1)
    FLASH_CASE(2)
    FLASH_CASE(3)
    FLASH_CASE(4)
    FLASH_CASE(5)
    FLASH_CASE(6)
    FLASH_CASE(7)
    FLASH_CASE(8)
  }
#undef FLASH_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace simt

// ---------------------------------------------------------------------------
// bf16: the wgmma kernel
// ---------------------------------------------------------------------------

namespace hopper {

constexpr int kBlockQ = 128;        // two consumer warpgroups of 64 rows
constexpr int kThreads = 3 * 128;   // producer warpgroup + 2 consumers
constexpr int kCols = 64;           // bf16 columns of one 128-byte row
constexpr int kRowBytes = 128;
constexpr int kAtomBytes = 8 * kRowBytes;  // one 8-row swizzle atom
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of one CTA, in bytes from a 1024-aligned base: Q
// [NC][kBlockQ][64], K and V [stages][NC][BK][64] each (bf16, 128-byte
// swizzle), then the mbarriers: Q full and empty, full K and full V per
// stage, empty per stage.  NC = ceil(D / 64) chunks of 64 columns.  Three
// stages let the producer load tile j + 1 while tiles j - 1 (V) and j (K)
// are in use; at D > 192 only two fit.
template <int NC>
struct Layout {
  static constexpr int BK = NC <= 2 ? 128 : 64;  // keys per tile
  static constexpr int stages = NC <= 3 ? 3 : 2;
  static constexpr int q_chunk = kBlockQ * kRowBytes;
  static constexpr int q_bytes = NC * q_chunk;
  static constexpr int kv_chunk = BK * kRowBytes;
  static constexpr int kv_bytes = NC * kv_chunk;  // one K or one V tile
  static constexpr int k_off = q_bytes;
  static constexpr int v_off = k_off + stages * kv_bytes;
  static constexpr int bar_off = v_off + stages * kv_bytes;
  static constexpr int bytes = bar_off + (2 + 3 * stages) * 8;
  static constexpr int alloc = bytes + 1024;  // room to align the base
  static_assert(alloc <= 232448, "shared memory of one CTA");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One TMA box of a 3-D tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// wgmma descriptor of a tile in 128-byte-swizzled shared memory (layout
// type 1): start address, leading and stride byte offsets, all >> 4.  The
// stride byte offset is the step between 8-row atoms (1024 bytes); the
// leading one is unused by the operands below (K-major, or MN-major 64
// columns wide), set to the atom as well.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(kAtomBytes >> 4) << 16 |
         static_cast<uint64_t>(kAtomBytes >> 4) << 32 | 1ull << 62;
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
__device__ __forceinline__ void wgmma_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}
// Keep the compiler from moving reads or writes of accumulator registers
// across the asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int NC>
__device__ __forceinline__ void fence_acc(float (&acc)[NC][32]) {
#pragma unroll
  for (int c = 0; c < NC; ++c) fence_regs(acc[c]);
}
// The same for the A-operand registers of P . V: they must stay as they
// are until the product has read them.
template <int N>
__device__ __forceinline__ void fence_pa(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// d[0:32] (+)= A (64x16, smem) . B (64x16, smem, K-major)
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da,
                                              uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// d[0:64] (+)= A (64x16, smem) . B (128x16, smem, K-major)
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da,
                                              uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

// d[0:32] += A (64x16, registers) . B (16x64, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(1));
}

// S = Q . K^T of one tile: wgmma m64nBKk16 over D in steps of 16 columns
// (32 bytes within a 128-byte row, then the next 64-column chunk).
template <int NC, int BK>
__device__ __forceinline__ void mma_qk(float (&sc)[BK / 2], uint32_t q_rows,
                                         uint32_t ks) {
#pragma unroll
  for (int kk = 0; kk < 4 * NC; ++kk) {
    const uint32_t off = (kk / 4) * Layout<NC>::q_chunk + (kk % 4) * 32;
    const uint32_t koff = (kk / 4) * Layout<NC>::kv_chunk + (kk % 4) * 32;
    if constexpr (BK == 128) {
      wgmma_ss_n128(sc, sw128_desc(q_rows + off), sw128_desc(ks + koff),
                    kk > 0);
    } else {
      wgmma_ss_n64(sc, sw128_desc(q_rows + off), sw128_desc(ks + koff),
                   kk > 0);
    }
  }
}

// O += P . V of one tile: per 16 keys (16 rows of 128 bytes), per 64
// columns of D.
template <int NC, int BK>
__device__ __forceinline__ void mma_pv(float (&acc)[NC][32],
                                         const uint32_t (&pa)[BK / 16][4],
                                         uint32_t vs) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int c = 0; c < NC; ++c)
      wgmma_rs_n64(acc[c], pa[kk],
                   sw128_desc(vs + c * Layout<NC>::kv_chunk +
                              kk * 16 * kRowBytes));
}

// 2^x on the MUFU unit (denormal results flush to 0: such p add nothing)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Online softmax on one tile's fragment (element i of a thread: row
// row0 + 8 * ((i / 2) % 2), column c0 + 8 * (i / 4) + colq + i % 2), in
// the log2 domain.  Leaves p in sc, updates m and l, and gives the factor
// alpha of each of the thread's two rows.  CAP and MASK are decided once
// per tile, so the element loop has no branch.  With MASK, row r keeps
// the columns in [lo, hi): hi = Sk, or row + 1 if causal and less; lo =
// row - window + 1 with a window.
template <int BK, bool CAP, bool MASK>
__device__ __forceinline__ void softmax_tile(
    float (&sc)[BK / 2], float (&m)[2], float (&l)[2], float (&alpha)[2],
    int row0, int c0, int colq, int Sk, int causal, int window, float mul,
    float cap) {
  int lo[2], hi[2];  // relative to the thread's first column c0 + colq
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    hi[r] = (causal ? min(Sk, row + 1) : Sk) - c0 - colq;
    lo[r] = (window > 0 ? row - window + 1 : INT_MIN / 2) - c0 - colq;
  }
  // four independent chains per row for the max and the sum
  float mx[2][4], ps[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) mx[r][c] = kNegBig, ps[r][c] = 0.f;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    const int r = (i / 2) % 2, col = 8 * (i / 4) + i % 2;
    float x = sc[i] * mul;
    if constexpr (CAP) x = cap * tanhf(x);
    if constexpr (MASK) x = col >= lo[r] && col < hi[r] ? x : kNegBig;
    sc[i] = x;
    mx[r][(i / 4) % 4] = fmaxf(mx[r][(i / 4) % 4], x);
  }
  float mr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mr[r] = fmaxf(fmaxf(mx[r][0], mx[r][1]), fmaxf(mx[r][2], mx[r][3]));
    mr[r] = fmaxf(mr[r], __shfl_xor_sync(kFull, mr[r], 1));
    mr[r] = fmaxf(mr[r], __shfl_xor_sync(kFull, mr[r], 2));
    const float m_new = fmaxf(m[r], mr[r]);
    alpha[r] = ex2(m[r] - m_new);
    m[r] = m_new;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    const int r = (i / 2) % 2, col = 8 * (i / 4) + i % 2;
    float p = ex2(sc[i] - m[r]);
    if constexpr (MASK) p = col >= lo[r] && col < hi[r] ? p : 0.f;
    ps[r][(i / 4) % 4] += p;
    sc[i] = p;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
    l[r] += (ps[r][0] + ps[r][1]) + (ps[r][2] + ps[r][3]);
}

// The mask only where the block reaches past Sk, crosses the diagonal or
// reaches the window edge (kernels/flash_attention.py tile_schedule).
template <int BK>
__device__ __forceinline__ void softmax(
    float (&sc)[BK / 2], float (&m)[2], float (&l)[2], float (&alpha)[2],
    int q0, int row0, int c0, int colq, int Sk, int causal, int window,
    int has_softcap, float mul, float cap) {
  const bool masked = c0 + BK > Sk || (causal && c0 + BK - 1 > q0) ||
                      (window > 0 && q0 + kBlockQ - 1 - c0 >= window);
  if (has_softcap) {
    if (masked)
      softmax_tile<BK, true, true>(sc, m, l, alpha, row0, c0, colq, Sk,
                                   causal, window, mul, cap);
    else
      softmax_tile<BK, true, false>(sc, m, l, alpha, row0, c0, colq, Sk,
                                    causal, window, mul, cap);
  } else {
    if (masked)
      softmax_tile<BK, false, true>(sc, m, l, alpha, row0, c0, colq, Sk,
                                    causal, window, mul, cap);
    else
      softmax_tile<BK, false, false>(sc, m, l, alpha, row0, c0, colq, Sk,
                                     causal, window, mul, cap);
  }
}

// P in bf16: the fragment of 16 columns kk is the A operand of the k-step
// kk of P . V, accumulator registers {i, i + 1} packed as a bf16 pair.
template <int BK>
__device__ __forceinline__ void pack_p(const float (&sc)[BK / 2],
                                       uint32_t (&pa)[BK / 16][4]) {
#pragma unroll
  for (int i = 0; i < BK / 2; i += 2) {
    const __nv_bfloat162 pr = __floats2bfloat162_rn(sc[i], sc[i + 1]);
    pa[i / 8][(i % 8) / 2] = *reinterpret_cast<const uint32_t*>(&pr);
  }
}

// One work item: a (batch * head, 128-query block) pair and its key
// blocks (kernels/flash_attention.py tile_schedule).  Items are numbered
// longest causal rows first: the last query blocks of every head lead.
struct Work {
  int bh, q0, kvh, kb_begin, n_tiles;
};

__device__ __forceinline__ Work work_item(int w, int BH, int H, int Hkv,
                                          int Sk, int n_qb, int causal,
                                          int window, int BK) {
  Work it;
  it.bh = w % BH;
  it.q0 = (n_qb - 1 - w / BH) * kBlockQ;
  it.kvh = (it.bh / H) * Hkv + (it.bh % H) / (H / Hkv);
  const int n_kb = (Sk + BK - 1) / BK;
  it.kb_begin = window > 0 ? max(0, it.q0 - window + 1) / BK : 0;
  const int kb_end =
      causal ? min(n_kb, (it.q0 + kBlockQ - 1) / BK + 1) : n_kb;
  it.n_tiles = max(0, kb_end - it.kb_begin);
  return it;
}

// The j-th work item of this CTA: round j of the grid over the items,
// in a snake order (odd rounds backwards), so that a CTA that took one of
// the longest items of a round takes one of the shortest of the next.
__device__ __forceinline__ int work_index(int j) {
  return j * gridDim.x +
         ((j & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
}

// Persistent: one CTA per SM walks its work items; the producer loads the
// next item's Q and first tiles while the consumers finish the current
// one.
template <int NC>
__global__ void __launch_bounds__(kThreads, 1) flash_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o,
    int BH, int H, int Hkv, int Sq, int Sk, int D, int n_qb, int causal,
    int window, int has_softcap, float softcap, float scale) {
  using L = Layout<NC>;
  constexpr int BK = L::BK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base, k_s = base + L::k_off, v_s = base + L::v_off;
  const uint32_t q_full = base + L::bar_off, q_empty = q_full + 8;
  const uint32_t full_k = q_empty + 8, full_v = full_k + 8 * L::stages;
  const uint32_t empty = full_v + 8 * L::stages;
  const int n_work = BH * n_qb;

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 2 * 128);  // every consumer thread
    for (int s = 0; s < L::stages; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty + 8 * s, 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    // ---- producer warpgroup: one thread starts every load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == 0) {
      int tile = 0;  // tiles loaded so far, over all items
      int j = 0;
      for (int w = work_index(0); w < n_work; w = work_index(++j)) {
        const Work it = work_item(w, BH, H, Hkv, Sk, n_qb, causal, window, BK);
        // the consumers are done with the Q before (the first passes)
        mbar_wait(q_empty, (j & 1) ^ 1);
        mbar_expect_tx(q_full, L::q_bytes);
#pragma unroll
        for (int c = 0; c < NC; ++c)
          tma_load_3d(q_s + c * L::q_chunk, &tm_q, q_full, c * kCols, it.q0,
                      it.bh);
        for (int t = 0; t < it.n_tiles; ++t, ++tile) {
          const int s = tile % L::stages;
          // the first round finds every stage empty
          mbar_wait(empty + 8 * s, ((tile / L::stages) & 1) ^ 1);
          const int c0 = (it.kb_begin + t) * BK;
          const uint32_t ks = k_s + s * L::kv_bytes;
          const uint32_t vs = v_s + s * L::kv_bytes;
          mbar_expect_tx(full_k + 8 * s, L::kv_bytes);
#pragma unroll
          for (int c = 0; c < NC; ++c)
            tma_load_3d(ks + c * L::kv_chunk, &tm_k, full_k + 8 * s,
                        c * kCols, c0, it.kvh);
          mbar_expect_tx(full_v + 8 * s, L::kv_bytes);
#pragma unroll
          for (int c = 0; c < NC; ++c)
            tma_load_3d(vs + c * L::kv_chunk, &tm_v, full_v + 8 * s,
                        c * kCols, c0, it.kvh);
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int t = tid % 128;
    const int g = tid / 128 - 1;
    const int lane = t % 32;
    const int colq = 2 * (lane % 4);
    const uint32_t q_rows = q_s + 64 * g * kRowBytes;
    // log2-domain scores: x = s * scale * log2(e), or with a softcap
    // softcap * log2(e) * tanh(s * scale / softcap)
    const float mul = has_softcap ? scale / softcap : scale * kLog2e;
    const float cap = softcap * kLog2e;
    int tile0 = 0;  // tiles consumed before this item
    int j = 0;
    for (int w = work_index(0); w < n_work; w = work_index(++j)) {
      const Work item = work_item(w, BH, H, Hkv, Sk, n_qb, causal, window, BK);
      const int bh = item.bh, q0 = item.q0, kb_begin = item.kb_begin;
      const int n_tiles = item.n_tiles;
      // Accumulator fragment: element i of a thread lies in row
      // row0 + 8 * ((i / 2) % 2) and column 8 * (i / 4) + colq + i % 2.
      const int row0 = q0 + 64 * g + 16 * (t / 32) + lane / 4;

      float acc[NC][32];
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
      float m[2] = {kNegBig, kNegBig}, l[2] = {0.f, 0.f};

      // Pipelined per warpgroup: while P.V of tile it - 1 runs on the
      // tensor cores, Q.K^T of tile it runs and its softmax is computed.
      float sc[BK / 2];         // scores, then p, of the newest tile
      uint32_t pa[BK / 16][4];  // p of the tile before, bf16, the A operand
      float alpha[2];
      mbar_wait(q_full, j & 1);
      if (n_tiles == 0) {
        mbar_arrive(q_empty);
      } else {
        // tile 0: S and its softmax
        int s = tile0 % L::stages;
        mbar_wait(full_k + 8 * s, (tile0 / L::stages) & 1);
        fence_regs(sc);
        wgmma_fence();
        mma_qk<NC, BK>(sc, q_rows, k_s + s * L::kv_bytes);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sc);
        if (n_tiles == 1) mbar_arrive(q_empty);  // the item's Q is read
        softmax<BK>(sc, m, l, alpha, q0, row0, kb_begin * BK, colq, Sk,
                         causal, window, has_softcap, mul, cap);
        pack_p<BK>(sc, pa);
        // tiles 1 ...: S of tile it beside P . V of tile it - 1
        for (int it = 1; it < n_tiles; ++it) {
          const int tile = tile0 + it;
          const int prev = s;
          s = tile % L::stages;
          mbar_wait(full_k + 8 * s, (tile / L::stages) & 1);
          mbar_wait(full_v + 8 * prev, ((tile - 1) / L::stages) & 1);
          fence_regs(sc);
          fence_acc(acc);
          fence_pa(pa);
          wgmma_fence();
          mma_qk<NC, BK>(sc, q_rows, k_s + s * L::kv_bytes);
          wgmma_commit();
          mma_pv<NC, BK>(acc, pa, v_s + prev * L::kv_bytes);
          wgmma_commit();
          wgmma_wait_one();  // Q . K^T done; P . V may still run
          fence_regs(sc);
          if (it == n_tiles - 1) mbar_arrive(q_empty);
          softmax<BK>(sc, m, l, alpha, q0, row0, (kb_begin + it) * BK,
                           colq, Sk, causal, window, has_softcap, mul, cap);
          wgmma_wait_all();  // P . V done: its stage is free
          fence_acc(acc);
          fence_pa(pa);
          mbar_arrive(empty + 8 * prev);
#pragma unroll
          for (int c = 0; c < NC; ++c)
#pragma unroll
            for (int i = 0; i < 32; ++i) acc[c][i] *= alpha[(i / 2) % 2];
          pack_p<BK>(sc, pa);
        }
        // P . V of the last tile
        const int last = tile0 + n_tiles - 1;
        mbar_wait(full_v + 8 * s, (last / L::stages) & 1);
        fence_acc(acc);
        fence_pa(pa);
        wgmma_fence();
        mma_pv<NC, BK>(acc, pa, v_s + s * L::kv_bytes);
        wgmma_commit();
        wgmma_wait_all();
        fence_acc(acc);
        mbar_arrive(empty + 8 * s);
      }

      // o = acc / max(l, 1e-30): rows below Sq, columns below D
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(kFull, l[r], 1);
        l[r] += __shfl_xor_sync(kFull, l[r], 2);
        l[r] = fmaxf(l[r], 1e-30f);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        if (row >= Sq) continue;
        __nv_bfloat16* orow = o + (static_cast<long long>(bh) * Sq + row) * D;
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const int col = c * kCols + 8 * jj + colq;
            if (col < D)
              *reinterpret_cast<__nv_bfloat162*>(orow + col) =
                  __floats2bfloat162_rn(acc[c][4 * jj + 2 * r] / l[r],
                                        acc[c][4 * jj + 2 * r + 1] / l[r]);
          }
      }
      tile0 += n_tiles;
    }
  }
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no -lcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

cudaError_t encoder(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (cached == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || p == nullptr)
      return cudaErrorNotSupported;
    cached = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = cached;
  return cudaSuccess;
}

// Tensor map over a contiguous bf16 (heads, S, D) tensor as (D, S, heads):
// boxes of 64 columns x `rows` rows x 1 head, 128-byte swizzle, elements
// out of bounds read as 0.
bool encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int D, int S,
            long long heads, int rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(S) * D * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(kCols),
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NC>
int launch(void* stream, const void* q, const void* k, const void* v,
           void* o, int B, int H, int Hkv, int Sq, int Sk, int D, int causal,
           int window, int has_softcap, float softcap, float scale) {
  using L = Layout<NC>;
  EncodeTiled fn;
  cudaError_t err = encoder(&fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long BH = static_cast<long long>(B) * H;
  const int n_qb = (Sq + kBlockQ - 1) / kBlockQ;
  if (BH * n_qb > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tm_q, tm_k, tm_v;
  if (!encode(fn, &tm_q, q, D, Sq, BH, kBlockQ) ||
      !encode(fn, &tm_k, k, D, Sk, static_cast<long long>(B) * Hkv, L::BK) ||
      !encode(fn, &tm_v, v, D, Sk, static_cast<long long>(B) * Hkv, L::BK))
    return static_cast<int>(cudaErrorInvalidValue);
  // the shared-memory limit is a per-device attribute: set it once each
  static uint64_t devices_set = 0;
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64 || !(devices_set >> dev & 1)) {
    err = cudaFuncSetAttribute(flash_wgmma_kernel<NC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               L::alloc);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) devices_set |= 1ull << dev;
  }
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long grid = std::min<long long>(BH * n_qb, sms);
  flash_wgmma_kernel<NC><<<static_cast<unsigned>(grid), kThreads, L::alloc,
                           static_cast<cudaStream_t>(stream)>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o), static_cast<int>(BH),
      H, Hkv, Sq, Sk, D, n_qb, causal, window, has_softcap, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(void* stream, const void* q, const void* k, const void* v,
             void* o, int B, int H, int Hkv, int Sq, int Sk, int D,
             int causal, int window, int has_softcap, float softcap,
             float scale) {
  switch ((D + kCols - 1) / kCols) {
    case 1:
      return launch<1>(stream, q, k, v, o, B, H, Hkv, Sq, Sk, D, causal,
                       window, has_softcap, softcap, scale);
    case 2:
      return launch<2>(stream, q, k, v, o, B, H, Hkv, Sq, Sk, D, causal,
                       window, has_softcap, softcap, scale);
    case 3:
      return launch<3>(stream, q, k, v, o, B, H, Hkv, Sq, Sk, D, causal,
                       window, has_softcap, softcap, scale);
    case 4:
      return launch<4>(stream, q, k, v, o, B, H, Hkv, Sq, Sk, D, causal,
                       window, has_softcap, softcap, scale);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace hopper

bool operands_ok(int B, int H, int Hkv, int Sq, int Sk, int D) {
  return B >= 1 && H >= 1 && Hkv >= 1 && H % Hkv == 0 && Sq >= 1 &&
         Sk >= 1 && D >= 8 && D <= 256 && D % 8 == 0;
}

}  // namespace

extern "C" {

int flash_attention_f32(void* stream, const void* q, const void* k,
                        const void* v, void* o, int B, int H, int Hkv, int Sq,
                        int Sk, int D, int causal, int window, int has_softcap,
                        float softcap, float scale) {
  if (!operands_ok(B, H, Hkv, Sq, Sk, D))
    return static_cast<int>(cudaErrorInvalidValue);
  return simt::dispatch(stream, q, k, v, o, B, H, Hkv, Sq, Sk, D, causal,
                        window, has_softcap, softcap, scale);
}

int flash_attention_bf16(void* stream, const void* q, const void* k,
                         const void* v, void* o, int B, int H, int Hkv,
                         int Sq, int Sk, int D, int causal, int window,
                         int has_softcap, float softcap, float scale) {
  if (!operands_ok(B, H, Hkv, Sq, Sk, D))
    return static_cast<int>(cudaErrorInvalidValue);
  return hopper::dispatch(stream, q, k, v, o, B, H, Hkv, Sq, Sk, D, causal,
                          window, has_softcap, softcap, scale);
}


const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
