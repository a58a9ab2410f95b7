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
//   outputs 0.  Inputs are f32 or bf16, D a multiple of 8 up to 256.
//
// Bound on the H100: at serving shapes (llama3.2-1b prefill, D = 64,
// S = 1024) the work is 4 * B * H * Sq * Sk * D / 2 multiply-adds of the
// causal half, far above the bytes of q, k, v and o, so the bound is
// tensor-core FLOPs (989 TFLOP/s dense bf16).  This first version is SIMT
// f32 on the CUDA cores and leaves the tensor cores unused; a later version
// stages K/V tiles with TMA and runs Q.K^T and P.V as wgmma products.
//
// Design: one CTA per (batch * head, 64-row query block), 8 warps of 8
// query rows each.  A loop over 64-key blocks stages K and V in shared
// memory as f32 (K rows padded to D + 1 floats, so lane j reading key j is
// free of bank conflicts); lane j scores keys j and j + 32 for the warp's
// rows, the row max and sum are warp reductions, p goes through shared
// memory, and lane i accumulates output columns i, i + 32, ... of its
// warp's rows in registers.  Key blocks wholly above the causal diagonal or
// wholly outside the window are skipped: they change neither m, l nor acc.
// Ragged tails are masked here (query rows beyond Sq are never stored, keys
// beyond Sk are loaded as 0 and masked), so the host pads nothing.
// Offsets are 64-bit.  Numerics: expf, tanhf and a true division, no fast
// math.  Every entry point returns cudaGetLastError().

#include <cfloat>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 8;                    // query rows per warp
constexpr int kBlockQ = kWarps * kRows;     // 64 query rows per CTA
constexpr int kBlockK = 64;                 // keys per staged tile
constexpr int kKeysPerLane = kBlockK / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNegBig = static_cast<float>(-0.7 * static_cast<double>(FLT_MAX));

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Dynamic shared memory of one CTA: Q [kBlockQ][D], K [kBlockK][D + 1],
// V [kBlockK][D], P [kBlockQ][kBlockK], all f32.
inline size_t smem_bytes(int D) {
  return sizeof(float) * (static_cast<size_t>(kBlockQ) * D +
                          static_cast<size_t>(kBlockK) * (D + 1) +
                          static_cast<size_t>(kBlockK) * D +
                          static_cast<size_t>(kBlockQ) * kBlockK);
}

// NA = ceil(D / 32): output columns each lane accumulates per row.
template <typename T, int NA>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, long long BH, int H, int Hkv, int Sq, int Sk, int D,
    int n_qb, int causal, int window, int has_softcap, float softcap,
    float scale) {
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
  const T* qp = q + (bh * Sq + q0) * D;
  const T* kp = k + kvh * Sk * D;
  const T* vp = v + kvh * Sk * D;

  const int q_rows = min(kBlockQ, Sq - q0);
  for (int e = tid; e < kBlockQ * D; e += kThreads) {
    Qs[e] = e / D < q_rows ? to_f32(qp[e]) : 0.f;
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
      Ks[j * (D + 1) + d] = in ? to_f32(kp[g]) : 0.f;
      Vs[e] = in ? to_f32(vp[g]) : 0.f;
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
    T* orow = o + (bh * Sq + row) * D;
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const int d = lane + 32 * i;
      if (d < D) store(orow + d, acc[r][i] / den);
    }
  }
}

template <typename T, int NA>
int launch(void* stream, const void* q, const void* k, const void* v,
           void* o, int B, int H, int Hkv, int Sq, int Sk, int D, int causal,
           int window, int has_softcap, float softcap, float scale) {
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, NA>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qb = (Sq + kBlockQ - 1) / kBlockQ;
  const long long BH = static_cast<long long>(B) * H;
  if (BH * n_qb > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  flash_fwd_kernel<T, NA><<<static_cast<unsigned>(BH * n_qb), kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), BH, H, Hkv, Sq, Sk, D,
      n_qb, causal, window, has_softcap, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(void* stream, const void* q, const void* k, const void* v,
             void* o, int B, int H, int Hkv, int Sq, int Sk, int D,
             int causal, int window, int has_softcap, float softcap,
             float scale) {
  if (B < 1 || H < 1 || Hkv < 1 || H % Hkv != 0 || Sq < 1 || Sk < 1 ||
      D < 8 || D > 256 || D % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
#define FLASH_CASE(NA)                                                       \
  case NA:                                                                   \
    return launch<T, NA>(stream, q, k, v, o, B, H, Hkv, Sq, Sk, D, causal,   \
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

}  // namespace

extern "C" {

int flash_attention_f32(void* stream, const void* q, const void* k,
                        const void* v, void* o, int B, int H, int Hkv, int Sq,
                        int Sk, int D, int causal, int window, int has_softcap,
                        float softcap, float scale) {
  return dispatch<float>(stream, q, k, v, o, B, H, Hkv, Sq, Sk, D, causal,
                         window, has_softcap, softcap, scale);
}

int flash_attention_bf16(void* stream, const void* q, const void* k,
                         const void* v, void* o, int B, int H, int Hkv,
                         int Sq, int Sk, int D, int causal, int window,
                         int has_softcap, float softcap, float scale) {
  return dispatch<__nv_bfloat16>(stream, q, k, v, o, B, H, Hkv, Sq, Sk, D,
                                 causal, window, has_softcap, softcap, scale);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
