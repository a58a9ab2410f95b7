// Blockwise int8 quantize and dequantize of the PyTorch port, written by
// hand for Hopper (sm_90a).  They replace the Pallas kernels of the JAX
// package's kernels/quant8.py (_quant_kernel launched by
// quantize_blockwise, and _dequant_kernel launched by dequantize_blockwise)
// and compute the same functions, over blocks of 256 elements of a flat
// vector of n f32 or bf16 elements (bf16 widened to f32 in the kernel, as
// the Pallas kernel's astype does):
//
//   scale[b] = max(max_j |x[256 b + j]|, 1e-30) / 127        (true divide)
//   q[i]     = clamp(rint(x[i] / scale[i / 256]), -127, 127)  (true divide,
//                                                   rounding half to even)
//   y[i]     = q[i] * scale[i / 256]
//
// Elements past n load as 0, as the Pallas kernel pads its last tile with
// zeros; only the n values and ceil(n / 256) scales are stored.  The
// divisions are __fdiv_rn, IEEE division rounded to nearest, so the
// scales equal the eager reference bit for bit (the jitted Pallas kernel
// multiplies by 1/127 instead and moves some scales by one ulp); rintf
// rounds half to even like jnp.round and torch.round (roundf would round
// half away from zero).  Built with -fmad=false, so nothing is contracted.
// Non-finite values go as in JAX: the block max carries NaN as jnp.max
// does (fmaxf would drop it), so a NaN makes its block's scale NaN and an
// infinity makes it infinite; a NaN quotient (NaN / s, inf / inf) stores
// 0, as XLA's float-to-int8 cast gives, and the +-127 clamp applies only
// to numbers.  Dequantize gives 0 * inf = NaN there, as JAX does.
//
// Bound on the H100: HBM bytes.  Quantize reads 4 (f32) or 2 (bf16) bytes
// and writes 1 per element, plus 4 per block; dequantize the reverse.  The
// divides do not bound it: about a dozen instructions each, some 0.007 ms
// of issue at 2^24 elements against the 0.025 ms the bytes take.
//
// Design.  Every warp instruction moves whole 32-byte sectors, and the
// library picks the grid from n and the route; the hardware hands out the
// CTAs.  A persistent grid of the SM count times the CTAs an SM holds,
// each warp striding over ~12 blocks, measured slower on the H100.
//  * quantize, the scalar route (f32, and bf16 at an odd element
//    offset): a warp per 256-element block, lane l taking elements l,
//    l+32, ..., l+224 (128 contiguous bytes a warp load for f32, 64 for
//    bf16), zero fill past n; the block's max is a warp-shuffle reduction.
//    f32 always goes here: its 4-byte loads fill whole sectors, and a
//    16-byte layout measured 2 % slower on the H100.
//  * quantize, the bf16 vec route (x 16-byte aligned): a warp per two
//    blocks, both loaded before the first reduction; lane l loads its 8
//    elements as one 16-byte word and stores their int8 values as one
//    8-byte word (256 contiguous bytes a warp store).  On the H100 it
//    took 0.0236 ms a call at 2^24 where the scalar layout took 0.0278
//    with two blocks a warp and 0.029 with one (not profiled further: with
//    half the bytes of f32 to read, the scalar layout's 32-byte int8
//    stores weigh more).
//  * dequantize, the vec route (q 16-byte aligned): a warp per two
//    512-element tiles, both in flight; lane l loads 4 int8 values at
//    128j+4l (j = 0..3; 128 contiguous bytes a warp instruction) and the
//    tile's two scales, does 16 __fmul_rn and stores four float4 (512
//    contiguous bytes a warp instruction).  A thread's 16 values stored
//    as 64 contiguous bytes instead would leave every store instruction
//    half-filling the sectors of a 2 KiB span.  The last n % 512 elements
//    go one a thread.
//  * dequantize, the scalar route (q at an odd offset): four elements a
//    thread, grid-stride.
// y, q and scale are the wrapper's own allocations, so always aligned.
// Every entry point returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;    // elements per quantization block
constexpr int kTile = 512;     // elements per dequantize warp tile
constexpr int kThreads = 256;  // threads per CTA: 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kVecBlocks = 2;  // blocks a warp on the bf16 vec route
constexpr long long kMaxCtas = 0x7fffffffLL;
constexpr unsigned kFull = 0xffffffffu;

enum Dtype { kF32 = 0, kBF16 = 1 };

// max that carries NaN as jnp.max does (fmaxf drops it): a canonical NaN
// if either operand is one.
__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// One quotient to int8: rint, then the clamp for numbers; a NaN quotient
// (NaN / s, inf / inf) is 0, as XLA's float-to-int8 cast gives.
__device__ __forceinline__ signed char to_int8(float t) {
  const float r = rintf(t);
  return r != r ? 0
                : static_cast<signed char>(fminf(fmaxf(r, -127.0f), 127.0f));
}

__device__ __forceinline__ float load1(const float* x, long long i) {
  return x[i];
}
// bf16 bits widened to f32: exact, NaN payloads kept (torch's .float()).
__device__ __forceinline__ float load1(const unsigned short* x, long long i) {
  return __uint_as_float(static_cast<unsigned>(x[i]) << 16);
}

// Block scale from a lane's 8 values: the warp's NaN-carrying max of |v|.
__device__ __forceinline__ float block_scale(const float (&v)[8]) {
  float m = 0.0f;
#pragma unroll
  for (int k = 0; k < 8; ++k) m = max_nan(m, fabsf(v[k]));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = max_nan(m, __shfl_xor_sync(kFull, m, o));
  return __fdiv_rn(max_nan(m, 1e-30f), 127.0f);
}

// Block b by a warp, lane l taking elements l + 32 k, zero fill past n.
template <typename T>
__device__ __forceinline__ void quant_block(const T* __restrict__ x,
                                            long long n, long long b,
                                            int lane,
                                            signed char* __restrict__ q,
                                            float* __restrict__ scale) {
  const long long base = b * kBlock;
  float v[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const long long i = base + k * 32 + lane;
    v[k] = i < n ? load1(x, i) : 0.0f;
  }
  const float s = block_scale(v);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const long long i = base + k * 32 + lane;
    if (i < n) q[i] = to_int8(__fdiv_rn(v[k], s));
  }
  if (lane == 0) scale[b] = s;
}

// The scalar route: a warp per block.
template <typename T>
__global__ void __launch_bounds__(kThreads)
quant_kernel(const T* __restrict__ x, long long n,
             signed char* __restrict__ q, float* __restrict__ scale) {
  const long long b =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  if (b * kBlock < n) quant_block(x, n, b, threadIdx.x & 31, q, scale);
}

// The low and the high bf16 of a 32-bit word, widened to f32 (as load1).
__device__ __forceinline__ float bf16_lo(unsigned w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}

// Four quotients as int8 bytes of one word, v[k0] in the lowest.
__device__ __forceinline__ unsigned pack4(const float (&v)[8], int k0,
                                          float s) {
  unsigned w = 0;
#pragma unroll
  for (int k = 3; k >= 0; --k)
    w = (w << 8) | static_cast<unsigned char>(to_int8(__fdiv_rn(v[k0 + k], s)));
  return w;
}

// The bf16 vec route (x 16-byte aligned): a warp per kVecBlocks blocks,
// the loads of all of them issued before the first reduction; lane l
// loads elements 8l..8l+7 of a block as one 16-byte word and stores their
// int8 values as one 8-byte word.  A partial last block goes by scalar
// loads (quant_block).
__global__ void __launch_bounds__(kThreads)
quant_bf16_vec_kernel(const unsigned short* __restrict__ x, long long n,
                      signed char* __restrict__ q,
                      float* __restrict__ scale) {
  const long long b0 =
      ((static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5) *
      kVecBlocks;
  const int lane = threadIdx.x & 31;
  uint4 w[kVecBlocks];
#pragma unroll
  for (int j = 0; j < kVecBlocks; ++j)
    if ((b0 + j + 1) * kBlock <= n)
      w[j] = reinterpret_cast<const uint4*>(x + (b0 + j) * kBlock)[lane];
#pragma unroll
  for (int j = 0; j < kVecBlocks; ++j) {
    const long long b = b0 + j;
    if (b * kBlock >= n) return;  // uniform across the warp
    if ((b + 1) * kBlock > n) {
      quant_block(x, n, b, lane, q, scale);
      return;
    }
    const float v[8] = {bf16_lo(w[j].x), bf16_hi(w[j].x), bf16_lo(w[j].y),
                        bf16_hi(w[j].y), bf16_lo(w[j].z), bf16_hi(w[j].z),
                        bf16_lo(w[j].w), bf16_hi(w[j].w)};
    const float s = block_scale(v);
    reinterpret_cast<uint2*>(q + b * kBlock)[lane] =
        make_uint2(pack4(v, 0, s), pack4(v, 4, s));
    if (lane == 0) scale[b] = s;
  }
}

__device__ __forceinline__ float4 dq4(unsigned w, float s) {
  return make_float4(
      __fmul_rn(static_cast<float>(static_cast<signed char>(w)), s),
      __fmul_rn(static_cast<float>(static_cast<signed char>(w >> 8)), s),
      __fmul_rn(static_cast<float>(static_cast<signed char>(w >> 16)), s),
      __fmul_rn(static_cast<float>(static_cast<signed char>(w >> 24)), s));
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
dequant_kernel(const signed char* __restrict__ q,
               const float* __restrict__ scale, long long n,
               float* __restrict__ y) {
  const long long threads = static_cast<long long>(gridDim.x) * kThreads;
  const long long tid = static_cast<long long>(blockIdx.x) * kThreads +
                        threadIdx.x;
  long long done = 0;
  if (kVec) {
    const int lane = threadIdx.x & 31;
    const long long stride = threads >> 5;
    const long long n_tiles = n / kTile;
    for (long long t = tid >> 5; t < n_tiles; t += 2 * stride) {
      const long long u = t + stride;  // the second tile in flight
      const bool two = u < n_tiles;
      unsigned a[4], c[4];
      float sa0, sa1, sc0 = 0.0f, sc1 = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        a[j] = reinterpret_cast<const unsigned*>(q + t * kTile + 128 * j)[lane];
      sa0 = scale[2 * t];
      sa1 = scale[2 * t + 1];
      if (two) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          c[j] =
              reinterpret_cast<const unsigned*>(q + u * kTile + 128 * j)[lane];
        sc0 = scale[2 * u];
        sc1 = scale[2 * u + 1];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        reinterpret_cast<float4*>(y + t * kTile + 128 * j)[lane] =
            dq4(a[j], j < 2 ? sa0 : sa1);
      if (two) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          reinterpret_cast<float4*>(y + u * kTile + 128 * j)[lane] =
              dq4(c[j], j < 2 ? sc0 : sc1);
      }
    }
    done = n_tiles * kTile;
  }
  for (long long i = done + tid; i < n; i += threads)
    y[i] = __fmul_rn(static_cast<float>(q[i]), scale[i / kBlock]);
}

// CTAs to cover `units` at `per_cta` a CTA, or 0 past the grid's limit.
unsigned ctas_for(long long units, long long per_cta) {
  const long long c = units < 1 ? 1 : (units + per_cta - 1) / per_cta;
  return c > kMaxCtas ? 0u : static_cast<unsigned>(c);
}

}  // namespace

extern "C" {

// x: n f32 (dtype 0) or bf16 (dtype 1) -> q: n int8, scale: ceil(n / 256)
// f32.  vec: 1 for the bf16 16-byte route (x 16-byte aligned; two blocks a
// warp), 0 for scalar (a block a warp).
int quantize_blockwise(void* stream, const void* x, int vec, int dtype,
                       long long n, signed char* q, float* scale) {
  if (n < 1 || (dtype != kF32 && dtype != kBF16) || (vec && dtype != kBF16))
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec && (reinterpret_cast<unsigned long long>(x) & 15))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const long long n_blocks = (n + kBlock - 1) / kBlock;
  const unsigned g = ctas_for(n_blocks, vec ? kVecBlocks * kWarps : kWarps);
  if (g == 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const unsigned short*>(x);
  if (vec)
    quant_bf16_vec_kernel<<<g, kThreads, 0, s>>>(xb, n, q, scale);
  else if (dtype == kBF16)
    quant_kernel<unsigned short><<<g, kThreads, 0, s>>>(xb, n, q, scale);
  else
    quant_kernel<float><<<g, kThreads, 0, s>>>(static_cast<const float*>(x),
                                               n, q, scale);
  return static_cast<int>(cudaGetLastError());
}

// q: n int8, scale: ceil(n / 256) f32 -> y: n f32.  vec: 1 for the 16-byte
// route (q 16-byte aligned; two tiles a warp), 0 for scalar (four elements
// a thread).
int dequantize_blockwise(void* stream, const signed char* q, int vec,
                         const float* scale, long long n, float* y) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (vec && (reinterpret_cast<unsigned long long>(q) & 15))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const unsigned g = vec ? ctas_for(n / kTile, 2 * kWarps)
                         : ctas_for(n, 4 * kThreads);
  if (g == 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec)
    dequant_kernel<true><<<g, kThreads, 0, s>>>(q, scale, n, y);
  else
    dequant_kernel<false><<<g, kThreads, 0, s>>>(q, scale, n, y);
  return static_cast<int>(cudaGetLastError());
}

const char* quant8_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
