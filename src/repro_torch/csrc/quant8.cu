// Blockwise int8 quantize and dequantize of the PyTorch port, written by
// hand for Hopper (sm_90a).  They replace the Pallas kernels of the JAX
// package's kernels/quant8.py (_quant_kernel launched by
// quantize_blockwise, and _dequant_kernel launched by dequantize_blockwise)
// and compute the same functions, over blocks of 256 elements of a flat f32
// vector of n elements:
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
//
// Bound on the H100: HBM bytes; quantize reads 4 bytes and writes 1 per
// element (plus 4 per block), dequantize the reverse.  Design: one warp per
// 256-element block, 8 elements per lane at stride 32 (each load
// instruction of the warp reads 128 contiguous bytes); the block's max is a
// warp-shuffle reduction, so nothing goes through shared memory.
// Dequantize is one thread per element in a grid-stride loop.  Every entry
// point returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;            // elements per quantization block
constexpr int kPerLane = kBlock / 32;  // 8
constexpr int kWarps = 8;              // warps (blocks) per CTA
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr long long kMaxCtas = 132 * 16;

__global__ void quant_kernel(const float* __restrict__ x, long long n,
                             long long n_blocks, signed char* __restrict__ q,
                             float* __restrict__ scale) {
  const long long b =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (b >= n_blocks) return;  // uniform across the warp
  const long long base = b * kBlock;
  float v[kPerLane];
  float m = 0.0f;
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    const long long i = base + k * 32 + lane;
    v[k] = i < n ? x[i] : 0.0f;
    m = fmaxf(m, fabsf(v[k]));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, o));
  const float s = __fdiv_rn(fmaxf(m, 1e-30f), 127.0f);
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    const long long i = base + k * 32 + lane;
    if (i < n) {
      const float r = fminf(fmaxf(rintf(__fdiv_rn(v[k], s)), -127.0f), 127.0f);
      q[i] = static_cast<signed char>(r);
    }
  }
  if (lane == 0) scale[b] = s;
}

__global__ void dequant_kernel(const signed char* __restrict__ q,
                               const float* __restrict__ scale, long long n,
                               float* __restrict__ y) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    y[i] = __fmul_rn(static_cast<float>(q[i]), scale[i / kBlock]);
  }
}

}  // namespace

extern "C" {

// x: n f32 -> q: n int8, scale: ceil(n / 256) f32.
int quantize_blockwise(void* stream, const float* x, long long n,
                       signed char* q, float* scale) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long n_blocks = (n + kBlock - 1) / kBlock;
  const long long ctas = (n_blocks + kWarps - 1) / kWarps;
  if (ctas > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  quant_kernel<<<static_cast<unsigned>(ctas), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(x, n, n_blocks, q,
                                                      scale);
  return static_cast<int>(cudaGetLastError());
}

// q: n int8, scale: ceil(n / 256) f32 -> y: n f32.
int dequantize_blockwise(void* stream, const signed char* q,
                         const float* scale, long long n, float* y) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  long long ctas = (n + kThreads - 1) / kThreads;
  if (ctas > kMaxCtas) ctas = kMaxCtas;
  dequant_kernel<<<static_cast<unsigned>(ctas), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(q, scale, n, y);
  return static_cast<int>(cudaGetLastError());
}

const char* quant8_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
