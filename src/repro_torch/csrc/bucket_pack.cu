// Gradient-bucket pack and unpack of the PyTorch port, written by hand for
// Hopper (sm_90a).  They replace the Pallas kernels of the JAX package's
// kernels/bucket_pack.py (_pack_kernel launched by bucket_pack, and
// _unpack_kernel launched by bucket_unpack) and compute the same functions:
//
//   pack:    out[off[s] + j] = cast(src_s[j])        for every segment s
//   unpack:  dst_s[j]        = cast(flat[off[s] + j])
//
// where a segment is one contiguous tensor (a gradient leaf, or one layer's
// slice of a stacked leaf), off[] the exclusive prefix sum of the segment
// sizes, and cast the conversion between the segment's dtype and the
// bucket's (f32 or bf16, all four pairs; f32 -> bf16 rounds to nearest
// even, as torch and JAX do; equal dtypes copy the bits).  The Pallas kernel
// stages every leaf as padded (rows, 128) tiles, a TPU layout that its
// output compacts away again; here the bucket is the exact concatenation.
//
// Bound on the H100: pure data movement, each element read once and
// written once, so HBM bytes (3.35 TB/s).  Design: one launch per bucket
// over all its elements; the segment table (source or destination
// pointer, offset, dtype; int64) lies in device memory, built by the
// wrapper.  A grid-stride loop gives each thread element indices; the
// thread finds its segment by a binary search over off[] (the table is
// small and stays in L1), so one launch serves buckets of one leaf or of
// hundreds.  Neighbouring threads touch neighbouring elements of the
// bucket and, within a segment, of the segment.  Every entry point returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 16;  // 16 CTAs per SM of the H100

// Dtype codes of the table: the wrapper's _DTYPE_CODE.
constexpr long long kF32 = 0;

// Largest s with off[s] <= i: the segment holding bucket element i (empty
// segments have off[s] == off[s + 1] and are stepped over).
__device__ __forceinline__ int find_segment(const long long* off, int K,
                                            long long i) {
  int lo = 0, hi = K - 1;
  while (lo < hi) {
    int mid = (lo + hi + 1) >> 1;
    if (off[mid] <= i) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return lo;
}

__device__ __forceinline__ void move(const void* src, long long sdt,
                                     long long j, void* dst, long long ddt,
                                     long long k) {
  if (sdt == ddt) {
    if (sdt == kF32) {
      static_cast<float*>(dst)[k] = static_cast<const float*>(src)[j];
    } else {
      static_cast<unsigned short*>(dst)[k] =
          static_cast<const unsigned short*>(src)[j];
    }
  } else if (sdt == kF32) {
    static_cast<__nv_bfloat16*>(dst)[k] =
        __float2bfloat16_rn(static_cast<const float*>(src)[j]);
  } else {
    static_cast<float*>(dst)[k] =
        __bfloat162float(static_cast<const __nv_bfloat16*>(src)[j]);
  }
}

// table: ptr[K], off[K + 1], dtype[K].
__global__ void pack_kernel(const long long* __restrict__ table, int K,
                            long long total, void* out, long long out_dt) {
  const long long* off = table + K;
  const long long* dt = table + 2 * K + 1;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < total; i += stride) {
    const int s = find_segment(off, K, i);
    move(reinterpret_cast<const void*>(table[s]), dt[s], i - off[s], out,
         out_dt, i);
  }
}

__global__ void unpack_kernel(const long long* __restrict__ table, int K,
                              long long total, const void* flat,
                              long long flat_dt) {
  const long long* off = table + K;
  const long long* dt = table + 2 * K + 1;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < total; i += stride) {
    const int s = find_segment(off, K, i);
    move(flat, flat_dt, i, reinterpret_cast<void*>(table[s]), dt[s],
         i - off[s]);
  }
}

int grid_for(long long total) {
  long long blocks = (total + kThreads - 1) / kThreads;
  return static_cast<int>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

}  // namespace

extern "C" {

// Pack the K segments of ``table`` (device memory) into ``out`` of
// ``total`` elements of dtype ``out_dt`` (0 f32, 1 bf16).
int bucket_pack(void* stream, const long long* table, int K,
                long long total, void* out, long long out_dt) {
  if (K < 1 || total < 1 || out_dt < 0 || out_dt > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  pack_kernel<<<grid_for(total), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(table, K, total, out,
                                                     out_dt);
  return static_cast<int>(cudaGetLastError());
}

// Unpack ``flat`` (``total`` elements of dtype ``flat_dt``) into the K
// destination segments of ``table``.
int bucket_unpack(void* stream, const long long* table, int K,
                  long long total, const void* flat, long long flat_dt) {
  if (K < 1 || total < 1 || flat_dt < 0 || flat_dt > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  unpack_kernel<<<grid_for(total), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(table, K, total, flat,
                                                       flat_dt);
  return static_cast<int>(cudaGetLastError());
}

const char* bucket_pack_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
