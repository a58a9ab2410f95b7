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
// written once, so HBM bytes (3.35 TB/s).  Design:
//
// * The host plan (kernels/bucket_pack.py, make_plan) cuts every segment
//   into tiles of a fixed number of bucket bytes and writes one Seg
//   descriptor per segment: pointer, bucket offset, size, dtype, the index
//   of its first tile, and its alignment class.  One CTA moves one tile;
//   it finds its segment once, by a binary search over the descriptors'
//   first tiles, so no thread searches per element.
// * The descriptors travel by value, as a __grid_constant__ kernel
//   parameter (ByValue<CAP>): the launch carries them, so a call stages no
//   table and issues no host-to-device copy.  The wrapper builds a plan's
//   parameter block (a Header and its descriptors) once and passes its
//   address to every launch of that plan.  Two capacities are instantiated:
//   32 descriptors (about 1 KiB of parameters, every bucket of the training
//   path) and kCap, the most that 32 764 bytes of parameters hold (CUDA
//   12.1 and later).  A bucket with more segments passes a device table
//   that the wrapper stages (InMemory), in the same kernel template.
// * Inside a tile each thread moves 16 bytes per access, four independent
//   accesses in flight: float4 for f32 -> f32, eight bf16 as a uint4 for
//   bf16 -> bf16, and for f32 <-> bf16 one 16-byte bf16 vector against two
//   float4.  The vector body of a segment starts where both its segment
//   address and its bucket address are 16-byte aligned; the `head`
//   elements before it and the tail after it go scalar.  A segment whose
//   two addresses differ in alignment mod 16 has no such start and is
//   copied by scalar accesses (vec = 0), still coalesced.  Scalar and
//   vector paths convert with the same intrinsics, so the result is
//   bitwise the same whichever path an element takes.
//
// The launch entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // independent 16-byte accesses per thread

// Dtype codes of the descriptors: the wrapper's _DTYPE_CODE.
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

// One segment; the layout of the wrapper's ctypes _Seg (32 bytes).
struct Seg {
  long long ptr;        // segment address (source of pack, destination of unpack)
  long long off;        // first bucket element of the segment
  long long n;          // elements
  int first_tile;       // index of the segment's first tile
  unsigned char dtype;  // kF32 or kBF16
  unsigned char vec;    // 1: head, 16-byte body, tail; 0: all scalar
  unsigned char head;   // scalar elements before the body (vec == 1)
  unsigned char pad;
};
static_assert(sizeof(Seg) == 32, "Seg must match the wrapper's _Seg");

// What a launch needs besides the descriptors; the layout of the
// wrapper's ctypes _Header (16 bytes).
struct Header {
  int K;          // descriptors
  int n_tiles;    // tiles, one CTA each
  int bucket_dt;  // kF32 or kBF16
  int pack;       // 1: pack (segments -> bucket); 0: unpack
};
static_assert(sizeof(Header) == 16, "Header must match the wrapper's _Header");

// Bucket bytes per tile: one CTA of kThreads threads, each moving kUnroll
// 16-byte accesses of an f32 bucket's body.  A multiple of 32, so that a
// tile holds whole 16-byte units of every dtype pair (8 elements where one
// side is bf16: 32 bytes of an f32 bucket).
constexpr int kTileBytes = 16384;
static_assert(kTileBytes % 32 == 0, "a tile must hold whole vector units");

// Descriptors as a kernel parameter: read from the parameter space.
template <int CAP>
struct ByValue {
  Header h;
  Seg seg[CAP];
  __device__ __forceinline__ const Seg& at(int i) const { return seg[i]; }
};

// Descriptors in device memory, for buckets above the largest capacity.
struct InMemory {
  Header h;
  const Seg* seg;
  __device__ __forceinline__ const Seg& at(int i) const { return seg[i]; }
};

// CUDA 12.1 and later take 32 764 bytes of kernel parameters (the bucket
// pointer, 8 of them, besides the table).
static_assert(CUDART_VERSION >= 12010,
              "32 KiB of kernel parameters need CUDA 12.1 or later");
constexpr int kParamBytes = 32764 - 8;
constexpr int kSmallCap = 32;
constexpr int kCap = (kParamBytes - static_cast<int>(sizeof(Header))) /
                     static_cast<int>(sizeof(Seg)) / 8 * 8;
static_assert(sizeof(ByValue<kCap>) <= kParamBytes, "parameters too large");

__device__ __forceinline__ int elem_bytes(int dt) { return dt == kF32 ? 4 : 2; }

// Element j of src (dtype sdt) to element k of dst (dtype ddt).
__device__ __forceinline__ void move(const char* src, int sdt, long long j,
                                     char* dst, int ddt, long long k) {
  if (sdt == ddt) {
    if (sdt == kF32) {
      reinterpret_cast<float*>(dst)[k] =
          reinterpret_cast<const float*>(src)[j];
    } else {
      reinterpret_cast<unsigned short*>(dst)[k] =
          reinterpret_cast<const unsigned short*>(src)[j];
    }
  } else if (sdt == kF32) {
    reinterpret_cast<__nv_bfloat16*>(dst)[k] =
        __float2bfloat16_rn(reinterpret_cast<const float*>(src)[j]);
  } else {
    reinterpret_cast<float*>(dst)[k] =
        __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(src)[j]);
  }
}

// Elements [lo, hi) one at a time; neighbouring threads on neighbouring
// elements.
__device__ __forceinline__ void scalar_range(const char* src, int sdt,
                                             char* dst, int ddt, long long lo,
                                             long long hi) {
  for (long long j = lo + threadIdx.x; j < hi; j += kThreads) {
    move(src, sdt, j, dst, ddt, j);
  }
}

// 16-byte units of the four dtype pairs: U elements each; load() reads
// unit k of the source, store() converts and writes unit k of the
// destination.
struct CopyF32 {  // f32 -> f32
  static constexpr int U = 4;
  using R = float4;
  __device__ __forceinline__ static R load(const char* s, long long k) {
    return reinterpret_cast<const float4*>(s)[k];
  }
  __device__ __forceinline__ static void store(char* d, long long k, R r) {
    reinterpret_cast<float4*>(d)[k] = r;
  }
};

struct CopyBF16 {  // bf16 -> bf16
  static constexpr int U = 8;
  using R = uint4;
  __device__ __forceinline__ static R load(const char* s, long long k) {
    return reinterpret_cast<const uint4*>(s)[k];
  }
  __device__ __forceinline__ static void store(char* d, long long k, R r) {
    reinterpret_cast<uint4*>(d)[k] = r;
  }
};

__device__ __forceinline__ unsigned int bf2_bits(float a, float b) {
  __nv_bfloat162 h = __float22bfloat162_rn(make_float2(a, b));
  return *reinterpret_cast<unsigned int*>(&h);
}

struct F32ToBF16 {  // two float4 -> one 16-byte bf16 vector
  static constexpr int U = 8;
  struct R {
    float4 a, b;
  };
  __device__ __forceinline__ static R load(const char* s, long long k) {
    const float4* p = reinterpret_cast<const float4*>(s) + 2 * k;
    return R{p[0], p[1]};
  }
  __device__ __forceinline__ static void store(char* d, long long k, R r) {
    reinterpret_cast<uint4*>(d)[k] =
        make_uint4(bf2_bits(r.a.x, r.a.y), bf2_bits(r.a.z, r.a.w),
                   bf2_bits(r.b.x, r.b.y), bf2_bits(r.b.z, r.b.w));
  }
};

__device__ __forceinline__ float2 bf2_float2(unsigned int bits) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&bits));
}

struct BF16ToF32 {  // one 16-byte bf16 vector -> two float4
  static constexpr int U = 8;
  using R = uint4;
  __device__ __forceinline__ static R load(const char* s, long long k) {
    return reinterpret_cast<const uint4*>(s)[k];
  }
  __device__ __forceinline__ static void store(char* d, long long k, R r) {
    float2 x = bf2_float2(r.x), y = bf2_float2(r.y);
    float2 z = bf2_float2(r.z), w = bf2_float2(r.w);
    float4* p = reinterpret_cast<float4*>(d) + 2 * k;
    p[0] = make_float4(x.x, x.y, y.x, y.y);
    p[1] = make_float4(z.x, z.y, w.x, w.y);
  }
};

// Units [0, units) of a body whose both sides start 16-byte aligned:
// kUnroll loads in flight per thread before their stores.
template <class C>
__device__ __forceinline__ void vector_body(const char* src, char* dst,
                                            long long units) {
  for (long long base = threadIdx.x; base < units;
       base += kUnroll * kThreads) {
    typename C::R r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long k = base + u * kThreads;
      if (k < units) r[u] = C::load(src, k);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long k = base + u * kThreads;
      if (k < units) C::store(dst, k, r[u]);
    }
  }
}

// One CTA per tile.  Tile t of a segment covers its body elements
// [head + t*E, head + (t+1)*E) (E = kTileBytes over the bucket's element
// size), clipped to the body; tile 0 also moves the head and the
// segment's last tile the tail.  make_plan's tile_pieces is the same rule.
template <bool kPack, class Table>
__global__ void __launch_bounds__(kThreads)
    bucket_kernel(const __grid_constant__ Table tab, char* bucket) {
  const Header& h = tab.h;
  const int tile = static_cast<int>(blockIdx.x);
  int lo = 0, hi = h.K - 1;  // the last segment whose first tile <= tile
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (tab.at(mid).first_tile <= tile) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  const Seg& d = tab.at(lo);
  const long long n = d.n;
  const int seg_dt = d.dtype, bkt_dt = h.bucket_dt;
  const int U = (seg_dt == kF32 && bkt_dt == kF32) ? 4 : 8;
  const long long head = d.vec ? d.head : 0;
  const long long body = d.vec ? (n - head) / U * U : n;
  const long long E = kTileBytes / elem_bytes(bkt_dt);
  const long long t = tile - d.first_tile;
  const long long last = body > 0 ? (body + E - 1) / E - 1 : 0;
  const long long b_lo = head + t * E;
  const long long b_hi = min(head + (t + 1) * E, head + body);

  char* seg = reinterpret_cast<char*>(d.ptr);
  char* bkt = bucket + d.off * elem_bytes(bkt_dt);
  const char* src = kPack ? seg : bkt;
  char* dst = kPack ? bkt : seg;
  const int sdt = kPack ? seg_dt : bkt_dt, ddt = kPack ? bkt_dt : seg_dt;

  if (b_lo < b_hi) {
    if (d.vec) {
      const char* s = src + b_lo * elem_bytes(sdt);
      char* o = dst + b_lo * elem_bytes(ddt);
      const long long units = (b_hi - b_lo) / U;
      if (sdt == ddt) {
        if (sdt == kF32) {
          vector_body<CopyF32>(s, o, units);
        } else {
          vector_body<CopyBF16>(s, o, units);
        }
      } else if (sdt == kF32) {
        vector_body<F32ToBF16>(s, o, units);
      } else {
        vector_body<BF16ToF32>(s, o, units);
      }
    } else {
      scalar_range(src, sdt, dst, ddt, b_lo, b_hi);
    }
  }
  if (t == 0) scalar_range(src, sdt, dst, ddt, 0, head);
  if (t == last) scalar_range(src, sdt, dst, ddt, head + body, n);
}

template <bool kPack>
void launch(const Header& h, const void* dev_table, cudaStream_t s,
            char* bucket) {
  if (dev_table != nullptr) {
    const InMemory p{h, static_cast<const Seg*>(dev_table)};
    bucket_kernel<kPack, InMemory><<<h.n_tiles, kThreads, 0, s>>>(p, bucket);
  } else if (h.K <= kSmallCap) {
    const auto& p = reinterpret_cast<const ByValue<kSmallCap>&>(h);
    bucket_kernel<kPack, ByValue<kSmallCap>>
        <<<h.n_tiles, kThreads, 0, s>>>(p, bucket);
  } else {
    const auto& p = reinterpret_cast<const ByValue<kCap>&>(h);
    bucket_kernel<kPack, ByValue<kCap>><<<h.n_tiles, kThreads, 0, s>>>(p,
                                                                       bucket);
  }
}

}  // namespace

extern "C" {

// One launch of a plan on ``stream`` into (pack) or out of (unpack) the
// bucket at ``bucket``.  ``params`` is the plan's parameter block: its
// Header followed by its K descriptors, spanning
// bucket_pack_param_bytes(K) bytes; or, when ``dev_table`` is not null,
// the Header alone, the K descriptors lying in device memory at
// ``dev_table``.
int bucket_launch(const void* params, const void* dev_table, void* stream,
                  void* bucket) {
  if (params == nullptr || bucket == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const Header& h = *static_cast<const Header*>(params);
  if (h.K < 1 || h.n_tiles < 1 || h.bucket_dt < kF32 || h.bucket_dt > kBF16 ||
      (dev_table == nullptr && h.K > kCap))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  char* b = static_cast<char*>(bucket);
  if (h.pack) {
    launch<true>(h, dev_table, s, b);
  } else {
    launch<false>(h, dev_table, s, b);
  }
  return static_cast<int>(cudaGetLastError());
}

// The bytes a by-value parameter block of K descriptors must span: the
// instance that takes it reads its whole capacity.
int bucket_pack_param_bytes(int K) {
  return static_cast<int>(K <= kSmallCap ? sizeof(ByValue<kSmallCap>)
                                         : sizeof(ByValue<kCap>));
}

// The most descriptors a launch takes by value.
int bucket_pack_capacity() { return kCap; }

// Bucket bytes per tile, checked against the wrapper's at binding.
int bucket_pack_tile_bytes() { return kTileBytes; }

// sizeof(Seg), checked against the wrapper's descriptor at binding.
int bucket_pack_desc_bytes() { return static_cast<int>(sizeof(Seg)); }

const char* bucket_pack_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
