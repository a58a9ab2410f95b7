// Mamba-2's chunked SSD scan (forward), written by hand for Hopper (sm_90a).
// It replaces no Pallas kernel: the JAX package leaves the SSD to XLA
// (models/mamba.py ssd_chunked), and so does the port's training path.  It
// was added because on the card the plain version materialises several
// (b, c, h, Q, Q) f32 tensors per layer, repeats C.B^T over every head and
// loops over the chunks in Python; here nothing of size Q x Q leaves the
// chip.  It computes exactly models/mamba.py's ssd_chunked:
//
//   x (b, l, h, P) and B, C (b, l, g, N) in f32 or bf16 (one dtype for the
//   three, widened to f32 in registers), dt (b, l, h) f32 (after softplus),
//   A (h) f32 (negative), D (h) f32, an optional init_state (b, h, P, N)
//   f32; head hh reads group hh / (h / g).  Chunks of Q positions (the last
//   one ragged; one chunk when l <= Q).  Within chunk c, with
//   cum[t] = sum_{u <= t} dt[u] A (its positions only):
//     y[t]   = sum_{s <= t} (C[t].B[s]) exp(cum[t] - cum[s]) dt[s] x[s]
//            + exp(cum[t]) C[t] . S_c  +  D x[t]
//     st_c   = sum_s exp(cum[Q-1] - cum[s]) dt[s] x[s] (x) B[s]
//     S_{c+1} = S_c exp(cum[Q-1]) + st_c,   S_0 = init_state or 0
//   y is written in x's dtype (one rounding of the f32 sum), the final
//   state S_{last+1} in f32.
//
// Arithmetic: every product is an f32 FMA on the CUDA cores (no TF32, no
// operand rounded below f32); the exponentials are expf.  Sums run in
// another order than the einsums of the plain version.
//
// Bound on the H100.  Per position and head the work is about
// 2 * (Q/2 + 2 N) * P FLOPs (causal pairs of the chunk, the chunk state,
// the state's read-out) plus C.B^T once per group; at mamba2-780m's serving
// shape (b 8, l 8192, h 48, P 64, N 128, Q 256) 157 GFLOP a layer, 2.3 ms
// at the f32 FMA rate (67 TFLOP/s), against 0.85 GB of x, B, C, dt and y
// (0.25 ms at 3.35 TB/s): operations bound it.  A fixed chain of three
// kernels a call, whatever l is:
//
//  1. ssd_chunk_state_kernel, a CTA per (four heads of one group, 64 x 64
//     tile of P x N, chunk, batch): the chunk's B in the tile's N columns
//     once into shared memory (f32), then for each head the chunk's cumsum
//     of dt A (one warp scan) and st_c as a GEMM over the chunk's
//     positions, B read in place; writes st_c (f32) and cum[Q-1].
//  2. ssd_state_pass_kernel, a thread per state element of a (batch, head):
//     walks the chunks in order, replacing each st_c by the state S_c that
//     enters chunk c, and writes the final state; bytes bound, eight
//     chunks' loads in flight.
//  3. ssd_chunk_scan_kernel, a CTA of eight thread groups per (64 output
//     rows of a chunk, 16 heads of one group, chunk, batch): C.B^T
//     of its rows against the chunk's positions up to its last row, once,
//     and the rows of C, into shared memory (transposed f32, at most
//     256 x 64 and N x 64); then each group takes a head and 64 columns
//     of P at a time.  Below the diagonal tile the decay factors into a
//     row factor and a column factor, both <= 1 (see the kernel), so C.B^T
//     and C serve every head in place as the A operand and only x and the
//     state, scaled per head, are staged; on the diagonal tile the decayed
//     scores (exp of the difference, the masked upper triangle zero) are
//     built as they are staged.  The epilogue adds D x.
//
// The GEMMs share one engine: groups of 64 threads, each computing its own
// 64 x 64 output tile (8 x 8 outputs a thread, rows and columns split in
// halves 32 apart so that the shared-memory reads are conflict-free
// broadcasts) with its own staging buffers and named barrier.  Where one
// operand lies in shared memory already, the other is staged 16 deep; the
// diagonal tile stages both, 8 deep; either way double-buffered, a thread's
// loads of the next stage in flight during the current stage's FMAs and
// converted and scaled only when they are stored.  Offsets are 64-bit.
// Every entry point returns the first CUDA error of its launches.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace ssd {

constexpr int kGroup = 64;            // threads of a GEMM group
constexpr int kTile = 64;             // a group's output tile
constexpr int kLd = kTile + 4;        // staged row stride (floats)
constexpr int kDeep = 16;             // stage depth, one operand staged
constexpr int kPair = 8;              // stage depth, both operands staged
constexpr int kGroupStage = 2 * kDeep * kLd;   // a group's two buffers
constexpr int kMaxChunk = 256;        // longest chunk Q
constexpr int kMaxState = 256;        // largest N (chunk scan's C rows)

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void narrow(float v, float* p) { *p = v; }
__device__ __forceinline__ void narrow(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ void group_sync(int group) {
  asm volatile("bar.sync %0, %1;" ::"r"(group + 1), "n"(kGroup) : "memory");
}

// The registers one thread fetches for a stage, a stage ahead, as the
// values' bits (bf16 zero-extended, f32 as they are), converted and scaled
// only when the stage is stored, after the current stage's FMAs, so that
// the loads' latency hides behind them.
template <int K>
struct Raw {
  unsigned v[K];
  unsigned w[K];
};

__device__ __forceinline__ unsigned bits(const float* p) {
  return __float_as_uint(*p);
}
__device__ __forceinline__ unsigned bits(const __nv_bfloat16* p) {
  return *reinterpret_cast<const unsigned short*>(p);
}
template <typename T>
__device__ __forceinline__ float from_bits(unsigned v);
template <>
__device__ __forceinline__ float from_bits<float>(unsigned v) {
  return __uint_as_float(v);
}
template <>
__device__ __forceinline__ float from_bits<__nv_bfloat16>(unsigned v) {
  return __uint_as_float(v << 16);   // bf16 is the high half of an f32
}

// A staged operand of depth K has, for element i of group thread lt, the
// row-fast slot (k = i, row lt: consecutive threads, consecutive rows) or
// the depth-fast one (k = lt % K, row lt / K + (64 / K) i), for sources
// contiguous along the reduction.
template <int K>
__device__ __forceinline__ int deep_k(int lt) {
  return lt % K;
}
template <int K>
__device__ __forceinline__ int deep_row(int i, int lt) {
  return lt / K + (kGroup / K) * i;
}

// acc (this thread's 8 x 8 of a group's 64 x 64 tile: rows ty*4 + {0..3,
// 32..35}, columns tx*4 + {0..3, 32..35}) += A . B over one stage of depth
// K: A at As[k * LDA + row], B at Bs[k * LDB + column].  A thread's rows
// (and columns) are two float4 32 apart, so that a warp's reads are
// conflict-free broadcasts.
template <int LDA, int LDB, int K>
__device__ __forceinline__ void stage_fma(const float* As, const float* Bs,
                                          int lt, float acc[8][8]) {
  const int ty = lt >> 3, tx = lt & 7;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(As + k * LDA + ty * 4);
    const float4 a1 =
        *reinterpret_cast<const float4*>(As + k * LDA + 32 + ty * 4);
    const float4 b0 = *reinterpret_cast<const float4*>(Bs + k * LDB + tx * 4);
    const float4 b1 =
        *reinterpret_cast<const float4*>(Bs + k * LDB + 32 + tx * 4);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// One group's GEMM, acc += A . B over n_slabs stages of depth kPair, both
// operands staged: fetch(slab, raw) loads this thread's part of a stage
// into registers; put(slab, raw, As, Bs) stores it, converted, as A's and
// B's operands (As[k * kLd + row]).  stage: the group's kGroupStage floats
// of shared memory (two buffers).
template <class Fetch, class Put>
__device__ __forceinline__ void group_gemm(int n_slabs, Fetch fetch, Put put,
                                           float* stage, int group, int lt,
                                           float acc[8][8]) {
  if (n_slabs <= 0) return;
  Raw<kPair> raw;
  fetch(0, raw);
  for (int s = 0; s < n_slabs; ++s) {
    float* As = stage + (s & 1) * 2 * kPair * kLd;
    float* Bs = As + kPair * kLd;
    put(s, raw, As, Bs);
    group_sync(group);
    if (s + 1 < n_slabs) fetch(s + 1, raw);
    stage_fma<kLd, kLd, kPair>(As, Bs, lt, acc);
  }
  group_sync(group);  // the stages are free for the group's next GEMM
}

// The same with one operand already in shared memory, of(slab) pointing at
// its stage (rows LD floats apart), A if A_IN_PLACE else B; the other is
// fetched and put (Ss[k * kLd + row]), kDeep deep.
template <bool A_IN_PLACE, int LD, class Of, class Fetch, class Put>
__device__ __forceinline__ void group_gemm_one(int n_slabs, Of of, Fetch fetch,
                                               Put put, float* stage,
                                               int group, int lt,
                                               float acc[8][8]) {
  if (n_slabs <= 0) return;
  Raw<kDeep> raw;
  fetch(0, raw);
  for (int s = 0; s < n_slabs; ++s) {
    float* Ss = stage + (s & 1) * kDeep * kLd;
    put(s, raw, Ss);
    group_sync(group);
    if (s + 1 < n_slabs) fetch(s + 1, raw);
    if (A_IN_PLACE)
      stage_fma<LD, kLd, kDeep>(of(s), Ss, lt, acc);
    else
      stage_fma<kLd, LD, kDeep>(Ss, of(s), lt, acc);
  }
  group_sync(group);
}

__device__ __forceinline__ int acc_row(int i, int lt) {
  return (lt >> 3) * 4 + (i & 3) + (i >> 2) * 32;
}
__device__ __forceinline__ int acc_col(int j, int lt) {
  return (lt & 7) * 4 + (j & 3) + (j >> 2) * 32;
}

// cum[s] = sum_{u <= s} dt[u] * a for s < qc (qc <= 256), by the first
// warp of a group (lane = its thread's lane): eight consecutive positions
// a lane, then a shuffle scan of the lanes' sums.  dt[u] lies at
// dt[u * stride].  The caller synchronises the group.
__device__ __forceinline__ void chunk_cumsum(const float* dt, long long stride,
                                             float a, int qc, float* cum,
                                             int lane) {
  constexpr int kPer = kMaxChunk / 32;
  float v[kPer];
  float run = 0.f;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int s = lane * kPer + j;
    run += s < qc ? dt[s * stride] * a : 0.f;
    v[j] = run;
  }
  float incl = run;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += o;
  }
  const float before = incl - run;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int s = lane * kPer + j;
    if (s < qc) cum[s] = before + v[j];
  }
}

// The chunk's rows [0, s_cap) of a (b, l, g, n)-shaped operand's group grp
// and n columns [n0, n0 + 64), as f32 at dst[row * 64 + j]; zero past the
// chunk's qc rows and past n.  By all NT threads, eight loads a thread in
// flight at a time.
template <int NT, typename T>
__device__ __forceinline__ void stage_rows(const T* src, long long t0,
                                           long long gn, int grp, int N,
                                           int n0, int qc, int s_cap,
                                           float* dst) {
  constexpr int kBatch = 8;
  const int total = s_cap * kTile;
  const T* base = src + t0 * gn + static_cast<long long>(grp) * N;
  for (int e0 = threadIdx.x; e0 < total; e0 += NT * kBatch) {
    unsigned v[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int e = e0 + j * NT, r = e / kTile, n = n0 + e % kTile;
      v[j] = 0u;
      if (e < total && r < qc && n < N) v[j] = bits(base + r * gn + n);
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      if (e0 + j * NT < total) dst[e0 + j * NT] = from_bits<T>(v[j]);
  }
}

// fn(s) for s = lt, lt + 64, ... < n (n <= 256), the iterations unrolled so
// that their loads are in flight together.
template <class Fn>
__device__ __forceinline__ void for_positions(int lt, int n, Fn fn) {
#pragma unroll
  for (int j = 0; j < kMaxChunk / kGroup; ++j)
    if (lt + j * kGroup < n) fn(lt + j * kGroup);
}

}  // namespace ssd

using namespace ssd;

// 1. The chunk states.  Grid (G * n_hb * n_pt * n_nt, nc, b), n_hb =
// ceil((H / G) / 4): a CTA per (four heads of one group, P tile, N tile)
// of a (chunk, batch).  The chunk's B, in the N tile, is staged once into
// shared memory (f32) and serves the four heads in place as the B operand;
// each group stages its head's x, scaled by exp(cum[Q-1] - cum[s]) dt[s],
// as A.  Dynamic shared memory: chunk_state_smem.
constexpr int kStateGroups = 4;
constexpr int kStateThreads = kStateGroups * kGroup;

template <typename T>
__global__ void __launch_bounds__(kStateThreads, 2) ssd_chunk_state_kernel(
    const T* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const T* __restrict__ B,
    float* __restrict__ states, float* __restrict__ cum_last, int L, int H,
    int P, int G, int N, int Q, int n_hb) {
  extern __shared__ __align__(16) float smem[];
  const int group = threadIdx.x / kGroup, lt = threadIdx.x % kGroup;
  const int qc_max = min(Q, L);
  const int s_cap = (qc_max + kTile - 1) / kTile * kTile;
  float* Bt = smem;                                     // [s_cap][64]
  float* stage = Bt + s_cap * kTile + group * kGroupStage;
  float* cum = Bt + s_cap * kTile + kStateGroups * kGroupStage +
               group * 2 * kMaxChunk;                   // [256]
  float* w = cum + kMaxChunk;                           // [256]

  const int n_pt = (P + kTile - 1) / kTile, n_nt = (N + kTile - 1) / kTile;
  const int n0 = blockIdx.x % n_nt * kTile;
  const int p0 = blockIdx.x / n_nt % n_pt * kTile;
  const int hbi = blockIdx.x / (n_nt * n_pt);
  const int grp = hbi / n_hb, rep = H / G;
  const int hh = hbi % n_hb * kStateGroups + group;     // head in its group
  const int h = grp * rep + hh;
  const int c = blockIdx.y, nc = gridDim.y, bb = blockIdx.z;
  const long long t0 = static_cast<long long>(bb) * L + c * Q;
  const int qc = min(Q, L - c * Q);
  const long long gn = static_cast<long long>(G) * N;

  stage_rows<kStateThreads>(B, t0, gn, grp, N, n0, qc, s_cap, Bt);
  __syncthreads();
  if (hh >= rep) return;

  if (lt < 32) chunk_cumsum(dt + t0 * H + h, H, A[h], qc, cum, lt);
  group_sync(group);
  const float last = cum[qc - 1];
  for_positions(lt, qc, [&](int s) {
    w[s] = expf(last - cum[s]) * dt[(t0 + s) * H + h];
  });
  if (p0 == 0 && n0 == 0 && lt == 0)
    cum_last[(static_cast<long long>(bb) * H + h) * nc + c] = last;
  group_sync(group);

  // rows p, columns n, reduction over the chunk's positions s
  const long long hp = static_cast<long long>(H) * P;
  const T* xg = x + (t0 * H + h) * P + p0 + lt;
  const bool p_ok = p0 + lt < P;
  auto fetch = [&](int slab, Raw<kDeep>& raw) {
#pragma unroll
    for (int i = 0; i < kDeep; ++i) {
      const int s = slab * kDeep + i;
      raw.v[i] = 0u;
      if (s < qc && p_ok) raw.v[i] = bits(xg + s * hp);
    }
  };
  auto put = [&](int slab, const Raw<kDeep>& raw, float* As) {
#pragma unroll
    for (int i = 0; i < kDeep; ++i) {
      const int s = slab * kDeep + i;
      As[i * kLd + lt] = from_bits<T>(raw.v[i]) * (s < qc ? w[s] : 0.f);
    }
  };
  auto b_of = [&](int slab) -> const float* {
    return Bt + slab * kDeep * kTile;
  };
  float acc[8][8] = {};
  group_gemm_one<false, kTile>((qc + kDeep - 1) / kDeep, b_of, fetch, put,
                               stage, group, lt, acc);

  float* out = states + ((static_cast<long long>(bb) * nc + c) * H + h) *
                            static_cast<long long>(P) * N;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int p = p0 + acc_row(i, lt);
    if (p >= P) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + acc_col(j, lt);
      if (n < N) out[static_cast<long long>(p) * N + n] = acc[i][j];
    }
  }
}

// 2. The states entering each chunk, in place, and the final state.
// Grid (ceil(P N / 256), b * H).
constexpr int kPassThreads = 256;

__global__ void __launch_bounds__(kPassThreads) ssd_state_pass_kernel(
    float* __restrict__ states, const float* __restrict__ cum_last,
    const float* __restrict__ init_state, float* __restrict__ final_state,
    int H, int PN, int nc) {
  constexpr int kAhead = 8;
  const int e = blockIdx.x * kPassThreads + threadIdx.x;
  if (e >= PN) return;
  const long long bh = blockIdx.y;
  const long long bb = bh / H, h = bh % H;
  const long long step = static_cast<long long>(H) * PN;   // one chunk
  float* p = states + (bb * nc * H + h) * PN + e;
  const float* decay = cum_last + bh * nc;
  float s = init_state ? init_state[bh * PN + e] : 0.f;
  for (int c0 = 0; c0 < nc; c0 += kAhead) {
    float st[kAhead];
#pragma unroll
    for (int j = 0; j < kAhead; ++j)
      st[j] = c0 + j < nc ? p[(c0 + j) * step] : 0.f;
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      if (c0 + j < nc) {
        p[(c0 + j) * step] = s;
        s = s * expf(decay[c0 + j]) + st[j];
      }
    }
  }
  final_state[bh * PN + e] = s;
}

// 3. The outputs.  Grid (n_qb * G * n_hb, nc, b); the last row blocks of a
// chunk (the most work) first; kScanGroups groups of 64 threads.  With the
// pivot q0 (the block's first row), for s < q0 <= t:
//   exp(cum[t] - cum[s]) = row[t] * exp(cum[q0] - cum[s]),  exp(cum[t]) =
//   row[t] * exp(cum[q0]),  row[t] = exp(cum[t] - cum[q0]),
// every factor <= 1.  So
//   y[t] = row[t] * (sum_{s < q0} CB[t, s] (col[s] x[s])
//                    + sum_n C[t, n] (exp(cum[q0]) S[., n]))
//        + sum_{q0 <= s <= t} CB[t, s] exp(cum[t] - cum[s]) dt[s] x[s]
//        + D x[t],   col[s] = exp(cum[q0] - cum[s]) dt[s]:
// the first sum's A operand, C.B^T and C, is the same for every head and
// read in place from shared memory; only its B operand (x and the state,
// scaled per head) is staged.  The diagonal tile stages both.  Dynamic
// shared memory: chunk_scan_smem.
constexpr int kScanGroups = 8;
constexpr int kScanThreads = kScanGroups * kGroup;
// Heads of one group a chunk-scan CTA runs, sharing its C.B^T (each of its
// thread groups takes two).  On the H100 at B 8, 48 heads, P 64, N 128, Q
// 256 it was within 3 % of the best of 8, 16, 24 and 48 at every served
// length (1024-8192); 8 was 11 % slower at 8192.
constexpr int kHeadBlock = 2 * kScanGroups;

template <typename T>
__global__ void __launch_bounds__(kScanThreads, 1) ssd_chunk_scan_kernel(
    const T* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const T* __restrict__ B,
    const T* __restrict__ C, const float* __restrict__ D,
    const float* __restrict__ states, T* __restrict__ y, int L, int H, int P,
    int G, int N, int Q, int n_qb, int n_hb, int has_init) {
  extern __shared__ __align__(16) float smem[];
  const int group = threadIdx.x / kGroup, lt = threadIdx.x % kGroup;
  const int qc_max = min(Q, L);
  const int s_cap = (qc_max + kTile - 1) / kTile * kTile;
  const int n_pad = (N + kDeep - 1) / kDeep * kDeep;
  float* CBt = smem;                         // [s_cap][64]: C[t].B[s] at [s][t]
  float* Ct = CBt + s_cap * kTile;           // [n_pad][64]: C[t, n] at [n][t]
  float* stage = Ct + n_pad * kTile + group * kGroupStage;
  float* cum = Ct + n_pad * kTile + kScanGroups * kGroupStage +
               group * (2 * kMaxChunk + kTile);   // [256]
  float* col = cum + kMaxChunk;              // [256]
  float* row = col + kMaxChunk;              // [64]

  const int per_q = G * n_hb;
  const int qb = n_qb - 1 - blockIdx.x / per_q;
  const int grp = (blockIdx.x % per_q) / n_hb;
  const int rep = H / G;
  const int h_begin = grp * rep + (blockIdx.x % n_hb) * kHeadBlock;
  const int h_end = min(h_begin + kHeadBlock, (grp + 1) * rep);
  const int c = blockIdx.y, nc = gridDim.y, bb = blockIdx.z;
  const int qc = min(Q, L - c * Q);
  const int q0 = qb * kTile;
  if (q0 >= qc || h_begin >= h_end) return;
  const int rows = min(kTile, qc - q0);
  const int s_len = q0 + rows;               // positions these rows reach
  const long long t0 = static_cast<long long>(bb) * L + c * Q;
  const bool has_prev = c > 0 || has_init;
  const long long gn = static_cast<long long>(G) * N;
  const long long hp = static_cast<long long>(H) * P;

  // the rows' C, transposed: Ct[n * 64 + r], eight loads a thread in
  // flight at a time
  {
    constexpr int kBatch = 8;
    const T* base = C + (t0 + q0) * gn + static_cast<long long>(grp) * N;
    for (int e0 = threadIdx.x; e0 < n_pad * kTile;
         e0 += kScanThreads * kBatch) {
      unsigned v[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int e = e0 + j * kScanThreads, r = e / n_pad, n = e % n_pad;
        v[j] = 0u;
        if (e < n_pad * kTile && r < rows && n < N)
          v[j] = bits(base + r * gn + n);
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int e = e0 + j * kScanThreads;
        if (e < n_pad * kTile) Ct[(e % n_pad) * kTile + e / n_pad] =
            from_bits<T>(v[j]);
      }
    }
  }
  __syncthreads();
  // C.B^T of the rows against positions [0, s_len): group j the 64
  // positions of tile j, C in place as A, B staged
  if (group * kTile < s_len) {
    const int sb = group * kTile;
    const T* brow = B + (t0 + sb) * gn + static_cast<long long>(grp) * N;
    auto fetch = [&](int slab, Raw<kDeep>& raw) {
      const int n = slab * kDeep + deep_k<kDeep>(lt);
#pragma unroll
      for (int i = 0; i < kDeep; ++i) {
        const int r = deep_row<kDeep>(i, lt);
        raw.v[i] = 0u;
        if (n < N && sb + r < s_len) raw.v[i] = bits(brow + r * gn + n);
      }
    };
    auto put = [&](int slab, const Raw<kDeep>& raw, float* Bs) {
      const int k = deep_k<kDeep>(lt);
#pragma unroll
      for (int i = 0; i < kDeep; ++i)
        Bs[k * kLd + deep_row<kDeep>(i, lt)] = from_bits<T>(raw.v[i]);
    };
    auto a_of = [&](int slab) -> const float* {
      return Ct + slab * kDeep * kTile;
    };
    float acc[8][8] = {};
    group_gemm_one<true, kTile>(n_pad / kDeep, a_of, fetch, put, stage,
                                group, lt, acc);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float* dst = CBt + (sb + acc_col(j, lt)) * kTile;
      *reinterpret_cast<float4*>(dst + acc_row(0, lt)) =
          make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
      *reinterpret_cast<float4*>(dst + acc_row(4, lt)) =
          make_float4(acc[4][j], acc[5][j], acc[6][j], acc[7][j]);
    }
  }
  __syncthreads();

  const int n_below = q0 / kDeep;            // q0 is a multiple of 64
  const int n_state = has_prev ? n_pad / kDeep : 0;
  for (int h = h_begin + group; h < h_end; h += kScanGroups) {
    if (lt < 32) chunk_cumsum(dt + t0 * H + h, H, A[h], s_len, cum, lt);
    group_sync(group);
    const float pivot = cum[q0];
    for_positions(lt, s_len, [&](int s) {
      const float d = dt[(t0 + s) * H + h];
      col[s] = s < q0 ? expf(pivot - cum[s]) * d : d;   // dt on the diagonal
    });
    if (lt < rows) row[lt] = expf(cum[q0 + lt] - pivot);
    group_sync(group);
    const float e0 = expf(pivot), dh = D[h];
    const float my_cum = lt < rows ? cum[q0 + lt] : 0.f;
    const float* S = states + ((static_cast<long long>(bb) * nc + c) * H + h) *
                                  static_cast<long long>(P) * N;
    for (int p0 = 0; p0 < P; p0 += kTile) {
      const T* xcol = x + (t0 * H + h) * P + p0 + lt;
      const bool p_ok = p0 + lt < P;
      float acc[8][8] = {};
      // below the diagonal tile, then the entering state: A in place
      auto a_of = [&](int slab) -> const float* {
        return slab < n_below ? CBt + slab * kDeep * kTile
                              : Ct + (slab - n_below) * kDeep * kTile;
      };
      auto fetch1 = [&](int slab, Raw<kDeep>& raw) {
        if (slab < n_below) {
#pragma unroll
          for (int i = 0; i < kDeep; ++i) {
            raw.v[i] = 0u;
            if (p_ok) raw.v[i] = bits(xcol + (slab * kDeep + i) * hp);
          }
          return;
        }
        const int n = (slab - n_below) * kDeep + deep_k<kDeep>(lt);
#pragma unroll
        for (int i = 0; i < kDeep; ++i) {
          const int p = p0 + deep_row<kDeep>(i, lt);
          raw.v[i] = 0u;
          if (n < N && p < P)
            raw.v[i] = bits(S + static_cast<long long>(p) * N + n);
        }
      };
      auto put1 = [&](int slab, const Raw<kDeep>& raw, float* Bs) {
        if (slab < n_below) {
#pragma unroll
          for (int i = 0; i < kDeep; ++i)
            Bs[i * kLd + lt] = from_bits<T>(raw.v[i]) * col[slab * kDeep + i];
          return;
        }
        const int k = deep_k<kDeep>(lt);
#pragma unroll
        for (int i = 0; i < kDeep; ++i)
          Bs[k * kLd + deep_row<kDeep>(i, lt)] =
              __uint_as_float(raw.v[i]) * e0;
      };
      group_gemm_one<true, kTile>(n_below + n_state, a_of, fetch1, put1,
                                  stage, group, lt, acc);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float f = row[acc_row(i, lt)];   // rows past `rows`: unused
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] *= f;
      }
      // the diagonal tile: the decayed scores staged as A, x as B
      auto fetch2 = [&](int slab, Raw<kPair>& raw) {
#pragma unroll
        for (int i = 0; i < kPair; ++i) {
          const int s = q0 + slab * kPair + i;
          raw.v[i] = 0u;
          if (s < s_len && p_ok) raw.v[i] = bits(xcol + s * hp);
        }
      };
      auto put2 = [&](int slab, const Raw<kPair>& raw, float* As, float* Bs) {
#pragma unroll
        for (int i = 0; i < kPair; ++i) {
          const int s = q0 + slab * kPair + i;   // row-fast: row lt
          float m = 0.f;
          if (lt < rows && s <= q0 + lt)
            m = CBt[s * kTile + lt] * expf(my_cum - cum[s]) * col[s];
          As[i * kLd + lt] = m;
          Bs[i * kLd + lt] = from_bits<T>(raw.v[i]);
        }
      };
      group_gemm((rows + kPair - 1) / kPair, fetch2, put2, stage, group, lt,
                 acc);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = acc_row(i, lt);
        if (r >= rows) continue;
        const long long base = ((t0 + q0 + r) * H + h) * P;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int p = p0 + acc_col(j, lt);
          if (p < P) narrow(acc[i][j] + dh * widen(x[base + p]), y + base + p);
        }
      }
    }
    // the group's cum, col and row are rewritten for its next head only
    // after group_gemm's last barrier, which every reader has passed
  }
}

namespace {

int s_cap_of(int Q, int L) {
  const int qc_max = Q < L ? Q : L;
  return (qc_max + kTile - 1) / kTile * kTile;
}

size_t chunk_state_smem(int Q, int L) {
  return sizeof(float) * (static_cast<size_t>(s_cap_of(Q, L)) * kTile +
                          kStateGroups * (kGroupStage + 2 * kMaxChunk));
}

size_t chunk_scan_smem(int Q, int L, int N) {
  const int n_pad = (N + kDeep - 1) / kDeep * kDeep;
  return sizeof(float) *
         (static_cast<size_t>(s_cap_of(Q, L) + n_pad) * kTile +
          kScanGroups * (kGroupStage + 2 * kMaxChunk + kTile));
}

template <typename T>
int launch(cudaStream_t st, const void* x_, const float* dt, const float* A,
           const void* B_, const void* C_, const float* D,
           const float* init_state, void* y_, float* final_state,
           float* states, float* cum_last, int b, int L, int H, int P, int G,
           int N, int Q) {
  const T* x = static_cast<const T*>(x_);
  const T* B = static_cast<const T*>(B_);
  const T* C = static_cast<const T*>(C_);
  T* y = static_cast<T*>(y_);
  const int nc = (L + Q - 1) / Q;
  const int rep = H / G;
  const int n_hb4 = (rep + kStateGroups - 1) / kStateGroups;
  const int tiles = ((P + kTile - 1) / kTile) * ((N + kTile - 1) / kTile);
  size_t smem = chunk_state_smem(Q, L);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_state_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_chunk_state_kernel<T><<<dim3(G * n_hb4 * tiles, nc, b), kStateThreads,
                              smem, st>>>(x, dt, A, B, states, cum_last, L,
                                          H, P, G, N, Q, n_hb4);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int PN = P * N;
  ssd_state_pass_kernel<<<dim3((PN + kPassThreads - 1) / kPassThreads, b * H),
                          kPassThreads, 0, st>>>(states, cum_last, init_state,
                                                 final_state, H, PN, nc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int n_qb = s_cap_of(Q, L) / kTile;
  const int n_hb = (rep + kHeadBlock - 1) / kHeadBlock;
  smem = chunk_scan_smem(Q, L, N);
  err = cudaFuncSetAttribute(ssd_chunk_scan_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_chunk_scan_kernel<T><<<dim3(n_qb * G * n_hb, nc, b), kScanThreads,
                             smem, st>>>(x, dt, A, B, C, D, states, y, L, H,
                                         P, G, N, Q, n_qb, n_hb,
                                         init_state != nullptr);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype 0: x, B, C and y f32; 1: bf16.  init_state may be null (a zero
// state).  states: (b, ceil(l / Q), H, P, N) f32 and cum_last (b, H,
// ceil(l / Q)) f32 are scratch.
int ssd_scan(void* stream, int dtype, const void* x, const float* dt,
             const float* A, const void* B, const void* C, const float* D,
             const float* init_state, void* y, float* final_state,
             float* states, float* cum_last, int b, int L, int H, int P,
             int G, int N, int Q) {
  if (b < 1 || L < 1 || H < 1 || P < 1 || G < 1 || N < 1 || H % G != 0 ||
      N > kMaxState || Q < 1 || Q > kMaxChunk ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(st, x, dt, A, B, C, D, init_state, y,
                                 final_state, states, cum_last, b, L, H, P,
                                 G, N, Q);
  return launch<float>(st, x, dt, A, B, C, D, init_state, y, final_state,
                       states, cum_last, b, L, H, P, G, N, Q);
}

const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
