// The fused fabric kernel of the PyTorch port, written by hand for Hopper
// (sm_90a).  It replaces the Pallas kernel built by the JAX package's
// core/fabric_pallas.py:_build_call and computes, for one cost-uniform
// super-batch of wire messages, the three serial-queue stages of the
// simulated MPI fabric and the finish reduction, in one launch:
//
//   VCI bank v:   t1 = max(t_ready, vci[v]) + c1            vci[v] = t1
//   NIC:          t2 = max(t1, nic) + alpha_nic             nic    = t2
//                 t2 = t2 + 2 alpha_wire  (rendezvous messages only)
//   wire l:       t3 = max(t2, wire[l]) + c3                wire[l] = t3
//   arrival:      (t3 + alpha_wire) + alpha_recv
//   finish:       out[dst] = max over messages into dst of arrival + foff
//
// All three queues of a message belong to its source rank (VCI (src, v),
// NIC src, wire (src, dst)), so each source rank-record -- one grid item's
// messages from one rank, in merge order -- is independent of every other.
// Design: one thread per rank-record walks its messages through all three
// queues; its VCI and link carries sit in shared memory (the host rejects
// a record whose carries exceed a block's share), the NIC carry in a
// register.  Nothing crosses between threads, so there is no barrier and
// no second pass: the finish is a max, taken with an atomic max (a
// reduction, red.global.max.u64) on the bit patterns of the positive
// arrival times, which order as the doubles do.
//
// Bound on the H100: bytes (40 per message in finish mode: three float64
// columns, the slot word, the output slot and the finish offset) and the
// serial chain of the deepest rank-record.  The host lays messages out
// warp-interleaved (message k of lane j of a warp at base + k * lanes + j
// up to the warp's least depth, each lane's rest after it), so the loads
// of one step coalesce across the warp.  Each thread loads the next batch
// of messages before it runs the current one's chain, and forwards the
// carries of earlier messages of the batch in registers, so the loop
// waits on neither device memory nor shared memory: the chain of a
// record that walks alone is bound by the issue of its one thread's
// instructions, the max/add chain and the bookkeeping around it.
//
// Exactness: one scalar type throughout, every add written as __dadd_rn
// (float64) or __fadd_rn (float32), so nvcc contracts nothing (the build
// also passes -fmad=false and no fast-math), adds in the reference's
// order, max as a compare and a select (vmax).  Adding 0.0 is identity on
// these positive times, so the rendezvous add is taken only where it is
// not 0.
//
// Two builds of the one template (Num<T> below): fabric_rank_scan, float64
// (bit for bit equal to the scalar reference), and fabric_rank_scan_f32,
// the engines' float32 mode (tolerance-close to the reference, bit for bit
// equal to its plain version).  In float32 the finish is red.global.max.u32
// on the float's bits, the output zeroed as floats, and shared memory is
// sized in floats.  Each entry point returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBatch = 2;
constexpr unsigned kVciMask = 0xffu;       // slot bits 0-7: VCI slot
constexpr unsigned kLinkMask = 0x7fffffu;  // slot bits 8-30: link slot
constexpr unsigned kRdvBit = 1u << 31;     // slot bit 31: rendezvous

// One rank-record, as the host describes it (12 int32, three int4 loads).
struct __align__(16) Record {
  int m0, stride, kw, tail;  // layout: message k at m0 + stride * k while
                             // k < kw, else at tail + (k - kw)
  int depth, rec, cv0, nv;   // messages; NIC carry index; VCI carries
  int cl0, nl, soff, pad;    // link carries; offset in shared memory
};

// max of two of these times: a compare and a select.  No NaN occurs and
// equal times are equal bits (the only other tie, +0 against -0, adds to
// the same sum), so it gives fmax's result without its NaN handling.
template <typename T>
__device__ __forceinline__ T vmax(T a, T b) {
  return a > b ? a : b;
}

// The scalar type's round-to-nearest add and its order-free finish: out =
// max(out, bits of v), as a reduction with no return value (the thread
// never waits for it).  The times are >= 0, so their bit patterns order as
// the values do.
template <typename T>
struct Num;

template <>
struct Num<double> {
  using Bits = unsigned long long;
  static __device__ __forceinline__ double add(double a, double b) {
    return __dadd_rn(a, b);
  }
  static __device__ __forceinline__ void red_max(Bits* out, double v) {
    asm volatile("red.global.max.u64 [%0], %1;" ::"l"(out),
                 "l"(static_cast<Bits>(__double_as_longlong(v)))
                 : "memory");
  }
};

template <>
struct Num<float> {
  using Bits = unsigned int;
  static __device__ __forceinline__ float add(float a, float b) {
    return __fadd_rn(a, b);
  }
  static __device__ __forceinline__ void red_max(Bits* out, float v) {
    asm volatile("red.global.max.u32 [%0], %1;" ::"l"(out),
                 "r"(__float_as_uint(v))
                 : "memory");
  }
};

template <typename T>
struct Msg {
  T tr, c1, c3, fo;
  unsigned slot;
  int out;
};

template <typename T, bool kFinish>
__device__ __forceinline__ void load_batch(
    Msg<T> (&m)[kBatch], int k0, const Record& R, const T* __restrict__ tr,
    const T* __restrict__ c1, const T* __restrict__ c3,
    const unsigned* __restrict__ slot, const int* __restrict__ out,
    const T* __restrict__ foff) {
#pragma unroll
  for (int j = 0; j < kBatch; ++j) {
    const int k = k0 + j;
    if (k < R.depth) {
      const int p = k < R.kw ? R.m0 + R.stride * k : R.tail + (k - R.kw);
      m[j].tr = tr[p];
      m[j].c1 = c1[p];
      m[j].c3 = c3[p];
      m[j].slot = slot[p];
      m[j].out = out[p];
      if (kFinish) m[j].fo = foff[p];
    }
  }
}

// The kernel's operands that the walk below reads and writes.
template <typename T>
struct Args {
  const T* __restrict__ tr;
  const T* __restrict__ c1;
  const T* __restrict__ c3;
  const unsigned* __restrict__ slot;
  const int* __restrict__ out;
  const T* __restrict__ foff;
  T alpha_nic, rdv_add, alpha_wire, alpha_recv;
  T* __restrict__ arr;
  typename Num<T>::Bits* __restrict__ rank_out;
};

// One record's walk through the three queues: V and W are its VCI and
// link carries, nic its NIC carry.
template <typename T, bool kFinish>
struct Walk {
  const Record& R;
  const Args<T>& A;
  T* V;
  T* W;
  T nic;
  int pend_dst;  // finish: the output slot of the running max
  T pend;

  // Messages k0 .. k0 + kBatch - 1 (those below the depth), loaded in m.
  __device__ __forceinline__ void batch(const Msg<T> (&m)[kBatch], int k0) {
    unsigned vs[kBatch], ls[kBatch];
    T bv[kBatch], bw[kBatch], t1s[kBatch], t3s[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {  // carries as the batch found them
      vs[j] = m[j].slot & kVciMask;
      ls[j] = (m[j].slot >> 8) & kLinkMask;
      t1s[j] = t3s[j] = T(0);
      if (k0 + j < R.depth) {
        bv[j] = V[vs[j]];
        bw[j] = W[ls[j]];
      }
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (k0 + j < R.depth) {
        T cv = bv[j], cw = bw[j];
#pragma unroll
        for (int i = 0; i < j; ++i) {  // forward earlier messages' carries
          if (vs[i] == vs[j]) cv = t1s[i];
          if (ls[i] == ls[j]) cw = t3s[i];
        }
        const T t1 = Num<T>::add(vmax(m[j].tr, cv), m[j].c1);
        t1s[j] = t1;
        T t2 = Num<T>::add(vmax(t1, nic), A.alpha_nic);
        nic = t2;
        if (m[j].slot & kRdvBit) t2 = Num<T>::add(t2, A.rdv_add);
        const T t3 = Num<T>::add(vmax(t2, cw), m[j].c3);
        t3s[j] = t3;
        const T a = Num<T>::add(Num<T>::add(t3, A.alpha_wire), A.alpha_recv);
        if (kFinish) {
          const T v = Num<T>::add(a, m[j].fo);
          if (m[j].out == pend_dst) {
            pend = vmax(pend, v);
          } else {
            if (pend_dst >= 0) Num<T>::red_max(A.rank_out + pend_dst, pend);
            pend_dst = m[j].out;
            pend = v;
          }
        } else {
          A.arr[m[j].out] = a;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {  // in order: the last write wins
      if (k0 + j < R.depth) {
        V[vs[j]] = t1s[j];
        W[ls[j]] = t3s[j];
      }
    }
  }

  // The whole record, two batch buffers in turn: the next batch's loads
  // are in flight while the current batch's chain runs.
  __device__ __forceinline__ T run() {
    Msg<T> a[kBatch], b[kBatch];
    load_batch<T, kFinish>(a, 0, R, A.tr, A.c1, A.c3, A.slot, A.out, A.foff);
    for (int k0 = 0; k0 < R.depth; k0 += 2 * kBatch) {
      const int k1 = k0 + kBatch;
      if (k1 < R.depth)
        load_batch<T, kFinish>(b, k1, R, A.tr, A.c1, A.c3, A.slot, A.out,
                               A.foff);
      batch(a, k0);
      if (k1 >= R.depth) break;
      if (k1 + kBatch < R.depth)
        load_batch<T, kFinish>(a, k1 + kBatch, R, A.tr, A.c1, A.c3, A.slot,
                               A.out, A.foff);
      batch(b, k1);
    }
    if (kFinish && pend_dst >= 0) Num<T>::red_max(A.rank_out + pend_dst, pend);
    return nic;
  }
};

template <typename T, bool kFinish>
__device__ __forceinline__ T walk(const Record& R, const Args<T>& A, T* V,
                                  T* W, T nic) {
  Walk<T, kFinish> w{R, A, V, W, nic, -1, T(0)};
  return w.run();
}

template <typename T, bool kFinish>
__global__ void __launch_bounds__(kThreads, 4) fabric_rank_kernel(
    const int* __restrict__ cta, const Record* __restrict__ records,
    const Args<T> A, const T* __restrict__ i1, const T* __restrict__ i2,
    const T* __restrict__ i3, T* __restrict__ o1, T* __restrict__ o2,
    T* __restrict__ o3) {
  // shared memory in slots of T (declared as raw bytes: the two builds
  // would otherwise declare one extern array with two types)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int r = cta[blockIdx.x] + static_cast<int>(threadIdx.x);
  if (r >= cta[blockIdx.x + 1]) return;
  const Record R = records[r];
  T nic = i2 != nullptr ? i2[R.rec] : T(0);
  T* V = smem + R.soff;
  T* W = V + R.nv;
  for (int j = 0; j < R.nv; ++j) V[j] = i1 != nullptr ? i1[R.cv0 + j] : T(0);
  for (int j = 0; j < R.nl; ++j) W[j] = i3 != nullptr ? i3[R.cl0 + j] : T(0);
  nic = walk<T, kFinish>(R, A, V, W, nic);
  if (!kFinish) {
    for (int j = 0; j < R.nv; ++j) o1[R.cv0 + j] = V[j];
    for (int j = 0; j < R.nl; ++j) o3[R.cl0 + j] = W[j];
    o2[R.rec] = nic;
  }
}

// One super-batch of scalar type T: zero the per-rank output (finish
// mode), then one launch of n_cta blocks, smem_slots carries of T each.
// The scalar costs arrive as doubles; in float32 the caller has rounded
// them already, so the conversion is exact.
template <typename T>
int rank_scan(void* stream, int finish, int n_cta, int smem_slots,
              const void* cta, const void* records, const void* tr,
              const void* c1, const void* c3, const void* slot,
              const void* out, const void* foff, const void* i1,
              const void* i2, const void* i3, double alpha_nic,
              double rdv_add, double alpha_wire, double alpha_recv, void* arr,
              void* o1, void* o2, void* o3, void* rank_out, long long n_out) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (finish) {
    const cudaError_t rc = cudaMemsetAsync(
        rank_out, 0, static_cast<size_t>(n_out) * sizeof(T), s);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  if (n_cta == 0) return static_cast<int>(cudaGetLastError());
  const size_t shmem = static_cast<size_t>(smem_slots) * sizeof(T);
  const Args<T> A{static_cast<const T*>(tr),
                  static_cast<const T*>(c1),
                  static_cast<const T*>(c3),
                  static_cast<const unsigned*>(slot),
                  static_cast<const int*>(out),
                  static_cast<const T*>(foff),
                  static_cast<T>(alpha_nic),
                  static_cast<T>(rdv_add),
                  static_cast<T>(alpha_wire),
                  static_cast<T>(alpha_recv),
                  static_cast<T*>(arr),
                  static_cast<typename Num<T>::Bits*>(rank_out)};
  const int* c = static_cast<const int*>(cta);
  const Record* rd = static_cast<const Record*>(records);
  const T* n1 = static_cast<const T*>(i1);
  const T* n2 = static_cast<const T*>(i2);
  const T* n3 = static_cast<const T*>(i3);
  T* d1 = static_cast<T*>(o1);
  T* d2 = static_cast<T*>(o2);
  T* d3 = static_cast<T*>(o3);
  if (finish)
    fabric_rank_kernel<T, true><<<n_cta, kThreads, shmem, s>>>(
        c, rd, A, n1, n2, n3, d1, d2, d3);
  else
    fabric_rank_kernel<T, false><<<n_cta, kThreads, shmem, s>>>(
        c, rd, A, n1, n2, n3, d1, d2, d3);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// One super-batch in float64.  Pointers that a mode does not use may be
// null; null init vectors mean a cold start (every carry 0).
int fabric_rank_scan(void* stream, int finish, int n_cta, int smem_doubles,
                     const void* cta, const void* records, const void* tr,
                     const void* c1, const void* c3, const void* slot,
                     const void* out, const void* foff, const void* i1,
                     const void* i2, const void* i3, double alpha_nic,
                     double rdv_add, double alpha_wire, double alpha_recv,
                     void* arr, void* o1, void* o2, void* o3, void* rank_out,
                     long long n_out) {
  return rank_scan<double>(stream, finish, n_cta, smem_doubles, cta, records,
                           tr, c1, c3, slot, out, foff, i1, i2, i3,
                           alpha_nic, rdv_add, alpha_wire, alpha_recv, arr,
                           o1, o2, o3, rank_out, n_out);
}

// The same super-batch in float32: every float operand and output float32,
// smem_slots carries of 4 bytes.
int fabric_rank_scan_f32(void* stream, int finish, int n_cta, int smem_slots,
                         const void* cta, const void* records, const void* tr,
                         const void* c1, const void* c3, const void* slot,
                         const void* out, const void* foff, const void* i1,
                         const void* i2, const void* i3, double alpha_nic,
                         double rdv_add, double alpha_wire, double alpha_recv,
                         void* arr, void* o1, void* o2, void* o3,
                         void* rank_out, long long n_out) {
  return rank_scan<float>(stream, finish, n_cta, smem_slots, cta, records, tr,
                          c1, c3, slot, out, foff, i1, i2, i3, alpha_nic,
                          rdv_add, alpha_wire, alpha_recv, arr, o1, o2, o3,
                          rank_out, n_out);
}

const char* fabric_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
