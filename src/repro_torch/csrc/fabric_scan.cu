// The fused fabric kernel of the PyTorch port, written by hand for Hopper
// (sm_90a).  It replaces the Pallas kernel built by the JAX package's
// core/fabric_pallas.py:_build_call and computes, for one cost-uniform
// super-batch of wire messages, the three serial-queue stages of the
// simulated MPI fabric and the finish reductions:
//
//   stage 1 (VCI banks):  t = max(t_ready[i], t) + c1[i]
//   stage 2 (NICs):       t = max(ys1[pos1[i]], t) + alpha_nic
//   stage 3 (wires):      r = ys2[pos2[i]] + rdv[i]; t = max(r, t) + c3[i];
//                         stored as (t + alpha_wire) + alpha_recv
//   finish:               per-flow max of arrivals, + foff via fperm,
//                         per-rank max.
//
// Bound on the H100: bytes moved (about 100 B per wire message) and the
// serial chain depth of each queue (24 VCI, 48 NIC, 8 wire steps per
// resource in the 32k-rank partitioned record).  Design: each bucket of
// segments of equal depth class is one launch with one thread per
// segment, walking its column of the step-major (K, G) lane matrix, so
// the reads of row k are coalesced across neighbouring segments and the
// only serial work is the chain itself.  Stages gather across segments,
// so the host launches bucket after bucket, in stage order, on one
// stream.
//
// Exactness: float64 throughout, every add written as __dadd_rn (no
// contraction; the build also passes -fmad=false and no fast-math), adds
// in the reference's order, fmax for max (no NaNs occur).  Masked lanes
// never update the carry.  Every entry point returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

inline unsigned blocks_for(int n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

// One bucket of one stage: segment g walks lanes k * G + g, k = 0..K-1.
//   r     = rsrc[ridx[lane]] (+ radd[cidx[lane]] when radd is given)
//   t     = max(r, cur) + (csrc ? csrc[cidx[lane]] : cscalar)
//   ys    = add_tail ? (t + tail1) + tail2 : t
//   cur   = t unless the lane is masked off
// init/ys/carry are already offset to the bucket's first group / slot;
// carry may be null (finish mode keeps no carried state).
__global__ void bucket_scan_kernel(
    int K, int G, const double* __restrict__ rsrc,
    const int* __restrict__ ridx, const double* __restrict__ radd,
    const double* __restrict__ csrc, const int* __restrict__ cidx,
    double cscalar, const bool* __restrict__ mask,
    const double* __restrict__ init, double* __restrict__ ys,
    double* __restrict__ carry, int add_tail, double tail1, double tail2) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= G) return;
  double cur = init[g];
  for (int k = 0; k < K; ++k) {
    const long long lane = static_cast<long long>(k) * G + g;
    double r = rsrc[ridx[lane]];
    if (radd != nullptr) r = __dadd_rn(r, radd[cidx[lane]]);
    const double c = csrc != nullptr ? csrc[cidx[lane]] : cscalar;
    const double t = __dadd_rn(fmax(r, cur), c);
    ys[lane] = add_tail ? __dadd_rn(__dadd_rn(t, tail1), tail2) : t;
    if (mask == nullptr || mask[lane]) cur = t;
  }
  if (carry != nullptr) carry[g] = cur;
}

// out[g] = max over k of src[idx[k * G + g]], masked lanes read as 0.0
// (every value reduced here is a positive time, so 0-fill is safe).
__global__ void bucket_colmax_kernel(int K, int G,
                                     const double* __restrict__ src,
                                     const int* __restrict__ idx,
                                     const bool* __restrict__ mask,
                                     double* __restrict__ out) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= G) return;
  double acc = 0.0;
  for (int k = 0; k < K; ++k) {
    const long long lane = static_cast<long long>(k) * G + g;
    const double v =
        (mask == nullptr || mask[lane]) ? src[idx[lane]] : 0.0;
    acc = k == 0 ? v : fmax(acc, v);
  }
  out[g] = acc;
}

// out[i] = src[idx[i]] (+ add[i] when add is given).
__global__ void gather_add_kernel(int n, const double* __restrict__ src,
                                  const int* __restrict__ idx,
                                  const double* __restrict__ add,
                                  double* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const double v = src[idx[i]];
  out[i] = add != nullptr ? __dadd_rn(v, add[i]) : v;
}

}  // namespace

extern "C" {

int fabric_bucket_scan(void* stream, int K, int G, const void* rsrc,
                       const void* ridx, const void* radd, const void* csrc,
                       const void* cidx, double cscalar, const void* mask,
                       const void* init, void* ys, void* carry, int add_tail,
                       double tail1, double tail2) {
  bucket_scan_kernel<<<blocks_for(G), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      K, G, static_cast<const double*>(rsrc), static_cast<const int*>(ridx),
      static_cast<const double*>(radd), static_cast<const double*>(csrc),
      static_cast<const int*>(cidx), cscalar, static_cast<const bool*>(mask),
      static_cast<const double*>(init), static_cast<double*>(ys),
      static_cast<double*>(carry), add_tail, tail1, tail2);
  return static_cast<int>(cudaGetLastError());
}

int fabric_bucket_colmax(void* stream, int K, int G, const void* src,
                         const void* idx, const void* mask, void* out) {
  bucket_colmax_kernel<<<blocks_for(G), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      K, G, static_cast<const double*>(src), static_cast<const int*>(idx),
      static_cast<const bool*>(mask), static_cast<double*>(out));
  return static_cast<int>(cudaGetLastError());
}

int fabric_gather_add(void* stream, int n, const void* src, const void* idx,
                      const void* add, void* out) {
  gather_add_kernel<<<blocks_for(n), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      n, static_cast<const double*>(src), static_cast<const int*>(idx),
      static_cast<const double*>(add), static_cast<double*>(out));
  return static_cast<int>(cudaGetLastError());
}

const char* fabric_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
