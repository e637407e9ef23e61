// Selective scan (Mamba-style SSM recurrence) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssm_scan.py::ssm_scan
// (_ssm_kernel): h_t = a_t * h_{t-1} + bx_t, y_t = h_t . c_t, h_0 = 0, with
// a/bx (B, S, din, N) and c (B, S, N) of one dtype, f32 or bf16, read as
// f32, and y (B, S, din) f32.  The TPU kernel walks a grid (batch,
// n_chunks) in order and carries the whole (din, N) state in VMEM scratch
// from one chunk to the next.  Blocks on the H100 run in no order, so nothing is carried between
// them: here one thread owns one (b, d, n) for the whole sequence and keeps
// its h in a register, and the time loop runs inside the kernel.  The N
// lanes of a channel are adjacent, so a (b, t) row of a/bx is one coalesced
// load, and y_t[d] = sum_n h * c_t[n] is a __shfl_xor_sync reduction within
// those N lanes (N divides 32).  A block is kThreads / N channels x N lanes;
// the grid is (din / channels, B).
//
// Bound on the H100: bytes, (2*B*S*din*N + B*S*N) * itemsize + B*S*din*4
// over 3.35 TB/s -- each element of a/bx is read once and used in one
// multiply-add.  Loads of a_t and bx_t do not depend on h, so the loop is
// software-pipelined in registers: the kU steps of the next time chunk are
// loaded while the kU steps of this one are computed, which keeps kU loads
// of each array in flight per thread instead of one.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;  // a block: kThreads / N channels x N lanes
constexpr int kU = 8;          // time steps loaded ahead per thread

template <typename T>
__device__ __forceinline__ void load_steps(float (&ra)[kU], float (&rb)[kU],
                                           float (&rc)[kU], const T* ap,
                                           const T* bp, const T* cp,
                                           int64_t t0, int64_t S,
                                           int64_t row, int N, bool live) {
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    const int64_t t = t0 + u;
    const bool ok = live && t < S;  // padded steps: a = bx = 0, not stored
    ra[u] = ok ? repro::to_f32(ap[t * row]) : 0.f;
    rb[u] = ok ? repro::to_f32(bp[t * row]) : 0.f;
    rc[u] = ok ? repro::to_f32(cp[t * N]) : 0.f;
  }
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
    ssm_scan_kernel(const T* __restrict__ a, const T* __restrict__ bx,
                    const T* __restrict__ c, float* __restrict__ y,
                    int64_t S, int64_t din) {
  constexpr int kChannels = kThreads / N;
  const int n = threadIdx.x % N;
  const int64_t d = static_cast<int64_t>(blockIdx.x) * kChannels +
                    threadIdx.x / N;
  const int64_t b = blockIdx.y;
  // a channel past din still takes part in the shuffles, with zeros
  const bool live = d < din;
  const int64_t row = din * N;  // elements of one (b, t) row of a / bx
  const int64_t off = b * S * row + (live ? d : 0) * N + n;
  const T* ap = a + off;
  const T* bp = bx + off;
  const T* cp = c + b * S * N + n;
  float* yp = y + b * S * din + d;

  float ra[kU], rb[kU], rc[kU];
  load_steps(ra, rb, rc, ap, bp, cp, 0, S, row, N, live);
  float h = 0.f;
  for (int64_t t0 = 0; t0 < S; t0 += kU) {
    float na[kU], nb[kU], nc[kU];
    load_steps(na, nb, nc, ap, bp, cp, t0 + kU, S, row, N, live);
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      h = ra[u] * h + rb[u];
      float v = h * rc[u];
#pragma unroll
      for (int o = N / 2; o > 0; o >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, o);
      if (n == 0 && live && t0 + u < S) yp[(t0 + u) * din] = v;
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      ra[u] = na[u];
      rb[u] = nb[u];
      rc[u] = nc[u];
    }
  }
}

template <typename T, int N>
int launch(const void* a, const void* bx, const void* c, void* y, int64_t B,
           int64_t S, int64_t din, cudaStream_t stream) {
  constexpr int kChannels = kThreads / N;
  const dim3 grid(static_cast<unsigned>((din + kChannels - 1) / kChannels),
                  static_cast<unsigned>(B));
  ssm_scan_kernel<T, N><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(bx),
      static_cast<const T*>(c), static_cast<float*>(y), S, din);
  return cudaGetLastError();
}

template <typename T>
int dispatch_n(int64_t N, const void* a, const void* bx, const void* c,
               void* y, int64_t B, int64_t S, int64_t din,
               cudaStream_t stream) {
  switch (N) {
    case 1:
      return launch<T, 1>(a, bx, c, y, B, S, din, stream);
    case 2:
      return launch<T, 2>(a, bx, c, y, B, S, din, stream);
    case 4:
      return launch<T, 4>(a, bx, c, y, B, S, din, stream);
    case 8:
      return launch<T, 8>(a, bx, c, y, B, S, din, stream);
    case 16:
      return launch<T, 16>(a, bx, c, y, B, S, din, stream);
    case 32:
      return launch<T, 32>(a, bx, c, y, B, S, din, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// a, bx (B, S, din, N) and c (B, S, N) of one dtype; y (B, S, din) float32;
// all contiguous; N divides 32 (the wrapper checks).
extern "C" int repro_ssm_scan_fwd(int dtype, const void* a, const void* bx,
                                  const void* c, void* y, int64_t B,
                                  int64_t S, int64_t din, int64_t N,
                                  void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || din <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32)
    return dispatch_n<float>(N, a, bx, c, y, B, S, din, s);
  if (dtype == repro::kBFloat16)
    return dispatch_n<__nv_bfloat16>(N, a, bx, c, y, B, S, din, s);
  return cudaErrorInvalidValue;
}
