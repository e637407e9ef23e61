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
//
// The fused entry, repro_ssm_scan_fused_fwd, is the counterpart of what the
// reference model's ssm_pallas region wraps (src/repro/models/ssm.py:84-91,
// the fused form's scan marked as one kernel region): the discretization
// and the scan in one kernel, xin (B, S, din) in and y out.  It computes
// dt = softplus(x * w_dt) = max(v, 0) + log1p(exp(-|v|)),
// a = exp(-exp(a_log) * dt) and bx = (dt * x) * bsel in registers, then the
// recurrence above; a and bx never reach device memory.  The layout is the
// first entry's.  Each channel's dt is computed once, not on each of its N
// lanes: lane n computes the softplus of steps t0 + n, t0 + n + N, ... of a
// group of kFusedSteps, and the lanes share them with __shfl_sync.  -exp(
// a_log[d, n]) is computed once a thread.  a_t and bx_t do not depend on h,
// so a group's are computed ahead of its chain h = a * h + bx, and the next
// group's x, bsel and csel are loaded while this one is computed.
//
// Bound of the fused entry on the H100: the special-function unit.  Bytes
// are small (xin read once, B*S*N of bsel and of csel, y written once: ~79
// MB at hymba-1.5b's prefill, 0.024 ms at 3.35 TB/s), but every (b, t, d,
// n) takes one exponential for a, B*S*din*N = 2.1e8 there, 16 a clock on
// each of the 132 SMs: ~0.05 ms at 1.98 GHz.
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

constexpr int kFusedSteps = 16;  // time steps a group (at least N)

// A group of the fused entry's inputs from step t0 on: x of this lane's
// steps t0 + n + j * N (P of them), bsel and csel of every step (G).
template <typename T, int N, int G, int P>
__device__ __forceinline__ void load_group(float (&rx)[P], float (&rb)[G],
                                           float (&rc)[G], const T* xp,
                                           const float* bp, const float* cp,
                                           int64_t t0, int64_t S,
                                           int64_t xs_t, int n, bool live) {
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int64_t t = t0 + n + j * N;
    rx[j] = live && t < S ? repro::to_f32(xp[t * xs_t]) : 0.f;
  }
#pragma unroll
  for (int u = 0; u < G; ++u) {
    const int64_t t = t0 + u;
    const bool ok = t < S;  // padded steps are computed, never stored
    rb[u] = ok ? bp[t * N] : 0.f;
    rc[u] = ok ? cp[t * N] : 0.f;
  }
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
    ssm_scan_fused_kernel(const T* __restrict__ xin, int64_t xs_b,
                          int64_t xs_t, const float* __restrict__ w_dt,
                          const float* __restrict__ a_log,
                          const float* __restrict__ bsel,
                          const float* __restrict__ csel,
                          float* __restrict__ y, int64_t S, int64_t din) {
  constexpr int kChannels = kThreads / N;
  constexpr int G = N > kFusedSteps ? N : kFusedSteps;  // steps a group
  constexpr int P = G / N;  // steps whose dt this lane computes
  const int n = threadIdx.x % N;
  const int64_t d = static_cast<int64_t>(blockIdx.x) * kChannels +
                    threadIdx.x / N;
  const int64_t b = blockIdx.y;
  // a channel past din still takes part in the shuffles, with zeros
  const bool live = d < din;
  const int64_t dl = live ? d : 0;
  const T* xp = xin + b * xs_b + dl;
  const float* bp = bsel + b * S * N + n;
  const float* cp = csel + b * S * N + n;
  float* yp = y + b * S * din + d;
  const float wdt = live ? w_dt[dl] : 0.f;
  const float neg_a = live ? -expf(a_log[dl * N + n]) : 0.f;

  float rx[P], rb[G], rc[G];
  load_group<T, N, G, P>(rx, rb, rc, xp, bp, cp, 0, S, xs_t, n, live);
  float h = 0.f;
  for (int64_t t0 = 0; t0 < S; t0 += G) {
    float nx[P], nb[G], nc[G];
    load_group<T, N, G, P>(nx, nb, nc, xp, bp, cp, t0 + G, S, xs_t, n,
                           live);
    // dt and dt * x of this lane's steps, once a channel
    float dt[P], dtx[P];
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const float v = rx[j] * wdt;
      dt[j] = fmaxf(v, 0.f) + log1pf(expf(-fabsf(v)));
      dtx[j] = dt[j] * rx[j];
    }
    // a and bx of every step of the group, ahead of the chain
    float ra[G], rbx[G];
#pragma unroll
    for (int u = 0; u < G; ++u) {
      const float dtu = __shfl_sync(0xffffffffu, dt[u / N], u % N, N);
      const float dtxu = __shfl_sync(0xffffffffu, dtx[u / N], u % N, N);
      ra[u] = expf(neg_a * dtu);
      rbx[u] = dtxu * rb[u];
    }
#pragma unroll
    for (int u = 0; u < G; ++u) {
      h = ra[u] * h + rbx[u];
      float v = h * rc[u];
#pragma unroll
      for (int o = N / 2; o > 0; o >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, o);
      if (n == 0 && live && t0 + u < S) yp[(t0 + u) * din] = v;
    }
#pragma unroll
    for (int j = 0; j < P; ++j) rx[j] = nx[j];
#pragma unroll
    for (int u = 0; u < G; ++u) {
      rb[u] = nb[u];
      rc[u] = nc[u];
    }
  }
}

template <typename T, int N>
int launch_fused(const void* xin, int64_t xs_b, int64_t xs_t,
                 const float* w_dt, const float* a_log, const float* bsel,
                 const float* csel, float* y, int64_t B, int64_t S,
                 int64_t din, cudaStream_t stream) {
  constexpr int kChannels = kThreads / N;
  const dim3 grid(static_cast<unsigned>((din + kChannels - 1) / kChannels),
                  static_cast<unsigned>(B));
  ssm_scan_fused_kernel<T, N><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(xin), xs_b, xs_t, w_dt, a_log, bsel, csel, y, S,
      din);
  return cudaGetLastError();
}

template <typename T>
int dispatch_fused(int64_t N, const void* xin, int64_t xs_b, int64_t xs_t,
                   const float* w_dt, const float* a_log, const float* bsel,
                   const float* csel, float* y, int64_t B, int64_t S,
                   int64_t din, cudaStream_t s) {
  switch (N) {
    case 1:
      return launch_fused<T, 1>(xin, xs_b, xs_t, w_dt, a_log, bsel, csel, y,
                                B, S, din, s);
    case 2:
      return launch_fused<T, 2>(xin, xs_b, xs_t, w_dt, a_log, bsel, csel, y,
                                B, S, din, s);
    case 4:
      return launch_fused<T, 4>(xin, xs_b, xs_t, w_dt, a_log, bsel, csel, y,
                                B, S, din, s);
    case 8:
      return launch_fused<T, 8>(xin, xs_b, xs_t, w_dt, a_log, bsel, csel, y,
                                B, S, din, s);
    case 16:
      return launch_fused<T, 16>(xin, xs_b, xs_t, w_dt, a_log, bsel, csel,
                                 y, B, S, din, s);
    case 32:
      return launch_fused<T, 32>(xin, xs_b, xs_t, w_dt, a_log, bsel, csel,
                                 y, B, S, din, s);
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

// xin (B, S, din) of `dtype` with unit stride along din and strides xs_b,
// xs_t (elements) along B and S; w_dt (din), a_log (din, N), bsel and csel
// (B, S, N) contiguous float32; y (B, S, din) float32 contiguous; N divides
// 32 (the wrapper checks).
extern "C" int repro_ssm_scan_fused_fwd(int dtype, const void* xin,
                                        int64_t xs_b, int64_t xs_t,
                                        const void* w_dt, const void* a_log,
                                        const void* bsel, const void* csel,
                                        void* y, int64_t B, int64_t S,
                                        int64_t din, int64_t N,
                                        void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || din <= 0 || xs_b < 0 || xs_t < 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* w = static_cast<const float*>(w_dt);
  const float* al = static_cast<const float*>(a_log);
  const float* bs = static_cast<const float*>(bsel);
  const float* cs = static_cast<const float*>(csel);
  float* yo = static_cast<float*>(y);
  if (dtype == repro::kFloat32)
    return dispatch_fused<float>(N, xin, xs_b, xs_t, w, al, bs, cs, yo, B, S,
                                 din, s);
  if (dtype == repro::kBFloat16)
    return dispatch_fused<__nv_bfloat16>(N, xin, xs_b, xs_t, w, al, bs, cs,
                                         yo, B, S, din, s);
  return cudaErrorInvalidValue;
}
