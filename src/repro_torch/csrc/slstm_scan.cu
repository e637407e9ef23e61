// sLSTM scan (xLSTM's scalar-memory recurrence) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/slstm_scan.py::
// slstm_scan (_slstm_kernel).  Per step t, for every batch row:
//   g = xg_t + h_{t-1} r   (r (D, 4D) upcast to f32, the sum in f32),
//   split into i, f, z, o;  log_f = log_sigmoid(f),  m' = max(log_f + m, i),
//   c' = e^{log_f + m - m'} c + e^{i - m'} tanh(z),  n' likewise with 1,
//   h' = sigmoid(o) c' / max(n', 1),
// with c = n = h = 0 and m = -1e30 at the start; xg (B, S, 4D) and r of one
// dtype (f32 or bf16), h (B, S, D) out in xg's dtype.
//
// The TPU kernel keeps all of r and the four states in VMEM and walks the
// time loop on one core.  r is dense: every unit of h_t needs all of
// h_{t-1}.  Here the units are split over the SMs: block j owns U
// consecutive units and keeps their 4U columns of r in shared memory in
// f32 for the whole sequence (U = 6 at D 768: 72 KB a block, 128 blocks).
// Each step a block reads h_{t-1} (all units, f32, from a double buffer in
// device memory that stays in L2), computes its 4U gate columns for every
// batch row (a warp a column, each value of r read once for all the rows),
// updates its units' c, n, m (in device memory, touched only by the thread
// that owns them; that thread loads them and its xg values before the
// product, so their latency hides behind it) and writes its units of h_t.
// Every block needs every other block's h_t before step t+1: one grid-wide
// barrier a step, `cooperative_groups::this_grid().sync()`, which is only
// legal when every block of the grid is resident at once.  So U is
// ceil(D / SMs), at most one block an SM, the kernel is launched with
// `cudaLaunchCooperativeKernel`, and the launch checks with
// `cudaOccupancyMaxActiveBlocksPerMultiprocessor` that the grid is
// co-resident; it fails rather than hangs if it is not.
//
// Bound on the H100: operations, 8 B S D^2 (the recurrent product) over the
// peak rate for the inputs' type (989 TFLOP/s bf16, 67 f32); the bytes (xg,
// h, and r once) are fewer.  The design is latency-bound instead: each step
// is a short dot product per gate column and a grid barrier (S barriers in
// all).
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBatchTile = 8;  // batch rows of h staged in shared memory
// units a block at most: a thread owns one (row, unit) of a batch tile
constexpr int kMaxUnits = kThreads / kBatchTile;

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

// Shared memory in floats: r's 4U columns (each D long), kBatchTile rows of
// h, and their 4U gate sums.
__host__ __device__ inline int64_t smem_floats(int64_t D, int64_t U) {
  return 4 * U * D + kBatchTile * D + kBatchTile * 4 * U;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    slstm_scan_kernel(const T* __restrict__ xg, const T* __restrict__ r,
                      T* __restrict__ out, float* __restrict__ hbuf,
                      float* __restrict__ state, int B, int64_t S, int D,
                      int U) {
  extern __shared__ __align__(16) float smem[];
  float* rs = smem;                                  // [4U][D]
  float* hs = rs + static_cast<int64_t>(4) * U * D;  // [kBatchTile][D]
  float* gs = hs + static_cast<int64_t>(kBatchTile) * D;  // [tile][4U]
  cg::grid_group grid = cg::this_grid();

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int j0 = blockIdx.x * U;
  const int units = min(U, D - j0);
  const int64_t D4 = 4 * static_cast<int64_t>(D);
  const int64_t BD = static_cast<int64_t>(B) * D;
  float* cst = state;           // c (B, D)
  float* nst = state + BD;      // n
  float* mst = state + 2 * BD;  // m

  // this block's columns of r: column c = g * U + u is r[:, g * D + j0 + u]
  for (int64_t i = tid; i < static_cast<int64_t>(4) * U * D; i += kThreads) {
    const int c = static_cast<int>(i / D), k = static_cast<int>(i % D);
    const int g = c / U, u = c % U;
    rs[i] = u < units ? repro::to_f32(r[k * D4 + g * D + j0 + u]) : 0.f;
  }
  for (int p = tid; p < B * units; p += kThreads) {
    const int64_t at = static_cast<int64_t>(p / units) * D + j0 + p % units;
    cst[at] = 0.f;
    nst[at] = 0.f;
    mst[at] = -1e30f;
  }
  __syncthreads();

  for (int64_t t = 0; t < S; ++t) {
    const float* hprev = hbuf + (t & 1) * BD;  // h_{t-1}; h_0 = 0
    float* hnext = hbuf + ((t + 1) & 1) * BD;
    for (int b0 = 0; b0 < B; b0 += kBatchTile) {
      const int nb = min(kBatchTile, B - b0);
      // this thread's (row, unit) of the tile, if any: its xg values and
      // states, loaded now and used after the product
      const bool owner = tid < nb * units;
      const int bb = owner ? tid / units : 0, u = owner ? tid % units : 0;
      const int64_t b = b0 + bb, at = b * D + j0 + u;
      float x4[4] = {0.f, 0.f, 0.f, 0.f}, c = 0.f, n = 0.f, m = 0.f;
      if (owner) {
        const T* x = xg + (b * S + t) * D4 + j0 + u;
#pragma unroll
        for (int g = 0; g < 4; ++g) x4[g] = repro::to_f32(x[g * D]);
        c = cst[at];
        n = nst[at];
        m = mst[at];
      }
      // h_{t-1} of other blocks: read past L1 (ld.global.cg), from L2
      for (int i = tid; i < nb * D; i += kThreads)
        hs[i] = __ldcg(hprev + static_cast<int64_t>(b0) * D + i);
      __syncthreads();
      // gate column sums: a warp per column of r, all the tile's rows at
      // once (one read of r for every row), the lanes over D
      for (int col = warp; col < 4 * U; col += kWarps) {
        const float* rc = rs + static_cast<int64_t>(col) * D;
        float acc[kBatchTile];
#pragma unroll
        for (int i = 0; i < kBatchTile; ++i) acc[i] = 0.f;
        for (int k = lane; k < D; k += 32) {
          const float rv = rc[k];
#pragma unroll
          for (int i = 0; i < kBatchTile; ++i)
            if (i < nb) acc[i] += hs[i * D + k] * rv;
        }
#pragma unroll
        for (int i = 0; i < kBatchTile; ++i) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], off);
        }
        if (lane == 0) {
#pragma unroll
          for (int i = 0; i < kBatchTile; ++i)
            if (i < nb) gs[i * 4 * U + col] = acc[i];
        }
      }
      __syncthreads();
      if (owner) {
        const float* g = gs + bb * 4 * U;
        const float gi = x4[0] + g[u];
        const float gf = x4[1] + g[U + u];
        const float gz = x4[2] + g[2 * U + u];
        const float go = x4[3] + g[3 * U + u];
        const float lf = log_sigmoid(gf);
        const float m_new = fmaxf(lf + m, gi);
        const float i_w = expf(gi - m_new);
        const float f_w = expf(lf + m - m_new);
        const float c_new = f_w * c + i_w * tanhf(gz);
        const float n_new = f_w * n + i_w;
        const float h = (1.f / (1.f + expf(-go))) * c_new / fmaxf(n_new, 1.f);
        cst[at] = c_new;
        nst[at] = n_new;
        mst[at] = m_new;
        hnext[at] = h;
        out[(b * S + t) * D + j0 + u] = repro::from_f32<T>(h);
      }
      __syncthreads();  // hs and gs are refilled by the next batch tile
    }
    grid.sync();  // h_t is complete before any block reads it
  }
}

template <typename T>
int launch(const void* xg, const void* r, void* out, float* hbuf,
           float* state, int64_t B, int64_t S, int64_t D,
           cudaStream_t stream) {
  int dev = 0, sms = 0, coop = 0, max_smem = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  if (!coop) return cudaErrorNotSupported;
  // One block an SM at most: the fewest units a block.
  const int64_t U = (D + sms - 1) / sms;
  const size_t smem = sizeof(float) * smem_floats(D, U);
  if (U > kMaxUnits || smem > static_cast<size_t>(max_smem))
    return cudaErrorCooperativeLaunchTooLarge;
  e = cudaFuncSetAttribute(slstm_scan_kernel<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, slstm_scan_kernel<T>, kThreads, smem);
  if (e != cudaSuccess) return e;
  const int64_t blocks = (D + U - 1) / U;
  if (blocks > static_cast<int64_t>(per_sm) * sms)
    return cudaErrorCooperativeLaunchTooLarge;
  const T* xg_t = static_cast<const T*>(xg);
  const T* r_t = static_cast<const T*>(r);
  T* out_t = static_cast<T*>(out);
  int b = static_cast<int>(B), d = static_cast<int>(D);
  int u = static_cast<int>(U);
  void* args[] = {&xg_t, &r_t, &out_t, &hbuf, &state, &b, &S, &d, &u};
  return cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(slstm_scan_kernel<T>),
      dim3(static_cast<unsigned>(blocks)), dim3(kThreads), args, smem,
      stream);
}

}  // namespace

// xg (B, S, 4D) and r (D, 4D) of one dtype, out (B, S, D) of that dtype;
// hbuf (2, B, D) f32 with hbuf[0] zero; state (3, B, D) f32 scratch; all
// contiguous (the wrapper checks and allocates).
extern "C" int repro_slstm_scan_fwd(int dtype, const void* xg, const void* r,
                                    void* out, void* hbuf, void* state,
                                    int64_t B, int64_t S, int64_t D,
                                    void* stream) {
  if (B <= 0 || B > (1 << 20) || S <= 0 || D <= 0 || D > (1 << 20))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* hb = static_cast<float*>(hbuf);
  float* st = static_cast<float*>(state);
  if (dtype == repro::kFloat32)
    return launch<float>(xg, r, out, hb, st, B, S, D, s);
  if (dtype == repro::kBFloat16)
    return launch<__nv_bfloat16>(xg, r, out, hb, st, B, S, D, s);
  return cudaErrorInvalidValue;
}
