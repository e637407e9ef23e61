// RMSNorm for Hopper (sm_90a): the baseline and the pipelined kernel of the
// paper's case study (section VI-D(b)), side by side so that one
// `nvcc -ptx` shows both (`core/ptx_frontend.py` reads them).
//
// Pipelined RMSNorm.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rmsnorm.py::
// rmsnorm_pipelined (_rmsnorm_pipelined_kernel): out = x * rsqrt(mean(x^2)
// + eps) * scale in f32, cast to x's dtype.  As there, rows stay in device
// memory and the kernel itself double-buffers row blocks into on-chip memory
// with one completion counter per buffer: here a 2-stage ring of cp.async
// groups (16-byte copies) in shared memory, so row block i+1 is in flight
// while row block i is reduced.  `cp.async.wait_group 1` waits for the older
// group only -- the split wait counters of the paper's case study.
//
// Bound on the H100: bytes, 2*R*D*itemsize + D*itemsize over 3.35 TB/s.
// The design moves each input byte once (global -> shared by cp.async, no
// register staging) and each output byte once; one block per SM walks
// several row blocks so the copy of the next overlaps the math of this one.
// A row block is kRowsPerBlock rows, one warp each, a constant of the
// kernel; where two blocks of 8 wide rows do not fit the 227 KB of shared
// memory (f32 rows above 3632 values) the wrapper asks for fewer, and a
// second instantiation (ROWS = 0) takes the count as an argument and
// leaves the spare warps idle.
#include "common.cuh"

namespace {

constexpr int kRowsPerBlock = 8;  // the most rows a row block; a warp a row
constexpr int kThreads = 32 * kRowsPerBlock;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_older() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Issue the 16-byte copies of row block `rb` of `rows` rows (fewer at the
// ragged end) into `buf`.
template <typename T>
__device__ void issue_row_block(T* buf, const T* x, int64_t rb, int rows,
                                int64_t R, int64_t D) {
  const int64_t row0 = rb * rows;
  const int64_t n = min(static_cast<int64_t>(rows), R - row0);
  const int64_t chunks = n * D * static_cast<int64_t>(sizeof(T)) / 16;
  const char* src = reinterpret_cast<const char*>(x + row0 * D);
  char* dst = reinterpret_cast<char*>(buf);
  for (int64_t c = threadIdx.x; c < chunks; c += blockDim.x)
    cp_async16(dst + 16 * c, src + 16 * c);
}

template <typename T, int ROWS>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_pipelined_kernel(const T* __restrict__ x,
                             const T* __restrict__ scale, T* __restrict__ out,
                             int64_t R, int64_t D, float eps, int rows_arg) {
  const int rows = ROWS > 0 ? ROWS : rows_arg;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* bufs = reinterpret_cast<T*>(smem_raw);  // [2][rows][D]
  const int64_t n_blocks = (R + rows - 1) / rows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  int64_t rb = blockIdx.x;
  if (rb >= n_blocks) return;  // uniform over the block

  int stage = 0;
  issue_row_block(bufs, x, rb, rows, R, D);
  cp_async_commit();
  for (; rb < n_blocks; rb += gridDim.x) {
    const int64_t next = rb + gridDim.x;
    if (next < n_blocks)
      issue_row_block(bufs + (stage ^ 1) * rows * D, x, next, rows, R, D);
    cp_async_commit();     // one group per buffer, empty at the tail
    cp_async_wait_older(); // this buffer has landed; the next may fly
    __syncthreads();

    const int64_t row = rb * rows + warp;
    if (warp < rows && row < R) {
      const T* xr = bufs + (stage * rows + warp) * D;
      float ss = 0.f;
      for (int64_t j = lane; j < D; j += 32) {  // D need not divide by 32
        const float v = repro::to_f32(xr[j]);
        ss += v * v;
      }
      for (int o = 16; o > 0; o >>= 1)
        ss += __shfl_xor_sync(0xffffffffu, ss, o);
      const float inv = rsqrtf(ss / static_cast<float>(D) + eps);
      T* orow = out + row * D;
      for (int64_t j = lane; j < D; j += 32)
        orow[j] = repro::from_f32<T>(repro::to_f32(xr[j]) * inv *
                                     repro::to_f32(scale[j]));
    }
    __syncthreads();  // buffer `stage` is refilled on the next iteration
    stage ^= 1;
  }
}

template <typename T, int ROWS>
int launch(const void* x, const void* scale, void* out, int64_t R,
           int64_t D, float eps, int rows, int64_t grid,
           cudaStream_t stream) {
  const size_t smem = 2 * static_cast<size_t>(rows) * D * sizeof(T);
  // Raise the shared-memory limit once per instantiation (not on every
  // launch, and never inside a CUDA-graph capture after the first call).
  static size_t configured = 0;
  if (smem > configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        rmsnorm_pipelined_kernel<T, ROWS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    configured = smem;
  }
  rmsnorm_pipelined_kernel<T, ROWS><<<static_cast<unsigned>(grid), kThreads,
                                      smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(scale),
      static_cast<T*>(out), R, D, eps, rows);
  return cudaGetLastError();
}

// 8 rows a block as a constant (every row that fits), or fewer as an
// argument.
template <typename T>
int dispatch_pipelined(const void* x, const void* scale, void* out,
                       int64_t R, int64_t D, float eps, int rows,
                       int64_t grid, cudaStream_t stream) {
  if (rows == kRowsPerBlock)
    return launch<T, kRowsPerBlock>(x, scale, out, R, D, eps, rows, grid,
                                    stream);
  return launch<T, 0>(x, scale, out, R, D, eps, rows, grid, stream);
}

// Baseline RMSNorm.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rmsnorm.py::
// rmsnorm_baseline (_rmsnorm_kernel): the same function, one row block of
// 8 rows per grid step through the implicit BlockSpec pipeline, so each
// step's compute waits on its own block's arrival.  Here one block per 8-row
// block, one warp per row, and the row is loaded straight from device memory
// into registers (PER_LANE values a lane, the lane-strided, coalesced
// pattern of the pipelined kernel's reduction): no cp.async and no
// shared-memory ring -- the synchronous-load pattern the case study
// contrasts with the kernel above.  The f32 sum of squares is taken in the
// same order as there (lane-strided, then __shfl_xor_sync).
//
// Bound on the H100: bytes, (2*R*D + D)*itemsize over 3.35 TB/s (0.0044 ms
// at R 4096, D 896, bf16).  Each input byte is read once and each output
// byte written once; the design does nothing to overlap one row block's
// loads with another's math beyond what other resident blocks give.
template <typename T, int PER_LANE>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_baseline_kernel(const T* __restrict__ x,
                            const T* __restrict__ scale, T* __restrict__ out,
                            int64_t R, int64_t D, float eps) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + warp;
  if (row >= R) return;  // the whole warp: no block-wide barrier follows
  const T* xr = x + row * D;
  float v[PER_LANE];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i) {
    const int64_t j = lane + 32 * static_cast<int64_t>(i);
    v[i] = j < D ? repro::to_f32(xr[j]) : 0.f;
    ss += v[i] * v[i];
  }
  for (int o = 16; o > 0; o >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, o);
  const float inv = rsqrtf(ss / static_cast<float>(D) + eps);
  T* orow = out + row * D;
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i) {
    const int64_t j = lane + 32 * static_cast<int64_t>(i);
    if (j < D)
      orow[j] = repro::from_f32<T>(v[i] * inv * repro::to_f32(scale[j]));
  }
}

template <typename T, int PER_LANE>
int launch_baseline(const void* x, const void* scale, void* out, int64_t R,
                    int64_t D, float eps, cudaStream_t stream) {
  const int64_t blocks = (R + kRowsPerBlock - 1) / kRowsPerBlock;
  rmsnorm_baseline_kernel<T, PER_LANE>
      <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
          static_cast<const T*>(x), static_cast<const T*>(scale),
          static_cast<T*>(out), R, D, eps);
  return cudaGetLastError();
}

// The baseline for a row wider than the 2048 values the kernel above keeps
// in registers: the same function and summation order (lane-strided, then
// __shfl_xor_sync), one warp a row; the first pass sums the squares, the
// second reads the row again and scales it.  A kernel of its own, so that
// the kernel above, the one the case study reads, keeps its code.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_baseline_wide_kernel(const T* __restrict__ x,
                                 const T* __restrict__ scale,
                                 T* __restrict__ out, int64_t R, int64_t D,
                                 float eps) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + warp;
  if (row >= R) return;  // the whole warp: no block-wide barrier follows
  const T* xr = x + row * D;
  float ss = 0.f;
#pragma unroll 8
  for (int64_t j = lane; j < D; j += 32) {
    const float v = repro::to_f32(xr[j]);
    ss += v * v;
  }
  for (int o = 16; o > 0; o >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, o);
  const float inv = rsqrtf(ss / static_cast<float>(D) + eps);
  T* orow = out + row * D;
#pragma unroll 8
  for (int64_t j = lane; j < D; j += 32)
    orow[j] = repro::from_f32<T>(repro::to_f32(xr[j]) * inv *
                                 repro::to_f32(scale[j]));
}

// The row lives in PER_LANE registers a lane: D <= 32 * PER_LANE; wider
// rows take the two-pass kernel.
template <typename T>
int dispatch_baseline(const void* x, const void* scale, void* out, int64_t R,
                      int64_t D, float eps, cudaStream_t stream) {
  if (D <= 32 * 16)
    return launch_baseline<T, 16>(x, scale, out, R, D, eps, stream);
  if (D <= 32 * 32)
    return launch_baseline<T, 32>(x, scale, out, R, D, eps, stream);
  if (D <= 32 * 64)
    return launch_baseline<T, 64>(x, scale, out, R, D, eps, stream);
  const int64_t blocks = (R + kRowsPerBlock - 1) / kRowsPerBlock;
  rmsnorm_baseline_wide_kernel<T>
      <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
          static_cast<const T*>(x), static_cast<const T*>(scale),
          static_cast<T*>(out), R, D, eps);
  return cudaGetLastError();
}

}  // namespace

// x (R, D), scale (D,), out (R, D), all of one dtype, contiguous.
extern "C" int repro_rmsnorm_baseline_fwd(int dtype, const void* x,
                                          const void* scale, void* out,
                                          int64_t R, int64_t D, float eps,
                                          void* stream) {
  if (R <= 0 || D <= 0 || R > 8 * static_cast<int64_t>(0x7fffffff))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32)
    return dispatch_baseline<float>(x, scale, out, R, D, eps, s);
  if (dtype == repro::kBFloat16)
    return dispatch_baseline<__nv_bfloat16>(x, scale, out, R, D, eps, s);
  return cudaErrorInvalidValue;
}

// x (R, D), scale (D,), out (R, D), all of one dtype, contiguous, 16-byte
// aligned, with D * itemsize a multiple of 16; `rows` (1..8) rows a row
// block, two of which fit in shared memory (the wrapper checks).
extern "C" int repro_rmsnorm_pipelined_fwd(int dtype, const void* x,
                                           const void* scale, void* out,
                                           int64_t R, int64_t D, float eps,
                                           int64_t rows, int64_t grid,
                                           void* stream) {
  if (R <= 0 || D <= 0 || grid <= 0 || rows < 1 || rows > kRowsPerBlock)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int r = static_cast<int>(rows);
  if (dtype == repro::kFloat32)
    return dispatch_pipelined<float>(x, scale, out, R, D, eps, r, grid, s);
  if (dtype == repro::kBFloat16)
    return dispatch_pipelined<__nv_bfloat16>(x, scale, out, R, D, eps, r,
                                             grid, s);
  return cudaErrorInvalidValue;
}
