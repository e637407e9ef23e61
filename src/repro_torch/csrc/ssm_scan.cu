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
// the fused form's scan marked as one kernel region), and so descends from
// the same TPU kernel: the discretization and the scan in one kernel, xin
// (B, S, din) in and y out.  It computes dt = softplus(x * w_dt) =
// max(v, 0) + log1p(exp(-|v|)), a = exp(-exp(a_log) * dt) and
// bx = (dt * x) * bsel, then the recurrence above; a and bx never reach
// device memory.
//
// Bound of the fused entry on the H100: the special-function unit.  Bytes
// are small (xin read once, B*S*N of bsel and of csel, y written once: ~79
// MB at hymba-1.5b's prefill, 0.024 ms at 3.35 TB/s), but every (b, t, d,
// n) takes one exponential for a, B*S*din*N = 2.1e8 there, 16 a clock on
// each of the 132 SMs: ~0.05 ms at 1.98 GHz.  The instructions come next:
// ~6 f32 ones an element besides the exponential.
//
// Its layout is Mamba's selective scan turned to (B, S, din) rows.  A block
// owns (b, 16 channels) and walks the sequence in chunks of 128 steps; each
// channel's chunk is split over 8 threads of one warp, a thread taking 16
// consecutive steps.  For each state index n a thread composes its 16 steps
// into (A, B), h_after = A * h_before + B; the 8 threads of a channel scan
// those pairs with __shfl_up_sync (3 steps), the state carried from the
// last chunk entering at the first; a second pass over the 16 steps gives h
// and adds h * c into y in registers.  So:
// * parallelism does not stop at one thread a (b, d, n): B*din*8 threads
//   in blocks of 128, 400 blocks at hymba's shape, resident at once on the
//   card (4 an SM at 128 registers a thread: one wave), where the first
//   layout took 1.5 waves of blocks that each walked the whole sequence;
// * y_t[d] is summed over n in the registers of the thread that owns step
//   t (no cross-lane reduction), and dt, dt * x and their sum over the
//   thread's steps are computed once a (b, t, d) by that thread (nothing
//   broadcast);
// * a is one ex2.approx (MUFU.EX2) of -exp(a_log) * log2(e), computed once
//   a (d, n) into shared memory, times dt; A is one more of the same times
//   the sum of the 16 dt, not a product.  softplus keeps the accurate expf
//   and log1pf, once a (b, t, d);
// * traffic is coalesced and staged: a chunk's x tile (128 steps x 16
//   channels, 16-byte parts of rows of any stride that keeps them aligned)
//   by cp.async into a double buffer, its bsel and csel rows once a block,
//   transposed to [n][t] by 4-byte cp.async so a thread reads its 16 steps
//   as four float4, skewed so the 8 threads of a channel do not meet in a
//   bank; y through shared memory, written a row of 16 channels at a time.
// What bounds it is neither the exponentials nor the bytes: one block
// alone on each SM takes ~0.1 ms (the serial path of 16 chunks x N state
// indices, each a chain of loads, exponentials, multiply-adds and shuffle
// rounds), and 3 to 4 blocks an SM share its dispatch and shared-memory
// pipes (`tools/k4_fused.py` times it with parts removed and at 1 to 6
// blocks an SM).  Ragged S (steps past S are zeros, computed and never
// stored), din not a multiple of 16 and unaligned x (copied an element at
// a time) give the same bits as the aligned path: only the copy differs.
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

// ---- the fused entry ------------------------------------------------------

constexpr int kFusedChunk = 128;   // L: steps a block stages at a time
constexpr int kFusedSteps = 16;    // R: consecutive steps a thread owns
constexpr int kFusedChannels = 16;  // C: channels a block
constexpr int kFusedMinBlocks = 4;  // blocks an SM the registers must allow
constexpr int kFusedSegs = kFusedChunk / kFusedSteps;  // P: threads a channel
constexpr int kFusedThreads = kFusedChannels * kFusedSegs;
constexpr int kFusedWarpChannels = 32 / kFusedSegs;  // channels a warp
// floats of a row of the transposed bsel / csel tiles: L steps with 4
// floats of skew after every 32 (`skew`), rounded up to 12 mod 32 words so
// the copies of one step's N values land in distinct banks
constexpr int kFusedRow =
    (kFusedChunk + (kFusedChunk - 1) / 32 * 4 + 19) / 32 * 32 + 12;
constexpr float kLog2e = 1.4426950408889634f;
// steps and channels are 32-bit in the kernel: S (rounded up to a chunk)
// and din must stay below 2^31
constexpr int64_t kFusedMaxS = (int64_t{1} << 31) - 1 - kFusedChunk;
static_assert(kFusedSegs <= 32 && 32 % kFusedSegs == 0,
              "a channel's threads lie in one warp");
static_assert(kFusedSteps % 4 == 0 && 32 % kFusedSteps == 0,
              "a thread's steps are whole 16-byte words within 32 steps");
static_assert(kFusedChunk + (kFusedChunk - 1) / 32 * 4 <= kFusedRow,
              "kFusedRow");
static_assert(kFusedChannels % kFusedWarpChannels == 0, "whole warps");

// index of step t in a transposed bsel / csel row: a thread's R steps are
// contiguous (whole float4s), and the P threads of a channel, which read
// the same n at R steps apart, start in different bank quads
__device__ __forceinline__ int skew(int t) { return t + (t >> 5) * 4; }

// 2^v on the special-function unit, one MUFU.EX2 (`ex2.approx.ftz.f32`)
__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// global -> shared copies; `valid` false zero-fills and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}

// bytes of one staged x tile (L rows of C channels) with 16 bytes of skew
// after every R rows, so the P threads of a channel, R rows apart, read
// in different banks
template <typename T>
__host__ __device__ constexpr int x_tile_bytes() {
  return kFusedChunk * kFusedChannels * static_cast<int>(sizeof(T)) +
         16 * kFusedSegs;
}
template <typename T>
__device__ __forceinline__ int x_row(int r) {  // elements of T
  return (r * kFusedChannels * static_cast<int>(sizeof(T)) +
          16 * (r / kFusedSteps)) /
         static_cast<int>(sizeof(T));
}
// the staged y tile: L rows of C floats, a warp's channels of skew after
// every R rows, so a warp's 32 threads write 32 banks
constexpr int kYTile = kFusedChunk * kFusedChannels +
                       kFusedWarpChannels * kFusedSegs;
__device__ __forceinline__ int y_row(int r) {
  return r * kFusedChannels + kFusedWarpChannels * (r / kFusedSteps);
}

template <typename T, int N>
constexpr int fused_smem_bytes() {
  return 4 * (2 * N * kFusedRow + kYTile + 2 * kFusedChannels * N) +
         2 * x_tile_bytes<T>();
}

template <typename T, int N>
__global__ void __launch_bounds__(kFusedThreads, kFusedMinBlocks)
    ssm_scan_fused_kernel(const T* __restrict__ xin, int64_t xs_b,
                          int64_t xs_t, const float* __restrict__ w_dt,
                          const float* __restrict__ a_log,
                          const float* __restrict__ bsel,
                          const float* __restrict__ csel,
                          float* __restrict__ y, int S, int din,
                          bool x_vec) {
  constexpr int L = kFusedChunk, R = kFusedSteps, P = kFusedSegs;
  constexpr int C = kFusedChannels, NT = kFusedThreads;
  extern __shared__ __align__(16) unsigned char smem[];
  float* bs = reinterpret_cast<float*>(smem);  // [N][kFusedRow], transposed
  float* cs = bs + N * kFusedRow;
  float* ys = cs + N * kFusedRow;      // [L][C] with skew (y_row)
  float* nas = ys + kYTile;            // [C][N]: -exp(a_log) * log2(e)
  float* carry = nas + C * N;          // [C][N]: h before the chunk
  T* xs = reinterpret_cast<T*>(carry + C * N);  // 2 x [L][C] with skew
  constexpr int kXTile = x_tile_bytes<T>() / static_cast<int>(sizeof(T));

  const int tid = threadIdx.x;
  const int seg = tid % P;  // which R steps of the chunk
  const int ch = tid / P;   // which channel of the block
  // 32-bit steps and channels (the entry refuses S or din past 2^31 - 1
  // - L), 64-bit element offsets
  const int64_t b = blockIdx.y;
  const int d0 = blockIdx.x * C;
  const int d = d0 + ch;
  const T* xb = xin + b * xs_b + d0;
  const float* bb = bsel + b * S * N;
  const float* cb = csel + b * S * N;
  float* yb = y + b * S * din + d0;
  const int chunks = (S + L - 1) / L;
  // a full tile of 16-byte aligned rows is copied 16 bytes at a time, any
  // other x (a ragged last tile, odd strides) an element at a time
  const bool x_wide = x_vec && d0 + C <= din;

  for (int i = tid; i < C * N; i += NT) {
    nas[i] = d0 + i / N < din
                 ? -expf(a_log[static_cast<int64_t>(d0) * N + i]) * kLog2e
                 : 0.f;
    carry[i] = 0.f;
  }
  const float wdt = d < din ? w_dt[d] : 0.f;

  // x of chunk k into buffer k & 1; steps past S and channels past din
  // are zeros (their y is computed and never stored)
  auto stage_x = [&](int k) {
    if (k >= chunks) return;
    T* dst = xs + (k & 1) * kXTile;
    if (x_wide) {
      constexpr int kParts = C * sizeof(T) / 16;  // 16-byte parts a row
      constexpr int kPer = 16 / sizeof(T);
      for (int i = tid; i < L * kParts; i += NT) {
        const int r = i / kParts, q = i % kParts;
        const int t = k * L + r;
        cp_async16(dst + x_row<T>(r) + q * kPer,
                   t < S ? xb + t * xs_t + q * kPer : xb, t < S);
      }
    } else {
#pragma unroll 1
      for (int i = tid; i < L * C; i += NT) {
        const int r = i / C, c = i % C;
        const int t = k * L + r;
        dst[x_row<T>(r) + c] = t < S && d0 + c < din
                                   ? xb[t * xs_t + c]
                                   : repro::from_f32<T>(0.f);
      }
    }
  };
  // bsel and csel of chunk k, transposed to [n][skew(t)] four bytes at a
  // time: L * N contiguous floats of each, read coalesced
  auto stage_bc = [&](int k) {
    if (k >= chunks) return;
    const int64_t e0 = static_cast<int64_t>(k) * L * N;
#pragma unroll 1
    for (int e = tid; e < L * N; e += NT) {
      const int r = e / N, n = e % N;
      const bool ok = k * L + r < S;
      const int at = n * kFusedRow + skew(r);
      cp_async4(bs + at, ok ? bb + e0 + e : bb, ok);
      cp_async4(cs + at, ok ? cb + e0 + e : cb, ok);
    }
  };

  // this thread's steps of chunk k: dt = softplus(x * w_dt) with the
  // accurate exp and log1p, once a (b, t, d), dt * x, and their sum
  float dt[R], dtx[R], dts;
  auto discretize = [&](int k) {
    const T* src = xs + (k & 1) * kXTile;
    dts = 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float x = repro::to_f32(src[x_row<T>(seg * R + r) + ch]);
      const float v = x * wdt;
      dt[r] = fmaxf(v, 0.f) + log1pf(expf(-fabsf(v)));
      dtx[r] = dt[r] * x;
      dts += dt[r];
    }
  };

  // chunk k + 1's bsel and csel are copied while y of chunk k is stored
  // and chunk k + 1 discretized; x runs a chunk further ahead
  stage_x(0);
  cp_async_commit();
  stage_bc(0);
  cp_async_commit();
  stage_x(1);
  cp_async_commit();
  cp_async_wait<2>();  // x of chunk 0
  __syncthreads();
  discretize(0);
  cp_async_wait<1>();  // bsel, csel of chunk 0
  __syncthreads();

  float yv[R];
  for (int k = 0; k < chunks; ++k) {
#pragma unroll
    for (int r = 0; r < R; ++r) yv[r] = 0.f;
#pragma unroll 1
    for (int n = 0; n < N; ++n) {
      const float na = nas[ch * N + n];
      const float4* bp =
          reinterpret_cast<const float4*>(bs + n * kFusedRow + skew(seg * R));
      const float4* cp =
          reinterpret_cast<const float4*>(cs + n * kFusedRow + skew(seg * R));
      // a and bx of this thread's R steps, and their composition
      // (A, Bv): h after the R steps = A * h before + Bv
      float a[R], bx[R], Bv = 0.f;
#pragma unroll
      for (int q = 0; q < R / 4; ++q) {
        const float4 b4 = bp[q];
        const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = 4 * q + j;
          a[r] = ex2(na * dt[r]);
          bx[r] = dtx[r] * bv[j];
          Bv = fmaf(a[r], Bv, bx[r]);
        }
      }
      float A = ex2(na * dts);  // the product of the R a's
      // the carried state enters at the chunk's first thread; then an
      // inclusive scan of (A, Bv) over the channel's P threads
      const float h0 = carry[ch * N + n];
      if (seg == 0) Bv = fmaf(A, h0, Bv);
#pragma unroll
      for (int o = 1; o < P; o <<= 1) {
        const float Ap = __shfl_up_sync(0xffffffffu, A, o, P);
        const float Bp = __shfl_up_sync(0xffffffffu, Bv, o, P);
        if (seg >= o) {
          Bv = fmaf(A, Bp, Bv);
          A *= Ap;
        }
      }
      float h = __shfl_up_sync(0xffffffffu, Bv, 1, P);
      if (seg == 0) h = h0;
      if (seg == P - 1) carry[ch * N + n] = Bv;
      // the R states again from h, each read out into y in registers
#pragma unroll
      for (int q = 0; q < R / 4; ++q) {
        const float4 c4 = cp[q];
        const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = 4 * q + j;
          h = fmaf(a[r], h, bx[r]);
          yv[r] = fmaf(h, cv[j], yv[r]);
        }
      }
    }
    __syncthreads();  // every thread is done with chunk k's tiles
    stage_bc(k + 1);
    cp_async_commit();
    stage_x(k + 2);
    cp_async_commit();
#pragma unroll
    for (int r = 0; r < R; ++r) ys[y_row(seg * R + r) + ch] = yv[r];
    cp_async_wait<2>();  // x of chunk k + 1
    __syncthreads();
    // y of chunk k, a row of C channels at a time along din
#pragma unroll 1
    for (int i = tid; i < L * C; i += NT) {
      const int r = i / C, c = i % C;
      const int t = k * L + r;
      if (t < S && d0 + c < din)
        yb[static_cast<int64_t>(t) * din + c] = ys[y_row(r) + c];
    }
    if (k + 1 < chunks) discretize(k + 1);
    cp_async_wait<1>();  // bsel, csel of chunk k + 1
    __syncthreads();
  }
}

// shared memory past the 48 KB a launch gets by default (N 32) must be
// allowed first, for the launch and for the occupancy calculator alike
template <typename T, int N>
cudaError_t allow_fused_smem() {
  constexpr int kSmem = fused_smem_bytes<T, N>();
  if (kSmem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(ssm_scan_fused_kernel<T, N>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kSmem);
}

template <typename T, int N>
int launch_fused(const void* xin, int64_t xs_b, int64_t xs_t,
                 const float* w_dt, const float* a_log, const float* bsel,
                 const float* csel, float* y, int64_t B, int64_t S,
                 int64_t din, cudaStream_t stream) {
  constexpr int kSmem = fused_smem_bytes<T, N>();
  const cudaError_t e = allow_fused_smem<T, N>();
  if (e != cudaSuccess) return e;
  const bool x_vec =
      reinterpret_cast<uintptr_t>(xin) % 16 == 0 &&
      (xs_t * static_cast<int64_t>(sizeof(T))) % 16 == 0 &&
      (xs_b * static_cast<int64_t>(sizeof(T))) % 16 == 0;
  const dim3 grid(
      static_cast<unsigned>((din + kFusedChannels - 1) / kFusedChannels),
      static_cast<unsigned>(B));
  ssm_scan_fused_kernel<T, N><<<grid, kFusedThreads, kSmem, stream>>>(
      static_cast<const T*>(xin), xs_b, xs_t, w_dt, a_log, bsel, csel, y,
      static_cast<int>(S), static_cast<int>(din), x_vec);
  return cudaGetLastError();
}

template <typename T, int N>
int occupancy_fused(int* blocks) {
  const cudaError_t e = allow_fused_smem<T, N>();
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, ssm_scan_fused_kernel<T, N>, kFusedThreads,
      fused_smem_bytes<T, N>());
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

template <typename T>
int dispatch_occupancy(int64_t N, int* blocks) {
  switch (N) {
    case 1:
      return occupancy_fused<T, 1>(blocks);
    case 2:
      return occupancy_fused<T, 2>(blocks);
    case 4:
      return occupancy_fused<T, 4>(blocks);
    case 8:
      return occupancy_fused<T, 8>(blocks);
    case 16:
      return occupancy_fused<T, 16>(blocks);
    case 32:
      return occupancy_fused<T, 32>(blocks);
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
  if (B <= 0 || B > 65535 || S <= 0 || din <= 0 || xs_b < 0 || xs_t < 0 ||
      S > kFusedMaxS || din > kFusedMaxS)
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

// blocks of the fused entry's kernel resident on one SM, for xin of `dtype`
// and state size N (the launch's threads and shared memory), and the
// channels of din a block takes (the grid is din / channels x B)
extern "C" int repro_ssm_scan_fused_occupancy(int dtype, int64_t N,
                                              int* blocks, int* channels) {
  *channels = kFusedChannels;
  if (dtype == repro::kFloat32) return dispatch_occupancy<float>(N, blocks);
  if (dtype == repro::kBFloat16)
    return dispatch_occupancy<__nv_bfloat16>(N, blocks);
  return cudaErrorInvalidValue;
}
