// RMSNorm for Hopper (sm_90a): the baseline and the pipelined kernel of the
// paper's case study (section VI-D(b)), side by side so that one
// `nvcc -ptx` shows both (`core/ptx_frontend.py` reads them).
//
// Both compute out = x * rsqrt(mean(x^2) + eps) * scale in f32, cast to x's
// dtype, one warp a row.  Bound on the H100 for both: bytes,
// (2*R*D + D)*itemsize over 3.35 TB/s (0.0044 ms at R 4096, D 896, bf16).
// The work is a few operations a byte, so only the memory system sets the
// time, and the design is about keeping it busy:
//
// * Every access is a 16-byte vector.  A row is cut into 16-byte chunks (8
//   bf16 or 4 f32 values) and lane l takes chunks l, l + 32, l + 64, ...:
//   a warp-wide load or store moves 512 contiguous bytes, and a lane issues
//   an eighth (bf16) or a quarter (f32) of the memory instructions that one
//   value a lane needs.
// * The row stays in registers, packed as it lies in memory (bf16 pairs in
//   32-bit words), from its load through the sum of squares to the store:
//   CHUNKS chunks a lane, a template value sized to the row.  A row of more
//   than kMaxChunks chunks a lane (more than 8192 bf16 or 4096 f32 values)
//   is read twice instead (CHUNKS = 0).
// * scale is fetched beside x, before the row's reduction, so a short call
//   waits on memory once; a lane holds scale's chunks beside the row's up
//   to 16 chunks a lane (kHoldScale).  Beyond, the pipelined kernel copies
//   scale into shared memory beside its ring where that fits (a ring of
//   213-229 KB leaves L1 too little to keep scale for the block's rows),
//   and otherwise, as the baseline always does, reads scale's chunks as it
//   scales.
// * The sum of squares is one per-lane order (chunk by chunk, value by
//   value, fmaf) and one __shfl_xor_sync tree, shared by both kernels
//   (`chunk_sumsq`, `warp_sum`, `chunk_scale`): the two return the same
//   bits on every input both take, so the case study compares their load
//   patterns and nothing else.
#include <string.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kMaxRows = 8;  // the most rows a K2 stage: a warp a row
constexpr int kMaxThreads = 32 * kMaxRows;
constexpr int kBaseRows = 4;  // rows (warps) a K3 block
constexpr int kMaxChunks = 32;  // the most chunks a lane holds
// scale's chunks are held in registers beside the row's up to this many
template <int CHUNKS>
constexpr bool kHoldScale = CHUNKS > 0 && CHUNKS <= 16;

template <typename T>
constexpr int kValues = 16 / static_cast<int>(sizeof(T));  // a chunk's

// -- the shared arithmetic ---------------------------------------------------

__device__ __forceinline__ float2 bf16x2_to_f32(uint32_t w) {
  __nv_bfloat162 h;
  memcpy(&h, &w, 4);
  return __bfloat1622float2(h);
}

__device__ __forceinline__ uint32_t f32_to_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  uint32_t w;
  memcpy(&w, &h, 4);
  return w;
}

template <typename T>
__device__ __forceinline__ float sumsq_word(uint32_t w, float ss) {
  if constexpr (sizeof(T) == 2) {
    const float2 v = bf16x2_to_f32(w);
    ss = fmaf(v.x, v.x, ss);
    return fmaf(v.y, v.y, ss);
  } else {
    const float v = __uint_as_float(w);
    return fmaf(v, v, ss);
  }
}

// The squares of a chunk's values, in order, added onto ss.
template <typename T>
__device__ __forceinline__ float chunk_sumsq(uint4 c, float ss) {
  ss = sumsq_word<T>(c.x, ss);
  ss = sumsq_word<T>(c.y, ss);
  ss = sumsq_word<T>(c.z, ss);
  return sumsq_word<T>(c.w, ss);
}

template <typename T>
__device__ __forceinline__ uint32_t scale_word(uint32_t x, uint32_t s,
                                               float inv) {
  if constexpr (sizeof(T) == 2) {
    const float2 xv = bf16x2_to_f32(x), sv = bf16x2_to_f32(s);
    return f32_to_bf16x2(xv.x * inv * sv.x, xv.y * inv * sv.y);
  } else {
    return __float_as_uint(__uint_as_float(x) * inv * __uint_as_float(s));
  }
}

// x * inv * scale, value by value, rounded to T.
template <typename T>
__device__ __forceinline__ uint4 chunk_scale(uint4 x, uint4 s, float inv) {
  return make_uint4(
      scale_word<T>(x.x, s.x, inv), scale_word<T>(x.y, s.y, inv),
      scale_word<T>(x.z, s.z, inv), scale_word<T>(x.w, s.w, inv));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float inv_rms(float ss, int64_t D, float eps) {
  return rsqrtf(warp_sum(ss) / static_cast<float>(D) + eps);
}

// Pipelined RMSNorm.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rmsnorm.py::
// rmsnorm_pipelined (_rmsnorm_pipelined_kernel).  As there, rows stay in
// device memory and the kernel itself double-buffers row blocks into
// on-chip memory with one completion counter per buffer: here a 2-stage
// ring of cp.async groups (16-byte copies) in shared memory, so row block
// i+1 is in flight while row block i is reduced.  `cp.async.wait_group 1`
// waits for the older group only -- the split wait counters of the paper's
// case study.
//
// Bound: bytes (above).  Why the design reaches it: each input byte moves
// once, global -> shared by cp.async with no register staging; a lane reads
// its chunks of the landed row from shared memory once (ld.shared.v4) and
// keeps them in registers through the reduction and the scaling; scale is
// held for the whole block, in registers loaded before the ring starts
// or, for a row of more than 16 chunks a lane, in shared memory, copied in
// the prologue group (`staged`), so a one-row-block call waits on memory
// once; a row too wide for scale beside two stages of one row reads
// scale's chunks as it scales; the output leaves in 16-byte stores.  A stage is blockDim.x / 32
// rows (the wrapper's choice, at most kMaxRows), and the wrapper launches
// as many blocks as the ring's shared memory and registers let reside on
// the card, so that many row blocks are in flight on each SM; a block walks
// further row blocks only when R has more than that.  Rows are 16-byte
// multiples and x, scale and out 16-byte aligned (the wrapper checks).

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

// Issue the 16-byte copies of row block `rb` (`rows` rows, fewer at the
// ragged end; `n` chunks a row) into `buf`.
__device__ __forceinline__ void issue_row_block(uint4* buf, const uint4* x,
                                                int64_t rb, int rows,
                                                int64_t R, int64_t n) {
  const int64_t row0 = rb * rows;
  const int64_t chunks = min(static_cast<int64_t>(rows), R - row0) * n;
  const uint4* src = x + row0 * n;
  for (int64_t c = threadIdx.x; c < chunks; c += blockDim.x)
    cp_async16(buf + c, src + c);
}

template <typename T, int CHUNKS>
__global__ void __launch_bounds__(kMaxThreads, 1)
    rmsnorm_pipelined_kernel(const T* __restrict__ x,
                             const T* __restrict__ scale, T* __restrict__ out,
                             int64_t R, int64_t D, float eps, bool staged) {
  const int rows = blockDim.x / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t n = D / kValues<T>;  // chunks a row
  const int64_t n_blocks = (R + rows - 1) / rows;
  int64_t rb = blockIdx.x;
  if (rb >= n_blocks) return;  // uniform over the block
  const uint4* xc = reinterpret_cast<const uint4*>(x);
  const uint4* sc = reinterpret_cast<const uint4*>(scale);
  const int64_t left = n - lane;  // chunks from this lane's first on
  // where a lane holds scale it is never staged, so that path compiles
  // without the flag
  staged = staged && !kHoldScale<CHUNKS>;
  extern __shared__ uint4 smem[];  // [scale if staged][2][rows][n]
  uint4* bufs = smem + (staged ? n : 0);
  const uint4* sr = sc + lane;  // this lane's chunks of scale
  // this lane's chunk c of scale, where a lane does not hold scale
  const auto scale_chunk = [&](int64_t c) {
    return staged ? smem[lane + c] : __ldg(sr + c);
  };

  uint4 s[kHoldScale<CHUNKS> ? CHUNKS : 1];
  if constexpr (kHoldScale<CHUNKS>) {  // loaded before the first wait
#pragma unroll
    for (int i = 0; i < CHUNKS; ++i)
      s[i] = 32 * i < left ? __ldg(sr + 32 * i) : make_uint4(0, 0, 0, 0);
  } else if (staged) {
    for (int64_t c = threadIdx.x; c < n; c += blockDim.x)
      cp_async16(smem + c, sc + c);  // joins the prologue group
  }
  int stage = 0;
  issue_row_block(bufs, xc, rb, rows, R, n);  // the prologue group
  cp_async_commit();
  for (; rb < n_blocks; rb += gridDim.x) {
    const int64_t next = rb + gridDim.x;
    if (next < n_blocks)
      issue_row_block(bufs + (stage ^ 1) * rows * n, xc, next, rows, R, n);
    cp_async_commit();      // one group per buffer, empty at the tail
    cp_async_wait_older();  // this buffer has landed; the next may fly
    __syncthreads();

    const int64_t row = rb * rows + warp;
    if (row < R) {
      const uint4* xr = bufs + (stage * rows + warp) * n + lane;
      uint4* orow = reinterpret_cast<uint4*>(out) + row * n + lane;
      float ss = 0.f;
      if constexpr (CHUNKS > 0) {
        uint4 v[CHUNKS];
#pragma unroll
        for (int i = 0; i < CHUNKS; ++i) {
          v[i] = 32 * i < left ? xr[32 * i] : make_uint4(0, 0, 0, 0);
          if (32 * i < left) ss = chunk_sumsq<T>(v[i], ss);
        }
        const float inv = inv_rms(ss, D, eps);
#pragma unroll
        for (int i = 0; i < CHUNKS; ++i) {
          if (32 * i < left) {
            uint4 si;
            if constexpr (kHoldScale<CHUNKS>)
              si = s[i];
            else
              si = scale_chunk(32 * i);
            orow[32 * i] = chunk_scale<T>(v[i], si, inv);
          }
        }
      } else {  // a wide row: read twice from shared memory
        for (int64_t c = 0; c < left; c += 32)
          ss = chunk_sumsq<T>(xr[c], ss);
        const float inv = inv_rms(ss, D, eps);
        for (int64_t c = 0; c < left; c += 32)
          orow[c] = chunk_scale<T>(xr[c], scale_chunk(c), inv);
      }
    }
    __syncthreads();  // buffer `stage` is refilled on the next iteration
    stage ^= 1;
  }
}

// Baseline RMSNorm.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rmsnorm.py::
// rmsnorm_baseline (_rmsnorm_kernel): the same function, one row block per
// grid step through the implicit BlockSpec pipeline, so each step's compute
// waits on its own block's arrival.  Here a block of kBaseRows rows, a warp
// a row, each row loaded straight from device memory into registers with
// read-only loads (ld.global.nc): no cp.async and no shared-memory ring --
// the synchronous-load pattern the case study contrasts with the kernel
// above.
//
// Bound: bytes (above).  Why the design reaches it: a lane issues all its
// 16-byte loads of the row and of scale in one burst before the reduction,
// so a warp waits on memory once, and small blocks of few registers let
// many warps reside on each SM, so that their bursts keep the memory
// system busy; the output leaves in 16-byte stores.  CHUNKS = 0 reads a
// wide row twice.  VEC = false, instantiated with CHUNKS = 0 only, takes
// any row width and alignment: each chunk loaded and stored value by
// value, zero past the row's end.  Its loop sums a lane's chunks in the
// order the register-held instantiations do, so it returns their bits.
template <typename T>
using Bits = std::conditional_t<sizeof(T) == 2, unsigned short, unsigned>;

template <typename T, bool VEC>
__device__ __forceinline__ uint4 load_chunk(const T* row, int64_t c,
                                            int64_t D) {
  if constexpr (VEC) {
    return __ldg(reinterpret_cast<const uint4*>(row) + c);
  } else {
    Bits<T> e[kValues<T>];
#pragma unroll
    for (int k = 0; k < kValues<T>; ++k) {
      const int64_t j = c * kValues<T> + k;
      e[k] = j < D ? __ldg(reinterpret_cast<const Bits<T>*>(row) + j)
                    : Bits<T>(0);
    }
    uint4 v;
    memcpy(&v, e, 16);
    return v;
  }
}

template <typename T, bool VEC>
__device__ __forceinline__ void store_chunk(T* row, int64_t c, int64_t D,
                                            uint4 v) {
  if constexpr (VEC) {
    reinterpret_cast<uint4*>(row)[c] = v;
  } else {
    Bits<T> e[kValues<T>];
    memcpy(e, &v, 16);
#pragma unroll
    for (int k = 0; k < kValues<T>; ++k) {
      const int64_t j = c * kValues<T> + k;
      if (j < D) reinterpret_cast<Bits<T>*>(row)[j] = e[k];
    }
  }
}

template <typename T, int CHUNKS, bool VEC>
__global__ void __launch_bounds__(32 * kBaseRows, 1)
    rmsnorm_baseline_kernel(const T* __restrict__ x,
                            const T* __restrict__ scale, T* __restrict__ out,
                            int64_t R, int64_t D, float eps) {
  // beyond 16 chunks a lane (kHoldScale false) a lane holds the row's
  // chunks only and reads scale's as it scales
  const int lane = threadIdx.x % 32;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kBaseRows + threadIdx.x / 32;
  if (row >= R) return;  // the whole warp: no block-wide barrier follows
  const int64_t n = (D + kValues<T> - 1) / kValues<T>;  // chunks a row
  const T* xr = x + row * D;
  T* orow = out + row * D;
  float ss = 0.f;
  if constexpr (CHUNKS > 0) {
    const int64_t left = n - lane;  // chunks from this lane's first on
    uint4 v[CHUNKS], s[kHoldScale<CHUNKS> ? CHUNKS : 1];
#pragma unroll
    for (int i = 0; i < CHUNKS; ++i) {  // the row's and scale's loads
      const bool in = 32 * i < left;
      v[i] = in ? load_chunk<T, VEC>(xr, lane + 32 * i, D)
                : make_uint4(0, 0, 0, 0);
      if constexpr (kHoldScale<CHUNKS>)
        s[i] = in ? load_chunk<T, VEC>(scale, lane + 32 * i, D)
                  : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int i = 0; i < CHUNKS; ++i)
      if (32 * i < left) ss = chunk_sumsq<T>(v[i], ss);
    const float inv = inv_rms(ss, D, eps);
#pragma unroll
    for (int i = 0; i < CHUNKS; ++i) {
      if (32 * i < left) {
        const int64_t c = lane + 32 * i;
        uint4 si;
        if constexpr (kHoldScale<CHUNKS>)
          si = s[i];
        else
          si = load_chunk<T, VEC>(scale, c, D);
        store_chunk<T, VEC>(orow, c, D, chunk_scale<T>(v[i], si, inv));
      }
    }
  } else {  // a wide row: one pass for the sum, one to scale
#pragma unroll 4
    for (int64_t c = lane; c < n; c += 32)
      ss = chunk_sumsq<T>(load_chunk<T, VEC>(xr, c, D), ss);
    const float inv = inv_rms(ss, D, eps);
#pragma unroll 4
    for (int64_t c = lane; c < n; c += 32)
      store_chunk<T, VEC>(orow, c, D,
                          chunk_scale<T>(load_chunk<T, VEC>(xr, c, D),
                                         load_chunk<T, VEC>(scale, c, D),
                                         inv));
  }
}

// -- dispatch ----------------------------------------------------------------

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// the ring's two stages, and scale if staged
template <typename T>
size_t ring_smem(int64_t D, int rows, bool staged) {
  return (2 * static_cast<size_t>(rows) + staged) * D * sizeof(T);
}

// Raise an instantiation's shared-memory limit to `smem` once (not on every
// launch, and never inside a CUDA-graph capture after the first call).
template <typename T, int CHUNKS>
cudaError_t configure_pipelined(size_t smem) {
  static size_t configured = 0;
  if (smem <= configured) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      rmsnorm_pipelined_kernel<T, CHUNKS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e == cudaSuccess) configured = smem;
  return e;
}

struct Args {
  const void* x;
  const void* scale;
  void* out;
  int64_t R, D;
  float eps;
  int64_t rows, grid;  // K2: rows a stage, blocks
  bool staged;         // K2: scale in shared memory
  int* blocks;         // the occupancy query's answer
  cudaStream_t stream;
};

template <typename T, int C, bool VEC>
int launch_baseline(const Args& a) {
  const unsigned blocks =
      static_cast<unsigned>((a.R + kBaseRows - 1) / kBaseRows);
  rmsnorm_baseline_kernel<T, C, VEC><<<blocks, 32 * kBaseRows, 0, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.scale),
      static_cast<T*>(a.out), a.R, a.D, a.eps);
  return cudaGetLastError();
}

template <typename T, int C>
struct Baseline {
  static int run(const Args& a) { return launch_baseline<T, C, true>(a); }
};

template <typename T, int C>
struct Pipelined {
  static int run(const Args& a) {
    const size_t smem =
        ring_smem<T>(a.D, static_cast<int>(a.rows), a.staged);
    const cudaError_t e = configure_pipelined<T, C>(smem);
    if (e != cudaSuccess) return e;
    rmsnorm_pipelined_kernel<T, C>
        <<<static_cast<unsigned>(a.grid), 32 * static_cast<unsigned>(a.rows),
           smem, a.stream>>>(static_cast<const T*>(a.x),
                             static_cast<const T*>(a.scale),
                             static_cast<T*>(a.out), a.R, a.D, a.eps,
                             a.staged);
    return cudaGetLastError();
  }
};

template <typename T, int C>
struct Occupancy {
  static int run(const Args& a) {
    const size_t smem =
        ring_smem<T>(a.D, static_cast<int>(a.rows), a.staged);
    const cudaError_t e = configure_pipelined<T, C>(smem);
    if (e != cudaSuccess) return e;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        a.blocks, rmsnorm_pipelined_kernel<T, C>,
        32 * static_cast<int>(a.rows), smem);
  }
};

// The chunks a lane needs for a row of D values.
template <typename T>
int64_t lane_need(int64_t D) {
  return ((D + kValues<T> - 1) / kValues<T> + 31) / 32;
}

// Op<T, CHUNKS>::run for the instantiations of CHUNKS: kernels/rmsnorm.py's
// LANE_CHUNKS, and 0 for a row of more than kMaxChunks chunks a lane.
template <template <typename, int> class Op, typename T>
int by_chunks(int64_t chunks, const Args& a) {
  const int64_t need = lane_need<T>(a.D);
  if (chunks == 0 ? need <= kMaxChunks : need > chunks)
    return cudaErrorInvalidValue;
  switch (chunks) {
    case 0: return Op<T, 0>::run(a);
    case 1: return Op<T, 1>::run(a);
    case 2: return Op<T, 2>::run(a);
    case 3: return Op<T, 3>::run(a);
    case 4: return Op<T, 4>::run(a);
    case 7: return Op<T, 7>::run(a);
    case 8: return Op<T, 8>::run(a);
    case 13: return Op<T, 13>::run(a);
    case 16: return Op<T, 16>::run(a);
    case 32: return Op<T, 32>::run(a);
    default: return cudaErrorInvalidValue;
  }
}

template <template <typename, int> class Op>
int dispatch(int dtype, int64_t chunks, const Args& a) {
  if (dtype == repro::kFloat32) return by_chunks<Op, float>(chunks, a);
  if (dtype == repro::kBFloat16)
    return by_chunks<Op, __nv_bfloat16>(chunks, a);
  return cudaErrorInvalidValue;
}

int item_size(int dtype) { return dtype == repro::kFloat32 ? 4 : 2; }

}  // namespace

// x (R, D), scale (D,), out (R, D), all of one dtype, contiguous; `vec`
// nonzero for 16-byte loads (rows of 16-byte multiples, x, scale and out
// 16-byte aligned), with `chunks` from kernels/rmsnorm.py::lane_chunks;
// `vec` zero for the value-by-value kernel (`chunks` unused).
extern "C" int repro_rmsnorm_baseline_fwd(int dtype, const void* x,
                                          const void* scale, void* out,
                                          int64_t R, int64_t D, float eps,
                                          int64_t chunks, int vec,
                                          void* stream) {
  if (R <= 0 || D <= 0 || R > kBaseRows * static_cast<int64_t>(0x7fffffff))
    return cudaErrorInvalidValue;
  if (vec && ((D * item_size(dtype)) % 16 || !aligned16(x) ||
              !aligned16(scale) || !aligned16(out)))
    return cudaErrorInvalidValue;
  Args a{x, scale, out, R, D, eps, 0, 0, false, nullptr,
         static_cast<cudaStream_t>(stream)};
  if (vec) return dispatch<Baseline>(dtype, chunks, a);
  if (dtype == repro::kFloat32) return launch_baseline<float, 0, false>(a);
  if (dtype == repro::kBFloat16)
    return launch_baseline<__nv_bfloat16, 0, false>(a);
  return cudaErrorInvalidValue;
}

// Blocks of the pipelined kernel that reside on one SM at once, with
// `rows` rows a stage and scale in shared memory if `staged`, into *blocks.
extern "C" int repro_rmsnorm_pipelined_occupancy(int dtype, int64_t D,
                                                 int64_t chunks, int64_t rows,
                                                 int staged, int* blocks) {
  if (D <= 0 || rows < 1 || rows > kMaxRows || blocks == nullptr)
    return cudaErrorInvalidValue;
  Args a{nullptr, nullptr, nullptr, 0, D, 0.f, rows, 0, staged != 0, blocks,
         nullptr};
  return dispatch<Occupancy>(dtype, chunks, a);
}

// x (R, D), scale (D,), out (R, D), all of one dtype, contiguous, 16-byte
// aligned, with D * itemsize a multiple of 16; `chunks` from
// kernels/rmsnorm.py::lane_chunks, `rows` (1..8) rows a stage, `staged`
// nonzero to copy scale into shared memory (kernels/rmsnorm.py::
// staged_scale), `grid` blocks (the wrapper checks that the ring fits
// shared memory).
extern "C" int repro_rmsnorm_pipelined_fwd(int dtype, const void* x,
                                           const void* scale, void* out,
                                           int64_t R, int64_t D, float eps,
                                           int64_t chunks, int64_t rows,
                                           int staged, int64_t grid,
                                           void* stream) {
  if (R <= 0 || D <= 0 || grid <= 0 || grid > 0x7fffffff || rows < 1 ||
      rows > kMaxRows || (D * item_size(dtype)) % 16 || !aligned16(x) ||
      !aligned16(scale) || !aligned16(out))
    return cudaErrorInvalidValue;
  Args a{x, scale, out, R, D, eps, rows, grid, staged != 0, nullptr,
         static_cast<cudaStream_t>(stream)};
  return dispatch<Pipelined>(dtype, chunks, a);
}
