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
// h_{t-1}.  Here the units are split over the SMs: block j owns U =
// ceil(D / SMs) consecutive units and keeps their 4U columns of r in shared
// memory in f32 (bf16 r upcast once) for the whole sequence: at D 768, U 6,
// r takes 72 KB of a block's 90 KB (the first design of this kernel took
// 99 KB, its h rows and sums beside r).  Held in bf16, r would take half
// the room, but every value would be unpacked in the product, which made
// the bf16 kernel slower than the f32 one.
//
// Bound on the H100: operations, 8 B S D^2 (the recurrent product) over the
// peak rate for the inputs' type (989 TFLOP/s bf16, 67 f32); the bytes (xg,
// h, and r once) are fewer.  The product of one step is short (9.4 M FMAs
// at xlstm-125m's B 4, D 768: about 0.3 us on 132 SMs), so the step is
// latency-bound: the design keeps the step's chain short.
//   * No grid barrier.  Each warp that holds owners of (row, unit) pairs
//     publishes its units of h_t with one release add on a step counter
//     (`red.release.gpu`, after a __syncwarp that orders its lanes'
//     stores), never reset within a launch; a block that needs h_t waits
//     until the counter reads blocks * owner warps * (t + 1) (one thread
//     that owns nothing polls with `ld.acquire.gpu`, not stalled behind the
//     owners' loads of the step's gate inputs, which are in flight
//     meanwhile), and each warp then reads its slice of h past L1
//     (`ld.global.cg`) in 16-byte vectors.  h is double-buffered in
//     device memory: a block can only overwrite the buffer of h_{t-1} after
//     every block has published h_t, that is after every block has read
//     h_{t-1}.  The launch stays cooperative (`cudaLaunchCooperativeKernel`)
//     because a polling block needs every other block resident: a grid
//     that is not co-resident is refused at launch and never hangs.
//   * The recurrent state (c, n, m) of a (row, unit) pair stays in the
//     registers of the thread that owns it for the whole sequence, when the
//     batch fits one tile of rows; wider batches keep it in device memory.
//     With one tile, the owners store `out` after their warp's release, so
//     that the release, which waits for every earlier store of the warp,
//     does not wait for bf16's 2-byte stores of `out` into sectors that
//     neighbouring blocks also write (tools/k6_step.py times the first
//     design's step with and without them).
//   * The product: warps split D; in a warp, 8 lanes split the 4U gate
//     columns (a lane holds 2, 4 or 8 of them, SLOTS) and 4 lanes the
//     warp's 16-byte vectors of k.  Warp w stages its own slice of h_{t-1}
//     in shared memory with 16-byte loads (no block barrier between the
//     fetch and the product); a lane reads r's columns as 16-byte vectors
//     of consecutive k and h as 16-byte broadcasts, each feeding 4 FMAs a
//     column it holds, and keeps one f32 sum a (column, row): each value of
//     r and of h is read from shared memory once a step.  The 4 lanes of a
//     column add their sums by shuffles, the sums of the 8 warps meet in
//     shared memory, and the thread that owns a (row, unit) adds its 4
//     gates' 8 partial sums.  Only the batch rows that exist are
//     reduced (NB, the rows of a tile, is a template argument).  The
//     partial sums are double-buffered by step: two block barriers a step,
//     after the wait and after the product.
//   * Host side, each instantiation caches the device's attributes, its
//     shared-memory limit and its occupancy.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 8;   // batch rows a tile at most
// The product's lanes: kColLanes over the gate columns (a lane holds
// columns l, l + kColLanes, ...: SLOTS of them, 2, 4 or 8) times kSubs over
// the warp's vectors of k
constexpr int kColLanes = 8;
constexpr int kSubs = 32 / kColLanes;
constexpr int kMaxSlots = 8;  // 4U <= 64
constexpr int kMaxDevices = 64;
constexpr int64_t kMaxSpins = int64_t{1} << 26;  // polls of the counter

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ unsigned long long ld_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];\n"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void red_release(unsigned long long* p) {
  asm volatile("red.release.gpu.global.add.u64 [%0], 1;\n" ::"l"(p)
               : "memory");
}

constexpr int P = 4;  // values of r or h in a 16-byte vector (f32)

// Shared memory of a block: r's 4U columns in f32 as 16-byte vectors of P
// consecutive k, NB rows of h padded to whole vectors, and two buffers of
// the 8 warps' partial gate sums.  kernels/slstm_scan.py::smem_bytes repeats
// it to check a shape without the card.
__host__ __device__ inline int64_t smem_bytes(int64_t D, int64_t U,
                                              int64_t NB) {
  const int64_t chunks = (D + P - 1) / P;
  return 16 * chunks * 4 * U + 4 * NB * chunks * P +
         2 * 4 * kWarps * NB * 4 * U;
}

template <typename T, int NB, int SLOTS>
__global__ void __launch_bounds__(kThreads, 1)
    slstm_scan_kernel(const T* __restrict__ xg, const T* __restrict__ r,
                      T* __restrict__ out, float* __restrict__ hbuf,
                      float* __restrict__ state,
                      unsigned long long* __restrict__ counter, int B,
                      int64_t S, int D, int U) {
  extern __shared__ __align__(16) float4 smem[];
  const int chunks = (D + P - 1) / P;
  const int Dh = chunks * P;  // a row of h, padded to whole vectors
  const int C4 = 4 * U;       // gate columns of the block
  float4* rs = smem;                                             // [chunk][C4]
  float* hs = reinterpret_cast<float*>(rs + static_cast<int64_t>(chunks) *
                                                C4);             // [NB][Dh]
  float* ps = hs + static_cast<int64_t>(NB) * Dh;  // [2][warp][NB][C4]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int j0 = blockIdx.x * U;
  const int units = min(U, D - j0);
  const int64_t D4 = 4 * static_cast<int64_t>(D);
  const int64_t BH = static_cast<int64_t>(B) * Dh;  // one buffer of h
  const int tiles = (B + NB - 1) / NB;

  // this block's columns of r: column c = g * U + u is r[:, g * D + j0 + u]
  for (int64_t i = tid; i < static_cast<int64_t>(chunks) * C4;
       i += kThreads) {
    const int c = static_cast<int>(i / C4), col = static_cast<int>(i % C4);
    const int g = col / U, u = col % U;
    const int64_t at = g * static_cast<int64_t>(D) + j0 + u;
    float w[P] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int64_t k = static_cast<int64_t>(c) * P + p;
      if (u < units && k < D) w[p] = repro::to_f32(r[k * D4 + at]);
    }
    rs[i] = make_float4(w[0], w[1], w[2], w[3]);
  }

  // this lane's gate columns and its vectors of the warp's slice of D
  // (whole vectors): every kSubs-th from sub
  const int cl = lane % kColLanes, sub = lane / kColLanes;
  int cols[SLOTS];
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) cols[s] = min(cl + kColLanes * s, C4 - 1);
  const int per_warp = (chunks + kWarps - 1) / kWarps;
  const int c_lo = min(warp * per_warp, chunks);
  const int c_hi = min(c_lo + per_warp, chunks);
  const int vec4 = (c_hi - c_lo) * P / 4;  // float4s of h a row

  // the (row, unit) this thread owns in every tile: rows oi of the tile
  const int oi = tid / U, ou = tid % U;
  const bool owns = oi < NB && ou < units;
  // c, n, m of the owned pair: registers when the batch is one tile
  float c_reg = 0.f, n_reg = 0.f, m_reg = -1e30f;
  if (tiles > 1) {
    for (int p = tid; p < B * units; p += kThreads) {
      const int64_t at = static_cast<int64_t>(p / units) * D + j0 +
                         p % units;
      state[at] = 0.f;
      state[static_cast<int64_t>(B) * D + at] = 0.f;
      state[2 * static_cast<int64_t>(B) * D + at] = -1e30f;
    }
  }
  __syncthreads();

  // the warps that hold owners publish h_t, each with one release add
  const int owner_warps = (NB * U + 31) / 32;
  float h_out = 0.f;
  for (int64_t t = 0; t < S; ++t) {
    const float* hprev = hbuf + (t & 1) * BH;  // h_{t-1}; h_{-1} = 0
    float* hnext = hbuf + ((t + 1) & 1) * BH;
    float* pst = ps + (t & 1) * kWarps * NB * C4;
    // the gate inputs of the first tile, loaded before the wait
    float x4[4] = {0.f, 0.f, 0.f, 0.f};
    if (owns && oi < B) {
      const T* x = xg + (static_cast<int64_t>(oi) * S + t) * D4 + j0 + ou;
#pragma unroll
      for (int g = 0; g < 4; ++g) x4[g] = repro::to_f32(x[g * D]);
    }
    if (t > 0) {  // every owner warp of every block has published h_{t-1}
      if (tid == kThreads - 1) {  // a thread that owns nothing
        const unsigned long long want =
            static_cast<unsigned long long>(gridDim.x) * owner_warps * t;
        // a count that stays short for about a minute of polls is a fault
        // of the exchange: abort the launch rather than hang
        for (int64_t spins = 0; ld_acquire(counter) < want; ++spins)
          if (spins > kMaxSpins) __trap();
      }
      __syncthreads();
    }
    for (int tile = 0; tile < tiles; ++tile) {
      const int b0 = tile * NB, nb = min(NB, B - b0);
      // this warp's slice of the tile's rows of h_{t-1}, past L1
      for (int idx = lane; idx < nb * vec4; idx += 32) {
        const int i = idx / vec4, j = idx % vec4;
        const int64_t off = static_cast<int64_t>(i) * Dh + c_lo * P;
        reinterpret_cast<float4*>(hs + off)[j] =
            __ldcg(reinterpret_cast<const float4*>(
                       hprev + static_cast<int64_t>(b0) * Dh + off) +
                   j);
      }
      __syncwarp();
      float acc[SLOTS][NB];
#pragma unroll
      for (int s = 0; s < SLOTS; ++s)
#pragma unroll
        for (int i = 0; i < NB; ++i) acc[s][i] = 0.f;
      // (a slot past the last column, the same for every lane, is skipped)
#pragma unroll 2
      for (int c = c_lo + sub; c < c_hi; c += kSubs) {
        float4 rv[SLOTS];
#pragma unroll
        for (int s = 0; s < SLOTS; ++s)
          if (kColLanes * s < C4) rv[s] = rs[static_cast<int64_t>(c) * C4 +
                                             cols[s]];
#pragma unroll
        for (int i = 0; i < NB; ++i) {
          const float4 hv = *reinterpret_cast<const float4*>(
              hs + static_cast<int64_t>(i) * Dh + c * P);
#pragma unroll
          for (int s = 0; s < SLOTS; ++s) {
            if (kColLanes * s >= C4) continue;
            acc[s][i] = fmaf(hv.x, rv[s].x, acc[s][i]);
            acc[s][i] = fmaf(hv.y, rv[s].y, acc[s][i]);
            acc[s][i] = fmaf(hv.z, rv[s].z, acc[s][i]);
            acc[s][i] = fmaf(hv.w, rv[s].w, acc[s][i]);
          }
        }
      }
      // the kSubs lanes of a column add their sums
#pragma unroll
      for (int s = 0; s < SLOTS; ++s)
#pragma unroll
        for (int i = 0; i < NB; ++i) {
#pragma unroll
          for (int off = kColLanes; off < 32; off <<= 1)
            acc[s][i] += __shfl_xor_sync(0xffffffffu, acc[s][i], off);
        }
      if (sub == 0) {
#pragma unroll
        for (int s = 0; s < SLOTS; ++s)
#pragma unroll
          for (int i = 0; i < NB; ++i)
            if (cl + kColLanes * s < C4)
              pst[(warp * NB + i) * C4 + cl + kColLanes * s] = acc[s][i];
      }
      __syncthreads();
      if (owns && oi < nb) {
        const int64_t b = b0 + oi, at = b * D + j0 + ou;
        if (tile > 0) {  // another tile's gate inputs
          const T* x = xg + (b * S + t) * D4 + j0 + ou;
#pragma unroll
          for (int g = 0; g < 4; ++g) x4[g] = repro::to_f32(x[g * D]);
        }
        float gate[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          float sum = 0.f;
#pragma unroll
          for (int w = 0; w < kWarps; ++w)
            sum += pst[(w * NB + oi) * C4 + g * U + ou];
          gate[g] = x4[g] + sum;
        }
        const int64_t BD = static_cast<int64_t>(B) * D;
        const float c = tiles > 1 ? state[at] : c_reg;
        const float n = tiles > 1 ? state[BD + at] : n_reg;
        const float m = tiles > 1 ? state[2 * BD + at] : m_reg;
        const float lf = log_sigmoid(gate[1]);
        const float m_new = fmaxf(lf + m, gate[0]);
        const float i_w = expf(gate[0] - m_new);
        const float f_w = expf(lf + m - m_new);
        const float c_new = f_w * c + i_w * tanhf(gate[2]);
        const float n_new = f_w * n + i_w;
        const float h =
            (1.f / (1.f + expf(-gate[3]))) * c_new / fmaxf(n_new, 1.f);
        if (tiles > 1) {
          state[at] = c_new;
          state[BD + at] = n_new;
          state[2 * BD + at] = m_new;
        } else {
          c_reg = c_new;
          n_reg = n_new;
          m_reg = m_new;
        }
        hnext[b * Dh + j0 + ou] = h;
        // with one tile, `out` after the release (which would wait for it)
        if (tiles > 1)
          out[(b * S + t) * D + j0 + ou] = repro::from_f32<T>(h);
        else
          h_out = h;
      }
      if (tiles > 1) __syncthreads();  // ps is free for the next tile
    }
    if (warp < owner_warps) {  // the warp's stores of h_t, then one add
      __syncwarp();
      if (lane == 0) red_release(counter);
    }
    if (tiles == 1 && owns)
      out[(static_cast<int64_t>(oi) * S + t) * D + j0 + ou] =
          repro::from_f32<T>(h_out);
  }
}

struct Device {
  int sms = 0, coop = 0, max_smem = 0;
};

// The device's attributes, queried once a device.
int device_info(Device& out) {
  static Device cache[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  Device& d = cache[dev];
  if (d.sms == 0) {
    Device q;
    e = cudaDeviceGetAttribute(&q.sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&q.coop, cudaDevAttrCooperativeLaunch, dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(
          &q.max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return e;
    d = q;
  }
  out = d;
  return cudaSuccess;
}

template <typename T, int NB, int SLOTS>
int launch(const void* xg, const void* r, void* out, float* hbuf,
           float* state, unsigned long long* counter, int64_t B, int64_t S,
           int64_t D, int64_t U, int64_t blocks, size_t smem, int sms,
           cudaStream_t stream) {
  // The shared-memory limit and the occupancy, once per instantiation and
  // size (never again inside a CUDA-graph capture after the first call).
  static size_t configured = 0, occ_smem = 0;
  static int per_sm = 0;
  if (smem > configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        slstm_scan_kernel<T, NB, SLOTS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    configured = smem;
  }
  if (smem != occ_smem) {
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, slstm_scan_kernel<T, NB, SLOTS>, kThreads, smem);
    if (e != cudaSuccess) return e;
    occ_smem = smem;
  }
  if (blocks > static_cast<int64_t>(per_sm) * sms)
    return cudaErrorCooperativeLaunchTooLarge;
  const T* xg_t = static_cast<const T*>(xg);
  const T* r_t = static_cast<const T*>(r);
  T* out_t = static_cast<T*>(out);
  int b = static_cast<int>(B), d = static_cast<int>(D);
  int u = static_cast<int>(U);
  void* args[] = {&xg_t, &r_t, &out_t, &hbuf, &state, &counter,
                  &b, &S, &d, &u};
  return cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(slstm_scan_kernel<T, NB, SLOTS>),
      dim3(static_cast<unsigned>(blocks)), dim3(kThreads), args, smem,
      stream);
}

template <typename T, int SLOTS>
int by_rows(int64_t nb, const void* xg, const void* r, void* out,
            float* hbuf, float* state, unsigned long long* counter,
            int64_t B, int64_t S, int64_t D, int64_t U, int64_t blocks,
            size_t smem, int sms, cudaStream_t stream) {
#define REPRO_SLSTM_ROWS(N)                                                \
  case N:                                                                  \
    return launch<T, N, SLOTS>(xg, r, out, hbuf, state, counter, B, S, D, \
                               U, blocks, smem, sms, stream);
  switch (nb) {
    REPRO_SLSTM_ROWS(1)
    REPRO_SLSTM_ROWS(2)
    REPRO_SLSTM_ROWS(3)
    REPRO_SLSTM_ROWS(4)
    REPRO_SLSTM_ROWS(5)
    REPRO_SLSTM_ROWS(6)
    REPRO_SLSTM_ROWS(7)
    REPRO_SLSTM_ROWS(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_SLSTM_ROWS
}

template <typename T>
int plan_and_launch(const void* xg, const void* r, void* out, void* hbuf,
                    void* state, int64_t B, int64_t S, int64_t D,
                    cudaStream_t stream) {
  Device dev;
  cudaError_t e = static_cast<cudaError_t>(device_info(dev));
  if (e != cudaSuccess) return e;
  if (!dev.coop) return cudaErrorNotSupported;
  // One block an SM at most: the fewest units a block; then the most rows
  // a tile that fit beside r, spread evenly over the tiles.
  const int64_t U = (D + dev.sms - 1) / dev.sms;
  if (4 * U > kColLanes * kMaxSlots)
    return cudaErrorCooperativeLaunchTooLarge;
  int64_t rows = kMaxRows < B ? kMaxRows : B;
  while (rows > 0 && smem_bytes(D, U, rows) > dev.max_smem) --rows;
  if (rows == 0) return cudaErrorCooperativeLaunchTooLarge;
  const int64_t tiles = (B + rows - 1) / rows;
  const int64_t nb = (B + tiles - 1) / tiles;
  const size_t smem = static_cast<size_t>(smem_bytes(D, U, nb));
  const int64_t blocks = (D + U - 1) / U;
  const int64_t Dh = (D + P - 1) / P * P;
  float* hb = static_cast<float*>(hbuf);
  // the step counter sits after the two buffers of h
  auto* counter = reinterpret_cast<unsigned long long*>(hb + 2 * B * Dh);
  float* st = static_cast<float*>(state);
  if (4 * U <= 2 * kColLanes)
    return by_rows<T, 2>(nb, xg, r, out, hb, st, counter, B, S, D, U, blocks,
                         smem, dev.sms, stream);
  if (4 * U <= 4 * kColLanes)
    return by_rows<T, 4>(nb, xg, r, out, hb, st, counter, B, S, D, U, blocks,
                         smem, dev.sms, stream);
  return by_rows<T, 8>(nb, xg, r, out, hb, st, counter, B, S, D, U, blocks,
                       smem, dev.sms, stream);
}

}  // namespace

// xg (B, S, 4D) and r (D, 4D) of one dtype, out (B, S, D) of that dtype;
// hbuf zeroed f32 scratch: two buffers of h (2, B, Dh), Dh = D rounded up
// to a multiple of 4, then the 64-bit step counter; state (3, B, D)
// f32 scratch, used only when the batch takes more than one tile of rows;
// all contiguous (the wrapper checks and allocates).
extern "C" int repro_slstm_scan_fwd(int dtype, const void* xg, const void* r,
                                    void* out, void* hbuf, void* state,
                                    int64_t B, int64_t S, int64_t D,
                                    void* stream) {
  if (B <= 0 || B > (1 << 20) || S <= 0 || D <= 0 || D > (1 << 20))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32)
    return plan_and_launch<float>(xg, r, out, hbuf, state, B, S, D, s);
  if (dtype == repro::kBFloat16)
    return plan_and_launch<__nv_bfloat16>(xg, r, out, hbuf, state, B, S, D,
                                          s);
  return cudaErrorInvalidValue;
}
