// Flash attention (forward, causal / sliding-window, GQA) for bf16 inputs
// on Hopper's tensor cores (sm_90a, mma.sync), f32 accumulation.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (_flash_kernel) for bf16 inputs; f32 inputs keep the
// CUDA-core body of flash_attention.cu (TF32 would break its f32 bar).
// Same function: online softmax with f32 (m, l, acc), -1e30 masking, l
// clamped at 1e-30, q-head h reading KV head h // (H / Kv).
//
// Bound on the H100: operations, 4*B*H*hd*pairs (QK^T and PV over the
// (query, key) pairs inside the band) over 989 TFLOP/s bf16; the scores
// never reach device memory, and the bytes (q, k, v and out once each) are
// far smaller.  What the design does about it:
//   * one block owns one (b, h, q-tile) and loops over its key tiles; one
//     warp owns 16 query rows (block_q / 16 warps), holds its Q rows as
//     m16n8k16 A fragments for the whole loop, and keeps m, l and the
//     output accumulator in registers on the accumulator layout;
//   * K and V tiles (BLOCK_K x HD bf16) pass through a two-stage cp.async
//     ring in shared memory, rows padded by 16 bytes so that ldmatrix hits
//     no bank twice; the next tile loads while this one is computed, with
//     one cp.async.wait_group / __syncthreads pair a tile.  Keys past S are
//     zero-filled (source size 0), never read, and masked;
//   * the band comes from positions: key tiles outside every row's band are
//     not loaded, a warp skips tiles outside its rows' band, and the -1e30
//     mask runs only on tiles that cross the band's edge or S;
//   * P is split into hi = bf16(p) and lo = bf16(p - hi), and PV is two
//     mma.sync passes into one f32 accumulator.  The TPU kernel rounds P to
//     bf16 once (p.astype(v.dtype)); against the f32 plain version that
//     breaks the port's bf16 bar (one bf16 step, 1e-4 + 2^-7 |plain|) on
//     about 2% of outputs at B2 S256 H4/2 hd64 in an emulation of this
//     body's arithmetic (tests/test_torch_flash_tc.py), where the split
//     meets it everywhere.  The split costs a second PV product: 1.5x the
//     MMA work of one bf16 pass.  l is summed from the f32 p.
// Still missing, queued as ROADMAP B1w: wgmma, a TMA ring and warp
// specialisation, and hd 120 read unpadded (it runs zero-padded to 128).
#include "common.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kPad = 8;        // bf16 elements of padding a shared row
constexpr int kMaxThreads = 256;  // block_q <= 128: 8 warps

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; `valid` false zero-fills and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (p0, p1) -> hi = bf16(p), lo = bf16(p - hi), p0 in the low half
__device__ __forceinline__ void split(float p0, float p1, uint32_t& hi,
                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(p0 - hf.x, p1 - hf.y));
}

template <int HD, int BLOCK_K>
__global__ void __launch_bounds__(kMaxThreads)
    flash_attention_tc_kernel(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v,
                              __nv_bfloat16* __restrict__ o, int64_t S,
                              int64_t H, int64_t Kv, int causal,
                              int64_t window, float scale) {
  constexpr int kRow = HD + kPad;         // shared row, bf16 elements
  constexpr int kTile = BLOCK_K * kRow;   // one K or V tile
  constexpr int kChunks = HD / 8;         // 16-byte chunks a row
  constexpr int kNT = BLOCK_K / 8;        // score tiles of 8 keys
  constexpr int kDT = HD / 8;             // output tiles of 8 dims
  // [stage][K, V][BLOCK_K][kRow]; after the loop, the output rows
  extern __shared__ __align__(16) __nv_bfloat16 smem[];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // accumulator row, column pair
  const int64_t block_q = blockDim.x / 2;  // 16 rows a warp of 32
  const int64_t b = blockIdx.z, h = blockIdx.y;
  const int64_t kvh = h / (H / Kv);  // GQA: h // groups, not h % Kv
  // the last (longest, under a causal band) q-tiles are scheduled first
  const int64_t q0 = (gridDim.x - 1 - static_cast<int64_t>(blockIdx.x)) *
                     block_q;
  const int64_t w0 = q0 + warp * 16;  // this warp's first row

  // Keys any row of this block can see, in whole tiles.
  const int64_t q_last = min(q0 + block_q, S) - 1;
  const int64_t k_lo = window > 0 ? max(static_cast<int64_t>(0),
                                        q0 - window + 1) : 0;
  const int64_t k_hi = causal ? q_last + 1 : S;  // exclusive
  const int64_t tile_lo = k_lo / BLOCK_K;
  const int64_t tile_hi = (k_hi + BLOCK_K - 1) / BLOCK_K;
  // ... and the rows of this warp
  const bool warp_rows = w0 < S;
  const int64_t wk_lo = window > 0 ? max(static_cast<int64_t>(0),
                                         w0 - window + 1) : 0;
  const int64_t wk_hi = causal ? min(w0 + 16, S) : S;

  const int64_t kv_stride = Kv * HD;  // between consecutive keys
  const __nv_bfloat16* kb = k + (b * S * Kv + kvh) * HD;
  const __nv_bfloat16* vb = v + (b * S * Kv + kvh) * HD;
  auto load_tile = [&](int64_t tile, int stage) {
    __nv_bfloat16* ks = smem + stage * 2 * kTile;
    __nv_bfloat16* vs = ks + kTile;
    const int64_t t0 = tile * BLOCK_K;
    for (int idx = threadIdx.x; idx < BLOCK_K * kChunks; idx += blockDim.x) {
      const int j = idx / kChunks, c = (idx % kChunks) * 8;
      const bool in = t0 + j < S;
      const int64_t off = (in ? t0 + j : 0) * kv_stride + c;
      cp_async16(smem_u32(ks + j * kRow + c), kb + off, in);
      cp_async16(smem_u32(vs + j * kRow + c), vb + off, in);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  load_tile(tile_lo, 0);

  // Q rows w0 + g and w0 + g + 8 as A fragments, zero past S.
  uint32_t qf[HD / 16][4];
  {
    const int64_t r0 = w0 + g, r1 = r0 + 8;
    const __nv_bfloat16* q0p = q + ((b * S + min(r0, S - 1)) * H + h) * HD;
    const __nv_bfloat16* q1p = q + ((b * S + min(r1, S - 1)) * H + h) * HD;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int c = kk * 16 + 2 * t;
      qf[kk][0] = r0 < S ? *reinterpret_cast<const uint32_t*>(q0p + c) : 0u;
      qf[kk][1] = r1 < S ? *reinterpret_cast<const uint32_t*>(q1p + c) : 0u;
      qf[kk][2] = r0 < S ? *reinterpret_cast<const uint32_t*>(q0p + c + 8)
                         : 0u;
      qf[kk][3] = r1 < S ? *reinterpret_cast<const uint32_t*>(q1p + c + 8)
                         : 0u;
    }
  }

  float acc[kDT][4];
#pragma unroll
  for (int dt = 0; dt < kDT; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  // m in log2 units (scores times scale * log2(e)); l partial to this
  // thread's columns, summed over the quad at the end
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const float scale2 = scale * kLog2e;

  for (int64_t tile = tile_lo; tile < tile_hi; ++tile) {
    const int stage = static_cast<int>((tile - tile_lo) & 1);
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    // tile is visible to all, and every warp is done with the other stage
    __syncthreads();
    if (tile + 1 < tile_hi) load_tile(tile + 1, stage ^ 1);
    const int64_t t0 = tile * BLOCK_K;
    if (!warp_rows || t0 >= wk_hi || t0 + BLOCK_K <= wk_lo) continue;
    const __nv_bfloat16* ks = smem + stage * 2 * kTile;
    const __nv_bfloat16* vs = ks + kTile;

    // scores: 16 rows x BLOCK_K keys
    float s[kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] =
        s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
      for (int nt = 0; nt < kNT; nt += 2) {
        // matrices: keys +0..7 at dims +0 / +8, keys +8..15 at +0 / +8
        uint32_t kf[4];
        const int key = nt * 8 + (lane & 7) + ((lane >> 4) << 3);
        const int dim = kk * 16 + (((lane >> 3) & 1) << 3);
        ldmatrix_x4(kf, smem_u32(ks + key * kRow + dim));
        mma(s[nt], qf[kk], kf[0], kf[1]);
        mma(s[nt + 1], qf[kk], kf[2], kf[3]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] *= scale2;
    // the -1e30 mask, only on a tile that crosses the band's edge or S
    const bool edge = t0 + BLOCK_K > S ||
                      (causal && t0 + BLOCK_K - 1 > w0) ||
                      (window > 0 && t0 <= w0 + 15 - window);
    if (edge) {
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int64_t kpos = t0 + nt * 8 + 2 * t + (i & 1);
          const int64_t qpos = w0 + g + (i >> 1) * 8;
          const bool in = kpos < S && (!causal || kpos <= qpos) &&
                          (window <= 0 || kpos > qpos - window);
          if (!in) s[nt][i] = kNegInf;
        }
    }

    // online softmax; rows g (r = 0) and g + 8 (r = 1) of the warp's 16
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
    }
    float base[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // m_new is known before any exp; a row with no key of its band yet
      // keeps -1e30 and takes p = exp2(-1e30) = 0, never exp2(0)
      base[r] = mx[r] == kNegInf ? 0.f : mx[r];
      const float corr = exp2f(m[r] - base[r]);
      m[r] = mx[r];
      l[r] *= corr;
#pragma unroll
      for (int dt = 0; dt < kDT; ++dt) {
        acc[dt][2 * r] *= corr;
        acc[dt][2 * r + 1] *= corr;
      }
    }
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = exp2f(s[nt][i] - base[i >> 1]);
      l[0] += s[nt][0] + s[nt][1];
      l[1] += s[nt][2] + s[nt][3];
    }

    // acc += (hi + lo) V over the tile's keys, 16 at a time
#pragma unroll
    for (int kk = 0; kk < BLOCK_K / 16; ++kk) {
      uint32_t hi[4], lo[4];
      split(s[2 * kk][0], s[2 * kk][1], hi[0], lo[0]);
      split(s[2 * kk][2], s[2 * kk][3], hi[1], lo[1]);
      split(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[2], lo[2]);
      split(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
      for (int dt = 0; dt < kDT; dt += 2) {
        // transposed matrices: keys +0..7 / +8..15 at dims +0, then +8
        uint32_t vf[4];
        const int key = kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
        const int dim = dt * 8 + ((lane >> 4) << 3);
        ldmatrix_x4_trans(vf, smem_u32(vs + key * kRow + dim));
        mma(acc[dt], hi, vf[0], vf[1]);
        mma(acc[dt], lo, vf[0], vf[1]);
        mma(acc[dt + 1], hi, vf[2], vf[3]);
        mma(acc[dt + 1], lo, vf[2], vf[3]);
      }
    }
  }

  // every warp is done with the ring: stage the output rows there and
  // write them with 16-byte stores
  __syncthreads();
  if (!warp_rows) return;
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / fmaxf(l[r], 1e-30f);
  }
  __nv_bfloat16* os = smem + warp * 16 * kRow;
#pragma unroll
  for (int dt = 0; dt < kDT; ++dt) {
    const int c = dt * 8 + 2 * t;
    *reinterpret_cast<__nv_bfloat162*>(os + g * kRow + c) =
        __floats2bfloat162_rn(acc[dt][0] * inv[0], acc[dt][1] * inv[0]);
    *reinterpret_cast<__nv_bfloat162*>(os + (g + 8) * kRow + c) =
        __floats2bfloat162_rn(acc[dt][2] * inv[1], acc[dt][3] * inv[1]);
  }
  __syncwarp();
  for (int idx = lane; idx < 16 * kChunks; idx += 32) {
    const int r = idx / kChunks, c = (idx % kChunks) * 8;
    const int64_t qpos = w0 + r;
    if (qpos < S)
      *reinterpret_cast<uint4*>(o + ((b * S + qpos) * H + h) * HD + c) =
          *reinterpret_cast<const uint4*>(os + r * kRow + c);
  }
}

template <int HD, int BLOCK_K>
int launch(const void* q, const void* k, const void* v, void* o, int64_t B,
           int64_t S, int64_t H, int64_t Kv, int64_t block_q, int64_t causal,
           int64_t window, float scale, cudaStream_t stream) {
  // the ring: two stages of a K and a V tile; the output rows (block_q <=
  // 128 <= 4 * BLOCK_K of them) fit in it
  constexpr size_t smem = 4 * BLOCK_K * (HD + kPad) * sizeof(__nv_bfloat16);
  // Raise the shared-memory limit once per instantiation (not on every
  // launch, and never inside a CUDA-graph capture after the first call).
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention_tc_kernel<HD, BLOCK_K>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const dim3 grid(static_cast<unsigned>((S + block_q - 1) / block_q),
                  static_cast<unsigned>(H), static_cast<unsigned>(B));
  flash_attention_tc_kernel<HD, BLOCK_K>
      <<<grid, static_cast<unsigned>(2 * block_q), smem, stream>>>(
          static_cast<const __nv_bfloat16*>(q),
          static_cast<const __nv_bfloat16*>(k),
          static_cast<const __nv_bfloat16*>(v),
          static_cast<__nv_bfloat16*>(o), S, H, Kv, static_cast<int>(causal),
          window, scale);
  return cudaGetLastError();
}

template <int HD>
int dispatch_block_k(int64_t block_k, const void* q, const void* k,
                     const void* v, void* o, int64_t B, int64_t S, int64_t H,
                     int64_t Kv, int64_t block_q, int64_t causal,
                     int64_t window, float scale, cudaStream_t stream) {
  switch (block_k) {
    case 32:
      return launch<HD, 32>(q, k, v, o, B, S, H, Kv, block_q, causal, window,
                            scale, stream);
    case 64:
      return launch<HD, 64>(q, k, v, o, B, S, H, Kv, block_q, causal, window,
                            scale, stream);
    case 128:
      return launch<HD, 128>(q, k, v, o, B, S, H, Kv, block_q, causal,
                             window, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// bf16 q (B, S, H, hd), k/v (B, S, Kv, hd), out (B, S, H, hd), contiguous,
// 16-byte aligned.  hd in {16, 32, 64, 128}; block_k in {32, 64, 128};
// block_q a multiple of 16 up to 128 (block_q / 16 warps).  window <= 0
// means no sliding window.  `scale` multiplies the scores: 1/sqrt(head_dim)
// of the model, which is not 1/sqrt(hd) when the wrapper zero-pads the head
// dim (hd 120 runs as 128).
extern "C" int repro_flash_attention_tc_fwd(const void* q, const void* k,
                                            const void* v, void* o,
                                            int64_t B, int64_t S, int64_t H,
                                            int64_t Kv, int64_t hd,
                                            int64_t block_q, int64_t block_k,
                                            int64_t causal, int64_t window,
                                            float scale, void* stream) {
  if (B <= 0 || S <= 0 || Kv <= 0 || H % Kv != 0 || block_q < 16 ||
      block_q > kMaxThreads / 2 || block_q % 16 != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16:
      return dispatch_block_k<16>(block_k, q, k, v, o, B, S, H, Kv, block_q,
                                  causal, window, scale, s);
    case 32:
      return dispatch_block_k<32>(block_k, q, k, v, o, B, S, H, Kv, block_q,
                                  causal, window, scale, s);
    case 64:
      return dispatch_block_k<64>(block_k, q, k, v, o, B, S, H, Kv, block_q,
                                  causal, window, scale, s);
    case 128:
      return dispatch_block_k<128>(block_k, q, k, v, o, B, S, H, Kv, block_q,
                                   causal, window, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}
