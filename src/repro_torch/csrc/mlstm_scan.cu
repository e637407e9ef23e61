// Chunkwise mLSTM (xLSTM's matrix-memory recurrence) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/mlstm_scan.py::
// mlstm_chunkwise (_mlstm_kernel).  Per (b, h), with the state C (hd, hd),
// n (hd) and the stabiliser m carried in f32 from one chunk of L steps to
// the next:
//   F = cumsum(log_f), m_u = max(m_prev, cummax(log_i - F)) + F,
//   S[u][t] = (q_u . k_t) exp(F_u - F_t + log_i_t - m_u) for t <= u, else 0,
//   out_u = (d_u q_u C + S v) / max(|d_u q_u . n + sum_t S[u][t]|, e^-m_u),
//   with d_u = exp(F_u + m_prev - m_u); then, at m_new = m_{L-1},
//   C = C e^{F_L + m_prev - m_new} + sum_t k_t w_t v_t^T, w_t =
//   exp(log_i_t + F_L - F_t - m_new), and n likewise with k_t w_t.
// q, k, v (B, S, H, hd) of one dtype (f32 or bf16; k already divided by
// sqrt(hd)), log_i, log_f (B, S, H) f32, out (B, S, H, hd) in q's dtype.
//
// The TPU kernel walks a grid (b, h, chunk) in order and keeps C, n and m in
// VMEM scratch between chunk steps.  Here the work is cut where the
// recurrence allows it: only the update of C, n, m runs in order over the
// chunks, and every chunk's outputs are computed in parallel once the state
// before that chunk is known.  Two launches:
//   1. States: a block owns a tile of C (and, in the first column block,
//      the tile's rows of n), keeps it in registers, walks the chunks of its
//      (b, h) in order and stores C, n and m as they stand before each chunk
//      in f32 scratch (B, H, S/L, hd, hd), (B, H, S/L, hd), (B, H, S/L).
//      The update is the reference's, C = C carry + (k w)^T v, in order over
//      the chunks; the next chunk's k, v and gates are loaded into registers
//      while this one is summed, and the last chunk's update (never needed)
//      is skipped.
//      * bf16 (mlstm_state_tc_kernel): mma.sync with f32 accumulators, a
//        64 x 64 tile a block (144 blocks at the model's shape), C held in
//        the accumulators across the chunks.  k w is formed in f32 and split
//        in two bf16 parts (A, read transposed from [t][d] by ldmatrix);
//        v is exact.  n sums the two parts on the CUDA cores.
//      * f32 (mlstm_state_kernel): the CUDA cores, a 32 x 32 tile a block,
//        one thread four elements, k w in f32.
//   2. Outputs: one block per (b, h, chunk, column block), all in parallel,
//      reads the state before its chunk.
//      * bf16 (mlstm_out_tc_kernel): the tensor cores, mma.sync m16n8k16,
//        f32 accumulation.  A warp owns 16 rows of the chunk; q and k pass
//        through shared memory in slices of 64 dimensions (any hd), and per
//        slice the warp accumulates S = q k^T (key tiles past its rows'
//        band skipped) and q C for the block's 64 value columns from the
//        same q fragments.  q, k and v are exact in bf16.  C is f32: it is
//        split into hi = bf16(C) and lo = bf16(C - hi) and multiplied twice;
//        S is gated in f32 and split the same way for S v.  Rounding any of
//        C, S and k w once to bf16 breaks the port's bf16 bar of one bf16
//        step on some outputs in an emulation of this arithmetic
//        (tests/test_torch_mlstm_tc.py), where the splits meet it.  The row
//        sums of S and q . n stay f32 on the CUDA cores.
//      * f32 (mlstm_out_kernel): the CUDA cores, as the first design of
//        this kernel computed a chunk's outputs (a block owns 32 value
//        columns; the score tile in registers), without its update of C.
//   The chunk's F and running max are warp scans in both passes; the row
//   sums of S are warp reductions.
//
// Bound on the H100.  A chunk of L steps takes 2 L (L + 1) hd (q k^T and
// S v over the causal pairs) + 4 L hd^2 (q C and the update of C)
// operations, over the peak rate for the inputs' type (989 TFLOP/s bf16, 67
// f32); the bytes (q, k, v, out, gates once) over 3.35 TB/s bound bf16 at
// xlstm-125m's shape.  The state scratch (written once, read once, 18.9 MB
// at B 4, H 4, S 1024, hd 192, L 128) stays within the 50 MB L2.  The bf16
// output blocks recompute S for each of their hd / 64 column blocks.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChunk = 128;  // L; the tiles below cover it

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// log_i and log_f of step `tid` of a chunk (0 past L)
__device__ __forceinline__ float2 load_gates(const float* __restrict__ li_g,
                                             const float* __restrict__ lf_g,
                                             int H, int L) {
  const int tid = threadIdx.x;
  if (tid >= L) return make_float2(0.f, 0.f);
  return make_float2(li_g[static_cast<int64_t>(tid) * H],
                     lf_g[static_cast<int64_t>(tid) * H]);
}

// The chunk's gates: thread t < L holds step t's (log_i, log_f).  Writes
// log_i, F = cumsum(log_f) and m_u = max(m_prev, cummax(log_i - F)) + F for
// t < lp (zero past L) into shared memory, by warp scans (the four warps of
// the first 128 threads, then their totals).  Every thread of the block
// calls it.
__device__ void chunk_gates(float2 gates, int L, int lp, float m_prev,
                            float* li_s, float* fc_s, float* mu_s,
                            float* scan_s) {
  const int tid = threadIdx.x, lane = tid % 32, w = tid / 32;
  const float li = gates.x;
  float f = gates.y;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float up = __shfl_up_sync(0xffffffffu, f, off);
    if (lane >= off) f += up;
  }
  if (lane == 31 && w < 4) scan_s[w] = f;
  __syncthreads();
  for (int j = 0; j < min(w, 4); ++j) f += scan_s[j];
  float x = tid < L ? li - f : -INFINITY;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float up = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x = fmaxf(x, up);
  }
  if (lane == 31 && w < 4) scan_s[4 + w] = x;
  __syncthreads();
  for (int j = 0; j < min(w, 4); ++j) x = fmaxf(x, scan_s[4 + j]);
  if (tid < lp) {
    const bool ok = tid < L;
    li_s[tid] = ok ? li : 0.f;
    fc_s[tid] = ok ? f : 0.f;
    mu_s[tid] = ok ? fmaxf(m_prev, x) + f : 0.f;
  }
  __syncthreads();
}

// -- pass 1: the states before each chunk ------------------------------------

constexpr int kStRows = 32;  // rows of C a state block owns
constexpr int kStCols = 32;  // columns

// The 16-byte vectors of a (kMaxChunk x kStRows) f32 tile a thread loads
constexpr int kStLoads = kMaxChunk * kStRows * 4 / 16 / kThreads;

// P = 16 / sizeof(T) consecutive values of row t of a (., hd) matrix whose
// rows are `stride` apart, from column c, as one 16-byte vector: zero past
// `valid` rows and past hd; one 16-byte load where `vec` (hd a multiple of
// P, the base 16-byte aligned).
template <typename T>
__device__ __forceinline__ uint4 load_vec(const T* __restrict__ src,
                                          int64_t stride, int t, int valid,
                                          int c, int hd, bool vec) {
  constexpr int P = 16 / sizeof(T);
  uint4 val = make_uint4(0u, 0u, 0u, 0u);
  if (t >= valid) return val;
  const T* p = src + t * stride + c;
  if (vec) {
    if (c < hd) val = __ldg(reinterpret_cast<const uint4*>(p));
    return val;
  }
  T* e = reinterpret_cast<T*>(&val);
#pragma unroll
  for (int j = 0; j < P; ++j)
    if (c + j < hd) e[j] = p[j];
  return val;
}

template <typename T>
__device__ __forceinline__ void unpack_vec(const uint4& v, float* out) {
  const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
  for (int j = 0; j < 16 / static_cast<int>(sizeof(T)); ++j)
    out[j] = repro::to_f32(e[j]);
}

__global__ void __launch_bounds__(kThreads)
    mlstm_state_kernel(const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ log_i,
                       const float* __restrict__ log_f,
                       float* __restrict__ cst, float* __restrict__ nst,
                       float* __restrict__ mst, int64_t S, int H, int hd,
                       int L, int vec) {
  constexpr int P = 4;                   // values a 16-byte vector
  constexpr int kRowVecs = kStRows / P;  // 16-byte vectors a tile row
  constexpr int kLoads = kStLoads;
  __shared__ __align__(16) float kw[kMaxChunk][kStRows];  // k_t w_t
  __shared__ __align__(16) float vs[kMaxChunk][kStCols];
  __shared__ float li_s[kMaxChunk], fc_s[kMaxChunk], mu_s[kMaxChunk],
      w_s[kMaxChunk], scan_s[8];

  const int tid = threadIdx.x;
  const int col_blocks = (hd + kStCols - 1) / kStCols;
  const int d0 = blockIdx.x / col_blocks * kStRows;
  const int e0 = blockIdx.x % col_blocks * kStCols;
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int64_t row = static_cast<int64_t>(H) * hd;  // elements a step
  const int64_t nc = S / L;
  const int64_t bh = b * H + h;
  // thread (dr, ec): row d0 + dr, columns e0 + 4 ec .. + 3
  const int dr = tid / 8, ec = tid % 8;
  const bool n_owner = e0 == 0 && tid < kStRows && d0 + tid < hd;
  float c[4] = {0.f, 0.f, 0.f, 0.f};
  float n = 0.f, m_prev = -1e30f;

  // a chunk's k and v tiles and gates, into registers: the next chunk's
  // loads are in flight while this one is summed
  uint4 kreg[kLoads], vreg[kLoads];
  float2 gates;
  const auto fetch = [&](int64_t ci) {
    const int64_t s0 = ci * L;
    const int64_t base = (b * S + s0) * row + static_cast<int64_t>(h) * hd;
    const int64_t gbase = (b * S + s0) * H + h;
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int i = tid + j * kThreads;
      const int t = i / kRowVecs, cc = i % kRowVecs * P;
      kreg[j] = load_vec(k + base, row, t, L, d0 + cc, hd, vec);
      vreg[j] = load_vec(v + base, row, t, L, e0 + cc, hd, vec);
    }
    gates = load_gates(log_i + gbase, log_f + gbase, H, L);
  };
  if (nc > 1) fetch(0);

  for (int64_t ci = 0; ci + 1 < nc; ++ci) {
    chunk_gates(gates, L, L, m_prev, li_s, fc_s, mu_s, scan_s);
    const float f_tot = fc_s[L - 1], m_new = mu_s[L - 1];
    const float carry = expf(f_tot + m_prev - m_new);
    for (int t = tid; t < L; t += kThreads)
      w_s[t] = expf(li_s[t] + (f_tot - fc_s[t]) - m_new);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int i = tid + j * kThreads;
      const int t = i / kRowVecs, cc = i % kRowVecs * P;
      float kv[P], vv[P];
      unpack_vec<float>(kreg[j], kv);
      unpack_vec<float>(vreg[j], vv);
      const float w = t < L ? w_s[t] : 0.f;
#pragma unroll
      for (int e = 0; e < P; ++e) {
        kw[t][cc + e] = kv[e] * w;
        vs[t][cc + e] = vv[e];
      }
    }
    if (ci + 2 < nc) fetch(ci + 1);
    __syncthreads();
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int t = 0; t < L; ++t) {
      const float kk = kw[t][dr];
      const float4 vv = *reinterpret_cast<const float4*>(&vs[t][4 * ec]);
      acc[0] += kk * vv.x;
      acc[1] += kk * vv.y;
      acc[2] += kk * vv.z;
      acc[3] += kk * vv.w;
    }
    // C before chunk ci + 1
    float* cout = cst + (bh * nc + ci + 1) * hd * hd;
    const int d = d0 + dr;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      c[j] = c[j] * carry + acc[j];
      const int e = e0 + 4 * ec + j;
      if (d < hd && e < hd) cout[static_cast<int64_t>(d) * hd + e] = c[j];
    }
    if (n_owner) {
      float acc_n = 0.f;
      for (int t = 0; t < L; ++t) acc_n += kw[t][tid];
      n = n * carry + acc_n;
      nst[(bh * nc + ci + 1) * hd + d0 + tid] = n;
    }
    if (blockIdx.x == 0 && tid == 0) mst[bh * nc + ci + 1] = m_new;
    m_prev = m_new;
    __syncthreads();  // the next chunk refills every buffer
  }
}

// -- pass 2, bf16: the outputs on the tensor cores ---------------------------

constexpr int kSlice = 64;         // dimensions of q/k a slice
constexpr int kTcCols = 64;        // value columns of an output block
constexpr int kRow = kSlice + 8;   // bf16 row in shared memory (+16 bytes)
static_assert(kTcCols == kSlice, "one row stride for every tile");
constexpr int kTcSmem = (3 * kMaxChunk + 2 * kSlice) * kRow * 2 +
                        (5 * kMaxChunk + kSlice + 8) * 4;

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
  const __nv_bfloat162 h2 = __floats2bfloat162_rn(p0, p1);
  const float2 hf = __bfloat1622float2(h2);
  hi = as_u32(h2);
  lo = as_u32(__floats2bfloat162_rn(p0 - hf.x, p1 - hf.y));
}

// rows [0, rows) x 64 columns of a (., hd) bf16 matrix whose rows are
// `stride` apart, starting at column c0, into a shared tile; zero past
// `valid` rows and past hd.  16-byte loads where `vec` (hd % 8 == 0 and
// the base 16-byte aligned).
constexpr int kTileLoads = kMaxChunk * (kSlice / 8) / kThreads;
constexpr int kCLoads = kSlice * (kTcCols / 4) / kThreads;

__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          int64_t stride, int rows,
                                          int valid, int c0, int hd,
                                          bool vec) {
  uint4 val[kTileLoads];  // every load in flight before the first store
#pragma unroll
  for (int j = 0; j < kTileLoads; ++j) {
    const int i = threadIdx.x + j * kThreads;
    val[j] = load_vec(src, stride, i / (kSlice / 8), valid,
                      c0 + i % (kSlice / 8) * 8, hd, vec);
  }
#pragma unroll
  for (int j = 0; j < kTileLoads; ++j) {
    const int i = threadIdx.x + j * kThreads;
    if (i < rows * (kSlice / 8))
      *reinterpret_cast<uint4*>(dst + i / (kSlice / 8) * kRow +
                                i % (kSlice / 8) * 8) = val[j];
  }
}

__global__ void __launch_bounds__(kThreads)
    mlstm_out_tc_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const float* __restrict__ log_i,
                        const float* __restrict__ log_f,
                        const float* __restrict__ cst,
                        const float* __restrict__ nst,
                        const float* __restrict__ mst,
                        __nv_bfloat16* __restrict__ out, int64_t S, int H,
                        int hd, int L, int vec) {
  // q, k and v tiles (kMaxChunk rows), C's hi and lo parts (kSlice rows),
  // then the f32 vectors: kTcSmem bytes in all
  extern __shared__ __align__(16) __nv_bfloat16 tc_smem[];
  __nv_bfloat16* qs = tc_smem;
  __nv_bfloat16* ks = qs + kMaxChunk * kRow;
  __nv_bfloat16* vs = ks + kMaxChunk * kRow;
  __nv_bfloat16* chs = vs + kMaxChunk * kRow;
  __nv_bfloat16* cls = chs + kSlice * kRow;
  float* li_s = reinterpret_cast<float*>(cls + kSlice * kRow);
  float* fc_s = li_s + kMaxChunk;
  float* mu_s = fc_s + kMaxChunk;
  float* du_s = mu_s + kMaxChunk;
  float* qn_s = du_s + kMaxChunk;
  float* ns = qn_s + kMaxChunk;  // kSlice
  float* scan_s = ns + kSlice;   // 8

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;  // accumulator row, column pair
  const int col_blocks = (hd + kTcCols - 1) / kTcCols;
  const int64_t ci = blockIdx.x / col_blocks;
  const int e0 = static_cast<int>(blockIdx.x % col_blocks) * kTcCols;
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int64_t row = static_cast<int64_t>(H) * hd;
  const int64_t nc = S / L, bh = b * H + h;
  const int64_t s0 = ci * L;
  const int64_t base = (b * S + s0) * row + static_cast<int64_t>(h) * hd;
  const int64_t gbase = (b * S + s0) * H + h;
  const int lr = (L + 15) / 16 * 16;  // rows in whole mma tiles
  const bool has_c = ci > 0;          // C = n = 0 before the first chunk
  const float m_prev = has_c ? mst[bh * nc + ci] : -1e30f;
  const float* cprev = cst + (bh * nc + ci) * hd * hd;
  const float* nprev = nst + (bh * nc + ci) * hd;

  const int w0 = warp * 16;  // this warp's first row
  const bool active = w0 < L;
  float s[kMaxChunk / 8][4];  // S: 16 rows x up to 128 keys
  float o[kTcCols / 8][4];    // the output: 16 rows x 64 columns
#pragma unroll
  for (int nt = 0; nt < kMaxChunk / 8; ++nt)
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
  for (int nt = 0; nt < kTcCols / 8; ++nt)
    o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
  // q . n: thread 2u + half sums half of each slice of row u
  const int qn_row = tid / 2, qn_half = tid % 2;
  float qn = 0.f;

  // a slice's q, k, C (this block's columns) and n in registers: the next
  // slice's loads are in flight while this one is multiplied
  uint4 qreg[kTileLoads], kreg[kTileLoads];
  float4 creg[kCLoads];
  float nreg = 0.f;
  const auto fetch = [&](int d0) {
#pragma unroll
    for (int j = 0; j < kTileLoads; ++j) {
      const int i = tid + j * kThreads;
      const int t = i / (kSlice / 8), c = d0 + i % (kSlice / 8) * 8;
      qreg[j] = load_vec(q + base, row, t, L, c, hd, vec);
      kreg[j] = load_vec(k + base, row, t, L, c, hd, vec);
    }
    if (!has_c) return;
#pragma unroll
    for (int j = 0; j < kCLoads; ++j) {
      const int i = tid + j * kThreads;
      const int d = d0 + i / (kTcCols / 4), e = e0 + i % (kTcCols / 4) * 4;
      float cv[4] = {0.f, 0.f, 0.f, 0.f};
      if (d < hd) {
        const float* p = cprev + static_cast<int64_t>(d) * hd + e;
        if (hd % 4 == 0) {
          if (e < hd) {
            const float4 c4 = __ldg(reinterpret_cast<const float4*>(p));
            cv[0] = c4.x, cv[1] = c4.y, cv[2] = c4.z, cv[3] = c4.w;
          }
        } else {
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            if (e + jj < hd) cv[jj] = p[jj];
        }
      }
      creg[j] = make_float4(cv[0], cv[1], cv[2], cv[3]);
    }
    nreg = tid < kSlice && d0 + tid < hd ? nprev[d0 + tid] : 0.f;
  };
  const auto stage = [&]() {
#pragma unroll
    for (int j = 0; j < kTileLoads; ++j) {
      const int i = tid + j * kThreads;
      if (i >= lr * (kSlice / 8)) continue;
      const int at = i / (kSlice / 8) * kRow + i % (kSlice / 8) * 8;
      *reinterpret_cast<uint4*>(qs + at) = qreg[j];
      *reinterpret_cast<uint4*>(ks + at) = kreg[j];
    }
    if (!has_c) return;
    // C in two bf16 parts
#pragma unroll
    for (int j = 0; j < kCLoads; ++j) {
      const int i = tid + j * kThreads;
      const int at = i / (kTcCols / 4) * kRow + i % (kTcCols / 4) * 4;
      uint32_t hi0, lo0, hi1, lo1;
      split(creg[j].x, creg[j].y, hi0, lo0);
      split(creg[j].z, creg[j].w, hi1, lo1);
      *reinterpret_cast<uint2*>(chs + at) = make_uint2(hi0, hi1);
      *reinterpret_cast<uint2*>(cls + at) = make_uint2(lo0, lo1);
    }
    if (tid < kSlice) ns[tid] = nreg;
  };

  fetch(0);  // in flight during the gates and v
  chunk_gates(load_gates(log_i + gbase, log_f + gbase, H, L), L, lr, m_prev,
              li_s, fc_s, mu_s, scan_s);
  if (tid < L) du_s[tid] = expf(fc_s[tid] + m_prev - mu_s[tid]);
  load_tile(vs, v + base, row, lr, L, e0, hd, vec);
  for (int d0 = 0; d0 < hd; d0 += kSlice) {
    stage();
    __syncthreads();
    if (d0 + kSlice < hd) fetch(d0 + kSlice);
    if (active) {
#pragma unroll
      for (int kk = 0; kk < kSlice / 16; ++kk) {
        uint32_t a[4];  // q rows w0 .. w0 + 15, dimensions kk * 16 ..
        ldmatrix_x4(a, smem_u32(qs + (w0 + lane % 16) * kRow + kk * 16 +
                                (lane / 16) * 8));
        // S: key tiles of 16 up to this warp's last row
#pragma unroll
        for (int np = 0; np < kMaxChunk / 16; ++np) {
          if (np * 16 > w0 + 15) continue;
          uint32_t kf[4];
          const int key = np * 16 + (lane & 7) + ((lane >> 4) << 3);
          const int dim = kk * 16 + (((lane >> 3) & 1) << 3);
          ldmatrix_x4(kf, smem_u32(ks + key * kRow + dim));
          mma(s[2 * np], a, kf[0], kf[1]);
          mma(s[2 * np + 1], a, kf[2], kf[3]);
        }
        // q C, C in two bf16 parts
        if (has_c) {
#pragma unroll
          for (int ep = 0; ep < kTcCols / 16; ++ep) {
            const int dd = kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
            const int col = ep * 16 + ((lane >> 4) << 3);
            uint32_t ch[4], cl[4];
            ldmatrix_x4_trans(ch, smem_u32(chs + dd * kRow + col));
            ldmatrix_x4_trans(cl, smem_u32(cls + dd * kRow + col));
            mma(o[2 * ep], a, ch[0], ch[1]);
            mma(o[2 * ep], a, cl[0], cl[1]);
            mma(o[2 * ep + 1], a, ch[2], ch[3]);
            mma(o[2 * ep + 1], a, cl[2], cl[3]);
          }
        }
      }
    }
    if (has_c && qn_row < L) {
      const __nv_bfloat16* qr = qs + qn_row * kRow + qn_half * 32;
      const float* nr = ns + qn_half * 32;
#pragma unroll 8
      for (int j = 0; j < 32; ++j) qn += __bfloat162float(qr[j]) * nr[j];
    }
    __syncthreads();  // before the next slice refills q, k and C
  }
  qn += __shfl_xor_sync(0xffffffffu, qn, 1);
  if (qn_half == 0 && qn_row < kMaxChunk) qn_s[qn_row] = qn;
  __syncthreads();
  if (!active) return;

  // gate S in f32, causal, and its row sums; scale q C by d_u
  const int u0 = w0 + g, u1 = u0 + 8;
  float rsum[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < kMaxChunk / 8; ++nt) {
    if (nt * 8 > w0 + 15) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int u = i < 2 ? u0 : u1, t = nt * 8 + 2 * tq + (i & 1);
      float sv = 0.f;
      if (t <= u && u < L)
        sv = s[nt][i] * expf(fc_s[u] - fc_s[t] + li_s[t] - mu_s[u]);
      s[nt][i] = sv;
      rsum[i >> 1] += sv;
    }
  }
  float den[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 1);
    rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 2);
    const int u = r ? u1 : u0;
    const float du = u < L ? du_s[u] : 0.f;
    den[r] = u < L ? fmaxf(fabsf(qn_s[u] * du + rsum[r]), expf(-mu_s[u]))
                   : 1.f;
#pragma unroll
    for (int nt = 0; nt < kTcCols / 8; ++nt) {
      o[nt][2 * r] *= du;
      o[nt][2 * r + 1] *= du;
    }
  }
  // o += (hi + lo) v over the keys up to this warp's last row
#pragma unroll
  for (int kk = 0; kk < kMaxChunk / 16; ++kk) {
    if (kk * 16 > w0 + 15) continue;
    uint32_t hi[4], lo[4];
    split(s[2 * kk][0], s[2 * kk][1], hi[0], lo[0]);
    split(s[2 * kk][2], s[2 * kk][3], hi[1], lo[1]);
    split(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[2], lo[2]);
    split(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
    for (int ep = 0; ep < kTcCols / 16; ++ep) {
      uint32_t vf[4];
      const int key = kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
      const int col = ep * 16 + ((lane >> 4) << 3);
      ldmatrix_x4_trans(vf, smem_u32(vs + key * kRow + col));
      mma(o[2 * ep], hi, vf[0], vf[1]);
      mma(o[2 * ep], lo, vf[0], vf[1]);
      mma(o[2 * ep + 1], hi, vf[2], vf[3]);
      mma(o[2 * ep + 1], lo, vf[2], vf[3]);
    }
  }
#pragma unroll
  for (int nt = 0; nt < kTcCols / 8; ++nt) {
    const int e = e0 + nt * 8 + 2 * tq;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int u = r ? u1 : u0;
      if (u >= L || e >= hd) continue;
      __nv_bfloat16* p = out + base + u * row + e;
      const float y0 = o[nt][2 * r] / den[r], y1 = o[nt][2 * r + 1] / den[r];
      if (e + 1 < hd && hd % 2 == 0) {
        *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(y0, y1);
      } else {
        p[0] = __float2bfloat16(y0);
        if (e + 1 < hd) p[1] = __float2bfloat16(y1);
      }
    }
  }
}

// -- pass 1, bf16: the states on the tensor cores ---------------------------

// A block owns a 64 x 64 tile of C; a warp 16 rows x 32 columns of it, as
// mma accumulators, for the whole walk over the chunks.
constexpr int kTcStTile = 64;
static_assert(kTcStTile == kSlice, "one row stride for every tile");
constexpr int kTcStSmem = 3 * kMaxChunk * kRow * 2 + (4 * kMaxChunk + 8) * 4;

__global__ void __launch_bounds__(kThreads)
    mlstm_state_tc_kernel(const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const float* __restrict__ log_i,
                          const float* __restrict__ log_f,
                          float* __restrict__ cst, float* __restrict__ nst,
                          float* __restrict__ mst, int64_t S, int H, int hd,
                          int L, int vec) {
  // k_t w_t in two bf16 parts and v, [t][kRow] each, then the gates
  extern __shared__ __align__(16) __nv_bfloat16 st_smem[];
  __nv_bfloat16* kwh = st_smem;
  __nv_bfloat16* kwl = kwh + kMaxChunk * kRow;
  __nv_bfloat16* vs = kwl + kMaxChunk * kRow;
  float* li_s = reinterpret_cast<float*>(vs + kMaxChunk * kRow);
  float* fc_s = li_s + kMaxChunk;
  float* mu_s = fc_s + kMaxChunk;
  float* w_s = mu_s + kMaxChunk;
  float* scan_s = w_s + kMaxChunk;  // 8

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;
  const int col_blocks = (hd + kTcStTile - 1) / kTcStTile;
  const int d0 = blockIdx.x / col_blocks * kTcStTile;
  const int e0 = blockIdx.x % col_blocks * kTcStTile;
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int64_t row = static_cast<int64_t>(H) * hd;
  const int64_t nc = S / L, bh = b * H + h;
  const int lr = (L + 15) / 16 * 16;
  const int wm = warp % 4, wn = warp / 4;  // rows 16 wm.., columns 32 wn..
  float acc[4][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  // n: in the first column block, 4 threads a row, steps t = nq mod 4
  const int nd = tid / 4, nq = tid % 4;
  float n = 0.f, m_prev = -1e30f;

  // a chunk's k and v tiles and gates, into registers: the next chunk's
  // loads are in flight while this one is multiplied
  uint4 kreg[kTileLoads], vreg[kTileLoads];
  float2 gates;
  const auto fetch = [&](int64_t ci) {
    const int64_t s0 = ci * L;
    const int64_t base = (b * S + s0) * row + static_cast<int64_t>(h) * hd;
    const int64_t gbase = (b * S + s0) * H + h;
#pragma unroll
    for (int j = 0; j < kTileLoads; ++j) {
      const int i = tid + j * kThreads;
      const int t = i / (kSlice / 8), c = i % (kSlice / 8) * 8;
      kreg[j] = load_vec(k + base, row, t, L, d0 + c, hd, vec);
      vreg[j] = load_vec(v + base, row, t, L, e0 + c, hd, vec);
    }
    gates = load_gates(log_i + gbase, log_f + gbase, H, L);
  };
  if (nc > 1) fetch(0);

  for (int64_t ci = 0; ci + 1 < nc; ++ci) {
    chunk_gates(gates, L, L, m_prev, li_s, fc_s, mu_s, scan_s);
    const float f_tot = fc_s[L - 1], m_new = mu_s[L - 1];
    const float carry = expf(f_tot + m_prev - m_new);
    for (int t = tid; t < L; t += kThreads)
      w_s[t] = expf(li_s[t] + (f_tot - fc_s[t]) - m_new);
    __syncthreads();
    // k_t w_t formed in f32, split in two bf16 parts; v as it is
#pragma unroll
    for (int j = 0; j < kTileLoads; ++j) {
      const int i = tid + j * kThreads;
      const int t = i / (kSlice / 8), c = i % (kSlice / 8) * 8;
      if (t >= lr) continue;
      const float w = t < L ? w_s[t] : 0.f;
      float kv[8];
      unpack_vec<__nv_bfloat16>(kreg[j], kv);
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        split(kv[2 * e] * w, kv[2 * e + 1] * w, hi[e], lo[e]);
      *reinterpret_cast<uint4*>(kwh + t * kRow + c) =
          make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(kwl + t * kRow + c) =
          make_uint4(lo[0], lo[1], lo[2], lo[3]);
      *reinterpret_cast<uint4*>(vs + t * kRow + c) = vreg[j];
    }
    if (ci + 2 < nc) fetch(ci + 1);
    __syncthreads();
    // C = C carry + (k w)^T v: A = (k w)^T from [t][d] by transposed loads
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nt][i] *= carry;
#pragma unroll
    for (int kk = 0; kk < kMaxChunk / 16; ++kk) {
      if (kk * 16 >= lr) break;
      const int t = kk * 16 + (lane & 7) + ((lane >> 4) << 3);
      const int d = wm * 16 + (((lane >> 3) & 1) << 3);
      uint32_t ah[4], al[4];
      ldmatrix_x4_trans(ah, smem_u32(kwh + t * kRow + d));
      ldmatrix_x4_trans(al, smem_u32(kwl + t * kRow + d));
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t vf[4];
        const int key = kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
        const int col = wn * 32 + np * 16 + ((lane >> 4) << 3);
        ldmatrix_x4_trans(vf, smem_u32(vs + key * kRow + col));
        mma(acc[2 * np], ah, vf[0], vf[1]);
        mma(acc[2 * np], al, vf[0], vf[1]);
        mma(acc[2 * np + 1], ah, vf[2], vf[3]);
        mma(acc[2 * np + 1], al, vf[2], vf[3]);
      }
    }
    // C before chunk ci + 1
    float* cout = cst + (bh * nc + ci + 1) * hd * hd;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int e = e0 + wn * 32 + nt * 8 + 2 * tq;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int d = d0 + wm * 16 + g + 8 * r;
        if (d >= hd || e >= hd) continue;
        float* p = cout + static_cast<int64_t>(d) * hd + e;
        if (e + 1 < hd && hd % 2 == 0) {
          *reinterpret_cast<float2*>(p) =
              make_float2(acc[nt][2 * r], acc[nt][2 * r + 1]);
        } else {
          p[0] = acc[nt][2 * r];
          if (e + 1 < hd) p[1] = acc[nt][2 * r + 1];
        }
      }
    }
    if (e0 == 0) {  // n = n carry + sum_t k_t w_t (the two parts in f32)
      float part = 0.f;
      for (int t = nq; t < L; t += 4)
        part += __bfloat162float(kwh[t * kRow + nd]) +
                __bfloat162float(kwl[t * kRow + nd]);
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      n = n * carry + part;
      if (nq == 0 && d0 + nd < hd) nst[(bh * nc + ci + 1) * hd + d0 + nd] = n;
    }
    if (blockIdx.x == 0 && tid == 0) mst[bh * nc + ci + 1] = m_new;
    m_prev = m_new;
    __syncthreads();  // the next chunk refills every buffer
  }
}

// -- pass 2, f32: the outputs on the CUDA cores ------------------------------

constexpr int kCols = 32;   // value columns of C a block owns
constexpr int kQkSlice = 32;  // dimensions of q/k staged at a time
// S's register tile: thread (tu, tt) of a 16 x 16 grid owns rows tu + 16 i
// and columns tt + 16 j, i, j < 8.
constexpr int kSGrid = 16;
constexpr int kSTile = kMaxChunk / kSGrid;
// the output's register tile: thread (ug, eg) of a 32 x 8 grid owns rows
// ug + 32 i, i < 4, and columns 4 eg .. 4 eg + 3.
constexpr int kURows = 32;
constexpr int kUTile = kMaxChunk / kURows;
constexpr int kEGroups = kCols / 4;

// Shared-memory layout, in floats, for a chunk of L rows (padded to Lp, a
// multiple of 4; strides padded by one against bank conflicts).
// kernels/mlstm_scan.py::smem_bytes repeats it to check a shape without the
// card.
struct Layout {
  int lp, ls;                  // padded rows, stride of a transposed slice
  int c, n, qt, kt, s, v, vec;  // offsets
  int total;
  __host__ __device__ Layout(int L, int hd) {
    lp = (L + 3) / 4 * 4;
    ls = lp + 1;
    c = 0;                          // C[hd][kCols]
    n = c + hd * kCols;             // n[hd]
    qt = n + hd;                    // q^T[kQkSlice][ls]
    kt = qt + kQkSlice * ls;        // k^T[kQkSlice][ls]
    s = kt + kQkSlice * ls;         // S[lp][ls]
    v = s + lp * ls;                // v[lp][kCols]
    v = (v + 3) / 4 * 4;            // float4 rows
    vec = v + lp * kCols;           // 5 vectors of lp, the scan's 8
    // floats: 6 lp + 4 >= 5 lp + 8 (lp >= 4)
    total = vec + 6 * lp + 4;
  }
};

__global__ void __launch_bounds__(kThreads)
    mlstm_out_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ log_i,
                     const float* __restrict__ log_f,
                     const float* __restrict__ cst,
                     const float* __restrict__ nst,
                     const float* __restrict__ mst, float* __restrict__ out,
                     int64_t S, int H, int hd, int L) {
  extern __shared__ __align__(16) float smem[];
  const Layout lay(L, hd);
  float* Cs = smem + lay.c;
  float* ns = smem + lay.n;
  float* qT = smem + lay.qt;
  float* kT = smem + lay.kt;
  float* Ss = smem + lay.s;
  float* vs = smem + lay.v;
  float* li_s = smem + lay.vec;   // log_i of the chunk
  float* fc_s = li_s + lay.lp;    // F = cumsum(log_f)
  float* mu_s = fc_s + lay.lp;    // m_u
  float* du_s = mu_s + lay.lp;    // d_u
  float* dn_s = du_s + lay.lp;    // the output's denominators
  float* scan_s = dn_s + lay.lp;  // 8 floats for the scans

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int col_blocks = (hd + kCols - 1) / kCols;
  const int64_t ci = blockIdx.x / col_blocks;
  const int e0 = static_cast<int>(blockIdx.x % col_blocks) * kCols;
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int lp = lay.lp, ls = lay.ls;
  const int64_t row = static_cast<int64_t>(H) * hd;  // elements a step
  const int64_t nc = S / L, bh = b * H + h;
  const int64_t s0 = ci * L;
  const int64_t base = (b * S + s0) * row + static_cast<int64_t>(h) * hd;
  const int64_t gbase = (b * S + s0) * H + h;
  const bool has_c = ci > 0;  // C = n = 0 before the first chunk
  const float m_prev = has_c ? mst[bh * nc + ci] : -1e30f;
  const float* cprev = cst + (bh * nc + ci) * hd * hd;
  const float* nprev = nst + (bh * nc + ci) * hd;

  for (int i = tid; i < hd * kCols; i += kThreads) {
    const int d = i / kCols, e = e0 + i % kCols;
    Cs[i] = has_c && e < hd ? cprev[static_cast<int64_t>(d) * hd + e] : 0.f;
  }
  for (int i = tid; i < hd; i += kThreads) ns[i] = has_c ? nprev[i] : 0.f;
  chunk_gates(load_gates(log_i + gbase, log_f + gbase, H, L), L, lp, m_prev,
              li_s, fc_s, mu_s, scan_s);
  // v's columns of this block
  for (int i = tid; i < lp * kCols; i += kThreads) {
    const int t = i / kCols, e = i % kCols;
    vs[i] = (t < L && e0 + e < hd)
                ? repro::to_f32(v[base + t * row + e0 + e])
                : 0.f;
  }
  for (int t = tid; t < lp; t += kThreads)
    du_s[t] = t < L ? expf(fc_s[t] + m_prev - mu_s[t]) : 0.f;

  // thread coordinates in the two register tiles
  const int tu = tid / kSGrid, tt = tid % kSGrid;
  const int ug = tid / kEGroups, eg = tid % kEGroups;
  float acc_s[kSTile][kSTile];  // q k^T
  float acc_o[kUTile][4];       // q C (this block's columns)
  float acc_n = 0.f;            // q . n, thread t < lp for row t
#pragma unroll
  for (int i = 0; i < kSTile; ++i)
#pragma unroll
    for (int j = 0; j < kSTile; ++j) acc_s[i][j] = 0.f;
#pragma unroll
  for (int i = 0; i < kUTile; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc_o[i][j] = 0.f;

  for (int d0 = 0; d0 < hd; d0 += kQkSlice) {
    // q and k, dimensions d0 .. d0 + kQkSlice, transposed
    for (int i = tid; i < lp * kQkSlice; i += kThreads) {
      const int t = i / kQkSlice, dd = i % kQkSlice;
      const bool ok = t < L && d0 + dd < hd;
      const int64_t at = base + t * row + d0 + dd;
      qT[dd * ls + t] = ok ? repro::to_f32(q[at]) : 0.f;
      kT[dd * ls + t] = ok ? repro::to_f32(k[at]) : 0.f;
    }
    __syncthreads();
    const int dn = min(kQkSlice, hd - d0);
    for (int dd = 0; dd < dn; ++dd) {
      const float* qr = qT + dd * ls;
      const float* kr = kT + dd * ls;
      float qv[kSTile], kv[kSTile];
#pragma unroll
      for (int i = 0; i < kSTile; ++i) {
        const int u = tu + kSGrid * i;
        qv[i] = u < lp ? qr[u] : 0.f;
        const int t = tt + kSGrid * i;
        kv[i] = t < lp ? kr[t] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kSTile; ++i)
#pragma unroll
        for (int j = 0; j < kSTile; ++j) acc_s[i][j] += qv[i] * kv[j];
      const float4 c4 =
          *reinterpret_cast<const float4*>(Cs + (d0 + dd) * kCols + 4 * eg);
#pragma unroll
      for (int i = 0; i < kUTile; ++i) {
        const int u = ug + kURows * i;
        const float qu = u < lp ? qr[u] : 0.f;
        acc_o[i][0] += qu * c4.x;
        acc_o[i][1] += qu * c4.y;
        acc_o[i][2] += qu * c4.z;
        acc_o[i][3] += qu * c4.w;
      }
      if (tid < lp) acc_n += qr[tid] * ns[d0 + dd];
    }
    __syncthreads();  // before the next slice overwrites q^T and k^T
  }

  // the gated scores, causal, into shared memory
#pragma unroll
  for (int i = 0; i < kSTile; ++i) {
    const int u = tu + kSGrid * i;
    if (u >= lp) continue;
#pragma unroll
    for (int j = 0; j < kSTile; ++j) {
      const int t = tt + kSGrid * j;
      if (t >= lp) continue;
      float sv = 0.f;
      if (t <= u && u < L)
        sv = acc_s[i][j] * expf(fc_s[u] - fc_s[t] + li_s[t] - mu_s[u]);
      Ss[u * ls + t] = sv;
    }
  }
  if (tid < lp) dn_s[tid] = acc_n;
  __syncthreads();
  // the denominators: a warp a row, the row sum a warp reduction
  for (int u = warp; u < L; u += kThreads / 32) {
    float norm = 0.f;
    for (int t = lane; t <= u; t += 32) norm += Ss[u * ls + t];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      norm += __shfl_xor_sync(0xffffffffu, norm, off);
    if (lane == 0)
      dn_s[u] = fmaxf(fabsf(dn_s[u] * du_s[u] + norm), expf(-mu_s[u]));
  }
  __syncthreads();
  // S v, and the output
#pragma unroll
  for (int i = 0; i < kUTile; ++i) {
    const int u = ug + kURows * i;
    if (u >= L) continue;
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
    for (int t = 0; t <= u; ++t) {
      const float sv = Ss[u * ls + t];
      const float4 v4 =
          *reinterpret_cast<const float4*>(vs + t * kCols + 4 * eg);
      a0 += sv * v4.x;
      a1 += sv * v4.y;
      a2 += sv * v4.z;
      a3 += sv * v4.w;
    }
    const float du = du_s[u], den = dn_s[u];
    const float res[4] = {(acc_o[i][0] * du + a0) / den,
                          (acc_o[i][1] * du + a1) / den,
                          (acc_o[i][2] * du + a2) / den,
                          (acc_o[i][3] * du + a3) / den};
    float* orow = out + base + u * row + e0 + 4 * eg;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (e0 + 4 * eg + j < hd) orow[j] = res[j];
  }
}

int launch_states(const void* k, const void* v, const float* li,
                  const float* lf, float* cst, float* nst, float* mst,
                  int64_t B, int64_t S, int H, int hd, int L,
                  cudaStream_t stream) {
  const int blocks = ((hd + kStRows - 1) / kStRows) *
                     ((hd + kStCols - 1) / kStCols);
  const int vec = hd % 4 == 0 && reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(v) % 16 == 0;
  mlstm_state_kernel<<<dim3(blocks, H, static_cast<unsigned>(B)), kThreads,
                       0, stream>>>(static_cast<const float*>(k),
                                    static_cast<const float*>(v), li, lf,
                                    cst, nst, mst, S, H, hd, L, vec);
  return cudaGetLastError();
}

int launch_states_tc(const void* k, const void* v, const float* li,
                     const float* lf, float* cst, float* nst, float* mst,
                     int64_t B, int64_t S, int H, int hd, int L,
                     cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        mlstm_state_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kTcStSmem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const int tiles = (hd + kTcStTile - 1) / kTcStTile;
  const int vec = hd % 8 == 0 && reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(v) % 16 == 0;
  mlstm_state_tc_kernel<<<dim3(tiles * tiles, H, static_cast<unsigned>(B)),
                          kThreads, kTcStSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), li, lf, cst, nst, mst, S, H, hd,
      L, vec);
  return cudaGetLastError();
}

int launch_out_tc(const void* q, const void* k, const void* v,
                  const float* li, const float* lf, const float* cst,
                  const float* nst, const float* mst, void* out, int64_t B,
                  int64_t S, int H, int hd, int L, cudaStream_t stream) {
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int vec = hd % 8 == 0 && aligned(q) && aligned(k) && aligned(v);
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        mlstm_out_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kTcSmem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const int64_t blocks = S / L * ((hd + kTcCols - 1) / kTcCols);
  mlstm_out_tc_kernel<<<dim3(static_cast<unsigned>(blocks), H,
                             static_cast<unsigned>(B)),
                        kThreads, kTcSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), li, lf, cst, nst, mst,
      static_cast<__nv_bfloat16*>(out), S, H, hd, L, vec);
  return cudaGetLastError();
}

int launch_out(const void* q, const void* k, const void* v, const float* li,
               const float* lf, const float* cst, const float* nst,
               const float* mst, void* out, int64_t B, int64_t S, int H,
               int hd, int L, cudaStream_t stream) {
  const size_t smem = sizeof(float) * Layout(L, hd).total;
  // Raise the shared-memory limit once, to the largest size asked (not on
  // every launch, and never inside a CUDA-graph capture after the first
  // call).
  static size_t configured = 0;
  if (smem > configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        mlstm_out_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    configured = smem;
  }
  const int64_t blocks = S / L * ((hd + kCols - 1) / kCols);
  mlstm_out_kernel<<<dim3(static_cast<unsigned>(blocks), H,
                          static_cast<unsigned>(B)),
                     kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), li, lf, cst, nst, mst,
      static_cast<float*>(out), S, H, hd, L);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, out (B, S, H, hd) of one dtype; log_i, log_f (B, S, H) f32;
// cst (B, H, S/L, hd, hd), nst (B, H, S/L, hd), mst (B, H, S/L) f32
// scratch (written by pass 1, read by pass 2; a chunk's slot holds the
// state before it, slot 0 is never touched); all contiguous; 1 <= L <= 128
// and S a multiple of L (the wrapper checks).  `passes`: 1 the states, 2
// the outputs, 3 both in order.
extern "C" int repro_mlstm_chunkwise_fwd(
    int dtype, const void* q, const void* k, const void* v,
    const void* log_i, const void* log_f, void* out, void* cst, void* nst,
    void* mst, int64_t B, int64_t S, int64_t H, int64_t hd, int64_t L,
    int passes, void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || H > 65535 || hd <= 0 || L <= 0 ||
      L > kMaxChunk || S <= 0 || S % L || passes < 1 || passes > 3 ||
      S / L * ((hd + kCols - 1) / kCols) > 0x7fffffff)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* li = static_cast<const float*>(log_i);
  const float* lf = static_cast<const float*>(log_f);
  float* c = static_cast<float*>(cst);
  float* n = static_cast<float*>(nst);
  float* m = static_cast<float*>(mst);
  const int h = static_cast<int>(H), d = static_cast<int>(hd);
  const int l = static_cast<int>(L);
  int e = 0;
  if (dtype == repro::kFloat32) {
    if (passes & 1)
      e = launch_states(k, v, li, lf, c, n, m, B, S, h, d, l, s);
    if (!e && (passes & 2))
      e = launch_out(q, k, v, li, lf, c, n, m, out, B, S, h, d, l, s);
    return e;
  }
  if (dtype == repro::kBFloat16) {
    if (passes & 1)
      e = launch_states_tc(k, v, li, lf, c, n, m, B, S, h, d, l, s);
    if (!e && (passes & 2))
      e = launch_out_tc(q, k, v, li, lf, c, n, m, out, B, S, h, d, l, s);
    return e;
  }
  return cudaErrorInvalidValue;
}
