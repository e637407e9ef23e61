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
// VMEM scratch between chunk steps.  Blocks on the H100 run in no order, so
// here one block walks all the chunks of its (b, h) in a loop.  C's value
// columns are independent, so a (b, h) is split over ceil(hd / kCols)
// blocks, each owning kCols columns of C and of the output: at hd 192 that
// is 24 KB of C in shared memory instead of 147 KB, and 6 blocks per
// (b, h) (96 at the model's B 4, H 4) instead of one.  Each block computes
// the chunk's full score matrix S (it needs all of q and k) and its own
// copy of n and m.  q and k pass through shared memory transposed, in
// slices of kSlice dimensions; within one slice the block reads its rows of
// C for the output and then updates them, so the old C is read before it is
// written and q/k are read once a chunk.  Everything is f32 on the CUDA
// cores: simple and right first (tensor cores are later work).
//
// Bound on the H100: operations.  A chunk of L steps takes 2 L^2 hd (q k^T)
// + 2 L^2 hd (S v) + 2 L hd^2 (q C) + 2 L hd^2 (the update of C) operations
// over the peak rate for the inputs' type (989 TFLOP/s bf16, 67 f32).  The
// bytes (q, k, v, out, gates once) over 3.35 TB/s weigh more in bf16.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 32;      // value columns of C a block owns
constexpr int kSlice = 32;     // dimensions of q/k staged at a time
constexpr int kMaxChunk = 128; // L; the register tiles below cover it
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
    qt = n + hd;                    // q^T[kSlice][ls]
    kt = qt + kSlice * ls;          // k^T[kSlice][ls]
    s = kt + kSlice * ls;           // S[lp][ls]
    v = s + lp * ls;                // v[lp][kCols]
    v = (v + 3) / 4 * 4;            // float4 rows
    vec = v + lp * kCols;           // 6 vectors of lp, then m
    total = vec + 6 * lp + 4;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    mlstm_chunkwise_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v,
                           const float* __restrict__ log_i,
                           const float* __restrict__ log_f,
                           T* __restrict__ out, int64_t S, int H, int hd,
                           int L) {
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
  float* w_s = mu_s + lay.lp;     // the update's weights w_t
  float* du_s = w_s + lay.lp;     // d_u
  float* dn_s = du_s + lay.lp;    // the output's denominators
  float* m_s = dn_s + lay.lp;     // m_prev, then the chunk's carry decay

  const int tid = threadIdx.x;
  const int e0 = blockIdx.x * kCols;
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int lp = lay.lp, ls = lay.ls;
  const int64_t row = static_cast<int64_t>(H) * hd;  // elements a step

  for (int i = tid; i < hd * kCols; i += kThreads) Cs[i] = 0.f;
  for (int i = tid; i < hd; i += kThreads) ns[i] = 0.f;
  if (tid == 0) m_s[0] = -1e30f;

  // thread coordinates in the two register tiles
  const int tu = tid / kSGrid, tt = tid % kSGrid;
  const int ug = tid / kEGroups, eg = tid % kEGroups;

  for (int64_t s0 = 0; s0 < S; s0 += L) {
    const int64_t base = (b * S + s0) * row + static_cast<int64_t>(h) * hd;
    const int64_t gbase = (b * S + s0) * H + h;
    __syncthreads();  // the previous chunk is done with every buffer
    for (int t = tid; t < lp; t += kThreads) {
      const bool ok = t < L;
      li_s[t] = ok ? log_i[gbase + static_cast<int64_t>(t) * H] : 0.f;
      fc_s[t] = ok ? log_f[gbase + static_cast<int64_t>(t) * H] : 0.f;
    }
    __syncthreads();
    // F (in place of log_f), the running max and m_u, in order, by one
    // thread: L <= 128 steps on shared memory
    if (tid == 0) {
      const float m_prev = m_s[0];
      float f = 0.f, run = -INFINITY;
      for (int t = 0; t < L; ++t) {
        f += fc_s[t];
        fc_s[t] = f;
        run = fmaxf(run, li_s[t] - f);
        mu_s[t] = fmaxf(m_prev, run) + f;
      }
      m_s[1] = expf(f + m_prev - mu_s[L - 1]);  // the carry decay
    }
    // v's columns of this block
    for (int i = tid; i < lp * kCols; i += kThreads) {
      const int t = i / kCols, e = i % kCols;
      vs[i] = (t < L && e0 + e < hd)
                  ? repro::to_f32(v[base + t * row + e0 + e])
                  : 0.f;
    }
    __syncthreads();
    const float m_prev = m_s[0], carry = m_s[1];
    const float f_tot = fc_s[L - 1], m_new = mu_s[L - 1];
    for (int t = tid; t < lp; t += kThreads) {
      w_s[t] = t < L ? expf(li_s[t] + (f_tot - fc_s[t]) - m_new) : 0.f;
      du_s[t] = t < L ? expf(fc_s[t] + m_prev - mu_s[t]) : 0.f;
    }

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

    for (int d0 = 0; d0 < hd; d0 += kSlice) {
      // q and k, dimensions d0 .. d0 + kSlice, transposed
      for (int i = tid; i < lp * kSlice; i += kThreads) {
        const int t = i / kSlice, dd = i % kSlice;
        const bool ok = t < L && d0 + dd < hd;
        const int64_t at = base + t * row + d0 + dd;
        qT[dd * ls + t] = ok ? repro::to_f32(q[at]) : 0.f;
        kT[dd * ls + t] = ok ? repro::to_f32(k[at]) : 0.f;
      }
      __syncthreads();
      const int dn = min(kSlice, hd - d0);
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
      __syncthreads();  // rows d0.. of C and n are read: now update them
      for (int i = tid; i < dn * kCols; i += kThreads) {
        const int dd = i / kCols, e = i % kCols;
        const float* kr = kT + dd * ls;
        float acc = 0.f;
        for (int t = 0; t < L; ++t) acc += (kr[t] * w_s[t]) * vs[t * kCols + e];
        float& c = Cs[(d0 + dd) * kCols + e];
        c = c * carry + acc;
      }
      for (int dd = tid; dd < dn; dd += kThreads) {
        const float* kr = kT + dd * ls;
        float acc = 0.f;
        for (int t = 0; t < L; ++t) acc += kr[t] * w_s[t];
        ns[d0 + dd] = ns[d0 + dd] * carry + acc;
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
    __syncthreads();
    if (tid < L) {
      float norm = 0.f;
      for (int t = 0; t <= tid; ++t) norm += Ss[tid * ls + t];
      dn_s[tid] = fmaxf(fabsf(acc_n * du_s[tid] + norm), expf(-mu_s[tid]));
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
      T* orow = out + base + u * row + e0 + 4 * eg;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (e0 + 4 * eg + j < hd) orow[j] = repro::from_f32<T>(res[j]);
    }
    if (tid == 0) m_s[0] = m_new;
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const float* li,
           const float* lf, void* out, int64_t B, int64_t S, int H, int hd,
           int L, cudaStream_t stream) {
  const size_t smem = sizeof(float) * Layout(L, hd).total;
  // Raise the shared-memory limit once per instantiation (not on every
  // launch, and never inside a CUDA-graph capture after the first call).
  static size_t configured = 0;
  if (smem > configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        mlstm_chunkwise_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    configured = smem;
  }
  const dim3 grid(static_cast<unsigned>((hd + kCols - 1) / kCols),
                  static_cast<unsigned>(H), static_cast<unsigned>(B));
  mlstm_chunkwise_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), li, lf, static_cast<T*>(out), S, H, hd, L);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, out (B, S, H, hd) of one dtype; log_i, log_f (B, S, H) f32; all
// contiguous; 1 <= L <= 128 and S a multiple of L (the wrapper checks).
extern "C" int repro_mlstm_chunkwise_fwd(int dtype, const void* q,
                                         const void* k, const void* v,
                                         const void* log_i,
                                         const void* log_f, void* out,
                                         int64_t B, int64_t S, int64_t H,
                                         int64_t hd, int64_t L,
                                         void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || H > 65535 || hd <= 0 || L <= 0 ||
      L > kMaxChunk || S <= 0 || S % L)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* li = static_cast<const float*>(log_i);
  const float* lf = static_cast<const float*>(log_f);
  const int h = static_cast<int>(H), d = static_cast<int>(hd);
  const int l = static_cast<int>(L);
  if (dtype == repro::kFloat32)
    return launch<float>(q, k, v, li, lf, out, B, S, h, d, l, s);
  if (dtype == repro::kBFloat16)
    return launch<__nv_bfloat16>(q, k, v, li, lf, out, B, S, h, d, l, s);
  return cudaErrorInvalidValue;
}
