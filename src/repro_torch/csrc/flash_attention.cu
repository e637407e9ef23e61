// Flash attention (forward, causal / sliding-window, GQA) for Hopper (sm_90a):
// the f32 body, on the CUDA cores.  bf16 inputs take the tensor-core body of
// flash_attention_tc.cu; TF32 would break this body's f32 bar (2e-5).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (_flash_kernel): online softmax with f32 (m, l, acc),
// -1e30 masking, l clamped at 1e-30, scale 1/sqrt(hd), q-head h reading KV
// head h // (H / Kv) with no repeated KV in memory.
//
// The TPU grid (b, h, n_q, n_kv) carried (m, l, acc) in VMEM across the
// sequential key axis.  Blocks on the H100 run in no order, so here one
// block owns one (b, h, q-block), loops over its key tiles itself, stages
// each K/V tile in shared memory and keeps m, l and the accumulator of its
// query row in registers: one thread per query row.
// The band of keys is computed from positions, not block indices:
// keys max(0, q_start - window + 1) .. q_end - 1 (causal), so any
// block_q / block_k pair is right and a ragged S is masked, not refused.
//
// Bound on the H100: operations, 4*B*H*hd*pairs (QK^T and PV over the
// (query, key) pairs inside the band; 2*B*H*S^2*hd for a causal band) over
// 67 TFLOP/s, the f32 rate outside the tensor cores, where its dot products
// run.  What it keeps from the TPU design is the point of flash attention:
// the S x S scores never reach device memory.
#include "common.cuh"

namespace {

constexpr int kChunk = 16;       // keys scored together per online update
constexpr float kNegInf = -1e30f;

template <int HD>
__global__ void flash_attention_kernel(const float* __restrict__ q,
                                       const float* __restrict__ k,
                                       const float* __restrict__ v,
                                       float* __restrict__ o, int64_t S,
                                       int64_t H, int64_t Kv, int block_k,
                                       int causal, int64_t window,
                                       float scale) {
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                 // [block_k][HD]
  float* vs = smem + block_k * HD;  // [block_k][HD]

  const int64_t b = blockIdx.z;
  const int64_t h = blockIdx.y;
  const int64_t kvh = h / (H / Kv);  // GQA: h // groups, not h % Kv
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * blockDim.x;
  const int64_t qpos = q0 + threadIdx.x;
  const bool row_ok = qpos < S;

  // Keys any row of this block can see.
  const int64_t q_last = min(q0 + static_cast<int64_t>(blockDim.x), S) - 1;
  const int64_t k_lo = window > 0 ? max(static_cast<int64_t>(0),
                                        q0 - window + 1) : 0;
  const int64_t k_hi = causal ? q_last + 1 : S;  // exclusive

  float qr[HD], acc[HD];
  if (row_ok) {
    const float* qp = q + ((b * S + qpos) * H + h) * HD;
#pragma unroll
    for (int d = 0; d < HD; ++d) qr[d] = qp[d];
  } else {
#pragma unroll
    for (int d = 0; d < HD; ++d) qr[d] = 0.f;
  }
#pragma unroll
  for (int d = 0; d < HD; ++d) acc[d] = 0.f;
  float m = kNegInf, l = 0.f;

  const int64_t kv_stride = Kv * HD;  // between consecutive keys
  const float* kb = k + (b * S * Kv + kvh) * HD;
  const float* vb = v + (b * S * Kv + kvh) * HD;

  for (int64_t t0 = k_lo; t0 < k_hi; t0 += block_k) {
    const int n = static_cast<int>(min(static_cast<int64_t>(block_k),
                                       k_hi - t0));
    __syncthreads();  // the previous tile is consumed
    for (int64_t idx = threadIdx.x; idx < static_cast<int64_t>(n) * HD;
         idx += blockDim.x) {
      const int64_t j = idx / HD, d = idx % HD;
      ks[idx] = kb[(t0 + j) * kv_stride + d];
      vs[idx] = vb[(t0 + j) * kv_stride + d];
    }
    __syncthreads();
    if (!row_ok) continue;  // every thread still reaches both barriers

    for (int c0 = 0; c0 < n; c0 += kChunk) {
      float s[kChunk];
      unsigned valid = 0;
      float m_new = m;  // computed before any exp, so no exp(-1e30 - -1e30)
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const int j = c0 + c;
        const int64_t kpos = t0 + j;
        const bool ok = j < n && (!causal || kpos <= qpos) &&
                        (window <= 0 || kpos > qpos - window);
        float dot = 0.f;
        if (ok) {
          const float* kr = ks + j * HD;
#pragma unroll
          for (int d = 0; d < HD; ++d) dot += qr[d] * kr[d];
          valid |= 1u << c;
        }
        s[c] = ok ? dot * scale : kNegInf;
        m_new = fmaxf(m_new, s[c]);
      }
      if (valid == 0) continue;  // a fully masked chunk adds nothing
      const float corr = expf(m - m_new);
      l *= corr;
#pragma unroll
      for (int d = 0; d < HD; ++d) acc[d] *= corr;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        if (!((valid >> c) & 1u)) continue;
        const float p = expf(s[c] - m_new);
        l += p;
        const float* vr = vs + (c0 + c) * HD;
#pragma unroll
        for (int d = 0; d < HD; ++d) acc[d] += p * vr[d];
      }
      m = m_new;
    }
  }

  if (row_ok) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    float* op = o + ((b * S + qpos) * H + h) * HD;
#pragma unroll
    for (int d = 0; d < HD; ++d) op[d] = acc[d] * inv;
  }
}

template <int HD>
int launch(const float* q, const float* k, const float* v, float* o,
           int64_t B, int64_t S, int64_t H, int64_t Kv, int64_t block_q,
           int64_t block_k, int64_t causal, int64_t window, float scale,
           cudaStream_t stream) {
  const size_t smem = 2 * block_k * HD * sizeof(float);
  // Raise the shared-memory limit once per instantiation (not on every
  // launch, and never inside a CUDA-graph capture after the first call).
  static size_t configured = 0;
  if (smem > configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention_kernel<HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    configured = smem;
  }
  const dim3 grid(static_cast<unsigned>((S + block_q - 1) / block_q),
                  static_cast<unsigned>(H), static_cast<unsigned>(B));
  flash_attention_kernel<HD><<<grid, static_cast<unsigned>(block_q), smem,
                               stream>>>(
      q, k, v, o, S, H, Kv, static_cast<int>(block_k),
      static_cast<int>(causal), window, scale);
  return cudaGetLastError();
}

}  // namespace

// f32 q (B, S, H, hd), k/v (B, S, Kv, hd), out (B, S, H, hd), contiguous.
// window <= 0 means no sliding window.  `scale` multiplies the scores:
// 1/sqrt(head_dim) of the model, which is not the template's HD when the
// wrapper zero-pads the head dim (hd 120 runs as HD 128).
extern "C" int repro_flash_attention_fwd(const void* q, const void* k,
                                         const void* v, void* o, int64_t B,
                                         int64_t S, int64_t H, int64_t Kv,
                                         int64_t hd, int64_t block_q,
                                         int64_t block_k, int64_t causal,
                                         int64_t window, float scale,
                                         void* stream) {
  if (B <= 0 || S <= 0 || Kv <= 0 || H % Kv != 0 || block_q <= 0 ||
      block_q > 1024 || block_k <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(o);
  switch (hd) {
    case 16:
      return launch<16>(qf, kf, vf, of, B, S, H, Kv, block_q, block_k,
                        causal, window, scale, s);
    case 32:
      return launch<32>(qf, kf, vf, of, B, S, H, Kv, block_q, block_k,
                        causal, window, scale, s);
    case 64:
      return launch<64>(qf, kf, vf, of, B, S, H, Kv, block_q, block_k,
                        causal, window, scale, s);
    case 128:
      return launch<128>(qf, kf, vf, of, B, S, H, Kv, block_q, block_k,
                         causal, window, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}
