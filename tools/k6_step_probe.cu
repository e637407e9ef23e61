// Where a step of the first design of the sLSTM scan (K6) went: that
// kernel's step (src/repro_torch/csrc/slstm_scan.cu before its redesign:
// one block an SM owning U units, r's columns in f32 shared memory, a warp
// a gate column, c/n/m in device memory, one cooperative grid barrier a
// step) with parts of it switched off, timed at xlstm-125m's B 4, S 1024,
// D 768.  Built and run by tools/k6_step.py; it needs nothing else.
//
// MODE 0 the step; 1 grid.sync only; 2 grid.sync + the h fetch; 3 the step
// without its barrier; 4 a one-way exchange (release add on a counter,
// acquire poll) only; 5 the exchange + a 16-byte h fetch; 6 the exchange +
// a scalar h fetch; 7 the step without its store of `out`; 8 the step with
// `out` stored as 4-byte words.  A mode that skips work computes nothing
// right: it times, it does not check.
#include <cooperative_groups.h>
#include <cuda_bf16.h>

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <vector>

namespace cg = cooperative_groups;
constexpr int kThreads = 256, kWarps = 8, kBatchTile = 8;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}
__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}
__device__ __forceinline__ void red_release(unsigned* p) {
  asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(p)
               : "memory");
}

template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads)
    step(const T* __restrict__ xg, const T* __restrict__ r,
         T* __restrict__ out, float* __restrict__ hbuf,
         float* __restrict__ state, unsigned* counter, int B, int64_t S,
         int D, int U) {
  extern __shared__ __align__(16) float smem[];
  float* rs = smem;
  float* hs = rs + static_cast<int64_t>(4) * U * D;
  float* gs = hs + static_cast<int64_t>(kBatchTile) * D;
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int j0 = blockIdx.x * U, units = min(U, D - j0);
  const int64_t D4 = 4 * static_cast<int64_t>(D);
  const int64_t BD = static_cast<int64_t>(B) * D;
  float *cst = state, *nst = state + BD, *mst = state + 2 * BD;
  for (int64_t i = tid; i < static_cast<int64_t>(4) * U * D; i += kThreads) {
    const int c = static_cast<int>(i / D), k = static_cast<int>(i % D);
    const int g = c / U, u = c % U;
    rs[i] = u < units ? to_f32(r[k * D4 + g * D + j0 + u]) : 0.f;
  }
  for (int p = tid; p < B * units; p += kThreads) {
    const int64_t at = static_cast<int64_t>(p / units) * D + j0 + p % units;
    cst[at] = 0.f;
    nst[at] = 0.f;
    mst[at] = -1e30f;
  }
  __syncthreads();
  float sink = 0.f;
  for (int64_t t = 0; t < S; ++t) {
    const float* hprev = hbuf + (t & 1) * BD;
    float* hnext = hbuf + ((t + 1) & 1) * BD;
    if (MODE == 1) {
      grid.sync();
      continue;
    }
    if (MODE == 2) {
      for (int i = tid; i < B * D; i += kThreads) hs[i] = __ldcg(hprev + i);
      __syncthreads();
      sink += hs[(tid * 7) % (B * D)];
      __syncthreads();
      grid.sync();
      continue;
    }
    if (MODE >= 4 && MODE <= 6) {
      if (t > 0) {
        if (tid == 0)
          while (ld_acquire(counter) < gridDim.x * static_cast<unsigned>(t)) {
          }
        __syncthreads();
      }
      if (MODE == 5) {
        const float4* h4 = reinterpret_cast<const float4*>(hprev);
        float4* s4 = reinterpret_cast<float4*>(hs);
        for (int i = tid; i < B * D / 4; i += kThreads) s4[i] = __ldcg(h4 + i);
        __syncthreads();
        sink += hs[(tid * 7) % (B * D)];
      } else if (MODE == 6) {
        for (int i = tid; i < B * D; i += kThreads) hs[i] = __ldcg(hprev + i);
        __syncthreads();
        sink += hs[(tid * 7) % (B * D)];
      }
      if (tid < B * units) hnext[(tid / units) * D + j0 + tid % units] = sink;
      __syncthreads();
      if (tid == 0) red_release(counter);
      continue;
    }
    for (int b0 = 0; b0 < B; b0 += kBatchTile) {
      const int nb = min(kBatchTile, B - b0);
      const bool owner = tid < nb * units;
      const int bb = owner ? tid / units : 0, u = owner ? tid % units : 0;
      const int64_t b = b0 + bb, at = b * D + j0 + u;
      float x4[4] = {0.f, 0.f, 0.f, 0.f}, c = 0.f, n = 0.f, m = 0.f;
      if (owner) {
        const T* x = xg + (b * S + t) * D4 + j0 + u;
#pragma unroll
        for (int g = 0; g < 4; ++g) x4[g] = to_f32(x[g * D]);
        c = cst[at];
        n = nst[at];
        m = mst[at];
      }
      for (int i = tid; i < nb * D; i += kThreads)
        hs[i] = __ldcg(hprev + static_cast<int64_t>(b0) * D + i);
      __syncthreads();
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
        for (int i = 0; i < kBatchTile; ++i)
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], off);
        if (lane == 0) {
#pragma unroll
          for (int i = 0; i < kBatchTile; ++i)
            if (i < nb) gs[i * 4 * U + col] = acc[i];
        }
      }
      __syncthreads();
      if (owner) {
        const float* g = gs + bb * 4 * U;
        const float gi = x4[0] + g[u], gf = x4[1] + g[U + u];
        const float gz = x4[2] + g[2 * U + u], go = x4[3] + g[3 * U + u];
        const float lf = log_sigmoid(gf), m_new = fmaxf(lf + m, gi);
        const float i_w = expf(gi - m_new), f_w = expf(lf + m - m_new);
        const float c_new = f_w * c + i_w * tanhf(gz), n_new = f_w * n + i_w;
        const float h =
            (1.f / (1.f + expf(-go))) * c_new / fmaxf(n_new, 1.f);
        cst[at] = c_new;
        nst[at] = n_new;
        mst[at] = m_new;
        hnext[at] = h;
        if (MODE == 0 || MODE == 3)
          out[(b * S + t) * D + j0 + u] = from_f32<T>(h);
        if (MODE == 8)  // two units a word, at the bf16 output's addresses
          reinterpret_cast<float*>(out)[((b * S + t) * D + j0 + u) / 2] = h;
      }
      __syncthreads();
    }
    if (MODE != 3) grid.sync();
  }
  if (sink == 12345.f) out[0] = from_f32<T>(sink);
}

template <typename T, int MODE>
void run(int B, int S, int D, int sms, const char* name) {
  int U = (D + sms - 1) / sms;
  const int blocks = (D + U - 1) / U;
  const size_t smem = sizeof(float) * (static_cast<int64_t>(4) * U * D +
                                       kBatchTile * D + kBatchTile * 4 * U);
  T *xg, *r, *out;
  float *hbuf, *state;
  unsigned* counter;
  cudaMalloc(&xg, sizeof(T) * static_cast<size_t>(B) * S * 4 * D);
  cudaMalloc(&r, sizeof(T) * static_cast<size_t>(D) * 4 * D);
  cudaMalloc(&out, sizeof(T) * static_cast<size_t>(B) * S * D);
  cudaMalloc(&hbuf, sizeof(float) * 2 * B * D);
  cudaMalloc(&state, sizeof(float) * 3 * B * D);
  cudaMalloc(&counter, 4);
  cudaMemset(xg, 0, sizeof(T) * static_cast<size_t>(B) * S * 4 * D);
  cudaMemset(r, 0, sizeof(T) * static_cast<size_t>(D) * 4 * D);
  cudaFuncSetAttribute(step<T, MODE>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  int64_t S64 = S;
  void* args[] = {&xg, &r, &out, &hbuf, &state, &counter, &B, &S64, &D, &U};
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  std::vector<float> ms;
  for (int rep = 0; rep < 8; ++rep) {
    cudaMemset(hbuf, 0, sizeof(float) * 2 * B * D);
    cudaMemset(counter, 0, 4);
    cudaEventRecord(a);
    const cudaError_t e = cudaLaunchCooperativeKernel(
        reinterpret_cast<void*>(step<T, MODE>), dim3(blocks), dim3(kThreads),
        args, smem, 0);
    cudaEventRecord(b);
    cudaEventSynchronize(b);
    if (e != cudaSuccess || cudaGetLastError() != cudaSuccess) {
      std::printf("%s: launch failed (%d)\n", name, static_cast<int>(e));
      return;
    }
    float t;
    cudaEventElapsedTime(&t, a, b);
    if (rep >= 2) ms.push_back(t);
  }
  std::sort(ms.begin(), ms.end());
  const float med = ms[ms.size() / 2];
  std::printf("first design, %-40s %.4f ms, %.3f us a step\n", name, med,
              med * 1e3f / S);
  cudaFree(xg);
  cudaFree(r);
  cudaFree(out);
  cudaFree(hbuf);
  cudaFree(state);
  cudaFree(counter);
}

int main() {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  const int B = 4, S = 1024, D = 768;
  using bf16 = __nv_bfloat16;
  run<float, 0>(B, S, D, sms, "f32 step");
  run<bf16, 0>(B, S, D, sms, "bf16 step");
  run<float, 1>(B, S, D, sms, "grid.sync only");
  run<float, 2>(B, S, D, sms, "grid.sync + h fetch");
  run<float, 3>(B, S, D, sms, "f32 step, no barrier");
  run<bf16, 3>(B, S, D, sms, "bf16 step, no barrier");
  run<float, 4>(B, S, D, sms, "one-way exchange only");
  run<float, 5>(B, S, D, sms, "exchange + 16-byte h fetch");
  run<float, 6>(B, S, D, sms, "exchange + scalar h fetch");
  run<float, 7>(B, S, D, sms, "f32 step, no out store");
  run<bf16, 7>(B, S, D, sms, "bf16 step, no out store");
  run<bf16, 8>(B, S, D, sms, "bf16 step, out as 4-byte words");
  return 0;
}
