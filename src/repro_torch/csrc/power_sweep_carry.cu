// Carry-resident fold-in sweep, serving mode, for Hopper (sm_90a).
//
// Replaces, in serving mode (update_phi=False), the two TPU kernels of the
// JAX package: src/repro/kernels/power_sweep/kernel.py:363
// (power_sweep_carry_tokens) and :523 (power_sweep_carry_kblocked_tokens).
// Both compute one Jacobi fold-in sweep over the token-major [T, K] message
// carry with phi fixed:
//
//   active token t (p_tok[t] names a phi row, not the guard id):
//     u_k    = (theta[d,k] - c*mu[t,k] + alpha) * (phi[p,k] + beta)
//              / (phi_tot[k] + wbeta)
//     mu'_k  = u_k * (sum_k mu[t,k]) / max(sum_k u_k, 1e-30)
//     cd_k   = c * (mu'_k - mu[t,k])
//   theta_delta[d,k] = sum over the doc's tokens of cd_k
//   rdoc[d]          = sum over the doc's tokens and k of |cd_k|
//   frozen token (p_tok == n_guard, or an id outside [0, n_rows)):
//     mu untouched, no phi row read, contributes nothing.
//
// The sweep is Jacobi: every token reads theta as it was at the start of the
// sweep; theta itself is updated by the caller (theta += theta_delta).
//
// Design.  The TPU kernels keep the row table in VMEM and gather rows with
// one-hot MXU contractions (K-blocked once the full-vocabulary table no
// longer fits).  Here the [W', K] phi table stays in HBM and each token
// reads its own row by index, so there is no full-K versus K-blocked choice.
// One CTA per document (tokens are doc-contiguous, doc_ids non-decreasing):
// theta[d] and phi_tot + wbeta sit in shared memory, read-only; each warp
// walks every nw-th token of the document, reduces sum(u) and sum(mu) with
// warp shuffles, then writes mu' in place and accumulates c*(mu'-mu) into
// its own [K] row of shared memory.  The warps' rows and residuals are
// summed in a fixed order at the end: no atomics, so the result is
// deterministic.  mu is updated IN PLACE (each element is read and written
// by one lane only).
//
// Bound.  At the slice's shapes (T = 4096 tokens, D = 64 docs, K = 2000,
// W' = 141044 rows) one sweep must read mu and one phi row per active token
// and write mu back: about 3 * 4096 * 2000 * 4 B = 98 MB, i.e. ~29 us at
// 3.35 TB/s; the arithmetic (~10 flops per element, f32) is ~1 us at
// 67 TFLOP/s, so the kernel is memory-bound.  Each warp reads its token's mu
// and phi rows twice (the second pass is meant to hit L1).
//
// Known limit, recorded and not fixed here: a 64-slot slab launches only 64
// CTAs on the card's 132 SMs.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;

__device__ __forceinline__ float warp_sum(float v) {
  // xor butterfly: a fixed order, every lane ends with the same sum
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// first index i in [0, n) with a[i] >= v (n when none)
__device__ __forceinline__ int lower_bound(const int* __restrict__ a, int n, int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(a + mid) < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ float update_u(float th, float pt, float m, float c,
                                          float ph, float alpha, float beta) {
  return (th - c * m + alpha) * (ph + beta) / pt;
}

__global__ void carry_sweep_serve_kernel(
    const int* __restrict__ p_tok, const int* __restrict__ doc_ids,
    const float* __restrict__ counts, float* mu,
    const float* __restrict__ theta, const float* __restrict__ phi_tot,
    const float* __restrict__ phi_rows, float* __restrict__ theta_delta,
    float* __restrict__ rdoc, int T, int K, int n_rows, int n_guard,
    float alpha, float beta, float wbeta) {
  extern __shared__ float smem[];
  __shared__ float r_warp[32];
  const int nw = blockDim.x / kWarp;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int d = blockIdx.x;
  float* th_s = smem;                         // [K] theta[d]
  float* pt_s = smem + K;                     // [K] phi_tot + wbeta
  float* acc = smem + (size_t)(2 + warp) * K; // [K] this warp's theta delta

  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    th_s[k] = theta[(size_t)d * K + k];
    pt_s[k] = phi_tot[k] + wbeta;
  }
  for (int i = threadIdx.x; i < nw * K; i += blockDim.x) smem[2 * K + i] = 0.f;
  const int t0 = lower_bound(doc_ids, T, d);
  const int t1 = lower_bound(doc_ids, T, d + 1);
  __syncthreads();

  float r = 0.f;
  for (int t = t0 + warp; t < t1; t += nw) {
    const int p = p_tok[t];
    if (p == n_guard || p < 0 || p >= n_rows) continue;
    const float c = counts[t];
    float* mu_t = mu + (size_t)t * K;
    const float* ph = phi_rows + (size_t)p * K;
    float su = 0.f, sm = 0.f;
#pragma unroll 4
    for (int k = lane; k < K; k += kWarp) {
      const float m = mu_t[k];
      su += update_u(th_s[k], pt_s[k], m, c, __ldg(ph + k), alpha, beta);
      sm += m;
    }
    su = warp_sum(su);
    sm = warp_sum(sm);
    const float scale = sm / fmaxf(su, 1e-30f);
#pragma unroll 4
    for (int k = lane; k < K; k += kWarp) {
      const float m = mu_t[k];
      const float mn = update_u(th_s[k], pt_s[k], m, c, __ldg(ph + k), alpha, beta) * scale;
      const float cd = c * (mn - m);
      mu_t[k] = mn;
      acc[k] += cd;
      r += fabsf(cd);
    }
  }
  r = warp_sum(r);
  if (lane == 0) r_warp[warp] = r;
  __syncthreads();

  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    float s = 0.f;
    for (int w = 0; w < nw; ++w) s += smem[(size_t)(2 + w) * K + k];
    theta_delta[(size_t)d * K + k] = s;
  }
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int w = 0; w < nw; ++w) s += r_warp[w];
    rdoc[d] = s;
  }
}

}  // namespace

extern "C" {

// Lets the kernel use, on the current device, all the dynamic shared memory
// a block may opt in to beside the kernel's static shared memory, and
// stores that many bytes in *smem_bytes.  Called once per device, before the
// first launch there.  Returns the CUDA error code (0 on success).
int power_sweep_carry_configure(int* smem_bytes) {
  int device = 0, optin = 0;
  cudaFuncAttributes attr;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, carry_sweep_serve_kernel);
  if (err != cudaSuccess) return (int)err;
  *smem_bytes = optin - (int)attr.sharedSizeBytes;
  return (int)cudaFuncSetAttribute(
      carry_sweep_serve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem_bytes);
}

// Launches one sweep on `stream`; allocates nothing.  `warps` must leave
// (2 + warps) * K floats within what power_sweep_carry_configure allowed.
// Returns the CUDA error code of the launch (0 on success).
int power_sweep_carry_serve(const int* p_tok, const int* doc_ids,
                            const float* counts, float* mu, const float* theta,
                            const float* phi_tot, const float* phi_rows,
                            float* theta_delta, float* rdoc, int T, int D,
                            int K, int n_rows, int n_guard, float alpha,
                            float beta, float wbeta, int warps, void* stream) {
  const int smem = (2 + warps) * K * (int)sizeof(float);
  if (D > 0) {
    carry_sweep_serve_kernel<<<D, warps * kWarp, smem, (cudaStream_t)stream>>>(
        p_tok, doc_ids, counts, mu, theta, phi_tot, phi_rows, theta_delta, rdoc,
        T, K, n_rows, n_guard, alpha, beta, wbeta);
  }
  return (int)cudaGetLastError();
}

const char* power_sweep_carry_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
