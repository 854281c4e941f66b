// Carry-resident selective sweep, serving and training modes, for Hopper
// (sm_90a).
//
// Replaces the two TPU kernels of the JAX package
// src/repro/kernels/power_sweep/kernel.py:363 (power_sweep_carry_tokens) and
// :523 (power_sweep_carry_kblocked_tokens), in both of their modes.  Each
// computes one Jacobi sweep over the token-major [T, K] message carry:
//
//   active token t (p = p_tok[t] names a row of phi_rows, not the guard id
//   n_guard), count c, document d:
//     serving (update_phi=False), phi fixed, every topic updated:
//       u_k   = (theta[d,k] - c*mu[t,k] + alpha) * (phi[p,k] + beta)
//               / (phi_tot[k] + wbeta)
//     training (update_phi=True), only where mask_rows[p,k] > 0 (the token's
//     power topics), the token's own count left out of phi and phi_tot:
//       u_k   = (theta[d,k] - c*mu[t,k] + alpha) * (phi[p,k] - c*mu[t,k] + beta)
//               / (phi_tot[k] - c*mu[t,k] + wbeta) * mask[p,k]
//     mu'_k  = u_k * (sum_k mu[t,k] mask) / max(sum_k u_k, 1e-30)   (masked k)
//     cd_k   = c * (mu'_k - mu[t,k])
//   theta_delta[d,k] = sum over the doc's tokens of cd_k
//   serving:  rdoc[d] = sum over the doc's tokens and k of |cd_k|
//   training: d_rows[p,k] += cd_k and r_rows[p,k] += |cd_k| (p < n_guard)
//   frozen token (p_tok == n_guard, or an id outside [0, n_rows)):
//     mu untouched, no row read, contributes nothing.
//
// The sweep is Jacobi: every token reads theta as it was at the start of the
// sweep; theta itself is updated by the caller (theta += theta_delta).
//
// Design.  The TPU kernels keep the row tables in VMEM and gather rows with
// one-hot MXU contractions (K-blocked once the tables no longer fit).  Here
// the row tables stay in HBM and each token reads its own rows by index, so
// there is no full-K versus K-blocked choice.  One CTA per document (tokens
// are doc-contiguous, doc_ids non-decreasing): theta[d] and phi_tot sit in
// shared memory, read-only; each warp walks every nw-th token of the
// document, reduces sum(u) and sum(mu) with warp shuffles, then writes mu'
// in place and accumulates c*(mu'-mu) into its own [K] row of shared
// memory.  The warps' rows (and serving residuals) are summed in a fixed
// order at the end, so theta_delta and rdoc are deterministic.  In training
// mode a power word's tokens sit in many documents, so its d_rows/r_rows
// row sums across CTAs: those adds are atomicAdds, made only at the token's
// masked (at most Pk) coordinates; their order varies from run to run, so
// d_rows and r_rows are compared with tolerances, never bit for bit.  mu is
// updated IN PLACE (each element is read and written by one lane only).
//
// Bound.  Serving, at the slab's shapes (T = 4096 tokens, D = 64 docs,
// K = 2000, W' = 141044 rows): read mu and one phi row per active token and
// write mu back, about 3 * 4096 * 2000 * 4 B = 98 MB, ~29 us at 3.35 TB/s;
// the arithmetic (~14 flops per element, f32) is ~2 us at 67 TFLOP/s, so
// the kernel is memory-bound.  Training, at the training slice's shapes
// (T = 65536, D = 512, K = 2000, P = 14104 power words, Pk = 50): only a
// token's <= Pk masked topics are read or changed, so the sweep must read
// the mask row of each distinct power word (up to 113 MB) and its phi at
// those topics, read and write each power token's mu at its Pk topics
// (2 * 13 MB at most), and write the [P, K] d_rows/r_rows (2 * 113 MB,
// zeroed by the caller): ~370 MB, ~0.11 ms at 3.35 TB/s, bound by bytes.
// This kernel reads whole [K] mask rows per token rather than per word, and
// each warp reads its token's rows twice (the second pass is meant to hit
// L1).
//
// Known limits, recorded and not fixed here: a 64-slot slab launches only
// 64 CTAs on the card's 132 SMs; the training mode takes the [P+1, K] phi
// and mask row tables that the JAX path rebuilds every iteration (113 MB
// each at P = 14104) instead of reading sel_k directly.

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

// training mode: the token's own count left out of phi and phi_tot (pt is
// phi_tot without wbeta here)
__device__ __forceinline__ float update_u_train(float th, float pt, float m, float c,
                                                float ph, float alpha, float beta,
                                                float wbeta) {
  const float cm = c * m;
  return (th - cm + alpha) * (ph - cm + beta) / (pt - cm + wbeta);
}

template <bool kTrain>
__global__ void carry_sweep_kernel(
    const int* __restrict__ p_tok, const int* __restrict__ doc_ids,
    const float* __restrict__ counts, float* mu,
    const float* __restrict__ theta, const float* __restrict__ phi_tot,
    const float* __restrict__ phi_rows, const float* __restrict__ mask_rows,
    float* __restrict__ theta_delta, float* __restrict__ rdoc,
    float* __restrict__ d_rows, float* __restrict__ r_rows, int T, int K,
    int n_rows, int n_guard, float alpha, float beta, float wbeta) {
  extern __shared__ float smem[];
  __shared__ float r_warp[32];
  const int nw = blockDim.x / kWarp;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int d = blockIdx.x;
  float* th_s = smem;                         // [K] theta[d]
  float* pt_s = smem + K;                     // [K] phi_tot (+ wbeta serving)
  float* acc = smem + (size_t)(2 + warp) * K; // [K] this warp's theta delta

  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    th_s[k] = theta[(size_t)d * K + k];
    pt_s[k] = kTrain ? phi_tot[k] : phi_tot[k] + wbeta;
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
    if constexpr (kTrain) {
      const float* mask = mask_rows + (size_t)p * K;
      float su = 0.f, sm = 0.f;
#pragma unroll 4
      for (int k = lane; k < K; k += kWarp) {
        const float mk = __ldg(mask + k);
        if (mk > 0.f) {
          const float m = mu_t[k];
          su += update_u_train(th_s[k], pt_s[k], m, c, __ldg(ph + k), alpha, beta,
                               wbeta) * mk;
          sm += m * mk;
        }
      }
      su = warp_sum(su);
      sm = warp_sum(sm);
      const float scale = sm / fmaxf(su, 1e-30f);
      float* d_row = d_rows + (size_t)p * K;
      float* r_row = r_rows + (size_t)p * K;
      const bool fold = p < n_guard;
#pragma unroll 4
      for (int k = lane; k < K; k += kWarp) {
        const float mk = __ldg(mask + k);
        if (mk > 0.f) {
          const float m = mu_t[k];
          const float mn = update_u_train(th_s[k], pt_s[k], m, c, __ldg(ph + k), alpha,
                                          beta, wbeta) * mk * scale;
          const float cd = c * (mn - m);
          mu_t[k] = mn;
          acc[k] += cd;
          if (fold) {
            atomicAdd(d_row + k, cd);
            atomicAdd(r_row + k, fabsf(cd));
          }
        }
      }
    } else {
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
  }
  if constexpr (!kTrain) {
    r = warp_sum(r);
    if (lane == 0) r_warp[warp] = r;
  }
  __syncthreads();

  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    float s = 0.f;
    for (int w = 0; w < nw; ++w) s += smem[(size_t)(2 + w) * K + k];
    theta_delta[(size_t)d * K + k] = s;
  }
  if (!kTrain && threadIdx.x == 0) {
    float s = 0.f;
    for (int w = 0; w < nw; ++w) s += r_warp[w];
    rdoc[d] = s;
  }
}

}  // namespace

extern "C" {

// Lets both modes of the kernel use, on the current device, all the dynamic
// shared memory a block may opt in to beside the kernel's static shared
// memory, and stores that many bytes in *smem_bytes.  Called once per
// device, before the first launch there.  Returns the CUDA error code (0 on
// success).
int power_sweep_carry_configure(int* smem_bytes) {
  int device = 0, optin = 0;
  cudaFuncAttributes attr;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, carry_sweep_kernel<false>);
  if (err != cudaSuccess) return (int)err;
  *smem_bytes = optin - (int)attr.sharedSizeBytes;
  err = cudaFuncSetAttribute(carry_sweep_kernel<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, *smem_bytes);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaFuncSetAttribute(
      carry_sweep_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem_bytes);
}

// Launches one serving sweep on `stream`; allocates nothing.  `warps` must
// leave (2 + warps) * K floats within what power_sweep_carry_configure
// allowed.  Returns the CUDA error code of the launch (0 on success).
int power_sweep_carry_serve(const int* p_tok, const int* doc_ids,
                            const float* counts, float* mu, const float* theta,
                            const float* phi_tot, const float* phi_rows,
                            float* theta_delta, float* rdoc, int T, int D,
                            int K, int n_rows, int n_guard, float alpha,
                            float beta, float wbeta, int warps, void* stream) {
  const int smem = (2 + warps) * K * (int)sizeof(float);
  if (D > 0) {
    carry_sweep_kernel<false><<<D, warps * kWarp, smem, (cudaStream_t)stream>>>(
        p_tok, doc_ids, counts, mu, theta, phi_tot, phi_rows, nullptr, theta_delta,
        rdoc, nullptr, nullptr, T, K, n_rows, n_guard, alpha, beta, wbeta);
  }
  return (int)cudaGetLastError();
}

// Launches one training sweep on `stream`; allocates nothing.  d_rows and
// r_rows are [n_guard, K] and must be zeroed by the caller (the kernel adds
// into them).  Same `warps` contract as power_sweep_carry_serve.  Returns
// the CUDA error code of the launch (0 on success).
int power_sweep_carry_train(const int* p_tok, const int* doc_ids,
                            const float* counts, float* mu, const float* theta,
                            const float* phi_tot, const float* phi_rows,
                            const float* mask_rows, float* theta_delta,
                            float* d_rows, float* r_rows, int T, int D, int K,
                            int n_rows, int n_guard, float alpha, float beta,
                            float wbeta, int warps, void* stream) {
  const int smem = (2 + warps) * K * (int)sizeof(float);
  if (D > 0) {
    carry_sweep_kernel<true><<<D, warps * kWarp, smem, (cudaStream_t)stream>>>(
        p_tok, doc_ids, counts, mu, theta, phi_tot, phi_rows, mask_rows, theta_delta,
        nullptr, d_rows, r_rows, T, K, n_rows, n_guard, alpha, beta, wbeta);
  }
  return (int)cudaGetLastError();
}

const char* power_sweep_carry_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
