// Dense BP message update (Eq. 1 + Eq. 7), token-major, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/bp_update/kernel.py:56
// (bp_update_tokens): the t=1 sweep of every POBP mini-batch.  For each
// token t of word w = word_ids[t] in document d = doc_ids[t], count c:
//
//   u_k   = (theta[d,k] - c*mu[t,k] + alpha) * (phi[w,k] - c*mu[t,k] + beta)
//           / (phi_tot[k] - c*mu[t,k] + wbeta)
//   mu'_k = u_k / max(sum_k u_k, 1e-30)
//   r_k   = c * |mu'_k - mu[t,k]|
//
// Design.  The TPU wrapper gathers theta[doc] and phi[word] into [T, K]
// arrays in HBM before the kernel (src/repro/kernels/bp_update/ops.py:49-50)
// and pads K to 128 lanes with a -alpha/-beta trick so padded topics add
// nothing.  Here one warp owns one token and reads its theta and phi rows by
// index, so neither [T, K] gather is written or read back, and the warp
// masks K itself (no padding).  Pass 1 sums u over K with warp shuffles;
// pass 2 recomputes u (its mu, theta and phi reads hit L1/L2), writes mu'
// and r.  Eight tokens per 256-thread block.
//
// Bound.  At the training slice's shapes (T = 65536 token slots, D = 512
// documents, K = 2000, W = 141043) the function must read mu and write mu'
// and r ([T, K] each, 3 * 524 MB), read the theta rows (4 MB) and each
// distinct phi row its tokens name (~20k rows, ~160 MB): ~1.7 GB, ~0.5 ms
// at 3.35 TB/s.  Its ~12 f32 operations per element are ~0.02 ms at
// 67 TFLOP/s, so it is bound by bytes.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float update_u(float th, float ph, float pt, float cm,
                                          float alpha, float beta, float wbeta) {
  return (th - cm + alpha) * (ph - cm + beta) / (pt - cm + wbeta);
}

__global__ void bp_update_kernel(const int* __restrict__ word_ids,
                                 const int* __restrict__ doc_ids,
                                 const float* __restrict__ counts,
                                 const float* __restrict__ mu,
                                 const float* __restrict__ theta,
                                 const float* __restrict__ phi,
                                 const float* __restrict__ phi_tot,
                                 float* __restrict__ mu_out, float* __restrict__ r_out,
                                 int T, int K, float alpha, float beta, float wbeta) {
  const int t = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (t >= T) return;
  const float c = counts[t];
  const float* m = mu + (size_t)t * K;
  const float* th = theta + (size_t)doc_ids[t] * K;
  const float* ph = phi + (size_t)word_ids[t] * K;
  float su = 0.f;
#pragma unroll 4
  for (int k = lane; k < K; k += kWarp) {
    su += update_u(__ldg(th + k), __ldg(ph + k), __ldg(phi_tot + k), c * __ldg(m + k),
                   alpha, beta, wbeta);
  }
  const float denom = fmaxf(warp_sum(su), 1e-30f);
  float* mo = mu_out + (size_t)t * K;
  float* ro = r_out + (size_t)t * K;
#pragma unroll 4
  for (int k = lane; k < K; k += kWarp) {
    const float mk = __ldg(m + k);
    const float mn = update_u(__ldg(th + k), __ldg(ph + k), __ldg(phi_tot + k), c * mk,
                              alpha, beta, wbeta) / denom;
    mo[k] = mn;
    ro[k] = c * fabsf(mn - mk);
  }
}

}  // namespace

extern "C" {

// Launches one dense sweep on `stream`; allocates nothing.  mu_out and r_out
// must not alias the inputs.  Returns the CUDA error code of the launch
// (0 on success).
int bp_update(const int* word_ids, const int* doc_ids, const float* counts,
              const float* mu, const float* theta, const float* phi,
              const float* phi_tot, float* mu_out, float* r_out, int T, int K,
              float alpha, float beta, float wbeta, void* stream) {
  if (T > 0) {
    const unsigned blocks = (unsigned)((T + kWarpsPerBlock - 1) / kWarpsPerBlock);
    bp_update_kernel<<<blocks, kWarpsPerBlock * kWarp, 0, (cudaStream_t)stream>>>(
        word_ids, doc_ids, counts, mu, theta, phi, phi_tot, mu_out, r_out, T, K,
        alpha, beta, wbeta);
  }
  return (int)cudaGetLastError();
}

const char* bp_update_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
