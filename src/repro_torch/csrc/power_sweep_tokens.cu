// Packed-stream selective sweep, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/power_sweep/kernel.py:174
// (power_sweep_tokens) together with the jnp code around it on the
// reference's packed path (src/repro/core/pobp.py,
// selective_sweep_tokens_pallas with policy "packed"): the [T, Pk] gathers
// of _gather_selection, the kernel body, and the fold-back of
// _apply_token_update.  One Jacobi sweep at the (power word, power topic)
// coordinates:
//
//   power token t (p = p_tok[t] in [0, P)), count c, document d = doc_ids[t],
//   its Pk topics k_j = sel_k[p, j]:
//     m_j   = mu[t, k_j]
//     u_j   = (theta[d, k_j] - c*m_j + alpha) * (phi_pack[p, j] - c*m_j + beta)
//             / (phi_tot[k_j] - c*m_j + wbeta)
//     m'_j  = u_j * (sum_j m_j) / max(sum_j u_j, 1e-30)   (mass-conserving)
//     cd_j  = c * (m'_j - m_j)
//   mu[t, k_j] = m'_j                 (in place, at those coordinates only)
//   theta_delta[d, k_j] += cd_j;  d_pack[p, j] += cd_j;  r_pack[p, j] += |cd_j|
//   guard token (p_tok == P, or any id outside [0, P)): reads and writes
//   nothing, so its mu stays bit for bit as it was.
//
// theta is read and never written: every token sees the theta of the start
// of the sweep (the reference's Jacobi sweep gathers theta_sel once), and
// the caller forms theta + theta_delta after the launch.  phi_pack has P
// rows and no guard row (the reference pads one; nothing here reads row P).
// phi is used as it is, not clamped at 0, as the reference's packed
// formulation uses it.  The rows of sel_k hold distinct topics (top-k
// selections), so each mu element belongs to one lane.
//
// Design.  On the TPU, XLA gathers mu, theta and phi_tot into [T, Pk] tiles
// in HBM before the kernel (Pallas-TPU has no dynamic gather), the kernel
// accumulates the packed d/r rows through a [TT, P+1] one-hot MXU
// contraction into VMEM buffers carried across its sequential grid, and
// XLA folds the result back with a Pk-term compare-select chain over the
// whole [T, K] carry.  Here one warp owns one token and its lanes stride
// over the token's Pk topics (any Pk from 1 to K): the gathers are indexed
// loads, the fold-back an indexed store of the Pk changed elements, and the
// renormalization two warp-shuffle sums.  The cross-token sums have no
// owner (theta_delta rows are shared by a document's tokens, d/r rows by a
// power word's tokens in many documents), so they are atomicAdds into
// zeroed outputs; their order varies from run to run, so theta_delta,
// d_pack and r_pack are compared with tolerances, never bit for bit.
//
// Bound.  At the training slice's shapes (T = 65536 slots of D = 512
// documents, K = 2000, P = 14104, Pk = 50, ~70% power tokens): read and
// write mu at each power token's Pk topics (2 * 45875 * 50 * 4 B = 18.4 MB),
// read theta at the selected (document, topic) pairs (<= 9.2 MB), sel_k and
// phi_pack of the power words present (<= 5.6 MB), the per-token ids and
// counts (0.8 MB); write theta_delta (4.1 MB) and d/r (5.6 MB): ~44 MB,
// ~13 us at 3.35 TB/s; ~30 f32 operations per (token, topic) are ~1 us at
// 67 TFLOP/s.  Bound by bytes.  In practice each scattered element costs a
// whole 32-byte sector, each atomic a round trip to L2, and pass 2 reads
// the token's elements again (meant to hit L1).

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float update_u(float th, float pt, float m, float c, float ph,
                                          float alpha, float beta, float wbeta) {
  const float cm = c * m;
  return (th - cm + alpha) * (ph - cm + beta) / (pt - cm + wbeta);
}

__global__ void power_sweep_tokens_kernel(
    const int* __restrict__ p_tok, const int* __restrict__ doc_ids,
    const float* __restrict__ counts, float* mu, const float* __restrict__ theta,
    const float* __restrict__ phi_tot, const float* __restrict__ phi_pack,
    const int* __restrict__ sel_k, float* __restrict__ theta_delta,
    float* __restrict__ d_pack, float* __restrict__ r_pack, int T, int K, int P,
    int Pk, float alpha, float beta, float wbeta) {
  const long long t = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (t >= T) return;                       // whole warps: one token each
  const int p = __ldg(p_tok + t);
  if (p < 0 || p >= P) return;              // guard token
  const float c = __ldg(counts + t);
  const int d = __ldg(doc_ids + t);
  float* mu_t = mu + (size_t)t * K;
  const float* th = theta + (size_t)d * K;
  const int* ks = sel_k + (size_t)p * Pk;
  const float* ph = phi_pack + (size_t)p * Pk;

  float su = 0.f, sm = 0.f;
  for (int j = lane; j < Pk; j += kWarp) {
    const int k = __ldg(ks + j);
    const float m = mu_t[k];
    su += update_u(__ldg(th + k), __ldg(phi_tot + k), m, c, __ldg(ph + j), alpha, beta,
                   wbeta);
    sm += m;
  }
  su = warp_sum(su);
  sm = warp_sum(sm);
  const float denom = fmaxf(su, 1e-30f);

  float* td = theta_delta + (size_t)d * K;
  float* dp = d_pack + (size_t)p * Pk;
  float* rp = r_pack + (size_t)p * Pk;
  for (int j = lane; j < Pk; j += kWarp) {
    const int k = __ldg(ks + j);
    const float m = mu_t[k];
    const float mn = update_u(__ldg(th + k), __ldg(phi_tot + k), m, c, __ldg(ph + j),
                              alpha, beta, wbeta) * sm / denom;
    const float cd = c * (mn - m);
    mu_t[k] = mn;
    atomicAdd(td + k, cd);
    atomicAdd(dp + j, cd);
    atomicAdd(rp + j, fabsf(cd));
  }
}

}  // namespace

extern "C" {

// Launches one packed sweep on `stream`; allocates nothing.  theta_delta
// [D, K], d_pack and r_pack [P, Pk] must be zeroed by the caller (the
// kernel adds into them).  Returns the CUDA error code of the launch (0 on
// success).
int power_sweep_tokens(const int* p_tok, const int* doc_ids, const float* counts,
                       float* mu, const float* theta, const float* phi_tot,
                       const float* phi_pack, const int* sel_k, float* theta_delta,
                       float* d_pack, float* r_pack, int T, int K, int P, int Pk,
                       float alpha, float beta, float wbeta, void* stream) {
  const long long threads = (long long)T * kWarp;
  if (threads > 0 && Pk > 0) {
    const unsigned blocks = (unsigned)((threads + kThreads - 1) / kThreads);
    power_sweep_tokens_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        p_tok, doc_ids, counts, mu, theta, phi_tot, phi_pack, sel_k, theta_delta,
        d_pack, r_pack, T, K, P, Pk, alpha, beta, wbeta);
  }
  return (int)cudaGetLastError();
}

const char* power_sweep_tokens_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
