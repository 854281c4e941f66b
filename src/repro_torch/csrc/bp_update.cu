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
// The TPU wrapper gathers theta[doc] and phi[word] into [T, K] arrays in HBM
// before the kernel (src/repro/kernels/bp_update/ops.py:49-50) and pads K to
// 128 lanes with a -alpha/-beta trick so padded topics add nothing.  Here
// the kernel reads each token's theta and phi rows by index, so neither
// [T, K] gather is written or read back, and it masks K itself (no
// padding, any K >= 1).
//
// Bound.  At the training slice's shapes (T = 512 x 128 token slots,
// K = 2000, W = 141043) the function must read mu and write mu' and r
// ([T, K] each, 3 x 524 MB), read each distinct phi row its tokens name
// (~52,400 rows with uniform words, 0.42 GB), the theta rows (4 MB) and
// phi_tot: ~2.0 GB, 0.596 ms at 3.35 TB/s.  Its ~12 f32 operations per
// element are ~0.02 ms at 67 TFLOP/s, so it is bound by bytes.
//
// Two paths; the wrapper's bp_launch_plan(K) (kernels/bp_update/ops.py)
// picks one by K.
//
// Register path (K <= 2048).  The first design gave a warp to a token and
// made two passes over K: pass 1 summed u, pass 2 reloaded the token's mu,
// theta and phi rows (8 KB each at K = 2000) and recomputed u.  With dozens
// of warps an SM the second pass found its rows evicted from L1 and much of
// L2 and re-read them from HBM; its loads were 4-byte scalars, and its 1 GB
// of outputs went out with the default cache policy, evicting the phi and
// theta rows later tokens reuse.  It runs 1.40 ms on an H100 (43% of the
// bound).  Here:
//   - a CTA of `threads` = 32 * ceil(K / 128) threads (at most 512) owns
//     one token at a time, each thread 4 topics (4 * tid + e); it holds the
//     token's mu, theta and phi at them in registers, so every row is read
//     once, with 16-byte loads (mu streaming, __ldcs; theta and phi cached,
//     __ldg).  u is computed once; its sum over K is a warp shuffle and
//     then a sum of the warps' parts in shared memory, in a fixed order;
//     mu' = u * (1 / max(sum u, 1e-30)) and r are written from registers
//     with 16-byte streaming stores (__stcs), so the outputs do not evict
//     the rows later tokens reuse;
//   - the CTA walks tokens blockIdx.x, + gridDim.x, ...; the grid is as
//     many CTAs as fit the SMs at once (4 of 512 threads at ~32
//     registers, the whole SM), and phi_tot is read once a CTA into
//     shared memory.  The other CTAs of the SM keep loads in flight while
//     one reduces and stores: loading the next token's rows before the
//     current one's reduction, in registers, ran slower, and so did fewer
//     threads a token with more topics each (PERF.md has the numbers);
//   - u divides with __fdividef (2 ulp) and mu' multiplies by one IEEE
//     reciprocal a token: the kernel issues instructions at a rate that
//     matters, and the IEEE divisions of the first design cost ~5% here;
//     the results stay within ~1e-9 of the plain version;
//   - a count-0 token (the padding slots of a training batch) reads no mu:
//     c * mu is exactly 0 for finite mu, so u does not depend on it, and r
//     is written as 0 (for non-finite mu at such a slot the plain version
//     gives NaN where this path does not);
//   - K not a multiple of 4, or a row not on a 16-byte boundary, takes the
//     same kernel with scalar loads and stores (kVec = false);
//   - no atomics: mu' and r repeat bit for bit from launch to launch.
// At phase 2's shapes it runs 0.74 ms on an H100 (80% of the bound; the
// two-pass path 1.40 ms in the same turns, chip_smoke.py phase 2).
//
// Two-pass path (any K; the wrapper takes it past 2048).  The first
// design, kept as it was: one warp a token, 8 warps a CTA; pass 1 sums u
// over K with warp shuffles; pass 2 recomputes u (its mu, theta and phi
// reads hit L1/L2 or HBM again), writes mu' and r.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRegMaxThreads = 512;   // register path: 4 topics a thread
constexpr int kTwoPassWarps = 8;      // two-pass path: tokens (warps) a CTA

__device__ __forceinline__ float warp_sum(float v) {
  // xor butterfly: a fixed order, every lane ends with the same sum
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float update_u(float th, float ph, float pt, float cm,
                                          float alpha, float beta, float wbeta) {
  return (th - cm + alpha) * (ph - cm + beta) / (pt - cm + wbeta);
}

// ------------------------------------------------------------ register path

template <bool kVec>
__global__ void __launch_bounds__(kRegMaxThreads) bp_update_kernel(
    const int* __restrict__ word_ids, const int* __restrict__ doc_ids,
    const float* __restrict__ counts, const float* __restrict__ mu,
    const float* __restrict__ theta, const float* __restrict__ phi,
    const float* __restrict__ phi_tot, float* __restrict__ mu_out,
    float* __restrict__ r_out, int T, int K, float alpha, float beta, float wbeta) {
  __shared__ float4 pt_s[kRegMaxThreads];     // phi_tot, 0 past K
  __shared__ float red[2][kRegMaxThreads / kWarp];   // [buffer][warp]
  const int nt = blockDim.x, tid = threadIdx.x;
  const int lane = tid % kWarp, warp = tid / kWarp, nw = nt / kWarp;
  const int k = 4 * tid;                      // this thread's topics k .. k + 3
  float* pt_f = reinterpret_cast<float*>(pt_s);
  for (int i = tid; i < 4 * nt; i += nt) pt_f[i] = i < K ? phi_tot[i] : 0.f;
  __syncthreads();

  int buf = 0;
  for (int t = blockIdx.x; t < T; t += gridDim.x) {   // uniform over the CTA
    const float c = __ldg(counts + t);
    const float* m_row = mu + (size_t)t * K;
    const float* th_row = theta + (size_t)__ldg(doc_ids + t) * K;
    const float* ph_row = phi + (size_t)__ldg(word_ids + t) * K;
    float m[4] = {0.f, 0.f, 0.f, 0.f}, th[4] = {0.f, 0.f, 0.f, 0.f},
          ph[4] = {0.f, 0.f, 0.f, 0.f};
    if (kVec) {
      if (k < K) {
        if (c != 0.f) {                       // a count-0 token reads no mu
          const float4 a = __ldcs(reinterpret_cast<const float4*>(m_row + k));
          m[0] = a.x; m[1] = a.y; m[2] = a.z; m[3] = a.w;
        }
        const float4 b = __ldg(reinterpret_cast<const float4*>(th_row + k));
        const float4 p = __ldg(reinterpret_cast<const float4*>(ph_row + k));
        th[0] = b.x; th[1] = b.y; th[2] = b.z; th[3] = b.w;
        ph[0] = p.x; ph[1] = p.y; ph[2] = p.z; ph[3] = p.w;
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (k + e < K) {
          if (c != 0.f) m[e] = __ldcs(m_row + k + e);
          th[e] = __ldg(th_row + k + e);
          ph[e] = __ldg(ph_row + k + e);
        }
    }
    const float4 pt4 = pt_s[tid];
    const float pt[4] = {pt4.x, pt4.y, pt4.z, pt4.w};
    float u[4], su = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float cm = c * m[e];
      u[e] = k + e < K ? __fdividef((th[e] - cm + alpha) * (ph[e] - cm + beta),
                                    pt[e] - cm + wbeta)
                       : 0.f;
      su += u[e];
    }
    // the CTA's sum in a fixed order; the two buffers alternate, so one
    // barrier a token suffices (a buffer is written again only after the
    // next token's barrier, which every thread passes after its reads)
    su = warp_sum(su);
    if (lane == 0) red[buf][warp] = su;
    __syncthreads();
    float s = 0.f;
    for (int w = 0; w < nw; ++w) s += red[buf][w];
    buf ^= 1;
    const float inv = 1.f / fmaxf(s, 1e-30f);
    float mn[4], r[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      mn[e] = u[e] * inv;
      r[e] = c * fabsf(mn[e] - m[e]);
    }
    float* mo = mu_out + (size_t)t * K;
    float* ro = r_out + (size_t)t * K;
    if (kVec) {
      if (k < K) {
        __stcs(reinterpret_cast<float4*>(mo + k), make_float4(mn[0], mn[1], mn[2], mn[3]));
        __stcs(reinterpret_cast<float4*>(ro + k), make_float4(r[0], r[1], r[2], r[3]));
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (k + e < K) {
          __stcs(mo + k + e, mn[e]);
          __stcs(ro + k + e, r[e]);
        }
    }
  }
}

template <bool kVec>
cudaError_t launch_registers(int threads, const int* word_ids, const int* doc_ids,
                             const float* counts, const float* mu, const float* theta,
                             const float* phi, const float* phi_tot, float* mu_out,
                             float* r_out, int T, int K, float alpha, float beta,
                             float wbeta, cudaStream_t stream) {
  auto kernel = bp_update_kernel<kVec>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  if (err != cudaSuccess) return err;
  // as many CTAs as run at once, each walking its share of the tokens
  const long long fit = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const unsigned blocks = (unsigned)(fit < T ? fit : T);
  kernel<<<blocks, threads, 0, stream>>>(word_ids, doc_ids, counts, mu, theta, phi,
                                         phi_tot, mu_out, r_out, T, K, alpha, beta, wbeta);
  return cudaGetLastError();
}

// ------------------------------------------------------------ two-pass path

__global__ void bp_update_twopass_kernel(const int* __restrict__ word_ids,
                                         const int* __restrict__ doc_ids,
                                         const float* __restrict__ counts,
                                         const float* __restrict__ mu,
                                         const float* __restrict__ theta,
                                         const float* __restrict__ phi,
                                         const float* __restrict__ phi_tot,
                                         float* __restrict__ mu_out,
                                         float* __restrict__ r_out, int T, int K,
                                         float alpha, float beta, float wbeta) {
  const int t = blockIdx.x * kTwoPassWarps + threadIdx.x / kWarp;
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

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

}  // namespace

extern "C" {

// Launches one dense sweep on `stream` by the caller's plan; allocates
// nothing.  `registers` = 1 takes the register path with `threads` threads
// a token (a multiple of 32, at most 512, 4 * threads >= K); 0 the
// two-pass path (`threads` unused).  mu_out and r_out must not alias the
// inputs.  Returns the CUDA error code of the launch (0 on success).
int bp_update(const int* word_ids, const int* doc_ids, const float* counts,
              const float* mu, const float* theta, const float* phi,
              const float* phi_tot, float* mu_out, float* r_out, int T, int K,
              float alpha, float beta, float wbeta, int registers, int threads,
              void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (T <= 0) return (int)cudaGetLastError();
  if (!registers) {
    const unsigned blocks = (unsigned)((T + kTwoPassWarps - 1) / kTwoPassWarps);
    bp_update_twopass_kernel<<<blocks, kTwoPassWarps * kWarp, 0, s>>>(
        word_ids, doc_ids, counts, mu, theta, phi, phi_tot, mu_out, r_out, T, K, alpha,
        beta, wbeta);
    return (int)cudaGetLastError();
  }
  if (threads < kWarp || threads > kRegMaxThreads || threads % kWarp != 0 ||
      4LL * threads < K)
    return (int)cudaErrorInvalidValue;
  const bool vec = K % 4 == 0 && aligned16(mu) && aligned16(theta) && aligned16(phi) &&
                   aligned16(mu_out) && aligned16(r_out);
  return (int)(vec ? launch_registers<true>(threads, word_ids, doc_ids, counts, mu, theta,
                                             phi, phi_tot, mu_out, r_out, T, K, alpha,
                                             beta, wbeta, s)
                   : launch_registers<false>(threads, word_ids, doc_ids, counts, mu,
                                              theta, phi, phi_tot, mu_out, r_out, T, K,
                                              alpha, beta, wbeta, s));
}

const char* bp_update_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
