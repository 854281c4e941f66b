// The collapsed Gibbs chain of LDA (the GS-family comparator), for Hopper
// (sm_90a).
//
// Replaces the lax.scan of src/repro/core/gibbs.py:73 (gibbs_sweep), which
// XLA compiles into one device loop; it is no Pallas kernel.  One launch
// runs one full sweep: the tokens in order t = 0 .. T-1, each with document
// d = doc_ids[t], word w = word_ids[t] and current topic z[t]:
//   1. n_dk[d, z] -= 1, n_wk[w, z] -= 1, n_k[z] -= 1;
//   2. logits[k] = (log(n_dk[d, k] + alpha) + log(n_wk[w, k] + beta))
//                  - log(n_k[k] + wbeta);
//   3. z' = argmax_k (g[t, k] + logits[k]), ties to the lowest k (the
//      reference's jax.random.categorical is this Gumbel-max, and
//      jnp.argmax breaks ties so);
//   4. n_dk[d, z'] += 1, n_wk[w, z'] += 1, n_k[z'] += 1, z[t] = z'.
// It is the same sequential chain, not AD-LDA within a sweep.  The counts
// are float32 integers, updated in place, so +-1 is exact in any order; the
// sums are formed in the reference's order with logf (no fast math), so the
// kernel and its plain PyTorch version choose the same topic on the same
// noise.  alpha, beta and wbeta = float32(W * beta) come from the host.
//
// The noise g comes one of two ways:
//   - injected: a float32 [T, K] tensor;
//   - drawn here: Philox4x32-10 with key (seed & 0xffffffff, seed >> 32)
//     and counter (k, t, sweep, 0); its first output word x gives
//     u = ((x >> 9) + 0.5) * 2^-23, strictly inside (0, 1), and
//     g = -log(-log(u)).  kernels/gibbs_sweep/ops.py::philox_gumbel makes
//     the same [T, K] numbers in PyTorch.
//
// Design (a simple one that is right first).  One CTA walks the chain.
// n_k lives in shared memory (K floats, K up to the block's opt-in size);
// n_dk and n_wk stay in device memory, and a token reads their two rows of
// K floats (int64 offsets: W * K passes 2^31 at PUBMED width).  Thread i
// scores the topics k = i, i + B, ...; the owner of z[t] applies step 1 to
// its own topic before scoring it, so no barrier is needed there.  A warp
// shuffle and then warp 0 reduce (value, topic) pairs; lane 0 of warp 0
// applies step 4, and a barrier publishes it before the next token.
//
// Bound.  Each token must read two rows (2 * K * 4 bytes): at K = 2000,
// 16 KB, 4.8 ns at 3.35 TB/s.  The chain is sequential, so what bounds it
// is latency: a token's dependent loads, its scores and two barriers.
// gibbs_reduce_floor runs the same loop with no loads and no logs (T steps
// of one block argmax, each depending on the last winner): T times its
// step time is the chain's latency floor.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = kMaxThreads / kWarp;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t philox_first(uint32_t c0, uint32_t c1, uint32_t c2,
                                                 uint32_t c3, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t lo0 = 0xD2511F53u * c0, hi0 = __umulhi(0xD2511F53u, c0);
    const uint32_t lo1 = 0xCD9E8D57u * c2, hi1 = __umulhi(0xCD9E8D57u, c2);
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c0;
}

__device__ __forceinline__ float gumbel(uint32_t x) {
  const float u = ((float)(x >> 9) + 0.5f) * 1.1920928955078125e-07f;  // 2^-23
  return -logf(-logf(u));
}

// (v, k) beats (bv, bk): larger value, or the same value at a lower topic
__device__ __forceinline__ bool beats(float v, int k, float bv, int bk) {
  return v > bv || (v == bv && k < bk);
}

__device__ __forceinline__ void warp_argmax(float& v, int& k) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(kFull, v, off);
    const int ok = __shfl_down_sync(kFull, k, off);
    if (beats(ov, ok, v, k)) {
      v = ov;
      k = ok;
    }
  }
}

template <bool kInjected>
__global__ void __launch_bounds__(kMaxThreads) gibbs_sweep_kernel(
    int* __restrict__ z, float* __restrict__ n_dk, float* __restrict__ n_wk,
    float* __restrict__ n_k, const int* __restrict__ doc_ids,
    const int* __restrict__ word_ids, const float* __restrict__ noise, uint32_t seed_lo,
    uint32_t seed_hi, uint32_t sweep, int T, int K, float alpha, float beta, float wbeta) {
  extern __shared__ float s_nk[];                // [K]
  __shared__ float s_val[kMaxWarps];
  __shared__ int s_top[kMaxWarps];
  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
  const int nwarps = blockDim.x / kWarp;
  for (int k = tid; k < K; k += blockDim.x) s_nk[k] = n_k[k];
  __syncthreads();
  for (int t = 0; t < T; ++t) {
    const int zt = z[t];
    float* rd = n_dk + (int64_t)__ldg(doc_ids + t) * K;
    float* rw = n_wk + (int64_t)__ldg(word_ids + t) * K;
    float bv = -INFINITY;
    int bk = K;
    for (int k = tid; k < K; k += blockDim.x) {
      float a = rd[k], b = rw[k], c = s_nk[k];
      if (k == zt) {                             // step 1: this thread's topic
        a -= 1.f;
        b -= 1.f;
        c -= 1.f;
        rd[k] = a;
        rw[k] = b;
        s_nk[k] = c;
      }
      const float logit = (logf(a + alpha) + logf(b + beta)) - logf(c + wbeta);
      float g;
      if constexpr (kInjected)
        g = __ldg(noise + (int64_t)t * K + k);
      else
        g = gumbel(philox_first((uint32_t)k, (uint32_t)t, sweep, 0u, seed_lo, seed_hi));
      const float v = g + logit;
      if (v > bv) {                              // k rises: the first max stays
        bv = v;
        bk = k;
      }
    }
    warp_argmax(bv, bk);
    if (lane == 0) {
      s_val[warp] = bv;
      s_top[warp] = bk;
    }
    __syncthreads();
    if (warp == 0) {
      bv = lane < nwarps ? s_val[lane] : -INFINITY;
      bk = lane < nwarps ? s_top[lane] : K;
      warp_argmax(bv, bk);
      if (lane == 0) {                           // step 4
        rd[bk] += 1.f;
        rw[bk] += 1.f;
        s_nk[bk] += 1.f;
        z[t] = bk;
      }
    }
    __syncthreads();
  }
  for (int k = tid; k < K; k += blockDim.x) n_k[k] = s_nk[k];
}

// the chain's skeleton: T steps of one block argmax over K topics, each
// step's values depending on the last winner, with the sweep's barriers
__global__ void __launch_bounds__(kMaxThreads) gibbs_reduce_floor_kernel(int* out, int T,
                                                                         int K) {
  __shared__ float s_val[kMaxWarps];
  __shared__ int s_top[kMaxWarps];
  __shared__ int s_win;
  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
  const int nwarps = blockDim.x / kWarp;
  if (tid == 0) s_win = 0;
  __syncthreads();
  for (int t = 0; t < T; ++t) {
    const uint32_t prev = (uint32_t)s_win;
    float bv = -INFINITY;
    int bk = K;
    for (int k = tid; k < K; k += blockDim.x) {
      const float v = (float)((((uint32_t)k ^ prev) * 2654435761u) >> 8);
      if (v > bv) {
        bv = v;
        bk = k;
      }
    }
    warp_argmax(bv, bk);
    if (lane == 0) {
      s_val[warp] = bv;
      s_top[warp] = bk;
    }
    __syncthreads();
    if (warp == 0) {
      bv = lane < nwarps ? s_val[lane] : -INFINITY;
      bk = lane < nwarps ? s_top[lane] : K;
      warp_argmax(bv, bk);
      if (lane == 0) s_win = bk + t;
    }
    __syncthreads();
  }
  if (tid == 0) out[0] = s_win;
}

int block_threads(int K) {
  const int warps = (K + kWarp - 1) / kWarp;
  return (warps < kMaxWarps ? warps : kMaxWarps) * kWarp;
}

}  // namespace

extern "C" {

// The largest K a sweep takes on the current device: n_k's K floats in
// shared memory within what a block may opt in to, beside the kernel's own
// static shared memory.  Returns the CUDA error code (0 on success).
int gibbs_sweep_max_topics(int* topics) {
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, gibbs_sweep_kernel<true>);
  if (err == cudaSuccess) *topics = (int)((optin - (int)attr.sharedSizeBytes) / sizeof(float));
  return (int)err;
}

// Launches one sweep on `stream`, in place on z [T] (int32), n_dk [D, K],
// n_wk [W, K] and n_k [K] (float32), over the tokens doc_ids [T] and
// word_ids [T] (int32).  With `noise` (float32 [T, K]) the kernel adds it;
// with noise == NULL it draws Philox noise from (seed_lo, seed_hi, sweep)
// as the note above says.  Ids and z must be in range: the kernel reads
// them unchecked.  Allocates nothing.  Returns the CUDA error code of the
// launch (0 on success).
int gibbs_sweep(int* z, float* n_dk, float* n_wk, float* n_k, const int* doc_ids,
                const int* word_ids, const float* noise, unsigned seed_lo, unsigned seed_hi,
                unsigned sweep, int T, int K, float alpha, float beta, float wbeta,
                void* stream) {
  if (K < 1 || T < 0) return (int)cudaErrorInvalidValue;
  if (T == 0) return 0;
  const size_t smem = sizeof(float) * (size_t)K;
  const int threads = block_threads(K);
  cudaError_t err = cudaSuccess;
  if (noise != nullptr) {
    if (smem > 48 * 1024)
      err = cudaFuncSetAttribute(gibbs_sweep_kernel<true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    gibbs_sweep_kernel<true><<<1, threads, smem, (cudaStream_t)stream>>>(
        z, n_dk, n_wk, n_k, doc_ids, word_ids, noise, seed_lo, seed_hi, sweep, T, K, alpha,
        beta, wbeta);
  } else {
    if (smem > 48 * 1024)
      err = cudaFuncSetAttribute(gibbs_sweep_kernel<false>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    gibbs_sweep_kernel<false><<<1, threads, smem, (cudaStream_t)stream>>>(
        z, n_dk, n_wk, n_k, doc_ids, word_ids, nullptr, seed_lo, seed_hi, sweep, T, K,
        alpha, beta, wbeta);
  }
  return (int)cudaGetLastError();
}

// Launches the chain's skeleton (see the note above): T steps of a block
// argmax over K topics with the sweep's block size and barriers; out [1]
// int32 receives the last winner.  Returns the CUDA error code.
int gibbs_reduce_floor(int* out, int T, int K, void* stream) {
  if (K < 1 || T < 0) return (int)cudaErrorInvalidValue;
  gibbs_reduce_floor_kernel<<<1, block_threads(K), 0, (cudaStream_t)stream>>>(out, T, K);
  return (int)cudaGetLastError();
}

const char* gibbs_sweep_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
