// The collapsed Gibbs chain of LDA (the GS-family comparator), for Hopper
// (sm_90a).
//
// Replaces the lax.scan of src/repro/core/gibbs.py:73 (gibbs_sweep), which
// XLA compiles into one device loop; it is no Pallas kernel.  One chain
// launch runs the tokens t = t0 .. t1-1 in order, each with document
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
// The noise g is a float32 [T, K] tensor: injected, or drawn ahead of the
// chain by gibbs_noise_kernel, a grid over every SM: Philox4x32-10 with key
// (seed & 0xffffffff, seed >> 32) and counter (k, t, sweep, 0); its first
// output word x gives u = ((x >> 9) + 0.5) * 2^-23, strictly inside
// (0, 1), and g = -log(-log(u)).  kernels/gibbs_sweep/ops.py::philox_gumbel
// makes the same numbers in PyTorch.
//
// Bound.  The chain is sequential: each token's argmax needs the last
// token's counts.  A token must read two rows (2 * K * 4 bytes; at K = 2000,
// 16 KB, 4.8 ns at 3.35 TB/s), so what bounds the chain is its per-token
// latency.  The design takes everything that does not depend on the last
// token's winner off that chain:
//   - Ownership.  One CTA of B threads walks the chain; thread i owns the
//     chunks of V topics starting at V i, V (i + B), ... (V = 4 where K is
//     a multiple of 4 and the rows lie on 16-byte boundaries: 16-byte
//     copies and loads; else V = 1).  Everything kept per topic (the rows'
//     counts, n_k and log(n_k + wbeta), the noise) is read and written by
//     its owner alone, so steps 1 and 4 and the scores need no barrier; the
//     owner of z applies step 1 to its topic before scoring it, the owner
//     of z' step 4 after the argmax.  Every change is also stored through
//     to n_dk and n_wk in device memory, so rows are never written back.
//   - Logs cached, not recomputed.  log(n_k + wbeta) is kept per topic and
//     patched at z and z' only.  The row counts are small integers:
//     logf(n + alpha) and logf(n + beta) for n < kTable are tabulated in
//     shared memory once a launch (logf of the same float: the same bits),
//     so a score is two table reads and one read of the cached log; a
//     count past the table takes logf.
//   - Rows and noise ahead of the chain (the shared-memory path).  While
//     token t runs, each owner copies its topics of token t+1's rows into a
//     second buffer with cp.async: the n_wk row when the word changes, the
//     n_dk row when the document changes (a row repeated by consecutive
//     tokens stays in place: tokens_from_batch emits documents in order
//     and repeats a word's count), and token t+1's noise row.  Token t
//     touches only its own two rows, so the copy of another row needs no
//     patch; any token order is right, a revisited row being read again
//     from device memory where every change was stored.  The Philox noise
//     is drawn by the pre-pass over all SMs, not on the chain's SM.
//     (Keeping the rows and the noise in registers instead, loaded a token
//     ahead by each owner, was tried and ran slower on an H100.)
//   - One barrier a token.  A thread's best (value, topic) becomes an
//     order-preserving key; two warp reductions (__reduce_max_sync of the
//     key, __reduce_min_sync of the topics holding it: the lowest topic on
//     a tie) leave each warp's best in a double-buffered slot; after the
//     one __syncthreads every warp reduces the slots itself, so each
//     thread knows z' without a second barrier.  The next token writes the
//     other slot, and a warp can reach the token after it only through the
//     next token's barrier, which the slowest reader has passed.
// Where K's caches do not fit in shared memory (8 floats a topic), the
// device-memory path reads the rows and the noise in place and keeps n_k
// and its logs in a scratch of 2K floats (each element its owner's); the
// tables, the ownership and the one-barrier argmax are the same.
// gibbs_reduce_floor runs the skeleton of this loop (T steps of the
// one-barrier block argmax over K topics, each depending on the last
// winner, no loads, no logs): T times its step is the chain's floor.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = kMaxThreads / kWarp;
constexpr int kTable = 1024;          // logf(n + c) tabulated for n < kTable
constexpr int kCachedFloats = 8;      // floats a topic on the shared-memory path
constexpr int kMaxTopics = 65536;
constexpr unsigned kNone = 0xffffffffu;

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

// larger float, larger key (no NaN); v + 0 maps -0 to +0, which compare
// equal as floats
__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned u = __float_as_uint(v + 0.f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The block's best topic: each thread's (bv, bk), bk == kNone for a thread
// with no topic; the largest value, the lowest topic on a tie.  One
// barrier; `parity` picks the slot buffer (alternate it between calls).
__device__ __forceinline__ int block_argmax(float bv, unsigned bk, unsigned* s_key,
                                           unsigned* s_top, int parity) {
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int nwarps = blockDim.x / kWarp;
  const unsigned key = bk == kNone ? 0u : order_key(bv);
  const unsigned wkey = __reduce_max_sync(0xffffffffu, key);
  const unsigned wtop = __reduce_min_sync(0xffffffffu, key == wkey ? bk : kNone);
  unsigned* keys = s_key + parity * kMaxWarps;
  unsigned* tops = s_top + parity * kMaxWarps;
  if (lane == 0) {
    keys[warp] = wkey;
    tops[warp] = wtop;
  }
  __syncthreads();
  const unsigned k2 = lane < nwarps ? keys[lane] : 0u;
  const unsigned t2 = lane < nwarps ? tops[lane] : kNone;
  const unsigned bkey = __reduce_max_sync(0xffffffffu, k2);
  return (int)__reduce_min_sync(0xffffffffu, k2 == bkey ? t2 : kNone);
}

// a 4- or 16-byte copy into shared memory that lands by cp.async.wait_group
template <int V>
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (V == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

template <int V>
__device__ __forceinline__ void load(float (&r)[V], const float* p) {
  if constexpr (V == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    r[0] = q.x;
    r[1] = q.y;
    r[2] = q.z;
    r[3] = q.w;
  } else {
    r[0] = *p;
  }
}

// f(c) for each of this thread's chunks c (its first topic), in order:
// kChunks of them (some past K) when kChunks > 0, else as many as K takes
template <int V, int kChunks, typename F>
__device__ __forceinline__ void each_chunk(int K, F&& f) {
  if constexpr (kChunks > 0) {
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      const int c = (threadIdx.x + j * blockDim.x) * V;
      if (c < K) f(c);
    }
  } else {
    for (int c = threadIdx.x * V; c < K; c += blockDim.x * V) f(c);
  }
}

__device__ __forceinline__ float log_count(float c, const float* table, float add) {
  return c < (float)kTable ? table[(int)c] : logf(c + add);
}

// table[c] for an integer-valued c < kTable with no conversion: c + 2^23
// holds c in its low mantissa bits.  Garbage (but in the table) past it.
__device__ __forceinline__ float log_fast(float c, const float* table) {
  return table[__float_as_int(c + 8388608.f) & (kTable - 1)];
}

// One thread's best (value, topic) over its chunks: g + ((log(a + alpha) +
// log(b + beta)) - log(n_k + wbeta)), the first max in topic order.  The
// fast form reads both logs from the tables and reports in `slow` whether
// a count reached kTable; the exact form takes logf there.
template <int V, int kChunks, bool kExact>
__device__ __forceinline__ void score(const float* rd, const float* rw, const float* lnk,
                                      const float* g, const float* tab_a,
                                      const float* tab_b, float alpha, float beta, int K,
                                      float& bv, unsigned& bk, bool& slow) {
  bv = -INFINITY;
  bk = kNone;
  each_chunk<V, kChunks>(K, [&](int c) {
    float a[V], b[V], lc[V], gg[V];
    load<V>(a, rd + c);
    load<V>(b, rw + c);
    load<V>(lc, lnk + c);
    load<V>(gg, g + c);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      float la, lb;
      if constexpr (kExact) {
        la = log_count(a[e], tab_a, alpha);
        lb = log_count(b[e], tab_b, beta);
      } else {
        la = log_fast(a[e], tab_a);
        lb = log_fast(b[e], tab_b);
        slow |= fmaxf(a[e], b[e]) >= (float)kTable;
      }
      const float v = gg[e] + ((la + lb) - lc[e]);
      if (v > bv || bk == kNone) {                // k rises: the first max stays
        bv = v;
        bk = (unsigned)(c + e);
      }
    }
  });
}

// one thread's copies of a row into its chunks of a shared-memory buffer
template <int V, int kChunks>
__device__ __forceinline__ void copy_row(float* dst, const float* src, int K) {
  each_chunk<V, kChunks>(K, [&](int c) { cp_async<V>(dst + c, src + c); });
}

// kCached: the shared-memory path (else the device-memory path).  V: the
// topics of a chunk a thread owns, 4 where K % 4 == 0 and the rows lie on
// 16-byte boundaries (16-byte copies and loads), else 1.  kChunks: the
// chunks a thread owns when 1 or 2 (no loop), else 0.
template <bool kCached, int V, int kChunks>
__global__ void __launch_bounds__(kMaxThreads) gibbs_chain_kernel(
    int* __restrict__ z, float* __restrict__ n_dk, float* __restrict__ n_wk,
    float* __restrict__ n_k, const int* __restrict__ doc_ids,
    const int* __restrict__ word_ids, const float* __restrict__ noise, long long noise_t0,
    int t0, int t1, int K, float alpha, float beta, float wbeta,
    float* __restrict__ scratch) {
  extern __shared__ __align__(16) float smem[];   // tables, then the caches
  __shared__ unsigned s_key[2 * kMaxWarps], s_top[2 * kMaxWarps];
  const int tid = threadIdx.x, B = blockDim.x;
  float* tab_a = smem;
  float* tab_b = smem + kTable;
  float* cache = smem + 2 * kTable;               // [8][K] on the cached path
  float* cnk = kCached ? cache : scratch;          // n_k
  float* lnk = kCached ? cache + K : scratch + K; // logf(n_k + wbeta)
  float* drows = cache + 2 * K;                   // [2][K] n_dk rows
  float* wrows = cache + 4 * K;                   // [2][K] n_wk rows
  float* grows = cache + 6 * K;                   // [2][K] noise rows
  for (int n = tid; n < kTable; n += B) {
    tab_a[n] = logf((float)n + alpha);
    tab_b[n] = logf((float)n + beta);
  }
  each_chunk<V, kChunks>(K, [&](int c) {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float x = n_k[c + e];
      cnk[c + e] = x;
      lnk[c + e] = logf(x + wbeta);
    }
  });
  int d = __ldg(doc_ids + t0), w = __ldg(word_ids + t0), zo = z[t0];
  int dn = -1, wn = -1, zn_old = 0;
  if (t0 + 1 < t1) {
    dn = __ldg(doc_ids + t0 + 1);
    wn = __ldg(word_ids + t0 + 1);
    zn_old = z[t0 + 1];
  }
  if constexpr (kCached) {
    copy_row<V, kChunks>(drows, n_dk + (int64_t)d * K, K);
    copy_row<V, kChunks>(wrows, n_wk + (int64_t)w * K, K);
    copy_row<V, kChunks>(grows, noise + (t0 - noise_t0) * K, K);
    cp_async_commit();
  }
  __syncthreads();                                // the tables
  int cd = 0, cw = 0;                             // current row buffers
  for (int t = t0; t < t1; ++t) {
    int dnn = -1, wnn = -1, znn = 0;              // token t+2's ids, ahead
    if (t + 2 < t1) {
      dnn = __ldg(doc_ids + t + 2);
      wnn = __ldg(word_ids + t + 2);
      znn = z[t + 2];
    }
    const int slot = (t - t0) & 1;
    float* rd;
    float* rw;
    const float* g;
    if constexpr (kCached) {
      if (t + 1 < t1) {                           // token t+1's rows and noise
        if (dn != d) copy_row<V, kChunks>(drows + (cd ^ 1) * K, n_dk + (int64_t)dn * K, K);
        if (wn != w) copy_row<V, kChunks>(wrows + (cw ^ 1) * K, n_wk + (int64_t)wn * K, K);
        copy_row<V, kChunks>(grows + (slot ^ 1) * K, noise + (t + 1 - noise_t0) * K, K);
      }
      cp_async_commit();
      cp_async_wait<1>();                         // token t's copies are in
      rd = drows + cd * K;
      rw = wrows + cw * K;
      g = grows + slot * K;
    } else {
      rd = n_dk + (int64_t)d * K;
      rw = n_wk + (int64_t)w * K;
      g = noise + (t - noise_t0) * K;
    }
    float* gd = n_dk + (int64_t)d * K;
    float* gw = n_wk + (int64_t)w * K;
    if (((zo / V) & (B - 1)) == tid) {            // step 1, by z's owner
      const float a = rd[zo] - 1.f, b = rw[zo] - 1.f, x = cnk[zo] - 1.f;
      cnk[zo] = x;
      lnk[zo] = logf(x + wbeta);
      if constexpr (kCached) {
        rd[zo] = a;
        rw[zo] = b;
      }
      gd[zo] = a;
      gw[zo] = b;
    }
    float bv;
    unsigned bk;
    bool slow = false;
    score<V, kChunks, false>(rd, rw, lnk, g, tab_a, tab_b, alpha, beta, K, bv, bk, slow);
    if (__any_sync(0xffffffffu, slow))            // a count past the tables
      score<V, kChunks, true>(rd, rw, lnk, g, tab_a, tab_b, alpha, beta, K, bv, bk, slow);
    const int zn = block_argmax(bv, bk, s_key, s_top, slot);
    if (((zn / V) & (B - 1)) == tid) {            // step 4, by z''s owner
      const float a = rd[zn] + 1.f, b = rw[zn] + 1.f, x = cnk[zn] + 1.f;
      cnk[zn] = x;
      lnk[zn] = logf(x + wbeta);
      if constexpr (kCached) {
        rd[zn] = a;
        rw[zn] = b;
      }
      gd[zn] = a;
      gw[zn] = b;
      z[t] = zn;
    }
    if (dn != d) cd ^= 1;
    if (wn != w) cw ^= 1;
    d = dn;
    w = wn;
    zo = zn_old;
    dn = dnn;
    wn = wnn;
    zn_old = znn;
  }
  if constexpr (kCached) cp_async_wait<0>();
  each_chunk<V, kChunks>(K, [&](int c) {
#pragma unroll
    for (int e = 0; e < V; ++e) n_k[c + e] = cnk[c + e];
  });
}

// the Philox noise of tokens t0 .. t0+n-1: out [n, K], a row a block at a
// time over a grid of every SM
__global__ void gibbs_noise_kernel(float* __restrict__ out, uint32_t seed_lo,
                                   uint32_t seed_hi, uint32_t sweep, int t0, int n,
                                   int K) {
  for (int r = blockIdx.x; r < n; r += gridDim.x) {
    float* row = out + (int64_t)r * K;
    for (int k = threadIdx.x; k < K; k += blockDim.x)
      row[k] = gumbel(philox_first((uint32_t)k, (uint32_t)(t0 + r), sweep, 0u, seed_lo,
                                   seed_hi));
  }
}

// the chain's skeleton: T steps of the one-barrier block argmax over K
// topics, each step's values depending on the last winner
__global__ void __launch_bounds__(kMaxThreads) gibbs_reduce_floor_kernel(int* out, int T,
                                                                         int K) {
  __shared__ unsigned s_key[2 * kMaxWarps], s_top[2 * kMaxWarps];
  int prev = 0;
  for (int t = 0; t < T; ++t) {
    float bv = -INFINITY;
    unsigned bk = kNone;
    for (int k = threadIdx.x; k < K; k += blockDim.x) {
      const float v = (float)((((uint32_t)k ^ (uint32_t)prev) * 2654435761u) >> 8);
      if (v > bv || bk == kNone) {
        bv = v;
        bk = (unsigned)k;
      }
    }
    prev = block_argmax(bv, bk, s_key, s_top, t & 1) + t;
  }
  if (threadIdx.x == 0) out[0] = prev;
}

size_t cached_bytes(int K) {
  return sizeof(float) * (2 * (size_t)kTable + (size_t)kCachedFloats * K);
}

cudaError_t shared_optin(int* bytes) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return err;
}

}  // namespace

extern "C" {

// The largest K a sweep takes (any device): the device-memory path takes
// any K; this bound keeps the per-thread topic loop (64 topics a thread at
// 1024 threads) within what is tested.  Returns 0.
int gibbs_sweep_max_topics(int* topics) {
  *topics = kMaxTopics;
  return 0;
}

// The largest K of the shared-memory path on the current device: the
// tables and 8 floats a topic beside the kernel's static shared memory,
// within what a block may opt in to.  Returns the CUDA error code.
int gibbs_sweep_cached_topics(int* topics) {
  int optin = 0;
  cudaError_t err = shared_optin(&optin);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, gibbs_chain_kernel<true, 1, 0>);
  if (err == cudaSuccess)
    *topics = (int)(((size_t)optin - attr.sharedSizeBytes - cached_bytes(0)) /
                    (sizeof(float) * kCachedFloats));
  return (int)err;
}

// Launches the chain over tokens [t0, t1) on `stream` with `threads`
// threads (a power of two from 32 to 1024), in place on z [T] (int32),
// n_dk [D, K], n_wk [W, K] and n_k [K] (float32), over doc_ids [T] and
// word_ids [T] (int32); noise row t is noise + (t - noise_t0) * K.
// `scratch` holds 2K floats (the device-memory path's n_k and logs).  Ids
// and z must be in range: the kernel reads them unchecked.  Allocates
// nothing.  Returns the CUDA error code of the launch (0 on success).
int gibbs_sweep(int* z, float* n_dk, float* n_wk, float* n_k, const int* doc_ids,
                const int* word_ids, const float* noise, long long noise_t0, int t0, int t1,
                int K, float alpha, float beta, float wbeta, float* scratch, int threads,
                void* stream) {
  if (K < 1 || K > kMaxTopics || t0 < 0 || t1 < t0 || threads < kWarp ||
      threads > kMaxThreads || (threads & (threads - 1)))
    return (int)cudaErrorInvalidValue;
  if (t1 == t0) return 0;
  int cached = 0;
  cudaError_t err = (cudaError_t)gibbs_sweep_cached_topics(&cached);
  if (err != cudaSuccess) return (int)err;
  const bool use_cache = K <= cached;
  const size_t smem = use_cache ? cached_bytes(K) : cached_bytes(0);
  const bool vec = K % 4 == 0 && (((uintptr_t)n_dk | (uintptr_t)n_wk | (uintptr_t)n_k |
                                   (uintptr_t)noise | (uintptr_t)scratch) & 15) == 0;
  const int chunks = (K + (vec ? 4 : 1) * threads - 1) / ((vec ? 4 : 1) * threads);
  auto kernel = gibbs_chain_kernel<false, 1, 0>;
  if (use_cache && vec)
    kernel = chunks == 1   ? gibbs_chain_kernel<true, 4, 1>
             : chunks == 2 ? gibbs_chain_kernel<true, 4, 2>
                           : gibbs_chain_kernel<true, 4, 0>;
  else if (use_cache)
    kernel = chunks == 1 ? gibbs_chain_kernel<true, 1, 1> : gibbs_chain_kernel<true, 1, 0>;
  else if (vec)
    kernel = gibbs_chain_kernel<false, 4, 0>;
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<1, threads, smem, (cudaStream_t)stream>>>(z, n_dk, n_wk, n_k, doc_ids, word_ids,
                                                     noise, noise_t0, t0, t1, K, alpha,
                                                     beta, wbeta, scratch);
  return (int)cudaGetLastError();
}

// Launches the Philox pre-pass on `stream`: out [n, K] float32 receives
// the noise of tokens t0 .. t0+n-1 for (seed_lo, seed_hi, sweep), as the
// note above says; a grid of up to 8 blocks an SM.  Returns the CUDA error
// code of the launch.
int gibbs_noise(float* out, unsigned seed_lo, unsigned seed_hi, unsigned sweep, int t0,
                int n, int K, int sms, void* stream) {
  if (K < 1 || n < 0 || t0 < 0 || sms < 1) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int blocks = n < 8 * sms ? n : 8 * sms;
  const int threads = K < 256 ? ((K + kWarp - 1) / kWarp) * kWarp : 256;
  gibbs_noise_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(out, seed_lo, seed_hi,
                                                                   sweep, t0, n, K);
  return (int)cudaGetLastError();
}

// Launches the chain's skeleton (see the note above): T steps of the
// one-barrier block argmax over K topics with `threads` threads; out [1]
// int32 receives the last winner.  Returns the CUDA error code.
int gibbs_reduce_floor(int* out, int T, int K, int threads, void* stream) {
  if (K < 1 || T < 0 || threads < kWarp || threads > kMaxThreads || (threads & (threads - 1)))
    return (int)cudaErrorInvalidValue;
  gibbs_reduce_floor_kernel<<<1, threads, 0, (cudaStream_t)stream>>>(out, T, K);
  return (int)cudaGetLastError();
}

const char* gibbs_sweep_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
