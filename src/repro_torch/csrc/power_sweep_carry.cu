// Carry-resident selective sweep, serving and training modes, for Hopper
// (sm_90a).
//
// Replaces the two TPU kernels of the JAX package
// src/repro/kernels/power_sweep/kernel.py:363 (power_sweep_carry_tokens) and
// :523 (power_sweep_carry_kblocked_tokens), in both of their modes.  Each
// computes one Jacobi sweep over the token-major [T, K] message carry
// (tokens doc-contiguous, doc_ids non-decreasing), count c, document d:
//
//   serving (the reference's update_phi=False): phi fixed, a token is
//   active when p = p_tok[t] is a row of phi in [0, n_rows) and not n_guard;
//   every topic k of an active token is updated:
//     u_k   = (theta[d,k] - c*mu[t,k] + alpha) * (phi[p,k] + beta)
//             / (phi_tot[k] + wbeta)
//     mu'_k = u_k * (sum_k mu[t,k]) / max(sum_k u_k, 1e-30)
//     cd_k  = c * (mu'_k - mu[t,k])
//     theta_delta[d,k] = sum over the doc's tokens of cd_k
//     rdoc[d]          = sum over the doc's tokens and k of |cd_k|
//
//   training (the reference's update_phi=True followed by the take_along_axis
//   of src/repro/core/pobp.py:424-425): a token is a power token when
//   p = p_tok[t] is in [0, P); it reads its word w = sel_w[p] and its Pk
//   topics k_j = sel_k[p, j] (distinct within a row, as top-k gives) and
//   nothing else; the token's own count is left out of phi and phi_tot:
//     m_j   = mu[t,k_j],  cm = c*m_j
//     u_j   = (theta[d,k_j] - cm + alpha) * (phi[w,k_j] - cm + beta)
//             / (phi_tot[k_j] - cm + wbeta)
//     m'_j  = u_j * (sum_j m_j) / max(sum_j u_j, 1e-30)
//     cd_j  = c * (m'_j - m_j);  mu[t,k_j] = m'_j
//     theta_delta[d,k_j] += cd_j;  d_pack[p,j] += cd_j;  r_pack[p,j] += |cd_j|
//   A guard token (any id outside [0, P)) reads and writes nothing, and mu
//   outside each power token's Pk topics stays bit for bit as it was.
//
// Both modes read theta as it was at the start of the sweep and never write
// it; the caller forms theta + theta_delta.  mu is updated IN PLACE: every
// element is read and written by one thread.
//
// Serving design.  Bound: at the slab's shapes (T = 4096, D = 64, K = 2000,
// W' = 141044 rows) the sweep must read and write each active token's mu
// row and read each distinct phi row it names, ~61 MB with the small
// arrays, 18 us at 3.35 TB/s; ~14 f32 operations per element are ~2 us at
// 67 TFLOP/s: bound by bytes.  So the design keeps the card's memory busy:
//   - each slot is a cluster of kCluster = 4 CTAs (256 CTAs at D = 64 on
//     132 SMs); rank r takes the slot's tokens t0 + r, t0 + r + 4, ...;
//   - the CTA walks its tokens one at a time, every thread owning fixed
//     topics (4V of them, V float4s: 256 threads x 8 at K = 2000).  A
//     thread keeps its slice of the token's mu and phi rows in registers
//     from the load through the sums to the write, so each row is read
//     once; the next active token's rows are loaded while the current
//     one's sums are reduced across the CTA (one __syncthreads a token);
//   - 16-byte loads and stores where K % 4 == 0 and mu, theta and phi lie
//     on 16-byte boundaries, else a scalar path in the same kernel;
//   - each thread sums theta_delta at its own topics in registers, so no
//     [K] row per warp is needed.  At the end each CTA puts its partial
//     in shared memory, and CTA r of the cluster sums the four partials of
//     its quarter of the topics in rank order through distributed shared
//     memory (cooperative_groups::this_cluster().map_shared_rank); rank 0
//     sums rdoc the same way.  Every sum runs in a fixed order, so mu',
//     theta_delta and rdoc repeat bit for bit from launch to launch.
//   Shared memory: theta[d] and phi_tot + wbeta at the owned topics, 2 x
//   threads x 4V floats (16 KB at K = 2000); the partials reuse it.
//   The register path holds K <= 2 x 4 x 256 = 2048 topics (V = 1 or 2
//   float4s a thread, 256 threads), which covers the K = 2000 cell.  Past
//   that a K-blocked path, the two passes of TPU kernel 4, serves any K:
//   the same clusters and token order; pass one streams the token's rows
//   to sum u and mu, pass two streams them again (from L2) for the update;
//   theta_delta's partials go to a [4D, K] scratch in global memory, one
//   row a CTA, summed in rank order, so it too repeats bit for bit.  Its
//   bound at K = 10,000 (the slab's shapes, W' = 141044 rows) is ~0.09 ms,
//   bound by bytes.  The wrapper's serve_launch_plan(K)
//   (kernels/power_sweep/ops.py) takes the register path up to K = 2048
//   and the K-blocked path with 256 threads past it; chip_smoke.py phase 2
//   times both paths at the slab's shapes (K = 2000 and 10,000).
//
// Training design.  Bound: at the training slice's shapes (T = 65536 slots
// of D = 512 documents, K = 2000, P = 14104, Pk = 50, ~70% power tokens) the
// sweep must read sel_w, sel_k and phi at the Pk topics of each distinct
// power word (~5.5 MB), read and write each power token's mu at its Pk
// topics (18.4 MB), read theta at the selected (document, topic) pairs
// (<= 4.1 MB) and write theta_delta (4.1 MB), write d_pack and r_pack
// (5.6 MB) and read the per-token ids and counts (0.8 MB): ~38 MB, ~12 us
// at 3.35 TB/s; ~30 f32 operations per (token, topic) are ~1 us.  But each
// (token, topic) element of mu and phi lies in a 32-byte sector of its own
// at a random place in HBM (8x the bytes counted), so what bounds the sweep
// is the rate of scattered requests, above all mu's: so each input of an
// element is read once, and the work per token is Pk elements, never K:
//   - one CTA per document, 8 warps; the document's theta row is read once,
//     whole (16-byte loads where aligned), into shared memory.  Warps take
//     the document's tokens t0 + warp, t0 + warp + 8, ... with no barrier
//     between them; a guard token reads and writes nothing;
//   - a power token's update is one pass by its warp: a lane holds its
//     topics j = lane + 32 i (i < J = ceil(Pk / 32) <= 4, a template
//     argument, so each J is a kernel of its own name) in registers from
//     the loads of k_j, mu, phi_tot and phi through the two warp sums to
//     the writes of mu' and cd.  A lane adds its topics in ascending j and
//     the warp sums by the same butterfly as the strided loop, so u, the
//     sums and mu' are that loop's bits.  Scattered requests an element:
//     mu, phi_tot and phi read once and mu written once, theta from shared
//     memory (before: mu, theta, phi_tot and phi read twice, two passes,
//     and mu written: 8 loads and a store).  Past Pk = 128 (J = 0) lanes
//     stride over the topics in two passes, as before, theta still from
//     shared memory;
//   - theta_delta stays deterministic: each power token's cd [Pk] goes to a
//     token-indexed [T, Pk] scratch (coalesced, 9.2 MB at these shapes);
//     after the last token and one barrier the shared theta row is zeroed
//     and becomes theta_delta[d], and warp 0 adds the document's cd rows
//     into it in token order, read back from L2 (the loads of a few tokens
//     in flight before their adds), so each topic's sum runs in token
//     order, as when warp 0 added each round's staged rows;
//   - d_pack and r_pack are sums over each power row's tokens, taken in one
//     fixed order with no atomics, so they repeat bit for bit from launch to
//     launch: a second kernel (carry_dr_fold_kernel) adds the cd rows of
//     the tokens of the run of each power row's word sel_w[p], in the sweep
//     order the caller made once per mini-batch (TokenLayout.word_runs:
//     counted tokens sorted by word, stable, so by token index within a
//     word; starts[w] .. starts[w + 1] is the run of word w).  Under the
//     Zipf word law of the training cells the head word is in almost every
//     document, so a run reaches ~D tokens (4045 of D = 4096): one warp
//     walking it token by token, a dependent order -> cd load each, took
//     1.05 ms of a 4.9 ms iteration on an H100, ~0.26 us a token.  So no
//     warp sums more than kFoldChunk = 64 tokens: a run of at most 64 is
//     summed whole by its row's warp; a longer one is cut into chunks of 64
//     (TokenLayout.word_chunks, made once per mini-batch: `split`, each
//     chunk's first run position), one warp a chunk, whose partials the
//     row's last chunk warp (a counter a row, left at 0 for the next launch)
//     adds in chunk order.  A warp reads its chunk's tokens once, one or
//     two a lane, and keeps 16 tokens' cd loads in flight; lanes own Pk
//     topics in passes of 64.  Every element of a chunk is added in run
//     order and the partials in chunk order, so the sums still repeat bit
//     for bit; every row is written (a run with no token as zeros), so the
//     buffers need no zeroing.  Tokens of count 0 are outside the runs:
//     their cd is exactly 0.  The fold reads the power tokens' cd once
//     more and writes the [P, Pk] buffers; the chunks' partials (2 x chunks
//     x Pk floats, ~0.9 MB at the training cells' shapes) pass through L2.
//   Measured on an H100 (80 GB HBM3, 700 W) on the training cells' own
//   inputs (D = 4096, K = 2000 and D = 2048, K = 10,000; L = 128, Pk = 50;
//   460k and 239k power slots, about half of them the count-0 padding of
//   power row 0): 1.87-1.92 -> 1.49-1.52 ms a launch at K = 2000 and
//   2.18 -> 1.24 ms at K = 10,000, every output bit for bit the two-pass
//   kernel's.  What is left is mu: with phi and phi_tot not loaded 1.39 /
//   1.11 ms, with mu not stored 0.87 / 0.66 ms; 32- or 128-byte L2 fetches,
//   L2 evict-first on mu or evict-last on phi, and the next token's indices
//   loaded ahead ran no faster.  The K gap: theta read from global memory
//   instead of shared took 1.61 / 1.38 ms (+2% / +11%), so the L1 that the
//   [K] rows left free covered theta at K = 2000 and not at 10,000; the
//   rest of the gap is mu's own (0.060 / 0.093 ns an update with only mu
//   loaded), where a document's rows span 5 MB at K = 10,000 and 1 MB at
//   K = 2000: 8 CTAs of 4 warps an SM (more documents in flight) took 1.53
//   ms at K = 10,000 and 2 of 16 warps 1.21 ms, at K = 2000 1.54 / 1.55.
//   Layout: theta alone in shared memory during the sweep, then the same
//   row as the accumulator (above), chosen over both rows side by side
//   (16 KB at K = 2000, 80 KB and 2 CTAs an SM at K = 10,000), which took
//   1.45-1.55 / 1.26 ms at the cells' share and 0.83-0.87 / 0.82-0.83 ms
//   with the padding made guard tokens (this layout: 0.81-0.83 /
//   0.68-0.69 ms).
//   Occupancy: __launch_bounds__(256, 4) (<= 64 registers, no spill at any
//   J); 4 CTAs an SM at both cells' K (8 / 40 KB of shared memory), and
//   shared memory padded to hold 3 or 2 CTAs an SM ran 21-36% slower.
//   Limit: K floats of shared memory whatever Pk, within what a block may
//   opt in to (232,448 B on an H100: K <= 58,112; before, K + 2 x warps x
//   Pk floats less 64 B); theta always fits where the sweep runs.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarp = 32;
constexpr int kCluster = 4;          // CTAs per serving slot
constexpr int kTrainWarps = 8;       // training sweep: warps a CTA
constexpr int kTrainMaxJ = 4;        // training sweep: most topics a lane holds
constexpr int kFoldWarps = 8;        // d/r fold: warps a CTA
constexpr int kFoldChunk = 64;       // d/r fold: the most tokens a warp sums
constexpr int kFoldAhead = 16;       // d/r fold: tokens' loads in flight

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

// ------------------------------------------------------------------ serving

// the first active token among t, t + kCluster, ... below t1 (t1 if none)
__device__ __forceinline__ int next_active(const int* __restrict__ p_tok, int t,
                                           int t1, int n_rows, int n_guard) {
  for (; t < t1; t += kCluster) {
    const int p = __ldg(p_tok + t);
    if (p != n_guard && p >= 0 && p < n_rows) return t;
  }
  return t1;
}

// this thread's slice of a token's mu and phi rows: topics 4*(i*nt + tid) + e
template <int V, bool kVec>
__device__ __forceinline__ void load_slice(const float* mu_row,
                                           const float* __restrict__ ph_row, int K,
                                           float (&m)[4 * V], float (&ph)[4 * V]) {
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int k = 4 * (i * (int)blockDim.x + (int)threadIdx.x);
    if (kVec) {
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
      if (k < K) {
        a = __ldcs(reinterpret_cast<const float4*>(mu_row + k));
        b = __ldg(reinterpret_cast<const float4*>(ph_row + k));
      }
      m[4 * i] = a.x; m[4 * i + 1] = a.y; m[4 * i + 2] = a.z; m[4 * i + 3] = a.w;
      ph[4 * i] = b.x; ph[4 * i + 1] = b.y; ph[4 * i + 2] = b.z; ph[4 * i + 3] = b.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        m[4 * i + e] = k + e < K ? __ldcs(mu_row + k + e) : 0.f;
        ph[4 * i + e] = k + e < K ? __ldg(ph_row + k + e) : 0.f;
      }
    }
  }
}

// sums a and b over the CTA in a fixed order; every thread gets the sums
__device__ __forceinline__ void block_sum2(float& a, float& b, float (*red)[32]) {
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int nw = blockDim.x / kWarp;
  a = warp_sum(a);
  b = warp_sum(b);
  if (lane == 0) {
    red[0][warp] = a;
    red[1][warp] = b;
  }
  __syncthreads();
  a = 0.f;
  b = 0.f;
  for (int w = 0; w < nw; ++w) {
    a += red[0][w];
    b += red[1][w];
  }
}

template <int V, bool kVec>
__global__ void __launch_bounds__(512) carry_serve_kernel(
    const int* __restrict__ p_tok, const int* __restrict__ doc_ids,
    const float* __restrict__ counts, float* mu, const float* __restrict__ theta,
    const float* __restrict__ phi_tot, const float* __restrict__ phi,
    float* __restrict__ theta_delta, float* __restrict__ rdoc, int T, int K,
    int n_rows, int n_guard, float alpha, float beta, float wbeta) {
  extern __shared__ float4 smem4[];
  __shared__ float red[2][2][32];   // [buffer][sum][warp]
  __shared__ float r_cta;
  cg::cluster_group cluster = cg::this_cluster();
  const int nt = blockDim.x, tid = threadIdx.x;
  const int span = nt * V;                    // float4s of one [>= K] row
  float4* th_s = smem4;                       // theta[d] at the owned topics
  float4* pt_s = smem4 + span;                // phi_tot + wbeta
  const int rank = (int)cluster.block_rank();
  const int d = blockIdx.x / kCluster;
  const float* th_row = theta + (size_t)d * K;
  float* th_f = reinterpret_cast<float*>(th_s);
  float* pt_f = reinterpret_cast<float*>(pt_s);
  for (int k = tid; k < 4 * span; k += nt) {
    th_f[k] = k < K ? th_row[k] : 0.f;
    pt_f[k] = k < K ? phi_tot[k] + wbeta : 1.f;
  }
  const int t0 = lower_bound(doc_ids, T, d);
  const int t1 = lower_bound(doc_ids, T, d + 1);
  __syncthreads();

  float acc[4 * V], m[4 * V], u[4 * V];
#pragma unroll
  for (int j = 0; j < 4 * V; ++j) acc[j] = m[j] = u[j] = 0.f;
  float r = 0.f;
  int t = next_active(p_tok, t0 + rank, t1, n_rows, n_guard);
  if (t < t1)
    load_slice<V, kVec>(mu + (size_t)t * K, phi + (size_t)__ldg(p_tok + t) * K, K, m, u);
  int buf = 0;
  while (t < t1) {                            // uniform over the CTA
    const float c = __ldg(counts + t);
    // the next token's rows are in flight while this one is reduced
    const int tn = next_active(p_tok, t + kCluster, t1, n_rows, n_guard);
    float nm[4 * V], nph[4 * V];
#pragma unroll
    for (int j = 0; j < 4 * V; ++j) nm[j] = nph[j] = 0.f;
    if (tn < t1)
      load_slice<V, kVec>(mu + (size_t)tn * K, phi + (size_t)__ldg(p_tok + tn) * K, K,
                          nm, nph);
    float su = 0.f, sm = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float4 th4 = th_s[i * nt + tid], pt4 = pt_s[i * nt + tid];
      const float th[4] = {th4.x, th4.y, th4.z, th4.w};
      const float pt[4] = {pt4.x, pt4.y, pt4.z, pt4.w};
      const int k = 4 * (i * nt + tid);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 4 * i + e;
        u[j] = k + e < K ? (th[e] - c * m[j] + alpha) * (u[j] + beta) / pt[e] : 0.f;
        su += u[j];
        sm += m[j];
      }
    }
    block_sum2(su, sm, red[buf]);
    buf ^= 1;                                 // the other buffer next token
    const float scale = sm / fmaxf(su, 1e-30f);
    float* mu_row = mu + (size_t)t * K;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int k = 4 * (i * nt + tid);
      float mn[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 4 * i + e;
        mn[e] = u[j] * scale;
        const float cd = c * (mn[e] - m[j]);
        acc[j] += cd;
        r += fabsf(cd);
      }
      if (kVec) {
        if (k < K)
          __stcs(reinterpret_cast<float4*>(mu_row + k),
                 make_float4(mn[0], mn[1], mn[2], mn[3]));
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k + e < K) __stcs(mu_row + k + e, mn[e]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4 * V; ++j) {
      m[j] = nm[j];
      u[j] = nph[j];
    }
    t = tn;
  }

  // this CTA's partials: theta_delta at the owned topics, and its residual
  __syncthreads();                            // th_s is read no more
#pragma unroll
  for (int i = 0; i < V; ++i)
    th_s[i * nt + tid] = make_float4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2],
                                     acc[4 * i + 3]);
  r = warp_sum(r);
  if (tid % kWarp == 0) red[0][0][tid / kWarp] = r;
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int w = 0; w < nt / kWarp; ++w) s += red[0][0][w];
    r_cta = s;
  }
  cluster.sync();                             // every partial is visible

  // CTA `rank` sums its quarter of the topics over the cluster, in rank order
  const int per = (K + kCluster - 1) / kCluster;
  const int k_hi = min(K, (rank + 1) * per);
  for (int k = rank * per + tid; k < k_hi; k += nt) {
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < kCluster; ++q) s += cluster.map_shared_rank(th_f, q)[k];
    theta_delta[(size_t)d * K + k] = s;
  }
  if (rank == 0 && tid == 0) {
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < kCluster; ++q) s += *cluster.map_shared_rank(&r_cta, q);
    rdoc[d] = s;
  }
  cluster.sync();                             // no CTA leaves while read
}

template <int V, bool kVec>
cudaError_t launch_serve(int threads, int D, const int* p_tok, const int* doc_ids,
                         const float* counts, float* mu, const float* theta,
                         const float* phi_tot, const float* phi, float* theta_delta,
                         float* rdoc, int T, int K, int n_rows, int n_guard,
                         float alpha, float beta, float wbeta, cudaStream_t stream) {
  const int smem = 2 * threads * V * (int)sizeof(float4);
  auto kernel = carry_serve_kernel<V, kVec>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(D * kCluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, p_tok, doc_ids, counts, mu, theta, phi_tot,
                            phi, theta_delta, rdoc, T, K, n_rows, n_guard, alpha,
                            beta, wbeta);
}

// The K-blocked serving path, for K past what the register path holds: the
// two passes of TPU kernel 4 over each active token.  Pass one sums u and
// mu over the token's whole row; pass two reads the row again (from L2),
// writes mu' and adds c * (mu' - mu) into this CTA's own theta_delta partial
// row in global scratch (`part`, [D * kCluster, K]).  A thread owns the same
// topics in both passes and in the partial row, so nothing there is shared.
// At the end CTA `rank` sums its quarter of the topics over the cluster's
// four partial rows in rank order, and rank 0 sums rdoc through distributed
// shared memory, as the register path does: a launch repeats bit for bit.
__device__ __forceinline__ float serve_u(float th, float m, float c, float ph, float pt,
                                         float alpha, float beta) {
  return (th - c * m + alpha) * (ph + beta) / pt;
}

template <bool kVec>
__global__ void __launch_bounds__(512) carry_serve_kblocked_kernel(
    const int* __restrict__ p_tok, const int* __restrict__ doc_ids,
    const float* __restrict__ counts, float* mu, const float* __restrict__ theta,
    const float* __restrict__ phi_tot, const float* __restrict__ phi,
    float* __restrict__ theta_delta, float* __restrict__ rdoc, float* part, int T,
    int K, int n_rows, int n_guard, float alpha, float beta, float wbeta) {
  __shared__ float red[2][2][32];   // [buffer][sum][warp]
  __shared__ float r_cta;
  cg::cluster_group cluster = cg::this_cluster();
  const int nt = blockDim.x, tid = threadIdx.x;
  const int rank = (int)cluster.block_rank();
  const int d = blockIdx.x / kCluster;
  const float* th_row = theta + (size_t)d * K;
  float* acc = part + (size_t)blockIdx.x * K;  // this CTA's partial row
  const int n4 = kVec ? K / 4 : K;            // owned units: float4s or floats
  for (int i = tid; i < n4; i += nt) {
    if (kVec) reinterpret_cast<float4*>(acc)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    else acc[i] = 0.f;
  }
  const int t0 = lower_bound(doc_ids, T, d);
  const int t1 = lower_bound(doc_ids, T, d + 1);
  float r = 0.f;
  int buf = 0;
  for (int t = next_active(p_tok, t0 + rank, t1, n_rows, n_guard); t < t1;
       t = next_active(p_tok, t + kCluster, t1, n_rows, n_guard)) {
    const float c = __ldg(counts + t);
    float* mu_row = mu + (size_t)t * K;
    const float* ph_row = phi + (size_t)__ldg(p_tok + t) * K;
    float su = 0.f, sm = 0.f;
    // pass one: the sums over the whole row
#pragma unroll 4
    for (int i = tid; i < n4; i += nt) {
      if (kVec) {
        const float4 m = reinterpret_cast<const float4*>(mu_row)[i];
        const float4 ph = __ldg(reinterpret_cast<const float4*>(ph_row) + i);
        const float4 th = __ldg(reinterpret_cast<const float4*>(th_row) + i);
        const float4 pt = __ldg(reinterpret_cast<const float4*>(phi_tot) + i);
        su += serve_u(th.x, m.x, c, ph.x, pt.x + wbeta, alpha, beta);
        su += serve_u(th.y, m.y, c, ph.y, pt.y + wbeta, alpha, beta);
        su += serve_u(th.z, m.z, c, ph.z, pt.z + wbeta, alpha, beta);
        su += serve_u(th.w, m.w, c, ph.w, pt.w + wbeta, alpha, beta);
        sm += (m.x + m.y) + (m.z + m.w);
      } else {
        const float m = mu_row[i];
        su += serve_u(__ldg(th_row + i), m, c, __ldg(ph_row + i),
                            __ldg(phi_tot + i) + wbeta, alpha, beta);
        sm += m;
      }
    }
    block_sum2(su, sm, red[buf]);
    buf ^= 1;                                 // the other buffer next token
    const float scale = sm / fmaxf(su, 1e-30f);
    // pass two: the row again, the update, theta_delta's partial
#pragma unroll 4
    for (int i = tid; i < n4; i += nt) {
      if (kVec) {
        const float4 m = reinterpret_cast<const float4*>(mu_row)[i];
        const float4 ph = __ldg(reinterpret_cast<const float4*>(ph_row) + i);
        const float4 th = __ldg(reinterpret_cast<const float4*>(th_row) + i);
        const float4 pt = __ldg(reinterpret_cast<const float4*>(phi_tot) + i);
        float4 mn, a = reinterpret_cast<float4*>(acc)[i];
        mn.x = serve_u(th.x, m.x, c, ph.x, pt.x + wbeta, alpha, beta) * scale;
        mn.y = serve_u(th.y, m.y, c, ph.y, pt.y + wbeta, alpha, beta) * scale;
        mn.z = serve_u(th.z, m.z, c, ph.z, pt.z + wbeta, alpha, beta) * scale;
        mn.w = serve_u(th.w, m.w, c, ph.w, pt.w + wbeta, alpha, beta) * scale;
        const float4 cd = make_float4(c * (mn.x - m.x), c * (mn.y - m.y),
                                      c * (mn.z - m.z), c * (mn.w - m.w));
        a.x += cd.x; a.y += cd.y; a.z += cd.z; a.w += cd.w;
        r += (fabsf(cd.x) + fabsf(cd.y)) + (fabsf(cd.z) + fabsf(cd.w));
        reinterpret_cast<float4*>(acc)[i] = a;
        reinterpret_cast<float4*>(mu_row)[i] = mn;
      } else {
        const float m = mu_row[i];
        const float mn = serve_u(__ldg(th_row + i), m, c, __ldg(ph_row + i),
                                       __ldg(phi_tot + i) + wbeta, alpha, beta) * scale;
        const float cd = c * (mn - m);
        acc[i] += cd;
        r += fabsf(cd);
        mu_row[i] = mn;
      }
    }
  }

  __syncthreads();                            // red[0] may still be read
  r = warp_sum(r);
  if (tid % kWarp == 0) red[0][0][tid / kWarp] = r;
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int w = 0; w < nt / kWarp; ++w) s += red[0][0][w];
    r_cta = s;
  }
  __threadfence();                            // the partial rows reach L2
  cluster.sync();                             // every partial is visible

  // CTA `rank` sums its quarter of the topics over the cluster, in rank order
  const int per = (K + kCluster - 1) / kCluster;
  const int k_hi = min(K, (rank + 1) * per);
  const float* rows = part + (size_t)d * kCluster * K;
  for (int k = rank * per + tid; k < k_hi; k += nt) {
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < kCluster; ++q) s += __ldcg(rows + (size_t)q * K + k);
    theta_delta[(size_t)d * K + k] = s;
  }
  if (rank == 0 && tid == 0) {
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < kCluster; ++q) s += *cluster.map_shared_rank(&r_cta, q);
    rdoc[d] = s;
  }
  cluster.sync();                             // no CTA leaves while read
}

template <bool kVec>
cudaError_t launch_serve_kblocked(int threads, int D, const int* p_tok,
                                  const int* doc_ids, const float* counts, float* mu,
                                  const float* theta, const float* phi_tot,
                                  const float* phi, float* theta_delta, float* rdoc,
                                  float* part, int T, int K, int n_rows, int n_guard,
                                  float alpha, float beta, float wbeta,
                                  cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(D * kCluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, carry_serve_kblocked_kernel<kVec>, p_tok, doc_ids,
                            counts, mu, theta, phi_tot, phi, theta_delta, rdoc, part, T,
                            K, n_rows, n_guard, alpha, beta, wbeta);
}

// One serving launch by the caller's plan: V = 1 or 2 float4s a thread on
// the register path (4 * V * threads >= K), V = 0 the K-blocked path.
template <bool kVec>
cudaError_t dispatch_serve(int V, int threads, int D, const int* p_tok,
                           const int* doc_ids, const float* counts, float* mu,
                           const float* theta, const float* phi_tot, const float* phi,
                           float* theta_delta, float* rdoc, float* part, int T, int K,
                           int n_rows, int n_guard, float alpha, float beta,
                           float wbeta, cudaStream_t stream) {
  switch (V) {
    case 0:
      return launch_serve_kblocked<kVec>(threads, D, p_tok, doc_ids, counts, mu, theta,
                                         phi_tot, phi, theta_delta, rdoc, part, T, K,
                                         n_rows, n_guard, alpha, beta, wbeta, stream);
    case 1:
      return launch_serve<1, kVec>(threads, D, p_tok, doc_ids, counts, mu, theta,
                                   phi_tot, phi, theta_delta, rdoc, T, K, n_rows,
                                   n_guard, alpha, beta, wbeta, stream);
    case 2:
      return launch_serve<2, kVec>(threads, D, p_tok, doc_ids, counts, mu, theta,
                                   phi_tot, phi, theta_delta, rdoc, T, K, n_rows,
                                   n_guard, alpha, beta, wbeta, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// ----------------------------------------------------------------- training

__device__ __forceinline__ float update_u(float th, float pt, float m, float c, float ph,
                                          float alpha, float beta, float wbeta) {
  const float cm = c * m;
  return (th - cm + alpha) * (ph - cm + beta) / (pt - cm + wbeta);
}

// One power token's update by its warp, its topics j = lane + 32 i (i < J)
// held in registers from the loads through the two warp sums to the writes:
// each input of a (token, topic) element is read once.  th_s is theta[d] in
// shared memory.  A lane adds its topics in ascending j, then the butterfly,
// so u, the sums and mu' are the strided loop's bits.
template <int J>
__device__ __forceinline__ void train_token(const int* __restrict__ ks,
                                            const float* __restrict__ ph, float* mu_t,
                                            const float* th_s,
                                            const float* __restrict__ phi_tot,
                                            float* co, float c, int Pk, float alpha,
                                            float beta, float wbeta) {
  const int lane = threadIdx.x % kWarp;
  int k[J];
  float m[J], th[J], pt[J], pw[J], u[J];
#pragma unroll
  for (int i = 0; i < J; ++i) k[i] = lane + kWarp * i < Pk ? __ldg(ks + lane + kWarp * i) : 0;
#pragma unroll
  for (int i = 0; i < J; ++i) {
    m[i] = th[i] = pt[i] = pw[i] = 0.f;
    if (lane + kWarp * i < Pk) {
      m[i] = mu_t[k[i]];
      pt[i] = __ldg(phi_tot + k[i]);
      pw[i] = __ldg(ph + k[i]);
      th[i] = th_s[k[i]];
    }
  }
  float su = 0.f, sm = 0.f;
#pragma unroll
  for (int i = 0; i < J; ++i) {
    u[i] = 0.f;
    if (lane + kWarp * i < Pk) {
      u[i] = update_u(th[i], pt[i], m[i], c, pw[i], alpha, beta, wbeta);
      su += u[i];
      sm += m[i];
    }
  }
  su = warp_sum(su);
  sm = warp_sum(sm);
  const float denom = fmaxf(su, 1e-30f);
#pragma unroll
  for (int i = 0; i < J; ++i) {
    const int j = lane + kWarp * i;
    if (j < Pk) {
      const float mn = u[i] * sm / denom;
      mu_t[k[i]] = mn;
      co[j] = c * (mn - m[i]);
    }
  }
}

// The same update for any Pk (past kTrainMaxJ * 32 topics): lanes stride
// over the topics twice, the sums first, then the update, reading the
// token's inputs again.
__device__ __forceinline__ void train_token_loop(const int* __restrict__ ks,
                                                 const float* __restrict__ ph,
                                                 float* mu_t, const float* th_s,
                                                 const float* __restrict__ phi_tot,
                                                 float* co, float c, int Pk,
                                                 float alpha, float beta, float wbeta) {
  const int lane = threadIdx.x % kWarp;
  float su = 0.f, sm = 0.f;
  for (int j = lane; j < Pk; j += kWarp) {
    const int k = __ldg(ks + j);
    const float m = mu_t[k];
    su += update_u(th_s[k], __ldg(phi_tot + k), m, c, __ldg(ph + k), alpha, beta, wbeta);
    sm += m;
  }
  su = warp_sum(su);
  sm = warp_sum(sm);
  const float denom = fmaxf(su, 1e-30f);
  for (int j = lane; j < Pk; j += kWarp) {
    const int k = __ldg(ks + j);
    const float m = mu_t[k];
    const float mn = update_u(th_s[k], __ldg(phi_tot + k), m, c, __ldg(ph + k), alpha,
                              beta, wbeta) * sm / denom;
    mu_t[k] = mn;
    co[j] = c * (mn - m);
  }
}

// acc[k] += the cd rows of the power tokens t0 .. t1 - 1 at their topics, by
// one warp, token after token: a token's topics are distinct, so its adds
// run at once, and each topic's adds run in token order.  The topics and cd
// of G tokens are loaded before their adds; cd was written by this CTA's
// warps before a barrier, so it is read from L2.
template <int J>
__device__ __forceinline__ void fold_theta_delta(float* acc, const int* __restrict__ p_tok,
                                                 const int* __restrict__ sel_k,
                                                 const float* cd, int t0, int t1, int P,
                                                 int Pk) {
  constexpr int JJ = J > 0 ? J : 1;
  constexpr int G = J > 0 ? (J > 2 ? 2 : 8 / J) : 1;
  const int lane = threadIdx.x % kWarp;
  for (int base = t0; base < t1; base += kWarp) {
    const int n = min(kWarp, t1 - base);
    int p = lane < n ? __ldg(p_tok + base + lane) : -1;
    if (p < 0 || p >= P) p = -1;
    for (int s = 0; s < n; s += G) {
      if constexpr (J > 0) {
        int k[G][JJ];
        float v[G][JJ];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const int q = __shfl_sync(0xffffffffu, p, (s + g) % kWarp);
          const bool on = s + g < n && q >= 0;
          const int* ks = sel_k + (size_t)max(q, 0) * Pk;
          const float* row = cd + (size_t)(base + s + g) * Pk;
#pragma unroll
          for (int i = 0; i < J; ++i) {
            const int j = lane + kWarp * i;
            k[g][i] = on && j < Pk ? __ldg(ks + j) : -1;
            v[g][i] = on && j < Pk ? __ldcg(row + j) : 0.f;
          }
        }
#pragma unroll
        for (int g = 0; g < G; ++g) {
#pragma unroll
          for (int i = 0; i < J; ++i)
            if (k[g][i] >= 0) acc[k[g][i]] += v[g][i];
          __syncwarp();                       // the next token may share topics
        }
      } else {
        const int q = __shfl_sync(0xffffffffu, p, s);
        if (q >= 0) {
          const int* ks = sel_k + (size_t)q * Pk;
          const float* row = cd + (size_t)(base + s) * Pk;
          for (int j = lane; j < Pk; j += kWarp) acc[__ldg(ks + j)] += __ldcg(row + j);
        }
        __syncwarp();
      }
    }
  }
}

// One CTA a document.  Its theta row is read once, whole, into shared
// memory; warps then take the document's tokens t0 + warp, t0 + warp + 8,
// ... with no barrier between them, each power token updated by train_token
// (J > 0) or train_token_loop (J = 0), its cd [Pk] written to cd_out.  After
// the last token and one barrier the same shared row becomes theta_delta[d]:
// warp 0 zeroes it, folds the document's cd rows into it in token order and
// writes it out.
template <int J>
__global__ void __launch_bounds__(kTrainWarps * kWarp, 4) carry_train_kernel(
    const int* __restrict__ p_tok, const int* __restrict__ doc_ids,
    const float* __restrict__ counts, float* mu, const float* __restrict__ theta,
    const float* __restrict__ phi_tot, const float* __restrict__ phi,
    const int* __restrict__ sel_w, const int* __restrict__ sel_k,
    float* __restrict__ theta_delta, float* cd_out, int T, int K, int P, int Pk,
    float alpha, float beta, float wbeta) {
  extern __shared__ float4 row4[];
  float* row = reinterpret_cast<float*>(row4);  // [K] theta[d], then theta_delta[d]
  const int nw = blockDim.x / kWarp;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int d = blockIdx.x;
  // 16-byte loads and stores where the rows lie on 16-byte boundaries
  const bool vec = K % 4 == 0 && (((uintptr_t)theta | (uintptr_t)theta_delta) & 15) == 0;
  const int n4 = vec ? K / 4 : 0;
  const float* th = theta + (size_t)d * K;
  for (int i = threadIdx.x; i < n4; i += blockDim.x)
    row4[i] = __ldg(reinterpret_cast<const float4*>(th) + i);
  for (int k = 4 * n4 + threadIdx.x; k < K; k += blockDim.x) row[k] = __ldg(th + k);
  const int t0 = lower_bound(doc_ids, T, d);
  const int t1 = lower_bound(doc_ids, T, d + 1);
  __syncthreads();

  for (int t = t0 + warp; t < t1; t += nw) {
    const int p = __ldg(p_tok + t);
    if (p < 0 || p >= P) continue;            // guard: nothing read or written
    const float c = __ldg(counts + t);
    const int* ks = sel_k + (size_t)p * Pk;
    const float* ph = phi + (size_t)__ldg(sel_w + p) * K;
    float* mu_t = mu + (size_t)t * K;
    float* co = cd_out + (size_t)t * Pk;
    if constexpr (J > 0)
      train_token<J>(ks, ph, mu_t, row, phi_tot, co, c, Pk, alpha, beta, wbeta);
    else
      train_token_loop(ks, ph, mu_t, row, phi_tot, co, c, Pk, alpha, beta, wbeta);
  }
  __syncthreads();                            // theta[d] is read no more
  if (warp != 0) return;
  for (int i = lane; i < n4; i += kWarp) row4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k = 4 * n4 + lane; k < K; k += kWarp) row[k] = 0.f;
  __syncwarp();
  fold_theta_delta<J>(row, p_tok, sel_k, cd_out, t0, t1, P, Pk);
  float* out = theta_delta + (size_t)d * K;
  for (int i = lane; i < n4; i += kWarp) reinterpret_cast<float4*>(out)[i] = row4[i];
  for (int k = 4 * n4 + lane; k < K; k += kWarp) out[k] = row[k];
}

// the training kernel's instantiations, by J
using TrainKernel = decltype(&carry_train_kernel<0>);
const TrainKernel kTrainKernels[kTrainMaxJ + 1] = {
    carry_train_kernel<0>, carry_train_kernel<1>, carry_train_kernel<2>,
    carry_train_kernel<3>, carry_train_kernel<4>};

// One warp's sums of the cd rows of the tokens at run positions [lo, lo + n),
// 0 <= n <= kFoldChunk, in run order: out_d[j] = sum cd[t, j], out_r[j] = sum
// |cd[t, j]|, every j < Pk written (zeros when n = 0).  The chunk's tokens
// are read once, one or two a lane, and handed round by shuffles; each lane
// owns two topics of a pass of 64, and kFoldAhead tokens' loads are in
// flight before their adds.
__device__ __forceinline__ void fold_chunk(const int* __restrict__ order,
                                           const float* __restrict__ cd, int lo, int n,
                                           int Pk, float* out_d, float* out_r) {
  constexpr int kSlots = kFoldChunk / kWarp;
  const int lane = threadIdx.x % kWarp;
  int tok[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s)
    tok[s] = s * kWarp + lane < n ? __ldg(order + lo + s * kWarp + lane) : 0;
  for (int j0 = 0; j0 < Pk; j0 += 2 * kWarp) {
    const int ja = j0 + lane, jb = ja + kWarp;
    float da = 0.f, ra = 0.f, db = 0.f, rb = 0.f;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
#pragma unroll
      for (int h = 0; h < kWarp; h += kFoldAhead) {
        const int u0 = s * kWarp + h;           // the chunk's token u0 + u is
        if (u0 < n) {                           // lane h + u's tok[s]
          float va[kFoldAhead], vb[kFoldAhead];
#pragma unroll
          for (int u = 0; u < kFoldAhead; ++u) {
            const int t = __shfl_sync(0xffffffffu, tok[s], h + u);
            va[u] = u0 + u < n && ja < Pk ? __ldg(cd + (size_t)t * Pk + ja) : 0.f;
            vb[u] = u0 + u < n && jb < Pk ? __ldg(cd + (size_t)t * Pk + jb) : 0.f;
          }
#pragma unroll
          for (int u = 0; u < kFoldAhead; ++u) {
            if (u0 + u < n) {
              da += va[u];
              ra += fabsf(va[u]);
              db += vb[u];
              rb += fabsf(vb[u]);
            }
          }
        }
      }
    }
    if (ja < Pk) {
      out_d[ja] = da;
      out_r[ja] = ra;
    }
    if (jb < Pk) {
      out_d[jb] = db;
      out_r[jb] = rb;
    }
  }
}

// out_d[j] and out_r[j]: the sums of the partial rows s0 .. s0 + nch - 1 of
// part_d and part_r ([*, Pk], written by other warps of this launch, so read
// from L2), in that order, kFoldAhead rows' loads in flight.
__device__ __forceinline__ void fold_partials(const float* part_d, const float* part_r,
                                              int s0, int nch, int Pk, float* out_d,
                                              float* out_r) {
  for (int j = threadIdx.x % kWarp; j < Pk; j += kWarp) {
    float d = 0.f, r = 0.f;
    for (int c0 = 0; c0 < nch; c0 += kFoldAhead) {
      float vd[kFoldAhead], vr[kFoldAhead];
#pragma unroll
      for (int u = 0; u < kFoldAhead; ++u) {   // a row past the last reads the last
        const size_t at = (size_t)(s0 + min(c0 + u, nch - 1)) * Pk + j;
        vd[u] = __ldcg(part_d + at);
        vr[u] = __ldcg(part_r + at);
      }
#pragma unroll
      for (int u = 0; u < kFoldAhead; ++u) {
        if (c0 + u < nch) {
          d += vd[u];
          r += vr[u];
        }
      }
    }
    out_d[j] = d;
    out_r[j] = r;
  }
}

// d_pack[p, :] and r_pack[p, :], the sums of the cd rows of the run of the
// power word sel_w[p].  Warps [0, E) take the chunks of the runs longer than
// kFoldChunk (split[e]: the chunk's first run position), warps E + p the
// power rows.  A row warp sums a run of at most kFoldChunk tokens whole and
// leaves a longer one to the chunk warps.  A chunk warp finds its row
// through its first token's p_tok (a word not selected this sweep: nothing
// to do), writes its partial to part, and counts itself in the row's
// counter; the row's last chunk warp sums the row's partials in chunk order
// and sets the counter back to 0 for the next launch.
__global__ void __launch_bounds__(kFoldWarps * kWarp) carry_dr_fold_kernel(
    const int* __restrict__ order, const int* __restrict__ starts,
    const int* __restrict__ split, const int* __restrict__ p_tok,
    const int* __restrict__ sel_w, const float* __restrict__ cd,
    float* __restrict__ d_pack, float* __restrict__ r_pack, float* part, int* counters,
    int E, int P, int Pk) {
  const int g = blockIdx.x * kFoldWarps + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (g >= E + P) return;
  if (g >= E) {                                 // a power row
    const int p = g - E;
    const int key = __ldg(sel_w + p);
    const int lo = __ldg(starts + key), n = __ldg(starts + key + 1) - lo;
    if (n <= kFoldChunk)
      fold_chunk(order, cd, lo, n, Pk, d_pack + (size_t)p * Pk, r_pack + (size_t)p * Pk);
    return;
  }
  const int lo = __ldg(split + g);              // a chunk of a long run
  const int p = __ldg(p_tok + __ldg(order + lo));
  if (p < 0 || p >= P) return;
  const int key = __ldg(sel_w + p);
  const int s0 = __ldg(starts + key), s1 = __ldg(starts + key + 1);
  const int i = (lo - s0) / kFoldChunk;
  const int nch = (s1 - s0 + kFoldChunk - 1) / kFoldChunk;
  float* part_d = part;
  float* part_r = part + (size_t)E * Pk;
  fold_chunk(order, cd, lo, min(kFoldChunk, s1 - lo), Pk, part_d + (size_t)g * Pk,
             part_r + (size_t)g * Pk);
  __threadfence();                              // the partial reaches L2 first
  __syncwarp();
  int last = 0;
  if (lane == 0) last = atomicAdd(counters + p, 1) == nch - 1;
  if (!__shfl_sync(0xffffffffu, last, 0)) return;
  __threadfence();
  // the row's chunks are split[g - i .. g - i + nch), in chunk order
  fold_partials(part_d, part_r, g - i, nch, Pk, d_pack + (size_t)p * Pk,
                r_pack + (size_t)p * Pk);
  if (lane == 0) counters[p] = 0;
}

}  // namespace

extern "C" {

// Lets the training mode use, on the current device, all the dynamic shared
// memory a block may opt in to beside its static shared memory, and stores
// that many bytes in *smem_bytes.  Called once per device, before the first
// training launch there.  Returns the CUDA error code (0 on success).
int power_sweep_carry_configure(int* smem_bytes) {
  int device = 0, optin = 0, most = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  for (TrainKernel kernel : kTrainKernels) {
    cudaFuncAttributes attr;
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
    if (err == cudaSuccess && (int)attr.sharedSizeBytes > most)
      most = (int)attr.sharedSizeBytes;
  }
  if (err != cudaSuccess) return (int)err;
  *smem_bytes = optin - most;
  for (TrainKernel kernel : kTrainKernels) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               *smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// Launches one serving sweep on `stream` by the caller's plan (V float4s a
// thread on the register path, V = 1 or 2 with 4 * V * threads >= K; V = 0
// the K-blocked path, which needs the scratch `part` of D * 4 * K floats;
// threads 128, 256 or 512); allocates nothing.  theta_delta [D, K] and rdoc [D]
// are written whole.  Returns the CUDA error code of the launch (0 on
// success).
int power_sweep_carry_serve(const int* p_tok, const int* doc_ids, const float* counts,
                            float* mu, const float* theta, const float* phi_tot,
                            const float* phi, float* theta_delta, float* rdoc,
                            float* part, int T, int D, int K, int n_rows, int n_guard,
                            float alpha, float beta, float wbeta, int V, int threads,
                            void* stream) {
  if (K < 1 || (threads != 128 && threads != 256 && threads != 512) ||
      (V != 0 && (long long)4 * V * threads < K) || (V == 0 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  if (D > 0) {
    const bool vec =
        K % 4 == 0 && (((uintptr_t)mu | (uintptr_t)theta | (uintptr_t)phi |
                        (uintptr_t)phi_tot | (uintptr_t)part) & 15) == 0;
    err = (vec ? dispatch_serve<true> : dispatch_serve<false>)(
        V, threads, D, p_tok, doc_ids, counts, mu, theta, phi_tot, phi, theta_delta,
        rdoc, part, T, K, n_rows, n_guard, alpha, beta, wbeta, (cudaStream_t)stream);
  }
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

// Launches one training sweep on `stream` with J topics a lane (1 to 4,
// Pk <= 32 * J; 0 for any Pk), taking 4 * K bytes of shared memory within
// what power_sweep_carry_configure allowed, then the d/r fold; allocates
// nothing.  `order` [T] and `starts` [W + 1] are the runs by word (see the
// note above): the counted tokens of word w are order[starts[w] ..
// starts[w + 1]).  `split` [E] lists the first run position of each chunk of
// `chunk` tokens (which must be kFoldChunk) of every run longer than that, in
// run order; `part` is a scratch of 2 * E * Pk floats, `counters` [P] ints
// that are zero and are left zero.  `cd` is a scratch of T * Pk floats.
// theta_delta [D, K], d_pack and r_pack [P, Pk] are written whole.  Returns
// the CUDA error code of the launches (0 on success).
int power_sweep_carry_train(const int* p_tok, const int* doc_ids, const float* counts,
                            float* mu, const float* theta, const float* phi_tot,
                            const float* phi, const int* sel_w, const int* sel_k,
                            const int* order, const int* starts, const int* split,
                            float* cd, float* theta_delta, float* d_pack, float* r_pack,
                            float* part, int* counters, int T, int D, int K, int P,
                            int Pk, int E, int chunk, float alpha, float beta,
                            float wbeta, int J, void* stream) {
  if (J < 0 || J > kTrainMaxJ || (J > 0 && Pk > kWarp * J) || chunk != kFoldChunk ||
      E < 0 || (E > 0 && (split == nullptr || part == nullptr)) ||
      (P > 0 && counters == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)K;
  const cudaStream_t s = (cudaStream_t)stream;
  if (D > 0) {
    kTrainKernels[J]<<<D, kTrainWarps * kWarp, smem, s>>>(
        p_tok, doc_ids, counts, mu, theta, phi_tot, phi, sel_w, sel_k, theta_delta, cd,
        T, K, P, Pk, alpha, beta, wbeta);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (P > 0 && Pk > 0) {
    const long long warps_fold = (long long)E + P;
    carry_dr_fold_kernel<<<(unsigned)((warps_fold + kFoldWarps - 1) / kFoldWarps),
                           kFoldWarps * kWarp, 0, s>>>(
        order, starts, split, p_tok, sel_w, cd, d_pack, r_pack, part, counters, E, P,
        Pk);
  }
  return (int)cudaGetLastError();
}

const char* power_sweep_carry_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
