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
// rows and no guard row.  phi is used as it is, not clamped at 0, as the
// reference's packed formulation uses it.  The rows of sel_k hold distinct
// topics (top-k selections), so each mu element belongs to one lane.
//
// Design.  On the TPU, XLA gathers mu, theta and phi_tot into [T, Pk] tiles
// before the kernel, the kernel sums the packed d/r rows through a one-hot
// MXU contraction carried across its sequential grid, and XLA folds the
// result back over the whole [T, K] carry.  Here two kernels, one launch
// of the wrapper, and no atomics: every sum runs in a fixed order, so
// mu', theta_delta, d_pack and r_pack repeat bit for bit from launch to
// launch.
//   - The tokens are visited in a sweep order (`order`, a permutation of
//     [0, T) made once per mini-batch): sorted by word, tokens of count 0
//     last.  The counted tokens of one power row are then contiguous, a
//     run of at most D tokens (a word has one slot a document), and the
//     padding slots (word 0, count 0) form no run however many there are.
//   - Sweep kernel: one warp per chunk of 32 positions of the order, so the
//     work is balanced whatever the rows' lengths.  Lane l loads position
//     l's token, row, count and document in one go; the warp then walks
//     the chunk's power tokens with its lanes over the Pk topics (Pk <= 128
//     kept in registers: sel_k, phi_pack and phi_tot of a row are loaded
//     once per run of the chunk, mu and theta of a token once, from the
//     sums to the update; the next token's loads are issued before the
//     current token's two warp sums).  It writes mu' in place and each
//     power token's cd [Pk] into a token-indexed [T, Pk] stream, the
//     gathered form of the reference's packed path, coalesced.  It sums
//     d/r of each run's part in the chunk in token order: a run that
//     begins in the chunk writes its part to its d_pack / r_pack row, a
//     run that began in an earlier chunk writes its part to the chunk's
//     scratch (`ChunkScratch`).
//   - Fold kernel: CTAs 0 .. D-1 fold theta_delta, one per document: warp w
//     of F walks tokens t0 + w, t0 + w + F, ... in token order, four at a
//     time, and adds cd into its own [K] row in shared memory at sel_k; the
//     F rows are then summed in warp order and theta_delta[d] is written
//     whole.  The other warps take one chunk each: where the chunk's last
//     run goes on past it, they add the parts the later chunks left, in
//     chunk order.  A run is at most D tokens, D / 32 + 1 chunks.  Rows
//     with no counted token keep the zeros the caller wrote.
//
// Bound.  At the training slice's shapes (T = 65536 slots of D = 512
// documents, K = 2000, P = 14104, Pk = 50, ~70% power tokens): read and
// write mu at each power token's Pk topics (2 * 45875 * 50 * 4 B = 18.4 MB),
// read theta at the selected (document, topic) pairs (<= 9.2 MB), sel_k and
// phi_pack of the power words present (<= 5.6 MB), the per-token ids and
// counts (0.8 MB); write theta_delta (4.1 MB) and d/r (5.6 MB): ~44 MB,
// ~13 us at 3.35 TB/s; ~30 f32 operations per (token, topic) are ~1 us at
// 67 TFLOP/s.  Bound by bytes.  The [T, K] layout sets a floor above that
// bound: each (token, topic) element of mu is a 32-byte sector of its own,
// 2 x ~2.29 M x 32 B = ~147 MB read and written, ~44 us at 3.35 TB/s; no
// layout inside this kernel removes it, since sel_k changes every
// iteration.  The [T, Pk] cd stream adds ~18 MB written and read.  On an
// H100 scattered 32-byte sectors move at ~0.8 TB/s (pack_rows' own time in
// chip_smoke.py phase 2: 705,200 sectors in ~0.03 ms), so the sector floor
// at that rate, not the byte bound, sets what this kernel can reach.
// chip_smoke.py phase 2 times it at these shapes with uniform and with
// Zipf rows, and phase 7 a launch on the training step's own data; PERF.md
// has the numbers and the atomic design's beside them.
//
// Limits: K floats of shared memory per fold warp (F = 1 .. 4, K <= 58,112
// on an H100); doc_ids non-decreasing (tokens doc-contiguous); `order` must
// keep each power row's counted tokens contiguous (the wrapper builds it).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSweepThreads = 256;          // 8 warps: 8 chunks a CTA
constexpr int kMaxFoldWarps = 4;
constexpr int kFoldBatch = 4;              // tokens a fold warp loads at once
constexpr int kChunk = 32;                  // positions of the order a warp sweeps
static_assert(kChunk >= 2 && kChunk <= kWarp, "a chunk's positions fit a warp");

__device__ __forceinline__ float warp_sum(float v) {
  // xor butterfly: a fixed order, every lane ends with the same sum
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float update_u(float th, float pt, float m, float c, float ph,
                                          float alpha, float beta, float wbeta) {
  const float cm = c * m;
  return (th - cm + alpha) * (ph - cm + beta) / (pt - cm + wbeta);
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

// the d/r run key of position i of the order: the row of a counted power
// token, else -1
__device__ __forceinline__ int run_key(const int* __restrict__ order,
                                       const int* __restrict__ p_tok,
                                       const float* __restrict__ counts, long long i,
                                       int T, int P) {
  if (i < 0 || i >= T) return -1;
  const int t = __ldg(order + i);
  const int q = __ldg(p_tok + t);
  return (q >= 0 && q < P && __ldg(counts + t) != 0.f) ? q : -1;
}

// ------------------------------------------------------------------- sweep

// a row's Pk topics, packed phi and phi_tot, lane's share j = lane + 32 * jj
template <int NJ>
__device__ __forceinline__ void load_row(const int* __restrict__ sel_k,
                                         const float* __restrict__ phi_pack,
                                         const float* __restrict__ phi_tot, int q, int Pk,
                                         int lane, int (&k)[NJ], float (&ph)[NJ],
                                         float (&pt)[NJ]) {
#pragma unroll
  for (int jj = 0; jj < NJ; ++jj) {
    const int j = lane + kWarp * jj;
    k[jj] = j < Pk ? __ldg(sel_k + (size_t)q * Pk + j) : 0;
    ph[jj] = j < Pk ? __ldg(phi_pack + (size_t)q * Pk + j) : 0.f;
  }
#pragma unroll
  for (int jj = 0; jj < NJ; ++jj)
    pt[jj] = lane + kWarp * jj < Pk ? __ldg(phi_tot + k[jj]) : 0.f;
}

// a token's mu and theta at the row's topics (mu with the default cache
// policy: evict-first loads and stores of mu ran slower on an H100)
template <int NJ>
__device__ __forceinline__ void load_tok(const float* mu, const float* __restrict__ theta,
                                         int t, int d, int K, int Pk, int lane,
                                         const int (&k)[NJ], float (&m)[NJ],
                                         float (&th)[NJ]) {
#pragma unroll
  for (int jj = 0; jj < NJ; ++jj) {
    const bool on = lane + kWarp * jj < Pk;
    m[jj] = on ? mu[(size_t)t * K + k[jj]] : 0.f;
    th[jj] = on ? __ldg(theta + (size_t)d * K + k[jj]) : 0.f;
  }
}

// The d/r bookkeeping of chunk c (per-chunk scratch, written whole by the
// sweep kernel): the part of the run that began in an earlier chunk (its
// "head", d then r, [2][Pk]), whether that run also covers the whole chunk
// and goes on (`through`), and the row of a run that begins in this chunk
// and goes on past it (`tail`, else -1).  A run's part in the chunk where it
// begins goes straight to its d_pack / r_pack row.
struct ChunkScratch {
  float* head;                              // [chunks][2][Pk]
  int* through;                             // [chunks]
  int* tail;                                // [chunks]
};

// NJ > 0: Pk <= 32 * NJ, a lane keeps its NJ topics in registers; NJ == 0:
// any Pk, the lanes stride over the topics twice (sums, then the update)
// and add the d/r parts in global memory (each row's part has one writer).
template <int NJ>
__global__ void __launch_bounds__(kSweepThreads) packed_sweep_kernel(
    const int* __restrict__ order, const int* __restrict__ p_tok,
    const int* __restrict__ doc_ids, const float* __restrict__ counts, float* mu,
    const float* __restrict__ theta, const float* __restrict__ phi_tot,
    const float* __restrict__ phi_pack, const int* __restrict__ sel_k,
    float* __restrict__ cd_out, float* __restrict__ d_pack, float* __restrict__ r_pack,
    ChunkScratch scr, int T, int K, int P, int Pk, float alpha, float beta,
    float wbeta) {
  const int lane = threadIdx.x % kWarp;
  const long long c = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / kWarp;
  const long long i0 = c * kChunk;
  if (i0 >= T) return;                      // whole warps
  const int n = (int)min((long long)kChunk, (long long)T - i0);
  int tok = 0, p = -1, d = 0;
  float cc = 0.f;
  if (lane < n) {
    tok = __ldg(order + i0 + lane);
    p = __ldg(p_tok + tok);
    if (p < 0 || p >= P) {
      p = -1;                               // guard token
    } else {
      cc = __ldg(counts + tok);
      d = __ldg(doc_ids + tok);
    }
  }
  const int key = (p >= 0 && cc != 0.f) ? p : -1;
  int edge = -1;                            // the keys just before and after
  if (lane == 0) edge = run_key(order, p_tok, counts, i0 - 1, T, P);
  if (lane == 1) edge = run_key(order, p_tok, counts, i0 + n, T, P);
  const int before = __shfl_sync(kFull, edge, 0);
  const int after = __shfl_sync(kFull, edge, 1);
  const int last = __shfl_sync(kFull, key, n - 1);
  float* head = scr.head + (size_t)c * 2 * Pk;
  unsigned todo = __ballot_sync(kFull, p >= 0);
  int seg = -1;                             // the current run's row
  bool seg_head = false;                    // ... and whether it began before

  if constexpr (NJ == 0) {
    float *dd = nullptr, *rr = nullptr;
    while (todo) {
      const int s = __ffs(todo) - 1;
      todo &= todo - 1;
      const int q = __shfl_sync(kFull, p, s), t = __shfl_sync(kFull, tok, s);
      const int dk = __shfl_sync(kFull, key, s), dd_doc = __shfl_sync(kFull, d, s);
      const float c_t = __shfl_sync(kFull, cc, s);
      if (dk >= 0 && dk != seg) {           // a run starts here
        seg = dk;
        seg_head = s == 0 && before == dk;
        dd = seg_head ? head : d_pack + (size_t)seg * Pk;
        rr = seg_head ? head + Pk : r_pack + (size_t)seg * Pk;
        if (seg_head)
          for (int j = lane; j < Pk; j += kWarp) dd[j] = rr[j] = 0.f;
      }
      float* mu_t = mu + (size_t)t * K;
      const float* th = theta + (size_t)dd_doc * K;
      const int* ks = sel_k + (size_t)q * Pk;
      const float* ph = phi_pack + (size_t)q * Pk;
      float su = 0.f, sm = 0.f;
      for (int j = lane; j < Pk; j += kWarp) {
        const int k = __ldg(ks + j);
        const float m = mu_t[k];
        su += update_u(__ldg(th + k), __ldg(phi_tot + k), m, c_t, __ldg(ph + j), alpha,
                       beta, wbeta);
        sm += m;
      }
      su = warp_sum(su);
      sm = warp_sum(sm);
      const float denom = fmaxf(su, 1e-30f);
      for (int j = lane; j < Pk; j += kWarp) {
        const int k = __ldg(ks + j);
        const float m = mu_t[k];
        const float mn = update_u(__ldg(th + k), __ldg(phi_tot + k), m, c_t, __ldg(ph + j),
                                  alpha, beta, wbeta) * sm / denom;
        const float cd = c_t * (mn - m);
        mu_t[k] = mn;
        cd_out[(size_t)t * Pk + j] = cd;
        if (dk >= 0) {
          dd[j] += cd;
          rr[j] += fabsf(cd);
        }
      }
    }
  } else {
    float da[NJ], ra[NJ];
    auto flush = [&]() {
      if (seg < 0) return;
      float* dd = seg_head ? head : d_pack + (size_t)seg * Pk;
      float* rr = seg_head ? head + Pk : r_pack + (size_t)seg * Pk;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const int j = lane + kWarp * jj;
        if (j < Pk) {
          dd[j] = da[jj];
          rr[j] = ra[jj];
        }
      }
    };
    if (todo) {
      int s = __ffs(todo) - 1;
      todo &= todo - 1;
      int row = __shfl_sync(kFull, p, s);
      int ck[NJ];
      float cph[NJ], cpt[NJ], cm[NJ], cth[NJ];
      load_row<NJ>(sel_k, phi_pack, phi_tot, row, Pk, lane, ck, cph, cpt);
      load_tok<NJ>(mu, theta, __shfl_sync(kFull, tok, s), __shfl_sync(kFull, d, s), K,
                   Pk, lane, ck, cm, cth);
      while (true) {
        const int t = __shfl_sync(kFull, tok, s);
        const float c_t = __shfl_sync(kFull, cc, s);
        const int dk = __shfl_sync(kFull, key, s);
        // the next power token's loads go out before this token's sums
        const int sn = todo ? __ffs(todo) - 1 : -1;
        int nk[NJ], nrow = row;
        float nph[NJ], npt[NJ], nm[NJ], nth[NJ];
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) {
          nk[jj] = ck[jj];
          nph[jj] = cph[jj];
          npt[jj] = cpt[jj];
          nm[jj] = nth[jj] = 0.f;
        }
        if (sn >= 0) {
          todo &= todo - 1;
          nrow = __shfl_sync(kFull, p, sn);
          if (nrow != row)
            load_row<NJ>(sel_k, phi_pack, phi_tot, nrow, Pk, lane, nk, nph, npt);
          load_tok<NJ>(mu, theta, __shfl_sync(kFull, tok, sn), __shfl_sync(kFull, d, sn),
                       K, Pk, lane, nk, nm, nth);
        }
        if (dk >= 0 && dk != seg) {         // a run starts here
          flush();
          seg = dk;
          seg_head = s == 0 && before == dk;
#pragma unroll
          for (int jj = 0; jj < NJ; ++jj) da[jj] = ra[jj] = 0.f;
        }
        float u[NJ], su = 0.f, sm = 0.f;
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) {
          u[jj] = lane + kWarp * jj < Pk
                      ? update_u(cth[jj], cpt[jj], cm[jj], c_t, cph[jj], alpha, beta, wbeta)
                      : 0.f;
          su += u[jj];
          sm += cm[jj];
        }
        su = warp_sum(su);
        sm = warp_sum(sm);
        const float denom = fmaxf(su, 1e-30f);
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) {
          const int j = lane + kWarp * jj;
          if (j < Pk) {
            const float mn = u[jj] * sm / denom;
            const float cd = c_t * (mn - cm[jj]);
            mu[(size_t)t * K + ck[jj]] = mn;
            cd_out[(size_t)t * Pk + j] = cd;
            if (dk >= 0) {
              da[jj] += cd;
              ra[jj] += fabsf(cd);
            }
          }
        }
        if (sn < 0) break;
        s = sn;
        row = nrow;
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) {
          ck[jj] = nk[jj];
          cph[jj] = nph[jj];
          cpt[jj] = npt[jj];
          cm[jj] = nm[jj];
          cth[jj] = nth[jj];
        }
      }
      flush();
    }
  }
  if (lane == 0) {
    const bool goes_on = seg >= 0 && last == seg && after == seg;
    scr.through[c] = goes_on && seg_head;
    scr.tail[c] = goes_on && !seg_head ? seg : -1;
  }
}

// -------------------------------------------------------------------- fold

// Blocks [0, D): theta_delta of document blockIdx.x.  Blocks [D, ...): one
// warp per chunk; a chunk whose last run goes on adds the heads of the
// chunks that run covers to its d_pack / r_pack row, in chunk order.
template <int NJ>
__global__ void __launch_bounds__(kMaxFoldWarps * kWarp) packed_fold_kernel(
    const int* __restrict__ p_tok, const int* __restrict__ doc_ids,
    const float* __restrict__ counts, const int* __restrict__ sel_k,
    const float* __restrict__ cd, ChunkScratch scr, float* __restrict__ theta_delta,
    float* __restrict__ d_pack, float* __restrict__ r_pack, int T, int D, int K, int P,
    int Pk, long long chunks) {
  extern __shared__ float rows[];           // [F][K], theta_delta blocks only
  const int nw = blockDim.x / kWarp, warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;

  if ((int)blockIdx.x < D) {
    const int d = blockIdx.x;
    float* row = rows + (size_t)warp * K;
    for (int k = threadIdx.x; k < nw * K; k += blockDim.x) rows[k] = 0.f;
    const int t0 = lower_bound(doc_ids, T, d);
    const int t1 = lower_bound(doc_ids, T, d + 1);
    __syncthreads();
    // warp w: tokens t0 + w, t0 + w + nw, ... in token order, 32 at a time
    for (int b = t0 + warp; b < t1; b += nw * kWarp) {
      const int t = b + lane * nw;
      int q = -1;
      if (t < t1) {
        q = __ldg(p_tok + t);
        if (q < 0 || q >= P || __ldg(counts + t) == 0.f) q = -1;
      }
      unsigned todo = __ballot_sync(kFull, q >= 0);
      if constexpr (NJ == 0) {
        while (todo) {
          const int s = __ffs(todo) - 1;
          todo &= todo - 1;
          const int tq = __shfl_sync(kFull, q, s);
          const int tt = b + s * nw;
          for (int j = lane; j < Pk; j += kWarp)
            row[__ldg(sel_k + (size_t)tq * Pk + j)] += __ldg(cd + (size_t)tt * Pk + j);
          __syncwarp();                     // the next token may share topics
        }
      } else {
        // kFoldBatch tokens' topics and values loaded at once, then added
        // in token order
        while (todo) {
          int k[kFoldBatch][NJ];
          float v[kFoldBatch][NJ];
#pragma unroll
          for (int i = 0; i < kFoldBatch; ++i) {
            const int s = todo ? __ffs(todo) - 1 : -1;
            if (s >= 0) todo &= todo - 1;
            const int tq = s >= 0 ? __shfl_sync(kFull, q, s) : 0;
            const int tt = b + (s >= 0 ? s : 0) * nw;
#pragma unroll
            for (int jj = 0; jj < NJ; ++jj) {
              const int j = lane + kWarp * jj;
              const bool on = s >= 0 && j < Pk;
              k[i][jj] = on ? __ldg(sel_k + (size_t)tq * Pk + j) : -1;
              v[i][jj] = on ? __ldg(cd + (size_t)tt * Pk + j) : 0.f;
            }
          }
#pragma unroll
          for (int i = 0; i < kFoldBatch; ++i) {
#pragma unroll
            for (int jj = 0; jj < NJ; ++jj)
              if (k[i][jj] >= 0) row[k[i][jj]] += v[i][jj];
            __syncwarp();                   // the next token may share topics
          }
        }
      }
    }
    __syncthreads();
    for (int k = threadIdx.x; k < K; k += blockDim.x) {
      float s = 0.f;
      for (int w = 0; w < nw; ++w) s += rows[(size_t)w * K + k];
      theta_delta[(size_t)d * K + k] = s;
    }
    return;
  }

  // d/r: a run that began in chunk c and goes on
  const long long c = (long long)(blockIdx.x - D) * nw + warp;
  if (c >= chunks) return;
  const int q = __ldg(scr.tail + c);
  if (q < 0) return;
  long long end = c + 1;                    // the last chunk the run covers
  for (;; end += kWarp) {
    const long long e = end + lane;
    const unsigned stop = __ballot_sync(kFull, e >= chunks || __ldg(scr.through + e) == 0);
    if (stop) {
      end += __ffs(stop) - 1;
      break;
    }
  }
  for (int j = lane; j < Pk; j += kWarp) {
    float sd = d_pack[(size_t)q * Pk + j], sr = r_pack[(size_t)q * Pk + j];
#pragma unroll 4
    for (long long h = c + 1; h <= end; ++h) {
      sd += __ldg(scr.head + (size_t)h * 2 * Pk + j);
      sr += __ldg(scr.head + (size_t)h * 2 * Pk + Pk + j);
    }
    d_pack[(size_t)q * Pk + j] = sd;
    r_pack[(size_t)q * Pk + j] = sr;
  }
}

template <int NJ>
cudaError_t launch(const int* order, const int* p_tok, const int* doc_ids,
                   const float* counts, float* mu, const float* theta,
                   const float* phi_tot, const float* phi_pack, const int* sel_k,
                   float* scratch, float* theta_delta, float* d_pack, float* r_pack, int T,
                   int D, int K, int P, int Pk, float alpha, float beta, float wbeta,
                   int fold_warps, cudaStream_t stream) {
  const long long chunks = ((long long)T + kChunk - 1) / kChunk;
  float* cd = scratch;                      // [T][Pk]
  ChunkScratch scr;
  scr.head = cd + (size_t)T * Pk;
  scr.through = reinterpret_cast<int*>(scr.head + (size_t)chunks * 2 * Pk);
  scr.tail = scr.through + chunks;
  const unsigned sweep_blocks =
      (unsigned)((chunks * kWarp + kSweepThreads - 1) / kSweepThreads);
  packed_sweep_kernel<NJ><<<sweep_blocks, kSweepThreads, 0, stream>>>(
      order, p_tok, doc_ids, counts, mu, theta, phi_tot, phi_pack, sel_k, cd, d_pack,
      r_pack, scr, T, K, P, Pk, alpha, beta, wbeta);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem = sizeof(float) * (size_t)fold_warps * K;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(packed_fold_kernel<NJ>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const unsigned fold_blocks = (unsigned)(D + (chunks + fold_warps - 1) / fold_warps);
  packed_fold_kernel<NJ><<<fold_blocks, fold_warps * kWarp, smem, stream>>>(
      p_tok, doc_ids, counts, sel_k, cd, scr, theta_delta, d_pack, r_pack, T, D, K, P, Pk,
      chunks);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The shared memory a block may opt in to on the current device, in bytes
// (the fold kernel takes K floats of it per fold warp).  Returns the CUDA
// error code (0 on success).
int power_sweep_tokens_smem_optin(int* bytes) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return (int)err;
}

// The 4-byte words of scratch one launch needs at T tokens and Pk topics:
// the [T, Pk] cd stream and each chunk's d/r head and two flags.
long long power_sweep_tokens_scratch_words(int T, int Pk) {
  const long long chunks = ((long long)T + kChunk - 1) / kChunk;
  return (long long)T * Pk + chunks * (2LL * Pk + 2);
}

// Launches one packed sweep on `stream`: the sweep kernel, then the fold
// kernel; allocates nothing.  `order` [T] is the sweep order (a permutation
// of the tokens keeping each power row's counted tokens contiguous);
// `scratch` holds power_sweep_tokens_scratch_words(T, Pk) words;
// theta_delta [D, K] is written whole; d_pack and r_pack [P, Pk] must be
// zeroed by the caller (rows with no counted token keep the zeros).
// fold_warps in [1, 4] with fold_warps * K floats within the shared memory
// a block may have.  Returns the CUDA error code of the launches (0 on
// success).
int power_sweep_tokens(const int* order, const int* p_tok, const int* doc_ids,
                       const float* counts, float* mu, const float* theta,
                       const float* phi_tot, const float* phi_pack, const int* sel_k,
                       float* scratch, float* theta_delta, float* d_pack, float* r_pack,
                       int T, int D, int K, int P, int Pk, float alpha, float beta,
                       float wbeta, int fold_warps, void* stream) {
  if (fold_warps < 1 || fold_warps > kMaxFoldWarps) return (int)cudaErrorInvalidValue;
  if (T <= 0 || D <= 0 || Pk <= 0) {
    if (D > 0 && K > 0)                     // nothing to sweep: theta_delta = 0
      return (int)cudaMemsetAsync(theta_delta, 0, sizeof(float) * (size_t)D * K,
                                  (cudaStream_t)stream);
    return (int)cudaGetLastError();
  }
  auto fn = Pk <= 32   ? &launch<1>
            : Pk <= 64  ? &launch<2>
            : Pk <= 128 ? &launch<4>
                        : &launch<0>;
  return (int)fn(order, p_tok, doc_ids, counts, mu, theta, phi_tot, phi_pack, sel_k,
                 scratch, theta_delta, d_pack, r_pack, T, D, K, P, Pk, alpha, beta, wbeta,
                 fold_warps, (cudaStream_t)stream);
}

const char* power_sweep_tokens_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
