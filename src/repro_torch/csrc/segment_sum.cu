// Fixed-order segmented sums of the POBP training step, for Hopper (sm_90a).
//
// These kernels have no TPU counterpart: on the TPU, XLA runs the two sums
// below as scatter-adds, and they are the step's own code, not Pallas
// kernels.  On the card, PyTorch's index_add_ adds with atomics in an order
// that changes from run to run, so two runs from one state would part in
// their last bits, torch.topk would then pick other power words, and the
// trajectories would diverge.  Here every sum runs in one fixed order, with
// no atomics, so the step repeats bit for bit.
//
// word_rows_sum (residuals.token_scatter_wk: the phi delta of Eq. 3 and the
// residual matrix of Eq. 8, three times a mini-batch):
//   out[w, :] = sum over the counted tokens t of word w of values[t, :],
//   in the order of the runs the caller made once per mini-batch
//   (TokenLayout.word_runs: order [T] holds the counted tokens sorted by
//   word, stable, and order[starts[w] .. starts[w + 1]) is word w's run).
//   Every row of out is written, so out needs no zeroing; a row with no
//   counted token is written as zeros.  Tokens of count 0 are left out:
//   every caller's values are exactly 0 there (c * mu, c * |dmu|).
//   Bound: at the training slice's shapes (T = 65536 slots, K = 2000,
//   W = 141043) the sum must read each counted token's row once (~0.26-0.52
//   GB: 32-64 k counted tokens x 8 KB) and write the [W, K] matrix once
//   (1.13 GB): ~0.4-0.5 ms at 3.35 TB/s, one add an element, bound by
//   bytes.  So the design is a streaming copy, spread so that a frequent
//   word does not hold one CTA for long: one warp a (word, slice of 128
//   topics), 8 warps a CTA; each lane owns one float4 of the slice (16-byte
//   loads and stores where K % 4 == 0 and the rows lie on 16-byte
//   boundaries, else one float of a 32-topic slice), and sums the run's rows
//   in registers in run order, 8 tokens' loads in flight at a time, with
//   streaming stores (the 1.13 GB result is read later, not from L2).  A
//   word's run is at most one token a document (D = 512), 256 KB a warp.
//   A first design, one CTA of 128 threads a word, ran 3.82 ms on an H100
//   at these shapes (Zipf words with repeats inside documents: one word's
//   run held a single CTA for most of it).
//
// topic_sum (the phi_tot refresh of each selective iteration, Eq. 4/9):
//   out[k] = base[k] + sum over (p, j) with sel_k[p, j] == k of vals[p, j].
//   Bound: read sel_k and vals once (2 x 2.8 MB at P = 14104, Pk = 50),
//   ~1.7 us at 3.35 TB/s; a launch's own floor is a few us.  One launch of
//   G CTAs (one an SM) sums in a fixed order that no timing changes:
//   - warp w of CTA b adds a contiguous block of rows, in row order, into
//     its own [K] row in shared memory.  It first copies a round of its
//     rows' pairs into a staging buffer in shared memory, all loads in
//     flight at once (16-byte loads where sel_k and vals lie on 16-byte
//     boundaries), then adds them a row at a time: lanes over the row's Pk
//     topics (distinct within a row, as top-k gives them; two a lane read
//     before either is written), a __syncwarp between rows;
//   - the CTA sums its F rows in warp order into partial[b, :];
//   - the CTAs form groups of about sqrt(G) in CTA order.  Each CTA fences
//     its partial and counts itself in its group's counter; the last of a
//     group sums the group's partials in CTA order into the group's row,
//     fences it and counts the group in the final counter; the last group
//     sums the group rows in group order and adds base.  A last CTA reads
//     its rows from L2 with 8 rows' loads in flight, 16 bytes a load where
//     K % 4 == 0.  Each last CTA sets its counter back to 0 for the next
//     launch on the stream.
//   So the sum order is fixed (rows, warps, CTAs, groups), each level's
//   last CTA reads about sqrt(G) rows of K, and nothing waits on a CTA that
//   may not be resident.  Tried and slower at these shapes on an H100: a
//   first design (each warp's rows loaded one row at a time, the G
//   partials summed by a second launch, one topic a thread), and clusters
//   of 8 CTAs summing their rows through distributed shared memory before
//   one last-CTA level over the clusters.  What remains is latency: each
//   phase (the rows' loads, the fences and counters, two L2 round trips)
//   waits on the one before.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRowThreads = 256;      // word_rows_sum: 8 (word, slice) warps a CTA
constexpr int kInFlight = 8;          // word_rows_sum: tokens' loads in flight
constexpr int kMaxTopicWarps = 8;     // topic_sum: warps a CTA

// one warp a (word, slice): slices of 32 float4s (kVec) or 32 floats
template <bool kVec>
__global__ void __launch_bounds__(kRowThreads) word_rows_sum_kernel(
    const int* __restrict__ order, const int* __restrict__ starts,
    const float* __restrict__ values, float* __restrict__ out, int W, int K,
    int slices) {
  const long long g = (long long)blockIdx.x * (kRowThreads / kWarp) + threadIdx.x / kWarp;
  if (g >= (long long)W * slices) return;
  const int w = (int)(g / slices), slice = (int)(g % slices);
  const int lane = threadIdx.x % kWarp;
  const int lo = __ldg(starts + w), hi = __ldg(starts + w + 1);
  if constexpr (kVec) {
    const int c = slice * kWarp + lane;             // this lane's float4
    if (c >= K / 4) return;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    int i = lo;
    for (; i + kInFlight <= hi; i += kInFlight) {
      float4 v[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u)
        v[u] = __ldg(reinterpret_cast<const float4*>(
                         values + (size_t)__ldg(order + i + u) * K) + c);
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        s.x += v[u].x;
        s.y += v[u].y;
        s.z += v[u].z;
        s.w += v[u].w;
      }
    }
    for (; i < hi; ++i) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(
                                 values + (size_t)__ldg(order + i) * K) + c);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    __stcs(reinterpret_cast<float4*>(out + (size_t)w * K) + c, s);
  } else {
    const int k = slice * kWarp + lane;
    if (k >= K) return;
    float s = 0.f;
    int i = lo;
    for (; i + kInFlight <= hi; i += kInFlight) {
      float v[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u)
        v[u] = __ldg(values + (size_t)__ldg(order + i + u) * K + k);
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) s += v[u];
    }
    for (; i < hi; ++i) s += __ldg(values + (size_t)__ldg(order + i) * K + k);
    __stcs(out + (size_t)w * K + k, s);
  }
}

// a release/acquire fence at GPU scope (lighter than __threadfence, whose
// sequentially consistent fence also empties L1)
__device__ __forceinline__ void fence_gpu() {
  asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
}

// one warp's rows [p0, p1) into its shared-memory row `acc`, through a
// staging buffer of `stage` pairs (0: no staging, one row at a time)
__device__ __forceinline__ void topic_rows(const int* __restrict__ sel_k,
                                           const float* __restrict__ vals, float* acc,
                                           int* s_sel, float* s_val, int p0, int p1,
                                           int Pk, int stage, bool vec) {
  const int lane = threadIdx.x % kWarp;
  if (stage == 0) {
    for (int p = p0; p < p1; ++p) {
      for (int j = lane; j < Pk; j += kWarp)
        acc[__ldg(sel_k + (int64_t)p * Pk + j)] += __ldg(vals + (int64_t)p * Pk + j);
      __syncwarp();                             // the next row may share topics
    }
    return;
  }
  const int per_round = stage / Pk > 0 ? stage / Pk : 1;
  for (int q = p0; q < p1; q += per_round) {
    const int qe = q + per_round < p1 ? q + per_round : p1;
    const int64_t e0 = (int64_t)q * Pk, e1 = (int64_t)qe * Pk;
    const int64_t ea = vec ? (e0 & ~(int64_t)3) : e0;  // 16-byte aligned start
    const int n = (int)(e1 - ea);
    int i = 0;
    if (vec) {
      const int nv = n / 4;
      const int4* gs = reinterpret_cast<const int4*>(sel_k + ea);
      const float4* gv = reinterpret_cast<const float4*>(vals + ea);
      for (int v = lane; v < nv; v += kWarp) {
        reinterpret_cast<int4*>(s_sel)[v] = __ldg(gs + v);
        reinterpret_cast<float4*>(s_val)[v] = __ldg(gv + v);
      }
      i = 4 * nv;
    }
    for (int e = i + lane; e < n; e += kWarp) {
      s_sel[e] = __ldg(sel_k + ea + e);
      s_val[e] = __ldg(vals + ea + e);
    }
    __syncwarp();
    int off = (int)(e0 - ea);
    if (Pk <= 2 * kWarp) {                      // two pairs a lane, the next row's read ahead
      const int j0 = lane, j1 = lane + kWarp;
      int k0 = j0 < Pk ? s_sel[off + j0] : -1, k1 = j1 < Pk ? s_sel[off + j1] : -1;
      float v0 = j0 < Pk ? s_val[off + j0] : 0.f, v1 = j1 < Pk ? s_val[off + j1] : 0.f;
      for (int p = q; p < qe; ++p) {
        off += Pk;
        int n0 = -1, n1 = -1;
        float w0 = 0.f, w1 = 0.f;
        if (p + 1 < qe) {
          if (j0 < Pk) {
            n0 = s_sel[off + j0];
            w0 = s_val[off + j0];
          }
          if (j1 < Pk) {
            n1 = s_sel[off + j1];
            w1 = s_val[off + j1];
          }
        }
        const float a0 = k0 >= 0 ? acc[k0] : 0.f, a1 = k1 >= 0 ? acc[k1] : 0.f;
        if (k0 >= 0) acc[k0] = a0 + v0;
        if (k1 >= 0) acc[k1] = a1 + v1;
        __syncwarp();                           // the next row may share topics
        k0 = n0;
        k1 = n1;
        v0 = w0;
        v1 = w1;
      }
    } else {
      for (int p = q; p < qe; ++p, off += Pk) {
        for (int j = lane; j < Pk; j += kWarp) acc[s_sel[off + j]] += s_val[off + j];
        __syncwarp();                           // the next row may share topics
      }
    }
  }
}

// dst[k] = add[k] + the sum of src's rows lo .. hi-1 at column k (rows of
// K floats), in row order; add may be null.  The rows were written by other
// CTAs of this launch, so they are read from L2 (ld.cg); up to 16 rows'
// loads are issued before their adds, 16 bytes a load with vec (K % 4 == 0
// and src, add and dst on 16-byte boundaries).
__device__ __forceinline__ void sum_rows(const float* src, int lo, int hi, int K,
                                         const float* add, float* dst, bool vec) {
  constexpr int kAhead = 16;
  if (vec) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    const int q4 = K / 4;
    for (int q = threadIdx.x; q < q4; q += blockDim.x) {
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int c = lo; c < hi; c += kAhead) {
        float4 v[kAhead];
#pragma unroll
        for (int u = 0; u < kAhead; ++u)              // a row past hi reads row hi-1
          v[u] = __ldcg(s4 + (size_t)(c + u < hi ? c + u : hi - 1) * q4 + q);
#pragma unroll
        for (int u = 0; u < kAhead; ++u)
          if (c + u < hi) {
            s.x += v[u].x;
            s.y += v[u].y;
            s.z += v[u].z;
            s.w += v[u].w;
          }
      }
      if (add != nullptr) {
        const float4 a = __ldg(reinterpret_cast<const float4*>(add) + q);
        s = make_float4(a.x + s.x, a.y + s.y, a.z + s.z, a.w + s.w);
      }
      reinterpret_cast<float4*>(dst)[q] = s;
    }
  } else {
    for (int k = threadIdx.x; k < K; k += blockDim.x) {
      float s = 0.f;
      for (int c = lo; c < hi; c += kAhead) {
        float v[kAhead];
#pragma unroll
        for (int u = 0; u < kAhead; ++u)
          v[u] = __ldcg(src + (size_t)(c + u < hi ? c + u : hi - 1) * K + k);
#pragma unroll
        for (int u = 0; u < kAhead; ++u)
          if (c + u < hi) s += v[u];
      }
      dst[k] = add != nullptr ? __ldg(add + k) + s : s;
    }
  }
}

// partial holds G + groups rows of K: the CTAs' rows, then the groups'
__global__ void __launch_bounds__(kMaxTopicWarps * kWarp) topic_sum_kernel(
    const int* __restrict__ sel_k, const float* __restrict__ vals,
    const float* __restrict__ base, float* __restrict__ partial, float* __restrict__ out,
    unsigned* __restrict__ counters, int P, int Pk, int K, int rows_per_warp, int group,
    int stage, int vec, int vec_k) {
  extern __shared__ __align__(16) float smem[];  // [F][2][stage + 4] staging, [F][K] rows
  __shared__ bool s_last;
  const int F = blockDim.x / kWarp, warp = threadIdx.x / kWarp;
  const int G = gridDim.x, b = blockIdx.x, groups = (G + group - 1) / group;
  const int st = stage > 0 ? stage + 4 : 0;
  float* rows = smem + 2 * F * st;
  const int n4 = F * K / 4;
  for (int i = threadIdx.x; i < n4; i += blockDim.x)
    reinterpret_cast<float4*>(rows)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = 4 * n4 + threadIdx.x; i < F * K; i += blockDim.x) rows[i] = 0.f;
  __syncthreads();
  const int64_t first = ((int64_t)b * F + warp) * rows_per_warp;
  const int p0 = first < P ? (int)first : P;
  const int p1 = first + rows_per_warp < P ? (int)(first + rows_per_warp) : P;
  topic_rows(sel_k, vals, rows + (size_t)warp * K,
             reinterpret_cast<int*>(smem + 2 * warp * st), smem + (2 * warp + 1) * st, p0, p1,
             Pk, stage, vec != 0);
  __syncthreads();
  float* mine = partial + (size_t)b * K;
  if (vec_k) {                                  // the warps' rows, in order
    for (int q = threadIdx.x; q < K / 4; q += blockDim.x) {
      float4 v[kMaxTopicWarps];
#pragma unroll
      for (int u = 0; u < kMaxTopicWarps; ++u)        // a row past F reads row F-1
        v[u] = reinterpret_cast<const float4*>(rows + (size_t)(u < F ? u : F - 1) * K)[q];
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int u = 0; u < kMaxTopicWarps; ++u)
        if (u < F) {
          s.x += v[u].x;
          s.y += v[u].y;
          s.z += v[u].z;
          s.w += v[u].w;
        }
      reinterpret_cast<float4*>(mine)[q] = s;
    }
  } else {
    for (int k = threadIdx.x; k < K; k += blockDim.x) {
      float v[kMaxTopicWarps];
#pragma unroll
      for (int u = 0; u < kMaxTopicWarps; ++u)
        v[u] = rows[(size_t)(u < F ? u : F - 1) * K + k];
      float s = 0.f;
#pragma unroll
      for (int u = 0; u < kMaxTopicWarps; ++u)
        if (u < F) s += v[u];
      mine[k] = s;
    }
  }
  // level 1: the last CTA of the group sums its partials in CTA order
  const int g = b / group, lo = g * group, hi = lo + group < G ? lo + group : G;
  fence_gpu();
  __syncthreads();
  if (threadIdx.x == 0) {
    s_last = atomicAdd(counters + g, 1u) == (unsigned)(hi - lo - 1);
    if (s_last) counters[g] = 0u;
  }
  __syncthreads();
  if (!s_last) return;
  fence_gpu();
  sum_rows(partial, lo, hi, K, nullptr, partial + (size_t)(G + g) * K, vec_k != 0);
  // level 2: the last group sums the groups' rows in group order
  fence_gpu();
  __syncthreads();
  if (threadIdx.x == 0) {
    s_last = atomicAdd(counters + groups, 1u) == (unsigned)(groups - 1);
    if (s_last) counters[groups] = 0u;
  }
  __syncthreads();
  if (!s_last) return;
  fence_gpu();
  sum_rows(partial, G, G + groups, K, base, out, vec_k != 0);
}

}  // namespace

extern "C" {

// Launches word_rows_sum on `stream`: out [W, K] = the runs' row sums (see
// the note above); allocates nothing.  starts holds W + 1 entries.  Returns
// the CUDA error code of the launch (0 on success).
int word_rows_sum(const int* order, const int* starts, const float* values, float* out,
                  int W, int K, void* stream) {
  if (W > 0 && K > 0) {
    const bool vec =
        K % 4 == 0 && (((uintptr_t)values | (uintptr_t)out) & 15) == 0;
    const int per = vec ? 4 * kWarp : kWarp;          // topics a slice
    const int slices = (K + per - 1) / per;
    const long long warps = (long long)W * slices;
    const unsigned blocks =
        (unsigned)((warps + kRowThreads / kWarp - 1) / (kRowThreads / kWarp));
    if (vec)
      word_rows_sum_kernel<true><<<blocks, kRowThreads, 0, (cudaStream_t)stream>>>(
          order, starts, values, out, W, K, slices);
    else
      word_rows_sum_kernel<false><<<blocks, kRowThreads, 0, (cudaStream_t)stream>>>(
          order, starts, values, out, W, K, slices);
  }
  return (int)cudaGetLastError();
}

// The shared memory a block may opt in to on the current device, in bytes
// (topic_sum takes K floats of it per warp, beside its staging).  Returns
// the CUDA error code (0 on success).
int segment_sum_smem_optin(int* bytes) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return (int)err;
}

// Launches topic_sum on `stream`, one launch: out [K] = base [K] plus the
// sums of vals [P, Pk] by topic sel_k [P, Pk] (topics distinct within a
// row), in the fixed order of the note above, with G CTAs of `warps` warps
// (1 to 8) in groups of `group` CTAs, each warp staging `stage` pairs at a
// time (0: none; else a multiple of 4, at least Pk); shared memory: warps *
// (K + 2 * (stage + 4)) floats.  `partial` is a scratch of (G + ceil(G /
// group)) * K floats; `counters` holds ceil(G / group) + 1 zeros, and the
// launch leaves them zero: launches that share them must run in stream
// order.  Allocates nothing.  Returns the CUDA error code of the launch (0
// on success).
int topic_sum(const int* sel_k, const float* vals, const float* base, float* partial,
              float* out, unsigned* counters, int P, int Pk, int K, int G, int warps,
              int group, int stage, void* stream) {
  if (warps < 1 || warps > kMaxTopicWarps || G < 1 || K < 1 || group < 1 || stage < 0 ||
      stage % 4 || (stage > 0 && stage < Pk) || (stage > 0 && Pk == 0) || P < 0 || Pk < 0)
    return (int)cudaErrorInvalidValue;
  const size_t st = stage > 0 ? (size_t)stage + 4 : 0;
  const size_t smem = sizeof(float) * (size_t)warps * ((size_t)K + 2 * st);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        topic_sum_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long warps_all = (long long)G * warps;
  const int rows_per_warp = (int)((P + warps_all - 1) / warps_all);
  const int vec = stage > 0 && (((uintptr_t)sel_k | (uintptr_t)vals) & 15) == 0;
  const int vec_k =
      K % 4 == 0 && (((uintptr_t)base | (uintptr_t)partial | (uintptr_t)out) & 15) == 0;
  topic_sum_kernel<<<G, warps * kWarp, smem, (cudaStream_t)stream>>>(
      sel_k, vals, base, partial, out, counters, P, Pk, K, rows_per_warp, group, stage,
      vec, vec_k);
  return (int)cudaGetLastError();
}

const char* segment_sum_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
