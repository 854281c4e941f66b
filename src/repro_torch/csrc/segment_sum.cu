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
//   out[k] = base[k] + sum over (p, j) with sel_k[p, j] == k of vals[p, j],
//   rows p in ascending order.  Bound: read sel_k and vals once (2 x 2.8 MB
//   at P = 14104, Pk = 50), ~1.7 us at 3.35 TB/s.  Pass one: G CTAs of F
//   warps; warp w of the grid adds a contiguous block of rows, in row order,
//   into its own [K] row in shared memory (lanes over the row's Pk topics,
//   distinct within a row as top-k gives them; a __syncwarp between rows);
//   the CTA then sums its F rows in warp order into partial[b, :].  Pass
//   two: out[k] = base[k] + the G partials in CTA order.  The work is
//   latency-bound (a warp's row chain), so the grid is one CTA an SM.

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

__global__ void __launch_bounds__(kMaxTopicWarps * kWarp) topic_sum_partial_kernel(
    const int* __restrict__ sel_k, const float* __restrict__ vals,
    float* __restrict__ partial, int P, int Pk, int K, int rows_per_warp) {
  extern __shared__ float rows[];               // [F][K]
  const int nw = blockDim.x / kWarp, warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  for (int k = threadIdx.x; k < nw * K; k += blockDim.x) rows[k] = 0.f;
  __syncthreads();
  float* row = rows + (size_t)warp * K;
  const long long first = ((long long)blockIdx.x * nw + warp) * rows_per_warp;
  const int p0 = first < P ? (int)first : P;
  const int p1 = first + rows_per_warp < P ? (int)(first + rows_per_warp) : P;
  for (int p = p0; p < p1; ++p) {
    for (int j = lane; j < Pk; j += kWarp)
      row[__ldg(sel_k + (size_t)p * Pk + j)] += __ldg(vals + (size_t)p * Pk + j);
    __syncwarp();                               // the next row may share topics
  }
  __syncthreads();
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    float s = 0.f;
    for (int v = 0; v < nw; ++v) s += rows[(size_t)v * K + k];
    partial[(size_t)blockIdx.x * K + k] = s;
  }
}

__global__ void topic_sum_final_kernel(const float* __restrict__ partial,
                                       const float* __restrict__ base,
                                       float* __restrict__ out, int K, int G) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  float s = 0.f;
  for (int b = 0; b < G; ++b) s += __ldg(partial + (size_t)b * K + k);
  out[k] = __ldg(base + k) + s;
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
// (topic_sum's first pass takes K floats of it per warp).  Returns the CUDA
// error code (0 on success).
int segment_sum_smem_optin(int* bytes) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return (int)err;
}

// Launches topic_sum on `stream`: out [K] = base [K] plus the sums of vals
// [P, Pk] by topic sel_k [P, Pk] (topics distinct within a row), in the
// fixed order of the note above, with G CTAs of `warps` warps (1 to 8,
// warps * K floats of shared memory); `partial` is a scratch of G * K
// floats.  Allocates nothing.  Returns the CUDA error code of the launches
// (0 on success).
int topic_sum(const int* sel_k, const float* vals, const float* base, float* partial,
              float* out, int P, int Pk, int K, int G, int warps, void* stream) {
  if (warps < 1 || warps > kMaxTopicWarps || G < 1 || K < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)warps * K;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        topic_sum_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long warps_all = (long long)G * warps;
  const int rows_per_warp = (int)((P + warps_all - 1) / warps_all);
  topic_sum_partial_kernel<<<G, warps * kWarp, smem, (cudaStream_t)stream>>>(
      sel_k, vals, partial, P, Pk, K, rows_per_warp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  topic_sum_final_kernel<<<(K + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      partial, base, out, K, G);
  return (int)cudaGetLastError();
}

const char* segment_sum_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
