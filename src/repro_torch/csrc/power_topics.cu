// Power-topic selection of the POBP training step, for Hopper (sm_90a).
//
// For each power word p < P it computes the Pk largest entries of the
// residual row r[sel_w[p], :] and writes their topic ids, int32 [P, Pk]:
//
//   out[p, :] = lax.top_k(r[sel_w[p], :], Pk).indices
//
// in lax.top_k's order: values descending under the float total order
// (-0.0 below +0.0), ties to the lower topic id.  The order is exact, so
// the output repeats bit for bit from launch to launch and each row's
// topics are distinct, as the carry sweep requires.  A row id outside
// [0, W) reads as an all-zero row (topics 0 .. Pk-1).
//
// It replaces no TPU kernel: the JAX package leaves the selection
// (src/repro/core/power.py::select_power_topics, a row gather then
// lax.top_k) to XLA.  On the card the library route took a [P, K] gather
// copy and then torch.topk's multi-pass radix select, which reads the
// copy again in each pass and launches some ten kernels.
//
// Bound.  Each selected row is read once and the ids written once:
// 4 * P * (K + 1 + Pk) bytes, 564 MB at the PUBMED shapes (P = 14,104,
// K = 10,000, Pk = 50), 168 us at 3.35 TB/s, and 113 MB (34 us) at
// K = 2000.  Bound by bytes: the selection does a few integer operations a
// key.
//
// Design.  One CTA a power word.  It reads its row by index once, with
// 16-byte loads where the rows allow them, turns each value into an
// order-preserving uint32 key and keeps the keys in shared memory; each
// thread keeps the largest and smallest of its own keys.  Then, without
// reading device memory again:
//   - A row whose keys are all equal (an all-zero guard row) is done at
//     once: topics 0 .. Pk-1.
//   - Each thread's largest key is the maximum of a group of the row; when
//     there are at least Pk groups, the Pk-th largest group maximum is a
//     lower bound of the row's Pk-th largest key.  Two radix passes over
//     the groups' maxima (8-bit digits, a shared-memory histogram, one
//     block scan) give that bound to 16 bits, and the keys at or above it
//     are the candidates: some 60 on rows of distinct values, where the
//     row has 10,000.  When at most CAP of them come, each candidate's
//     rank among them, by value and then by topic id, is its place in the
//     output (ranks past Pk are dropped).
//   - Otherwise (rows of few distinct values, or fewer groups than Pk) an
//     exact radix select runs over the whole row in shared memory (10-bit
//     digits, stopping as soon as the digit's bin holds exactly the keys
//     still needed); when the Pk-th value ties with more keys than are
//     needed, those with the lowest topic ids are taken by one ordered
//     count, and the Pk winners are ranked as above.
// Every path orders by (value, then lower topic id), so the output is the
// same bits whichever one a row takes.  The launch makes no copy and
// allocates nothing.

#include <cuda_runtime.h>

namespace {

constexpr int DIGIT_BITS = 10;         // the exact select's digits
constexpr int BINS = 1 << DIGIT_BITS;   // a histogram; two alternate
constexpr int BOUND_BITS = 8;           // the bound's digits, two passes
constexpr int BOUND_BINS = 1 << BOUND_BITS;
constexpr int CAP = 256;                // candidates ranked directly
constexpr int MAX_THREADS = 512;
constexpr unsigned FULL = 0xffffffffu;

// The float's order under lax.top_k's total order (-0.0 below +0.0), as an
// unsigned key: the larger float has the larger key.
__device__ __forceinline__ unsigned order_key(float x) {
  const unsigned u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// Key and topic id as one number: the larger is the earlier in lax.top_k's
// order (value descending, then the lower id).
__device__ __forceinline__ unsigned long long composite(unsigned key, int i, int ibits) {
  return ((unsigned long long)key << ibits) | (((1ull << ibits) - 1ull) - (unsigned long long)i);
}

// Exclusive prefix sum of v over the block's threads in thread order;
// blockDim.x a multiple of 32.  Two barriers; s_warp holds 32 ints.
__device__ __forceinline__ int block_exclusive_sum(int v, int* s_warp) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_warp[wid] = x;
  __syncthreads();
  if (wid == 0) {
    int y = lane < nw ? s_warp[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int z = __shfl_up_sync(FULL, y, o);
      if (lane >= o) y += z;
    }
    if (lane < nw) s_warp[lane] = y;
  }
  __syncthreads();
  return (wid ? s_warp[wid - 1] : 0) + x - v;
}

// Adds a thread's digits to a histogram, one atomic a run of equal digits.
struct RunAdder {
  unsigned cur = 0u, run = 0u;
  __device__ __forceinline__ void add(unsigned* h, unsigned dig) {
    if (dig != cur) {
      if (run) atomicAdd(h + cur, run);
      cur = dig;
      run = 0u;
    }
    ++run;
  }
  __device__ __forceinline__ void flush(unsigned* h) {
    if (run) atomicAdd(h + cur, run);
  }
};

// After the histogram h of nb bins is counted (and a barrier): finds the
// bin where the count from the top reaches `need` and leaves in s_res the
// bin, the count above it and its own count; ends on a barrier.  Thread t
// sums the t-th group of bins from the top; one block scan orders them.
__device__ __forceinline__ void find_digit(const unsigned* h, int nb, int need, int* s_warp,
                                           int* s_res) {
  const int NT = blockDim.x;
  const int per = (nb + NT - 1) / NT;
  const int hi = nb - (int)threadIdx.x * per, lo = max(hi - per, 0);
  int s = 0;
  for (int b = hi - 1; b >= lo; --b) s += (int)h[b];
  const int above = block_exclusive_sum(s, s_warp);
  if (above < need && need <= above + s) {
    int acc = above;
    for (int b = hi - 1; b >= lo; --b) {
      const int n = (int)h[b];
      if (acc + n >= need) {
        s_res[0] = b;
        s_res[1] = acc;
        s_res[2] = n;
        break;
      }
      acc += n;
    }
  }
  __syncthreads();
}

template <bool VEC4>
__global__ void __launch_bounds__(MAX_THREADS)
    power_topics_kernel(const float* __restrict__ r, const int* __restrict__ sel_w,
                        int* __restrict__ out, int Pk, int W, int K, int ibits, int n_cand) {
  // dynamic shared memory: candidates' composites [CAP], two histograms,
  // candidate or winner ids [n_cand, a multiple of 4], the row's keys [K]
  extern __shared__ unsigned long long smem_u64[];
  unsigned long long* ckey = smem_u64;
  unsigned* hist = reinterpret_cast<unsigned*>(ckey + CAP);
  int* cand = reinterpret_cast<int*>(hist + 2 * BINS);
  unsigned* keys = reinterpret_cast<unsigned*>(cand + n_cand);
  __shared__ int s_warp[32];
  __shared__ unsigned s_max[32], s_min[32];
  __shared__ int s_res[3];
  __shared__ int s_ncand, s_nwin;

  const int t = threadIdx.x, NT = blockDim.x;
  const int lane = t & 31, wid = t >> 5, nw = NT >> 5;
  const int p = blockIdx.x;
  int* orow = out + (size_t)p * Pk;
  const int w = sel_w[p];
  const bool inside = w >= 0 && w < W;
  const float* row = r + (size_t)(inside ? w : 0) * K;

  // ---- the row, read once: keys to shared memory, each thread's extremes
  unsigned kmax = 0u, kmin = FULL;
  if (VEC4) {
    const float4* row4 = reinterpret_cast<const float4*>(row);
    const int K4 = K >> 2;
#pragma unroll 4
    for (int i = t; i < K4; i += NT) {
      const float4 v = inside ? __ldg(row4 + i) : make_float4(0.f, 0.f, 0.f, 0.f);
      uint4 k;
      k.x = order_key(v.x);
      k.y = order_key(v.y);
      k.z = order_key(v.z);
      k.w = order_key(v.w);
      reinterpret_cast<uint4*>(keys)[i] = k;
      kmax = max(kmax, max(max(k.x, k.y), max(k.z, k.w)));
      kmin = min(kmin, min(min(k.x, k.y), min(k.z, k.w)));
    }
  } else {
#pragma unroll 4
    for (int i = t; i < K; i += NT) {
      const unsigned k = order_key(inside ? __ldg(row + i) : 0.f);
      keys[i] = k;
      kmax = max(kmax, k);
      kmin = min(kmin, k);
    }
  }
  const int groups = min(NT, VEC4 ? (K >> 2) : K);   // threads holding keys
  const bool has = t < groups;
  {
    const unsigned a = __reduce_max_sync(FULL, kmax), b = __reduce_min_sync(FULL, kmin);
    if (lane == 0) {
      s_max[wid] = a;
      s_min[wid] = b;
    }
  }
  for (int i = t; i < BOUND_BINS; i += NT) hist[i] = hist[BINS + i] = 0u;
  if (t == 0) s_ncand = s_nwin = 0;
  __syncthreads();
  unsigned gmax = 0u, gmin = FULL;
  for (int i = 0; i < nw; ++i) {
    gmax = max(gmax, s_max[i]);
    gmin = min(gmin, s_min[i]);
  }
  if (gmax == gmin) {                      // one value throughout: lowest ids
    for (int j = t; j < Pk; j += NT) orow[j] = j;
    return;
  }

  if (groups >= Pk) {
    // ---- a lower bound of the Pk-th key: the Pk-th group maximum, to 16 bits
    unsigned prefix = 0u;
    int done = 0, need = Pk;
    for (int pass = 0; done < 2 * BOUND_BITS; ++pass) {
      unsigned* h = hist + (pass & 1) * BINS;
      const int shift = 32 - done - BOUND_BITS;
      if (has && (done == 0 || (kmax >> (32 - done)) == prefix))
        atomicAdd(h + ((kmax >> shift) & (BOUND_BINS - 1)), 1u);
      __syncthreads();
      find_digit(h, BOUND_BINS, need, s_warp, s_res);
      need -= s_res[1];
      prefix = (prefix << BOUND_BITS) | (unsigned)s_res[0];
      done += BOUND_BITS;
      if (s_res[2] == need) break;
    }
    const unsigned tau = prefix << (32 - done);

    // ---- the candidates: every key at or above the bound
    if (VEC4) {
      const int K4 = K >> 2;
      for (int i = t; i < K4; i += NT) {
        const uint4 k = reinterpret_cast<const uint4*>(keys)[i];
        const unsigned kk[4] = {k.x, k.y, k.z, k.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (kk[c] >= tau) {
            const int slot = atomicAdd(&s_ncand, 1);
            if (slot < CAP) ckey[slot] = composite(kk[c], 4 * i + c, ibits);
          }
        }
      }
    } else {
      for (int i = t; i < K; i += NT) {
        const unsigned k = keys[i];
        if (k >= tau) {
          const int slot = atomicAdd(&s_ncand, 1);
          if (slot < CAP) ckey[slot] = composite(k, i, ibits);
        }
      }
    }
    __syncthreads();
    const int C = s_ncand;
    if (C <= CAP) {
      // ---- each candidate's rank among them is its place
      const unsigned long long imask = (1ull << ibits) - 1ull;
      for (int a = t; a < C; a += NT) {
        const unsigned long long mine = ckey[a];
        int rank = 0;
        for (int j = 0; j < C; ++j) rank += ckey[j] > mine;
        if (rank < Pk) orow[rank] = (int)(imask - (mine & imask));
      }
      return;
    }
  }

  // ---- the exact radix select over the whole row
  for (int i = t; i < 2 * BINS; i += NT) hist[i] = 0u;
  __syncthreads();
  unsigned prefix = 0u;
  int done = 0, need = Pk, last_count = 0;
  for (int pass = 0;; ++pass) {
    unsigned* h = hist + (pass & 1) * BINS;
    const int d = min(DIGIT_BITS, 32 - done);
    const int shift = 32 - done - d;
    const unsigned dmask = (1u << d) - 1u;
    RunAdder adder;
    for (int i = t; i < K; i += NT) {
      const unsigned k = keys[i];
      if (done == 0 || (k >> (32 - done)) == prefix) adder.add(h, (k >> shift) & dmask);
    }
    adder.flush(h);
    __syncthreads();
    find_digit(h, 1 << d, need, s_warp, s_res);
    need -= s_res[1];
    prefix = (prefix << d) | (unsigned)s_res[0];
    done += d;
    last_count = s_res[2];
    for (int i = t; i < (1 << d); i += NT) h[i] = 0u;
    if (last_count == need || done == 32) break;
  }
  if (last_count == need) {
    // the keys whose top bits are at least the prefix: exactly Pk
    for (int i = t; i < K; i += NT) {
      if ((keys[i] >> (32 - done)) >= prefix) cand[atomicAdd(&s_nwin, 1)] = i;
    }
  } else {
    // the keys above the Pk-th value, then the `need` lowest ids of those
    // equal to it, counted in id order (thread t holds the t-th stretch)
    const unsigned T = prefix;
    for (int i = t; i < K; i += NT) {
      if (keys[i] > T) cand[atomicAdd(&s_nwin, 1)] = i;
    }
    const int len = (K + NT - 1) / NT;
    const int lo = min(K, t * len), hi = min(K, lo + len);
    int n = 0;
    for (int i = lo; i < hi; ++i) n += keys[i] == T;
    int before = block_exclusive_sum(n, s_warp);
    for (int i = lo; i < hi && before < need; ++i) {
      if (keys[i] == T) {
        cand[atomicAdd(&s_nwin, 1)] = i;
        ++before;
      }
    }
  }
  __syncthreads();
  for (int a = t; a < Pk; a += NT) {
    const int ia = cand[a];
    const unsigned long long mine = composite(keys[ia], ia, ibits);
    int rank = 0;
    for (int j = 0; j < Pk; ++j) rank += composite(keys[cand[j]], cand[j], ibits) > mine;
    orow[rank] = ia;
  }
}

// The kernel's dynamic shared memory at K topics and n_cand ids.
int shared_bytes(int K, int n_cand) { return 8 * CAP + 4 * (2 * BINS + n_cand + K); }

}  // namespace

extern "C" {

// Lets both forms of the kernel take the device's largest dynamic shared
// memory and stores how much a CTA may take (the keys of a row, the
// histograms, the candidates) in *smem_bytes.  Returns the CUDA error code
// (0 on success).
int power_topics_configure(int* smem_bytes) {
  int device = 0, optin = 0;
  cudaFuncAttributes attr;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, power_topics_kernel<true>);
  if (err != cudaSuccess) return (int)err;
  *smem_bytes = optin - (int)attr.sharedSizeBytes;
  err = cudaFuncSetAttribute(power_topics_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, *smem_bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(power_topics_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, *smem_bytes);
  return (int)err;
}

// Launches the selection on `stream`: one CTA of `threads` (a power of two,
// 32 .. 512) a power word, writing the [P, Pk] `out`; allocates nothing.
// 1 <= Pk <= K.  Rows are read with 16-byte loads when K is a multiple of 4
// and `r` is 16-byte aligned.  Returns the CUDA error code of the launch
// (0 on success).
int power_topics(const float* r, const int* sel_w, int* out, int P, int Pk, int W, int K,
                 int threads, void* stream) {
  if (P > 0) {
    int ibits = 0;
    while ((1ll << ibits) < (long long)K) ++ibits;
    const int n_cand = ((Pk > CAP ? Pk : CAP) + 3) / 4 * 4;   // keys stay 16-byte aligned
    const int smem = shared_bytes(K, n_cand);
    const bool vec4 = (K % 4 == 0) && (reinterpret_cast<unsigned long long>(r) % 16 == 0);
    if (vec4)
      power_topics_kernel<true><<<P, threads, smem, (cudaStream_t)stream>>>(
          r, sel_w, out, Pk, W, K, ibits, n_cand);
    else
      power_topics_kernel<false><<<P, threads, smem, (cudaStream_t)stream>>>(
          r, sel_w, out, Pk, W, K, ibits, n_cand);
  }
  return (int)cudaGetLastError();
}

const char* power_topics_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
