// Power-submatrix row gather and row scatter-add, for Hopper (sm_90a).
//
// pack_rows replaces the TPU kernel src/repro/kernels/power_pack/kernel.py:50
// (pack_rows_pallas): the phi pack of every t>=2 iteration of the packed
// selective sweep,
//
//   out[p, j] = mat[sel_w[p], sel_k[p, j]]   for p < P, j < Pk,
//
// with 0 where the (row, column) pair lies outside [0, W) x [0, K) (the TPU
// kernel's out-of-range one-hot column packs to 0).  The TPU kernel DMAs
// each selected [1, K] row into VMEM and contracts it with a one-hot MXU
// product, because Pallas-TPU has no dynamic gather.  Here each thread owns
// one (p, j) pair and loads its one element by index: no row is read whole.
// It is the mirror of the scatter below.  Bound, at the training slice's
// shapes (P = 14104, Pk = 50): read sel_w, sel_k and one element of mat per
// pair and write out, 4 * (P + 3 * P * Pk) B = 8.5 MB, ~2.5 us at
// 3.35 TB/s, bound by bytes.  What bounds it in practice is the card's
// rate of scattered 32-byte sectors: each pair reads a sector of its own of
// the 1.13 GB phi, 705,200 sectors (22.6 MB) in ~0.03 ms with the L2 cold
// (chip_smoke.py phase 2 on an H100), ~25 G sectors/s.  Variants timed in
// turns with this kernel on an H100 (PERF.md has the numbers): the rows
// sorted by address, the rows contiguous, and one warp per 4 rows with
// sel_w read once a row and every load issued before any store all ran
// within 9% of it, the warp variant no faster; so latency chains and
// address locality are not what limits it, and the kernel stays one thread
// per pair.  chip_smoke.py phase 2 holds it to no slower than the library
// gather mat[sel_w[:, None], sel_k].
//
// scatter_add_rows replaces the TPU kernel
// src/repro/kernels/power_pack/kernel.py:75 (scatter_add_rows_pallas): the
// phi fold of every t>=2 POBP iteration,
//
//   mat[sel_w[p], sel_k[p, j]] += vals[p, j]   for p < P, j < Pk,
//
// with mat the [W, K] phi statistic updated in place.  Pairs whose row or
// column lies outside [0, W) x [0, K) are dropped (the reference's scatter
// drops them too).
//
// Design.  The TPU kernel DMAs each selected [1, K] row into VMEM and adds
// a one-hot MXU product of the packed values, because Pallas-TPU has no
// dynamic scatter.  Here each thread owns one (p, j) pair and adds its value
// with one atomicAdd straight into HBM: no row is read whole.  The atomic is
// what keeps repeated rows right (a live-vocabulary run points every dead
// slot at one guard row, carrying zeros); when the (row, column) pairs are
// unique, as they are whenever sel_w and each row of sel_k hold distinct
// ids (top-k selections), the result is exact and independent of order.
//
// Bound.  At the training slice's shapes (P = 14104 power words, Pk = 50
// power topics, W = 141043, K = 2000) the function reads sel_k and vals
// (2 * P * Pk * 4 B), sel_w (P * 4 B) and each touched element of mat, and
// writes it back: ~11.3 MB, ~3.4 us at 3.35 TB/s.  It is bound by bytes
// (one add per element).  What bounds it in practice is the card's rate of
// scattered sectors: a row's 50 random topics of 2000 fall in ~45.9
// distinct 32-byte sectors, ~647,000 sectors in all (~20.7 MB), each read
// and written back, in ~0.047 ms with the L2 flushed (~13.7 G sectors/s,
// ~27 G sector moves/s, the rate pack_rows reads at) and ~0.040 ms with
// the L2 warm (flushed, then pack_rows of the same selection, as on the
// main path).  Variants timed in turns with this kernel on an H100
// (PERF.md has the numbers): one warp per row with the row's topic ids
// sorted in shared memory ran within 1.5% of it flushed and warm, the warp
// unsorted 6% slower; the rows sorted by address ran 1% faster flushed and
// 7% faster warm, but only with the sort made beforehand: sorting inside
// the function took 2.5x the kernel's time.  Neither locality within a row
// nor the atomic unit is the limit, so the kernel stays one thread per
// pair.  chip_smoke.py phase 2 holds it to no slower than the library's
// index_put_(accumulate=True).

#include <cuda_runtime.h>

namespace {

__global__ void scatter_add_rows_kernel(float* mat, const int* __restrict__ sel_w,
                                        const int* __restrict__ sel_k,
                                        const float* __restrict__ vals, int P,
                                        int Pk, int W, int K) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)P * Pk) return;
  const int w = sel_w[i / Pk];
  const int k = sel_k[i];
  if (w < 0 || w >= W || k < 0 || k >= K) return;
  atomicAdd(mat + (size_t)w * K + k, vals[i]);
}

__global__ void pack_rows_kernel(const float* __restrict__ mat,
                                 const int* __restrict__ sel_w,
                                 const int* __restrict__ sel_k,
                                 float* __restrict__ out, int P, int Pk, int W,
                                 int K) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)P * Pk) return;
  const int w = sel_w[i / Pk];
  const int k = sel_k[i];
  out[i] = (w < 0 || w >= W || k < 0 || k >= K) ? 0.f : __ldg(mat + (size_t)w * K + k);
}

}  // namespace

extern "C" {

// Launches the gather on `stream` into the [P, Pk] `out`; allocates
// nothing.  Returns the CUDA error code of the launch (0 on success).
int pack_rows(const float* mat, const int* sel_w, const int* sel_k, float* out,
              int P, int Pk, int W, int K, void* stream) {
  const long long n = (long long)P * Pk;
  const int threads = 256;
  if (n > 0) {
    const unsigned blocks = (unsigned)((n + threads - 1) / threads);
    pack_rows_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        mat, sel_w, sel_k, out, P, Pk, W, K);
  }
  return (int)cudaGetLastError();
}

// Launches the scatter on `stream`; allocates nothing.  Returns the CUDA
// error code of the launch (0 on success).
int scatter_add_rows(float* mat, const int* sel_w, const int* sel_k,
                     const float* vals, int P, int Pk, int W, int K,
                     void* stream) {
  const long long n = (long long)P * Pk;
  const int threads = 256;
  if (n > 0) {
    const unsigned blocks = (unsigned)((n + threads - 1) / threads);
    scatter_add_rows_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        mat, sel_w, sel_k, vals, P, Pk, W, K);
  }
  return (int)cudaGetLastError();
}

const char* power_pack_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
