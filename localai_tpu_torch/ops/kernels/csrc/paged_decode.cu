// Paged decode attention with the current token appended: K1 (float pages)
// and K3 (int8 pages with per-row scales).
//
// K1 replaces the TPU kernel localai_tpu/ops/pallas/paged_attention.py::
// paged_decode_attention_append (body `_kernel`, pallas_call at :154).
// K3 replaces paged_decode_attention_append_quant in the same file (body
// `_kernel_quant` :163, pallas_call at :281): K1 over int8 pages with f32
// scales [n_pages, pg, KV] folded into the scores (k) and the probabilities
// (v); the current token's k/v stay float. Semantics match
// localai_tpu/ops/attention.py::decode_attention_append over the slot's
// logical rows [0, lengths[s]) read through the page table (int8 rows as
// {"q","s"}), plus the current token's own key/value (not yet in the pool).
//
// Bound on an H100: memory. Per layer and step the work reads every
// committed K and V row of every slot once (2 * sum(lengths) * KV * hd
// elements, plus 2 * sum(lengths) * KV f32 scales for K3) and does 2 * G
// flops per element read: 4 flop/byte in bf16 at G = 4, 8 in int8, far below
// the ~295 flop/byte ridge, so the floor is bytes / 3.35 TB/s. K3 moves
// (hd + 4) / (2 hd) of K1's bytes: about half.
//
// Design (decode_attention.cuh holds the block): split-K over the slot's
// rows (flash-decoding). The TPU grid (S, max_pages) carried m/l/acc across
// sequential grid steps in VMEM; CUDA blocks share nothing, so the rows are
// cut into n_split = ceil(mp * pg / split_rows) splits (a whole number of
// pages at the serving page size; shapes alone), and the grid is (S, KV,
// n_split): block (s, h, k) walks split k of slot s if it starts before
// the length, else exits at once. A long slot's rows are thus spread over
// many SMs instead of one block per (slot, kv head) walking them all. Each
// block reads its rows' pages from the slot's page-table row itself, keeps
// three 32-row tiles in a cp.async ring (the next tiles' table reads, rows
// and int8 scales load while one is scored), and shares each K/V row it
// stages among the G = H / KV query heads, so a row leaves device memory
// ONCE. Splits past ceil(length / split_rows) are never walked, so pages
// past the length cost nothing (the TPU kernel's index-map clamp). The
// combine kernel, launched right after by the same launcher as a
// programmatic dependent, merges the partials and folds in the current
// token for K1 and K3 alike.

#include <stdint.h>

#include "decode_attention.cuh"

namespace {

using namespace localai_kernels;
using namespace localai_kernels::decode;

template <typename T, typename TC, bool kQuant>
__global__ void __launch_bounds__(kThreads, split_min_blocks<kQuant>())
paged_split_kernel(const T* __restrict__ q,         // [S, KV*G, hd]
                   const TC* __restrict__ pk,       // [n_pages, pg, KV, hd]
                   const TC* __restrict__ pv,       // [n_pages, pg, KV, hd]
                   const float* __restrict__ sk,    // [n_pages, pg, KV] (K3 only)
                   const float* __restrict__ sv,    // [n_pages, pg, KV] (K3 only)
                   const int* __restrict__ ptab,    // [S, mp]
                   const int* __restrict__ lengths, // [S]
                   Partials part, int n_pages, int pg, int mp, int split_rows) {
  launch_dependents();  // the combine may start; it waits for the partials
  const int s = blockIdx.x;
  const int h = blockIdx.y;
  const int k = blockIdx.z;
  int length = lengths[s];
  length = length < 0 ? 0 : (length > mp * pg ? mp * pg : length);
  if (k * split_rows >= length) return;
  const size_t qo = (static_cast<size_t>(s) * part.KV + h) * part.G * part.hd;
  const PagedRows rows{ptab + static_cast<size_t>(s) * mp, pg, n_pages};
  split_block<T, TC, kQuant>(q + qo, pk, pv, sk, sv, rows, k * split_rows,
                             min(length, (k + 1) * split_rows), part.acc(s, h, k),
                             part.ml(s, h, k), part.KV, h, part.G, part.hd);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
combine_kernel(const T* __restrict__ q, const T* __restrict__ nk, const T* __restrict__ nv,
               const int* __restrict__ lengths, Partials part, T* __restrict__ out, int rows_cap,
               int split_rows) {
  combine_block<T>(q, nk, nv, lengths, part, out, rows_cap, split_rows);
}

template <typename T, typename TC, bool kQuant>
int launch(const void* q, const void* nk, const void* nv, const void* pk, const void* pv,
           const void* sk, const void* sv, const void* ptab, const void* lengths, void* out,
           void* ws, int S, int KV, int G, int hd, int n_pages, int pg, int mp, int split_rows,
           cudaStream_t st) {
  const size_t bytes = smem_bytes<TC>(hd, G);
  cudaError_t err = cudaFuncSetAttribute(paged_split_kernel<T, TC, kQuant>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows_cap = mp * pg;
  const Partials part{static_cast<float*>(ws), S, KV, G, hd, n_splits(rows_cap, split_rows)};
  paged_split_kernel<T, TC, kQuant><<<dim3(S, KV, part.n_split), kThreads, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const TC*>(pk), static_cast<const TC*>(pv),
      static_cast<const float*>(sk), static_cast<const float*>(sv), static_cast<const int*>(ptab),
      static_cast<const int*>(lengths), part, n_pages, pg, mp, split_rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_combine(
      combine_kernel<T>, S, KV, st, static_cast<const T*>(q), static_cast<const T*>(nk),
      static_cast<const T*>(nv), static_cast<const int*>(lengths), part, static_cast<T*>(out),
      rows_cap, split_rows));
}

bool bad_pages(int S, int KV, int G, int hd, int n_pages, int pg, int mp, int split_rows) {
  return pg <= 0 || mp <= 0 || n_pages <= 0 || bad_shape(S, KV, G, hd, mp * pg, split_rows);
}

}  // namespace

// K1. dtype: 0 = float32, 1 = bfloat16 (q, new k/v, pages, out alike).
// ws: the f32 workspace of S * KV * ceil(mp * pg / split_rows) * G *
// (hd + 2) floats (split_rows: a positive multiple of 32). Returns
// cudaGetLastError() after the launches (0 = success); shapes the kernels
// do not take return cudaErrorInvalidValue without launching. Float
// operands must be 16-byte aligned (the wrapper checks).
extern "C" int paged_decode_attention_launch(const void* q, const void* nk, const void* nv,
                                             const void* pk, const void* pv, const void* ptab,
                                             const void* lengths, void* out, void* ws, int S,
                                             int KV, int G, int hd, int n_pages, int pg, int mp,
                                             int split_rows, int dtype, void* stream) {
  if (bad_pages(S, KV, G, hd, n_pages, pg, mp, split_rows))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, float, false>(q, nk, nv, pk, pv, nullptr, nullptr, ptab, lengths, out,
                                       ws, S, KV, G, hd, n_pages, pg, mp, split_rows, st);
  if (dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16, false>(q, nk, nv, pk, pv, nullptr, nullptr, ptab,
                                                       lengths, out, ws, S, KV, G, hd, n_pages,
                                                       pg, mp, split_rows, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K3. dtype of q, new k/v and out: 0 = float32, 1 = bfloat16; pages are
// int8, scales float32. Workspace and return convention as K1.
extern "C" int paged_decode_attention_quant_launch(const void* q, const void* nk, const void* nv,
                                                   const void* pk, const void* sk, const void* pv,
                                                   const void* sv, const void* ptab,
                                                   const void* lengths, void* out, void* ws,
                                                   int S, int KV, int G, int hd, int n_pages,
                                                   int pg, int mp, int split_rows, int dtype,
                                                   void* stream) {
  if (bad_pages(S, KV, G, hd, n_pages, pg, mp, split_rows))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, int8_t, true>(q, nk, nv, pk, pv, sk, sv, ptab, lengths, out, ws, S, KV,
                                       G, hd, n_pages, pg, mp, split_rows, st);
  if (dtype == 1)
    return launch<__nv_bfloat16, int8_t, true>(q, nk, nv, pk, pv, sk, sv, ptab, lengths, out, ws,
                                               S, KV, G, hd, n_pages, pg, mp, split_rows, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
