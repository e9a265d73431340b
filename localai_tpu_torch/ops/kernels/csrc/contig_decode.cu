// Decode attention with the current token appended over a CONTIGUOUS KV
// cache: K4 (one layer) and K5 (the stacked cache plus a layer index).
//
// K4 replaces the TPU kernel localai_tpu/ops/pallas/decode_attention.py::
// decode_attention_append_pallas (body `_kernel` :36, pallas_call at :157):
// cache [S, C, KV, hd], slot s's committed rows [0, lengths[s]) plus the
// current token's own key/value. K5 replaces
// decode_attention_append_pallas_full in the same file (body `_kernel_full`
// :71, pallas_call at :134): the same function over the stacked cache
// [L, S', C, KV, hd] at layer layer_idx[0], an int32 read from device
// memory by the kernel itself (the TPU kernel's scalar-prefetch argument),
// so no host sync and no sliced copy of the cache. S' >= S: slots past S
// (the port's scratch slot for dropped writes) are never read. Semantics
// match localai_tpu/ops/attention.py::decode_attention_append.
//
// Bound on an H100: memory, exactly as K1's: 2 * sum(lengths) * KV * hd
// elements read once at 2 * G flops each.
//
// Design: K1's split-K block (decode_attention.cuh) with the contiguous
// row policy: row c of the slot is at (c * KV + h) * hd of the slot's
// block, no page table. Grid (S, KV, n_split) over n_split = ceil(C /
// split_rows) splits from the shapes, block (s, h, k) walking split k; the
// TPU kernel loaded each slot's whole [C, KV, hd] block, here splits past
// ceil(lengths[s] / split_rows) exit at once and rows past lengths[s] are
// never read. The combine
// kernel, launched right after by the same launcher as a programmatic
// dependent, merges the splits and folds in the current token. K5's split
// blocks read the layer index themselves; the combine reads no cache.

#include <stdint.h>

#include "decode_attention.cuh"

namespace {

using namespace localai_kernels;
using namespace localai_kernels::decode;

template <typename T>
__global__ void __launch_bounds__(kThreads, split_min_blocks<false>())
contig_split_kernel(const T* __restrict__ q,          // [S, KV*G, hd]
                    const T* __restrict__ ck,         // [L, S', C, KV, hd]
                    const T* __restrict__ cv,
                    const int* __restrict__ lengths,  // [S]
                    const int* __restrict__ layer_idx,  // [1] (K5) or nullptr (K4)
                    Partials part, int C, int s_alloc, int L, int split_rows) {
  launch_dependents();  // the combine may start; it waits for the partials
  const int s = blockIdx.x;
  const int h = blockIdx.y;
  const int k = blockIdx.z;
  int length = lengths[s];
  length = length < 0 ? 0 : (length > C ? C : length);
  if (k * split_rows >= length) return;
  int li = layer_idx == nullptr ? 0 : layer_idx[0];
  li = li < 0 ? 0 : (li >= L ? L - 1 : li);
  const size_t slot_rows = static_cast<size_t>(C) * part.KV * part.hd;
  const size_t base = (static_cast<size_t>(li) * s_alloc + s) * slot_rows;
  const size_t qo = (static_cast<size_t>(s) * part.KV + h) * part.G * part.hd;
  split_block<T, T, false>(q + qo, ck + base, cv + base, nullptr, nullptr, ContigRows{},
                           k * split_rows, min(length, (k + 1) * split_rows), part.acc(s, h, k),
                           part.ml(s, h, k), part.KV, h, part.G, part.hd);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
combine_kernel(const T* __restrict__ q, const T* __restrict__ nk, const T* __restrict__ nv,
               const int* __restrict__ lengths, Partials part, T* __restrict__ out, int rows_cap,
               int split_rows) {
  combine_block<T>(q, nk, nv, lengths, part, out, rows_cap, split_rows);
}

template <typename T>
int launch(const void* q, const void* nk, const void* nv, const void* ck, const void* cv,
           const void* lengths, const void* layer_idx, void* out, void* ws, int S, int KV, int G,
           int hd, int C, int s_alloc, int L, int split_rows, cudaStream_t st) {
  const size_t bytes = smem_bytes<T>(hd, G);
  cudaError_t err = cudaFuncSetAttribute(contig_split_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const Partials part{static_cast<float*>(ws), S, KV, G, hd, n_splits(C, split_rows)};
  contig_split_kernel<T><<<dim3(S, KV, part.n_split), kThreads, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(ck), static_cast<const T*>(cv),
      static_cast<const int*>(lengths), static_cast<const int*>(layer_idx), part, C, s_alloc, L,
      split_rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_combine(
      combine_kernel<T>, S, KV, st, static_cast<const T*>(q), static_cast<const T*>(nk),
      static_cast<const T*>(nv), static_cast<const int*>(lengths), part, static_cast<T*>(out),
      C, split_rows));
}

int dispatch(const void* q, const void* nk, const void* nv, const void* ck, const void* cv,
             const void* lengths, const void* layer_idx, void* out, void* ws, int S, int KV, int G,
             int hd, int C, int s_alloc, int L, int split_rows, int dtype, void* stream) {
  if (decode::bad_shape(S, KV, G, hd, C, split_rows) || s_alloc < S || L <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, nk, nv, ck, cv, lengths, layer_idx, out, ws, S, KV, G, hd, C, s_alloc,
                         L, split_rows, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, nk, nv, ck, cv, lengths, layer_idx, out, ws, S, KV, G, hd, C,
                                 s_alloc, L, split_rows, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// K4: cache [S, C, KV, hd]. dtype: 0 = float32, 1 = bfloat16. ws: the f32
// workspace of S * KV * ceil(C / split_rows) * G * (hd + 2) floats
// (split_rows: a positive multiple of 32). Returns cudaGetLastError() after
// the launches (0 = success); shapes the kernels do not take return
// cudaErrorInvalidValue without launching.
extern "C" int contig_decode_attention_launch(const void* q, const void* nk, const void* nv,
                                              const void* ck, const void* cv, const void* lengths,
                                              void* out, void* ws, int S, int KV, int G, int hd,
                                              int C, int split_rows, int dtype, void* stream) {
  return dispatch(q, nk, nv, ck, cv, lengths, nullptr, out, ws, S, KV, G, hd, C, S, 1, split_rows,
                  dtype, stream);
}

// K5: cache [L, s_alloc, C, KV, hd], layer_idx an int32 in device memory
// (clamped to [0, L)). Same dtype codes, workspace and return convention as
// K4.
extern "C" int contig_decode_attention_full_launch(const void* q, const void* nk, const void* nv,
                                                   const void* ck, const void* cv,
                                                   const void* lengths, const void* layer_idx,
                                                   void* out, void* ws, int S, int KV, int G,
                                                   int hd, int C, int s_alloc, int L,
                                                   int split_rows, int dtype, void* stream) {
  if (layer_idx == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(q, nk, nv, ck, cv, lengths, layer_idx, out, ws, S, KV, G, hd, C, s_alloc, L,
                  split_rows, dtype, stream);
}
