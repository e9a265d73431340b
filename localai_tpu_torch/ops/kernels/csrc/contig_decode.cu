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
// Design: K1's block (decode_attention.cuh) with the contiguous row
// policy: row c of the slot is at (c * KV + h) * hd of the slot's block, no
// page table. The TPU kernel loaded each slot's whole [C, KV, hd] block;
// here, as in K1, rows past lengths[s] are never read. One block per
// (slot, kv head); split-K for long contexts is later work, as for K1.

#include <stdint.h>

#include "decode_attention.cuh"

namespace {

using namespace localai_kernels;
using namespace localai_kernels::decode;

template <typename T>
__global__ void __launch_bounds__(kThreads)
contig_decode_kernel(const T* __restrict__ q,          // [S, KV*G, hd]
                     const T* __restrict__ nk,         // [S, KV, hd]
                     const T* __restrict__ nv,         // [S, KV, hd]
                     const T* __restrict__ ck,         // [L, S', C, KV, hd]
                     const T* __restrict__ cv,
                     const int* __restrict__ lengths,  // [S]
                     const int* __restrict__ layer_idx,  // [1] (K5) or nullptr (K4)
                     T* __restrict__ out,              // [S, KV*G, hd]
                     int KV, int G, int hd, int C, int s_alloc, int L) {
  const int s = blockIdx.x;
  const int h = blockIdx.y;
  int length = lengths[s];
  length = length < 0 ? 0 : (length > C ? C : length);
  int li = layer_idx == nullptr ? 0 : layer_idx[0];
  li = li < 0 ? 0 : (li >= L ? L - 1 : li);
  const size_t slot_rows = static_cast<size_t>(C) * KV * hd;
  const size_t base = (static_cast<size_t>(li) * s_alloc + s) * slot_rows;
  const size_t H = static_cast<size_t>(KV) * G;
  const size_t qo = (static_cast<size_t>(s) * H + static_cast<size_t>(h) * G) * hd;
  const size_t ko = (static_cast<size_t>(s) * KV + h) * hd;
  append_block<T, T, false>(q + qo, nk + ko, nv + ko, ck + base, cv + base, nullptr, nullptr,
                            ContigRows{}, length, out + qo, KV, h, G, hd);
}

template <typename T>
int launch(const void* q, const void* nk, const void* nv, const void* ck, const void* cv,
           const void* lengths, const void* layer_idx, void* out, int S, int KV, int G, int hd,
           int C, int s_alloc, int L, cudaStream_t st) {
  const size_t bytes = smem_bytes<T>(hd, G);
  cudaError_t err = cudaFuncSetAttribute(contig_decode_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(S, KV);
  contig_decode_kernel<T><<<grid, kThreads, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(nk), static_cast<const T*>(nv),
      static_cast<const T*>(ck), static_cast<const T*>(cv), static_cast<const int*>(lengths),
      static_cast<const int*>(layer_idx), static_cast<T*>(out), KV, G, hd, C, s_alloc, L);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const void* q, const void* nk, const void* nv, const void* ck, const void* cv,
             const void* lengths, const void* layer_idx, void* out, int S, int KV, int G, int hd,
             int C, int s_alloc, int L, int dtype, void* stream) {
  if (decode::bad_shape(S, KV, G, hd) || C <= 0 || s_alloc < S || L <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, nk, nv, ck, cv, lengths, layer_idx, out, S, KV, G, hd, C, s_alloc, L,
                         st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, nk, nv, ck, cv, lengths, layer_idx, out, S, KV, G, hd, C,
                                 s_alloc, L, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// K4: cache [S, C, KV, hd]. dtype: 0 = float32, 1 = bfloat16. Returns
// cudaGetLastError() after the launch (0 = success); shapes the kernel
// does not take return cudaErrorInvalidValue without launching.
extern "C" int contig_decode_attention_launch(const void* q, const void* nk, const void* nv,
                                              const void* ck, const void* cv, const void* lengths,
                                              void* out, int S, int KV, int G, int hd, int C,
                                              int dtype, void* stream) {
  return dispatch(q, nk, nv, ck, cv, lengths, nullptr, out, S, KV, G, hd, C, S, 1, dtype, stream);
}

// K5: cache [L, s_alloc, C, KV, hd], layer_idx an int32 in device memory
// (clamped to [0, L)). Same dtype codes and return convention as K4.
extern "C" int contig_decode_attention_full_launch(const void* q, const void* nk, const void* nv,
                                                   const void* ck, const void* cv,
                                                   const void* lengths, const void* layer_idx,
                                                   void* out, int S, int KV, int G, int hd, int C,
                                                   int s_alloc, int L, int dtype, void* stream) {
  if (layer_idx == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(q, nk, nv, ck, cv, lengths, layer_idx, out, S, KV, G, hd, C, s_alloc, L, dtype,
                  stream);
}
