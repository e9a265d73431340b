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
// Design (decode_attention.cuh holds the block). One block per (slot, kv
// head), 128 threads. The TPU grid (S, max_pages) carried m/l/acc across
// sequential grid steps in VMEM; CUDA blocks share nothing, so the page
// walk is the block's inner loop: tiles of 64 logical rows, each row's
// physical page read from the slot's page-table row by the block itself.
// A tile's K and V rows are staged in shared memory with 16-byte loads
// issued by every thread at once (8 bf16 or 16 int8 elements per load:
// many loads in flight per SM, which is what the bytes floor needs), then
// the G = H / KV query heads of the kv head score and accumulate from
// shared memory, so each K/V row leaves device memory ONCE for all G heads.
// Rows past lengths[s] are never touched, so pages past ceil(length / pg)
// cost nothing (the TPU kernel's index-map clamp). K1 walks the appended
// token as logical row lengths[s]; K3's int8 tiles cannot hold it, so K3
// folds it in after the walk. Split-K over pages (flash-decoding), to fill
// all 132 SMs when few slots hold long contexts, is later work.

#include <stdint.h>

#include "decode_attention.cuh"

namespace {

using namespace localai_kernels;
using namespace localai_kernels::decode;

template <typename T, typename TC, bool kQuant>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q,         // [S, KV*G, hd]
                    const T* __restrict__ nk,        // [S, KV, hd]
                    const T* __restrict__ nv,        // [S, KV, hd]
                    const TC* __restrict__ pk,       // [n_pages, pg, KV, hd]
                    const TC* __restrict__ pv,       // [n_pages, pg, KV, hd]
                    const float* __restrict__ sk,    // [n_pages, pg, KV] (K3 only)
                    const float* __restrict__ sv,    // [n_pages, pg, KV] (K3 only)
                    const int* __restrict__ ptab,    // [S, mp]
                    const int* __restrict__ lengths, // [S]
                    T* __restrict__ out,             // [S, KV*G, hd]
                    int KV, int G, int hd, int n_pages, int pg, int mp) {
  const int s = blockIdx.x;
  const int h = blockIdx.y;
  int length = lengths[s];
  length = length < 0 ? 0 : (length > mp * pg ? mp * pg : length);
  const size_t H = static_cast<size_t>(KV) * G;
  const size_t qo = (static_cast<size_t>(s) * H + static_cast<size_t>(h) * G) * hd;
  const size_t ko = (static_cast<size_t>(s) * KV + h) * hd;
  append_block<T, TC, kQuant>(q + qo, nk + ko, nv + ko, pk, pv, sk, sv,
                              PagedRows{ptab + static_cast<size_t>(s) * mp, pg, n_pages}, length,
                              out + qo, KV, h, G, hd);
}

template <typename T, typename TC, bool kQuant>
int launch(const void* q, const void* nk, const void* nv, const void* pk, const void* pv,
           const void* sk, const void* sv, const void* ptab, const void* lengths, void* out,
           int S, int KV, int G, int hd, int n_pages, int pg, int mp, cudaStream_t st) {
  const size_t bytes = smem_bytes<TC>(hd, G);
  cudaError_t err = cudaFuncSetAttribute(paged_decode_kernel<T, TC, kQuant>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(S, KV);
  paged_decode_kernel<T, TC, kQuant><<<grid, kThreads, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(nk), static_cast<const T*>(nv),
      static_cast<const TC*>(pk), static_cast<const TC*>(pv), static_cast<const float*>(sk),
      static_cast<const float*>(sv), static_cast<const int*>(ptab),
      static_cast<const int*>(lengths), static_cast<T*>(out), KV, G, hd, n_pages, pg, mp);
  return static_cast<int>(cudaGetLastError());
}

bool bad_pages(int n_pages, int pg, int mp) { return pg <= 0 || mp <= 0 || n_pages <= 0; }

}  // namespace

// K1. dtype: 0 = float32, 1 = bfloat16 (q, new k/v, pages, out alike).
// Returns cudaGetLastError() after the launch (0 = success); shapes the
// kernel does not take return cudaErrorInvalidValue without launching.
// Float operands must be 16-byte aligned (the wrapper checks).
extern "C" int paged_decode_attention_launch(const void* q, const void* nk, const void* nv,
                                             const void* pk, const void* pv, const void* ptab,
                                             const void* lengths, void* out, int S, int KV, int G,
                                             int hd, int n_pages, int pg, int mp, int dtype,
                                             void* stream) {
  if (bad_shape(S, KV, G, hd) || bad_pages(n_pages, pg, mp))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, float, false>(q, nk, nv, pk, pv, nullptr, nullptr, ptab, lengths, out,
                                       S, KV, G, hd, n_pages, pg, mp, st);
  if (dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16, false>(q, nk, nv, pk, pv, nullptr, nullptr, ptab,
                                                       lengths, out, S, KV, G, hd, n_pages, pg,
                                                       mp, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K3. dtype of q, new k/v and out: 0 = float32, 1 = bfloat16; pages are
// int8, scales float32. Same return convention as K1.
extern "C" int paged_decode_attention_quant_launch(const void* q, const void* nk, const void* nv,
                                                   const void* pk, const void* sk, const void* pv,
                                                   const void* sv, const void* ptab,
                                                   const void* lengths, void* out, int S, int KV,
                                                   int G, int hd, int n_pages, int pg, int mp,
                                                   int dtype, void* stream) {
  if (bad_shape(S, KV, G, hd) || bad_pages(n_pages, pg, mp))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, int8_t, true>(q, nk, nv, pk, pv, sk, sv, ptab, lengths, out, S, KV, G,
                                       hd, n_pages, pg, mp, st);
  if (dtype == 1)
    return launch<__nv_bfloat16, int8_t, true>(q, nk, nv, pk, pv, sk, sv, ptab, lengths, out, S,
                                               KV, G, hd, n_pages, pg, mp, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
