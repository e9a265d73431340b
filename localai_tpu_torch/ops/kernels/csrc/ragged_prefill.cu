// Ragged packed-prefill attention over a paged cache: K2 (float pages) and
// K2-int8 (int8 pages with per-row scales).
//
// K2 replaces the TPU kernel localai_tpu/ops/pallas/ragged_prefill.py::
// ragged_prefill_attention_pallas (body `_kernel`, pallas_call at :251).
// Semantics match localai_tpu/ops/ragged_prefill.py::
// ragged_prefill_attention: an N-token pack holds up to B segments; the
// token at pack index n of segment b (n in [seg_off[b], seg_off[b] +
// seg_len[b])) attends its slot's committed rows [0, seg_start[b]) through
// ptab[seg_slots[b]] plus the pack's own keys m <= n of the same segment.
// Rows of pad tokens (in no segment) come out as zeros; callers ignore
// them. Fresh packs take the same kernel (launched with mp = 0: no
// committed rows, the pool is never read): on the card no plain op sits on
// the main path.
//
// K2-int8 is K2 over int8 committed pages with f32 scales [n_pages, pg, KV]:
// the key scale multiplies the score, the value scale multiplies the
// probability before the value product (the fold of the jnp int8 route,
// localai_tpu/ops/ragged_prefill.py:96-124, which the JAX package runs for
// int8 packs: its Pallas kernel takes float pages only). The pack's own
// keys stay float. A tile may straddle the committed rows and the pack, so
// int8 and float rows are staged in 8-element units into one f32 tile.
//
// Bound on an H100: operations. The work is 4 * hd flops per (query
// head, visible key) pair. At Llama-3.1-8B head shapes a 512-token chunk
// continuing 1024 committed rows is ~10.7 GFLOP per layer against ~14 MB
// of q/k/v/out bytes: 10.8 us at the 989 TFLOP/s bf16 tensor-core peak
// versus 4.2 us at 3.35 TB/s, so operations set the floor (int8 pages
// halve the committed bytes, not the flops). This first kernel computes in
// f32 on the CUDA cores (no wgmma, no TMA yet) and sits far above that
// floor; making it fast is later work.
//
// Design. The TPU grid swept every (q-block, segment, kv-step) and
// predicated non-overlapping pairs off. Here one block owns (query tile,
// kv head): 64 / G pack tokens, i.e. up to 64 query rows (tokens x the G
// heads sharing the kv head, so each K/V row is staged once for all G).
// The block looks up only the segment(s) its tile overlaps, and for each
// walks that segment's committed rows page by page (physical page from
// the table, read by the block itself), then the pack's own keys up to
// the tile's last token. Key tiles of 32 rows are staged in shared memory
// as f32 with 16-byte loads from every thread at once (row addresses
// looked up once per tile); scores, an online softmax per query row (f32,
// the -1e30 mask with explicit zero probabilities) and P.V accumulate in
// registers, reading shared memory four floats at a time.

#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

using namespace localai_kernels;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 64;  // query rows per block (tokens x G)
constexpr int kKeys = 32;     // key rows per tile (one per lane)
constexpr int kRowsPerWarp = kMaxRows / kWarps;
constexpr int kMaxAcc = 64;   // accumulators per thread: kMaxRows * hd / kThreads, hd <= 256

size_t smem_bytes(int hd) {
  return sizeof(float) * (static_cast<size_t>(kMaxRows) * hd        // q
                          + static_cast<size_t>(kKeys) * (hd + 4)   // k (padded)
                          + static_cast<size_t>(kKeys) * hd         // v
                          + static_cast<size_t>(kMaxRows) * kKeys   // p
                          + 3 * kMaxRows);                          // m, l, alpha
}

// T: q / pack keys / out; TC: committed pages (T, or int8 with scales)
template <typename T, typename TC>
__global__ void __launch_bounds__(kThreads)
ragged_prefill_kernel(const T* __restrict__ q,           // [N, KV*G, hd]
                      const T* __restrict__ ck,          // [N, KV, hd] pack keys
                      const T* __restrict__ cv,          // [N, KV, hd]
                      const TC* __restrict__ pk,         // [n_pages, pg, KV, hd]
                      const TC* __restrict__ pv,
                      const float* __restrict__ sk,      // [n_pages, pg, KV] (int8 only)
                      const float* __restrict__ sv,
                      const int* __restrict__ ptab,      // [S, mp]
                      const int* __restrict__ seg_slots, // [B]
                      const int* __restrict__ seg_start, // [B]
                      const int* __restrict__ seg_off,   // [B]
                      const int* __restrict__ seg_len,   // [B]
                      T* __restrict__ out,               // [N, KV*G, hd]
                      int N, int KV, int G, int hd, int n_pages, int pg, int mp, int S, int B) {
  constexpr bool kQuant = std::is_same<TC, int8_t>::value;
  constexpr int kVec = vec_elems<T>();
  extern __shared__ __align__(16) float smem[];
  __shared__ const void* s_krow[kKeys];
  __shared__ const void* s_vrow[kKeys];
  __shared__ bool s_kq[kKeys];     // int8: the row is a committed (int8) row
  __shared__ float s_ks[kKeys];    // int8: key / value scale of each key row
  __shared__ float s_vs[kKeys];
  const int qt = kMaxRows / G;        // pack tokens per block
  const int R = qt * G;               // query rows per block
  const int kstride = hd + 4;         // padded: float4 reads across rows are conflict-free
  float* q_s = smem;                              // [R][hd]
  float* k_s = q_s + kMaxRows * hd;               // [kKeys][kstride]
  float* v_s = k_s + kKeys * kstride;             // [kKeys][hd]
  float* p_s = v_s + kKeys * hd;                  // [R][kKeys]
  float* m_s = p_s + kMaxRows * kKeys;            // [R]
  float* l_s = m_s + kMaxRows;                    // [R]
  float* a_s = l_s + kMaxRows;                    // [R]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int h = blockIdx.y;
  const int n0 = blockIdx.x * qt;
  const int n_hi = min(n0 + qt, N);
  const size_t H = static_cast<size_t>(KV) * G;
  const float scale = rsqrtf(static_cast<float>(hd));
  const int chunks = hd / kVec;       // 16-byte chunks per row

  // q rows of this tile, pre-scaled: row r = (token n0 + r / G, head h*G + r % G)
  for (int c = tid; c < R * chunks; c += kThreads) {
    const int r = c / chunks, j = c - r * chunks;
    const int n = n0 + r / G, g = r % G;
    float f[kVec];
    if (n < N) {
      unpack16(q + (static_cast<size_t>(n) * H + static_cast<size_t>(h) * G + g) * hd + j * kVec, f);
    } else {
#pragma unroll
      for (int i = 0; i < kVec; ++i) f[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < kVec; ++i) q_s[r * hd + j * kVec + i] = f[i] * scale;
  }
  for (int r = tid; r < kMaxRows; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
    a_s[r] = 1.f;
  }
  // P.V accumulators: threads along head_dim, rows strided by row groups
  const int groups = kThreads / hd;            // hd <= kThreads, hd | kThreads
  const int d_own = tid % hd;
  const int r_first = tid / hd;
  float acc[kMaxAcc];
#pragma unroll
  for (int i = 0; i < kMaxAcc; ++i) acc[i] = 0.f;
  __syncthreads();

  for (int b = 0; b < B; ++b) {
    const int len = seg_len[b];
    if (len <= 0) continue;
    const int off = seg_off[b];
    const int lo = max(off, n0);
    const int hi = min(off + len, n_hi);
    if (lo >= hi) continue;                     // tile does not overlap segment b
    const int slot = seg_slots[b];
    int start = seg_start[b];
    start = start < 0 ? 0 : (start > mp * pg ? mp * pg : start);   // mp = 0: fresh pack
    const bool slot_ok = slot >= 0 && slot < S;
    if (!slot_ok) start = 0;
    const int* tab = ptab + static_cast<size_t>(slot_ok ? slot : 0) * mp;
    const int n_keys = start + (hi - off);      // committed rows, then pack keys < hi

    for (int kb = 0; kb < n_keys; kb += kKeys) {
      // 0. row addresses of this key tile (nullptr: zeros)
      if (tid < kKeys) {
        const int kk = kb + tid;
        const void* kr = nullptr;
        const void* vr = nullptr;
        bool committed = false;
        float ks = 1.f, vs = 1.f;
        if (kk < start) {
          const long long row = page_row_index(tab, kk, pg, n_pages);
          kr = row_ptr(pk, row, KV, h, hd);
          vr = row_ptr(pv, row, KV, h, hd);
          committed = true;
          if constexpr (kQuant) {
            const size_t si = static_cast<size_t>(row < 0 ? 0 : row) * KV + h;
            ks = row < 0 ? 0.f : sk[si];
            vs = row < 0 ? 0.f : sv[si];
          }
        } else if (kk < n_keys) {
          const size_t m = static_cast<size_t>(off + (kk - start));
          kr = ck + (m * KV + h) * hd;
          vr = cv + (m * KV + h) * hd;
        }
        s_krow[tid] = kr;
        s_vrow[tid] = vr;
        s_kq[tid] = committed;
        s_ks[tid] = ks;
        s_vs[tid] = vs;
      }
      __syncthreads();
      // 1. stage the key/value tile as f32, 16 bytes per thread per load
      if constexpr (!kQuant) {
        for (int c = tid; c < kKeys * chunks; c += kThreads) {
          const int k = c / chunks, j = c - k * chunks;
          const T* kr = static_cast<const T*>(s_krow[k]);
          const T* vr = static_cast<const T*>(s_vrow[k]);
          float kf[kVec], vf[kVec];
          if (kr != nullptr) {
            unpack16(kr + j * kVec, kf);
            unpack16(vr + j * kVec, vf);
          } else {
#pragma unroll
            for (int i = 0; i < kVec; ++i) kf[i] = vf[i] = 0.f;
          }
#pragma unroll
          for (int i = 0; i < kVec; i += 4) {
            *reinterpret_cast<float4*>(k_s + k * kstride + j * kVec + i) =
                make_float4(kf[i], kf[i + 1], kf[i + 2], kf[i + 3]);
            *reinterpret_cast<float4*>(v_s + k * hd + j * kVec + i) =
                make_float4(vf[i], vf[i + 1], vf[i + 2], vf[i + 3]);
          }
        }
      } else {
        // int8 committed rows and float pack rows share the tile: 8 elements
        // per step (8 bytes of int8, 16 of bf16, 32 of f32)
        const int units = hd / 8;
        for (int c = tid; c < kKeys * units; c += kThreads) {
          const int k = c / units, j = c - k * units;
          float kf[8], vf[8];
          if (s_krow[k] == nullptr) {
#pragma unroll
            for (int i = 0; i < 8; ++i) kf[i] = vf[i] = 0.f;
          } else if (s_kq[k]) {
            load8(static_cast<const int8_t*>(s_krow[k]) + j * 8, kf);
            load8(static_cast<const int8_t*>(s_vrow[k]) + j * 8, vf);
          } else {
            load8(static_cast<const T*>(s_krow[k]) + j * 8, kf);
            load8(static_cast<const T*>(s_vrow[k]) + j * 8, vf);
          }
#pragma unroll
          for (int i = 0; i < 8; i += 4) {
            *reinterpret_cast<float4*>(k_s + k * kstride + j * 8 + i) =
                make_float4(kf[i], kf[i + 1], kf[i + 2], kf[i + 3]);
            *reinterpret_cast<float4*>(v_s + k * hd + j * 8 + i) =
                make_float4(vf[i], vf[i + 1], vf[i + 2], vf[i + 3]);
          }
        }
      }
      __syncthreads();
      // 2. scores: lane = key, warp = a strided set of query rows; masked -> -1e30
      {
        const int kk = kb + lane;
        float sc[kRowsPerWarp];
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) sc[i] = 0.f;
        const float* krow = k_s + lane * kstride;
        for (int d = 0; d < hd; d += 4) {
          const float4 kv = *reinterpret_cast<const float4*>(krow + d);
#pragma unroll
          for (int i = 0; i < kRowsPerWarp; ++i) {
            const int r = warp + i * kWarps;
            if (r < R) {
              const float4 qv = *reinterpret_cast<const float4*>(q_s + r * hd + d);
              sc[i] += qv.x * kv.x + qv.y * kv.y + qv.z * kv.z + qv.w * kv.w;
            }
          }
        }
        float key_scale = 1.f;
        if constexpr (kQuant) key_scale = s_ks[lane];   // key scale fold
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) {
          const int r = warp + i * kWarps;
          if (r < R) {
            const int n = n0 + r / G;
            bool ok = kk < n_keys && n >= lo && n < hi;
            if (ok && kk >= start) ok = off + (kk - start) <= n;  // causal in the pack
            if constexpr (kQuant) sc[i] *= key_scale;
            p_s[r * kKeys + lane] = ok ? sc[i] : kNegInf;
          }
        }
      }
      __syncthreads();
      // 3. online softmax per query row (explicit zero for masked columns)
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const int r = warp + i * kWarps;
        if (r >= R) break;
        const float s = p_s[r * kKeys + lane];
        const bool ok = s > 0.5f * kNegInf;
        const float mx = warp_max(ok ? s : kNegInf);
        const float m_prev = m_s[r];
        const float m_new = fmaxf(m_prev, mx);
        const float p = ok ? expf(s - m_new) : 0.f;
        const float sum = warp_sum(p);
        // value scale fold: into the probability the V product reads, not
        // into the denominator
        if constexpr (kQuant) p_s[r * kKeys + lane] = p * s_vs[lane];
        else p_s[r * kKeys + lane] = p;
        if (lane == 0) {
          const float a = expf(m_prev - m_new);
          a_s[r] = a;
          l_s[r] = l_s[r] * a + sum;
          m_s[r] = m_new;
        }
      }
      __syncthreads();
      // 4. acc = acc * alpha + P V (masked and past-the-end keys have p = 0)
#pragma unroll
      for (int i = 0; i < kMaxAcc; ++i) {
        const int r = r_first + i * groups;
        if (r < R) {
          float a = acc[i] * a_s[r];
          const float* prow = p_s + r * kKeys;
#pragma unroll
          for (int k = 0; k < kKeys; k += 4) {
            const float4 p4 = *reinterpret_cast<const float4*>(prow + k);
            a += p4.x * v_s[k * hd + d_own] + p4.y * v_s[(k + 1) * hd + d_own]
               + p4.z * v_s[(k + 2) * hd + d_own] + p4.w * v_s[(k + 3) * hd + d_own];
          }
          acc[i] = a;
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < kMaxAcc; ++i) {
    const int r = r_first + i * groups;
    const int n = n0 + r / G, g = r % G;
    if (r < R && n < N) {
      const float l = l_s[r];
      const size_t o = (static_cast<size_t>(n) * H + static_cast<size_t>(h) * G + g) * hd + d_own;
      store_f(out + o, l > 0.f ? acc[i] / l : 0.f);
    }
  }
}

template <typename T, typename TC>
int launch(const void* q, const void* ck, const void* cv, const void* pk, const void* pv,
           const void* sk, const void* sv, const void* ptab, const void* slots, const void* start,
           const void* off, const void* len, void* out, int N, int KV, int G, int hd, int n_pages,
           int pg, int mp, int S, int B, cudaStream_t st) {
  const size_t bytes = smem_bytes(hd);
  cudaError_t err = cudaFuncSetAttribute(ragged_prefill_kernel<T, TC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int qt = kMaxRows / G;
  const dim3 grid((N + qt - 1) / qt, KV);
  ragged_prefill_kernel<T, TC><<<grid, kThreads, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(ck), static_cast<const T*>(cv),
      static_cast<const TC*>(pk), static_cast<const TC*>(pv), static_cast<const float*>(sk),
      static_cast<const float*>(sv), static_cast<const int*>(ptab),
      static_cast<const int*>(slots), static_cast<const int*>(start),
      static_cast<const int*>(off), static_cast<const int*>(len), static_cast<T*>(out), N, KV, G,
      hd, n_pages, pg, mp, S, B);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int N, int KV, int G, int hd, int S, int B) {
  return N < 0 || KV <= 0 || G < 1 || G > kMaxRows || hd < 32 || hd > kThreads ||
         kThreads % hd != 0 || (kMaxRows / G) * G * hd / kThreads > kMaxAcc || S <= 0 || B <= 0;
}

}  // namespace

// K2. dtype: 0 = float32, 1 = bfloat16 (q, pack k/v, pages, out alike).
// mp = 0 launches a FRESH pack: no committed rows, pk / pv / ptab are
// never read (may be null). Returns cudaGetLastError() after the launch
// (0 = success); shapes the kernel does not take return
// cudaErrorInvalidValue without launching.
extern "C" int ragged_prefill_attention_launch(const void* q, const void* ck, const void* cv,
                                               const void* pk, const void* pv, const void* ptab,
                                               const void* seg_slots, const void* seg_start,
                                               const void* seg_off, const void* seg_len,
                                               void* out, int N, int KV, int G, int hd,
                                               int n_pages, int pg, int mp, int S, int B,
                                               int dtype, void* stream) {
  if (bad_shape(N, KV, G, hd, S, B) || mp < 0 || (mp > 0 && (pg <= 0 || n_pages <= 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, float>(q, ck, cv, pk, pv, nullptr, nullptr, ptab, seg_slots, seg_start,
                                seg_off, seg_len, out, N, KV, G, hd, n_pages, pg, mp, S, B, st);
  if (dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(q, ck, cv, pk, pv, nullptr, nullptr, ptab,
                                                 seg_slots, seg_start, seg_off, seg_len, out, N,
                                                 KV, G, hd, n_pages, pg, mp, S, B, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K2-int8: pages int8, scales float32 [n_pages, pg, KV]; dtype of q, pack
// k/v and out: 0 = float32, 1 = bfloat16. Same return convention as K2.
extern "C" int ragged_prefill_attention_quant_launch(
    const void* q, const void* ck, const void* cv, const void* pk, const void* sk,
    const void* pv, const void* sv, const void* ptab, const void* seg_slots,
    const void* seg_start, const void* seg_off, const void* seg_len, void* out, int N, int KV,
    int G, int hd, int n_pages, int pg, int mp, int S, int B, int dtype, void* stream) {
  if (bad_shape(N, KV, G, hd, S, B) || hd % 8 != 0 || pg <= 0 || mp <= 0 || n_pages <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, int8_t>(q, ck, cv, pk, pv, sk, sv, ptab, seg_slots, seg_start, seg_off,
                                 seg_len, out, N, KV, G, hd, n_pages, pg, mp, S, B, st);
  if (dtype == 1)
    return launch<__nv_bfloat16, int8_t>(q, ck, cv, pk, pv, sk, sv, ptab, seg_slots, seg_start,
                                         seg_off, seg_len, out, N, KV, G, hd, n_pages, pg, mp, S,
                                         B, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
