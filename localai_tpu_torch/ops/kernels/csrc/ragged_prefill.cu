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
// probability after the denominator has taken it (the fold of the jnp
// int8 route, localai_tpu/ops/ragged_prefill.py:96-124, which the JAX
// package runs for int8 packs: its Pallas kernel takes float pages only).
// The pack's own keys stay float (scale 1).
//
// Bound on an H100: operations. The work is 4 * hd flops per (query
// head, visible key) pair. At Llama-3.1-8B head shapes a 476-token chunk
// continuing 1024 committed rows is ~9.8 GFLOP per layer against ~14 MB
// of q/k/v/out bytes: 10.0 us at the 989 TFLOP/s bf16 tensor-core peak
// versus 4.2 us at 3.35 TB/s, so operations set the floor (int8 pages
// halve the committed bytes, not the flops). Only the tensor cores reach
// that rate, so the bfloat16 body runs both products on them:
//
// bfloat16 (tensor cores, wgmma). A block of two warpgroups (256
// threads) owns (query tile, kv head): 128 / G pack tokens x the G heads
// that share the kv head, 64 query rows per warpgroup = one wgmma M tile
// each (G not dividing 128 leaves masked pad rows), so each K/V row is
// staged once for all G heads and both warpgroups. The block looks up the
// segments its tile overlaps and, for each, walks key tiles of 64 rows
// (32 at hd 256, to stay within the registers) that never mix the two
// kinds of keys: first the committed rows [0, start) through the page
// table (any page size, so also the contiguous layout's pg = C over its
// identity table; each thread reads its row's table entry one tile ahead
// of its copy), then the pack's keys from the segment's offset up to the
// tile's last token (later tiles are causally empty and never visited).
// Tiles arrive through a three-stage cp.async ring, each thread writing
// its 16-byte chunks where wgmma's 128-byte-swizzle layout wants them
// (wgmma.cuh): tiles j+1 and j+2 load while tile j computes. S = Q K^T is
// wgmma m64nKTk16 with both operands in shared memory (Q staged once per
// block); 1/sqrt(hd) scales the f32 scores (folded into bf16 q it would
// add a rounding the plain version does not have). The online softmax
// runs on the accumulator fragment in registers, in the log2 domain: a
// row's max is reduced over the four threads that hold it, masked columns
// hold -inf so their probabilities are exactly zero (the plain version's
// -1e30 mask with explicit zeros), and alpha rescales the O accumulator.
// P, rounded to bf16 in registers, is the register A operand of O += P V;
// the V tile ([key][hd] in shared memory) is the B operand through the
// transpose bit. int8 tiles (and their scales) stage as int8 and widen to
// bf16 in shared memory, which is exact (every integer -127..127 is a
// bf16); the key scale multiplies the f32 score column, the value scale
// the P column before its bf16 rounding, while the denominator sums the
// unscaled P. The epilogue divides by l and stores zeros where l == 0
// (pad rows).
//
// float32 (CUDA cores, f32 FMAs). On the card float32 serves only the
// parity checks (atol 1e-4) and the small-model logits check (1e-3); TF32
// tensor cores keep about three decimal digits and would fail both. The
// launchers dispatch on dtype: float32 takes the CUDA-core body, bfloat16
// the tensor-core body, and a bf16 call never falls back to the former.

#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

using namespace localai_kernels;

bool bad_shape(int N, int KV, int G, int hd, int S, int B) {
  // hd in {32, 64, 128, 256}; G in 1..64 (a tile holds 64 / G >= 1 tokens)
  return N < 0 || KV <= 0 || G < 1 || G > 64 || hd < 32 || hd > 256 || 256 % hd != 0 || S <= 0 ||
         B <= 0;
}

// ---------------------------------------------------------------------------
// float32: CUDA-core body. One block owns (query tile, kv head) as above;
// key tiles of 32 rows (a tile may straddle the committed rows and the
// pack, so int8 and float rows are staged in 8-element units) are staged
// in shared memory as f32, scores and an online softmax per query row go
// through shared memory, and P.V accumulates in registers.
namespace cuda_core {

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
        // per step (8 bytes of int8, 32 of f32)
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

template <typename TC>
int launch(const void* q, const void* ck, const void* cv, const void* pk, const void* pv,
           const void* sk, const void* sv, const void* ptab, const void* slots, const void* start,
           const void* off, const void* len, void* out, int N, int KV, int G, int hd, int n_pages,
           int pg, int mp, int S, int B, cudaStream_t st) {
  const size_t bytes = smem_bytes(hd);
  cudaError_t err = cudaFuncSetAttribute(ragged_prefill_kernel<float, TC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int qt = kMaxRows / G;
  const dim3 grid((N + qt - 1) / qt, KV);
  ragged_prefill_kernel<float, TC><<<grid, kThreads, bytes, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(ck), static_cast<const float*>(cv),
      static_cast<const TC*>(pk), static_cast<const TC*>(pv), static_cast<const float*>(sk),
      static_cast<const float*>(sv), static_cast<const int*>(ptab),
      static_cast<const int*>(slots), static_cast<const int*>(start),
      static_cast<const int*>(off), static_cast<const int*>(len), static_cast<float*>(out), N, KV,
      G, hd, n_pages, pg, mp, S, B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cuda_core

// ---------------------------------------------------------------------------
// bfloat16: tensor-core body (see the note at the top)
namespace tensor_core {

constexpr int kWarpgroups = 2;               // consumers sharing each K/V tile
constexpr int kThreads = 128 * kWarpgroups;
constexpr int kRows = 64 * kWarpgroups;      // query rows per block; warpgroup w owns [64 w, 64 w + 64)
constexpr int kStages = 3;                   // the cp.async ring: two tiles in flight
constexpr int kMaxSegs = kRows;              // segments a tile of <= kRows tokens can overlap
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float fast_exp2(float x) {   // exp2(-inf) = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// HDP: head_dim padded to a whole 64-column block (hd 32 runs as 64 with
// zero columns: they add nothing to the scores and are never stored)
template <int HDP>
struct Tile {
  static constexpr int KT = HDP > 128 ? 32 : 64;   // keys per tile
  static constexpr int TPR = kThreads / KT;        // threads staging one key row
  static constexpr int CH = HDP / 8;               // 16-byte bf16 chunks per padded row
  static constexpr int Q_BYTES = kRows * HDP * 2;
  static constexpr int KV_BYTES = KT * HDP * 2;    // one K or V tile in bf16
  static constexpr int I8_BYTES = KT * HDP;        // one K or V tile staged as int8
};

template <int HDP, bool kQuant>
constexpr size_t smem_bytes() {
  // 1024 of slack to align the swizzled tiles; Q; the ring [stage][K, V];
  // int8 pages: the int8 staging pair [tile & 1][K, V] (a tile is widened
  // out of it before the copies two tiles later reuse it)
  return 1024 + Tile<HDP>::Q_BYTES + kStages * 2 * Tile<HDP>::KV_BYTES +
         (kQuant ? 4 * Tile<HDP>::I8_BYTES : 0);
}

// The segments a block's tile overlaps, in pack order, with their key
// tiles: nc committed tiles then nt - nc pack tiles
struct Segs {
  int start[kMaxSegs], off[kMaxSegs], lo[kMaxSegs], hi[kMaxSegs], slot[kMaxSegs];
  int nc[kMaxSegs], nt[kMaxSegs];
  int n;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);   // lo in the low half
  return *reinterpret_cast<const uint32_t*>(&t);
}

// Byte i of w as a float, exactly, without the quarter-rate int-to-float
// unit: the sign-extended byte added to the bits of 1.5 * 2^23 (whose
// ulp is 1), then 1.5 * 2^23 subtracted
__device__ __forceinline__ float s8_to_f32(uint32_t w, int i) {
  const int b = static_cast<int>(static_cast<int8_t>(w >> (8 * i)));
  return __int_as_float(0x4B400000 + b) - 12582912.f;
}

// 8 int8 values widened to 8 bf16, exactly: a float of |b| <= 128 has at
// most 8 significant bits, so its upper 16 bits are its bf16
__device__ __forceinline__ uint4 widen8(const int8_t* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  uint32_t w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t word = j < 2 ? raw.x : raw.y;
    const int i = 2 * (j & 1);
    w[j] = __byte_perm(__float_as_uint(s8_to_f32(word, i)),
                       __float_as_uint(s8_to_f32(word, i + 1)), 0x7632);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <int HDP, bool kQuant>
__global__ void __launch_bounds__(kThreads)
ragged_prefill_tc_kernel(const __nv_bfloat16* __restrict__ q,    // [N, KV*G, hd]
                         const __nv_bfloat16* __restrict__ ck,   // [N, KV, hd] pack keys
                         const __nv_bfloat16* __restrict__ cv,   // [N, KV, hd]
                         const void* __restrict__ pk_,           // [n_pages, pg, KV, hd] bf16 / int8
                         const void* __restrict__ pv_,
                         const float* __restrict__ sk,           // [n_pages, pg, KV] (int8 only)
                         const float* __restrict__ sv,
                         const int* __restrict__ ptab,           // [S, mp]
                         const int* __restrict__ seg_slots,      // [B]
                         const int* __restrict__ seg_start,      // [B]
                         const int* __restrict__ seg_off,        // [B]
                         const int* __restrict__ seg_len,        // [B]
                         __nv_bfloat16* __restrict__ out,        // [N, KV*G, hd]
                         int N, int KV, int G, int hd, int n_pages, int pg, int mp, int S, int B) {
  using C = Tile<HDP>;
  constexpr int KT = C::KT;
  using TC = typename std::conditional<kQuant, int8_t, __nv_bfloat16>::type;
  const TC* pk = static_cast<const TC*>(pk_);
  const TC* pv = static_cast<const TC*>(pv_);

  extern __shared__ uint8_t smem_raw[];
  __shared__ Segs segs;
  __shared__ float s_ks[kStages][KT];   // int8: key / value scale of each row of a staged tile
  __shared__ float s_vs[kStages][KT];
  uint8_t* q_s = smem_raw + (((smem_addr(smem_raw) + 1023u) & ~1023u) - smem_addr(smem_raw));
  uint8_t* kv_s = q_s + C::Q_BYTES;                // [stage][K, V], swizzled bf16
  uint8_t* i8_s = kv_s + kStages * 2 * C::KV_BYTES;   // [tile & 1][K, V], int8 rows of hd bytes
  const uint32_t q_a = smem_addr(q_s);
  const uint32_t kv_a = smem_addr(kv_s);
  const uint32_t i8_a = smem_addr(i8_s);

  const int tid = threadIdx.x, lane = tid & 31;
  const int wg = tid >> 7;            // this thread's warpgroup
  const int h = blockIdx.y;
  const int qt = kRows / G;           // pack tokens per block
  const int R = qt * G;               // query rows per block
  const int n0 = blockIdx.x * qt;
  const int n_hi = min(n0 + qt, N);
  const size_t H = static_cast<size_t>(KV) * G;

  // 1. the segments this tile overlaps (warp 0, in pack order)
  if (tid < 32) {
    int count = 0;
    for (int b0 = 0; b0 < B; b0 += 32) {
      const int b = b0 + lane;
      int off = 0, lo = 0, hi = 0;
      bool ov = false;
      if (b < B) {
        const int len = seg_len[b];
        off = seg_off[b];
        lo = max(off, n0);
        hi = min(off + len, n_hi);
        ov = len > 0 && lo < hi;
      }
      const unsigned m = __ballot_sync(0xffffffffu, ov);
      const int i = count + __popc(m & ((1u << lane) - 1u));
      if (ov && i < kMaxSegs) {
        const int slot = seg_slots[b];
        const bool slot_ok = slot >= 0 && slot < S;
        int start = seg_start[b];
        start = start < 0 ? 0 : (start > mp * pg ? mp * pg : start);   // mp = 0: fresh pack
        if (!slot_ok) start = 0;
        segs.start[i] = start;
        segs.off[i] = off;
        segs.lo[i] = lo;
        segs.hi[i] = hi;
        segs.slot[i] = slot_ok ? slot : 0;
        segs.nc[i] = (start + KT - 1) / KT;
        segs.nt[i] = segs.nc[i] + (hi - off + KT - 1) / KT;
      }
      count += __popc(m);
    }
    if (lane == 0) segs.n = min(count, kMaxSegs);
  }
  __syncthreads();
  int T = 0;   // key tiles of the walk
  for (int i = 0; i < segs.n; ++i) T += segs.nt[i];

  // This thread's key row (tid / TPR) of the walk's tile (i, j): its
  // page-table entry, or -1 (not a committed row). Read one tile ahead of
  // its use, so the load's latency hides behind a tile of compute.
  auto page_of = [&](int i, int j) -> int {
    if (i >= segs.n || j >= segs.nc[i]) return -1;
    const int kk = j * KT + tid / C::TPR;
    if (kk >= segs.start[i]) return -1;
    return ptab[static_cast<size_t>(segs.slot[i]) * mp + kk / pg];
  };
  // stage key tile j of overlapped segment i (the walk's tile t; `page`
  // from page_of) into ring stage t % kStages: thread tid copies row
  // tid / TPR, every TPR-th 16-byte chunk of it
  auto issue = [&](int i, int j, int t, int page) {
    const int st = t % kStages;
    const int k = tid / C::TPR, sub = tid % C::TPR;
    const uint32_t kd = kv_a + st * 2 * C::KV_BYTES;
    const uint32_t vd = kd + C::KV_BYTES;
    if (j < segs.nc[i]) {                         // committed rows, through the page table
      // past start or unallocated (sentinel page): zeros, and int8 scale 0
      // like the plain version's gather
      const bool ok = page >= 0 && page < n_pages;
      const size_t row = ok ? static_cast<size_t>(page) * pg + (j * KT + k) % pg : 0;
      const size_t e = (row * KV + h) * hd;
      if constexpr (kQuant) {
        const uint32_t ki = i8_a + (t & 1) * 2 * C::I8_BYTES;
        const uint32_t vi = ki + C::I8_BYTES;
        for (int c = sub; c < hd / 16; c += C::TPR) {
          cp_async16(ki + k * hd + c * 16, pk + e + c * 16, ok ? 16 : 0);
          cp_async16(vi + k * hd + c * 16, pv + e + c * 16, ok ? 16 : 0);
        }
        if (sub == 0) {
          cp_async4(smem_addr(&s_ks[st][k]), sk + row * KV + h, ok ? 4 : 0);
          cp_async4(smem_addr(&s_vs[st][k]), sv + row * KV + h, ok ? 4 : 0);
        }
      } else {
        for (int c = sub; c < C::CH; c += C::TPR) {
          const int bytes = ok && c * 8 < hd ? 16 : 0;
          cp_async16(kd + swz128(KT, k, c), pk + e + c * 8, bytes);
          cp_async16(vd + swz128(KT, k, c), pv + e + c * 8, bytes);
        }
      }
    } else {                                      // the pack's own keys
      const int m = segs.off[i] + (j - segs.nc[i]) * KT + k;
      const bool ok = m < segs.hi[i];
      const size_t e = ok ? (static_cast<size_t>(m) * KV + h) * hd : 0;
      for (int c = sub; c < C::CH; c += C::TPR) {
        const int bytes = ok && c * 8 < hd ? 16 : 0;
        cp_async16(kd + swz128(KT, k, c), ck + e + c * 8, bytes);
        cp_async16(vd + swz128(KT, k, c), cv + e + c * 8, bytes);
      }
    }
  };
  auto advance = [&](int& i, int& j) {
    if (++j == segs.nt[i]) {
      ++i;
      j = 0;
    }
  };

  // this thread's rows of its warpgroup's accumulator fragments: r0 and
  // r0 + 8; its columns: 8 x + 2 quad + {0, 1}
  const int r0 = wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
  const int quad = lane & 3;
  const bool r_in[2] = {r0 < R, r0 + 8 < R};              // a query row of the tile
  const int n_r[2] = {n0 + r0 / G, n0 + (r0 + 8) / G};    // its token
  const float c2 = rsqrtf(static_cast<float>(hd)) * kLog2e;   // scores in the log2 domain
  float o[HDP / 2];
#pragma unroll
  for (int x = 0; x < HDP / 2; ++x) o[x] = 0.f;
  const float kMinusInf = __int_as_float(0xff800000u);
  float m2[2] = {kNegInf, kNegInf};   // running max per row (log2 domain)
  float l[2] = {0.f, 0.f};            // this thread's part of the denominator

  int ci = 0, cj = 0;   // the tile computed now (t)
  int pi = 0, pj = 0;   // the next tile to load (t + 2 once the loop runs)
  if (T > 0) {
    // Q once: row r = token n0 + r / G, head h * G + r % G (zeros past R,
    // N and hd); it lands with key tile 0
    for (int u = tid; u < kRows * C::CH; u += kThreads) {
      const int r = u / C::CH, c = u - r * C::CH;
      const int n = n0 + r / G;
      const bool ok = r < R && n < N && c * 8 < hd;
      const size_t e = ok ? (static_cast<size_t>(n) * H + static_cast<size_t>(h) * G + r % G) * hd : 0;
      cp_async16(q_a + swz128(kRows, r, c), q + e + c * 8, ok ? 16 : 0);
    }
  }
  int pf = page_of(pi, pj);   // the page of the next tile to load
  for (int t = 0; t < 2 && t < T; ++t) {
    issue(pi, pj, t, pf);
    advance(pi, pj);
    pf = page_of(pi, pj);
    cp_async_commit();
  }
  for (int t = 0; t < T; ++t) {
    const int st = t % kStages;
    if (t + 1 < T) cp_async_wait_one();   // tile t landed; tile t + 1 may still fly
    else cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();     // tile t visible; every thread is done with tile t - 1
    const bool committed = cj < segs.nc[ci];
    if constexpr (kQuant) {
      if (committed) {   // widen the int8 tile into the bf16 stage
        const int8_t* ki = reinterpret_cast<const int8_t*>(i8_s + (t & 1) * 2 * C::I8_BYTES);
        const int8_t* vi = ki + C::I8_BYTES;
        uint8_t* kd = kv_s + st * 2 * C::KV_BYTES;
        uint8_t* vd = kd + C::KV_BYTES;
        for (int u = tid; u < KT * C::CH; u += kThreads) {
          const int k = u / C::CH, c = u - k * C::CH;
          uint4 wk = make_uint4(0u, 0u, 0u, 0u), wv = wk;
          if (c * 8 < hd) {
            wk = widen8(ki + k * hd + c * 8);
            wv = widen8(vi + k * hd + c * 8);
          }
          *reinterpret_cast<uint4*>(kd + swz128(KT, k, c)) = wk;
          *reinterpret_cast<uint4*>(vd + swz128(KT, k, c)) = wv;
        }
        fence_proxy_async();
        __syncthreads();
      }
    }
    const uint32_t kd = kv_a + st * 2 * C::KV_BYTES;
    const uint32_t vd = kd + C::KV_BYTES;

    // S = Q K^T for this warpgroup's 64 rows: HDP / 16 steps of k16, 32
    // bytes apart inside a 64-column block
    float s[KT / 2];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < HDP / 16; ++ks) {
      const uint32_t step = (ks & 3) * 32;
      wgmma_ss<KT>(s, smem_desc(q_a + (ks >> 2) * kRows * 128 + wg * 64 * 128 + step, 16, 1024),
                   smem_desc(kd + (ks >> 2) * KT * 128 + step, 16, 1024), ks > 0);
    }
    wgmma_commit();
    // tile t + 2's copies go out while the tensor cores work (into the
    // stage tile t - 1 used)
    if (t + 2 < T) {
      issue(pi, pj, t + 2, pf);
      advance(pi, pj);
      pf = page_of(pi, pj);
      cp_async_commit();
    }
    __syncwarp();
    wgmma_wait_all();
    fence_regs(s);

    // online softmax on the fragment, in the log2 domain: a score s
    // weighs exp2(s * c2 - m) (int8 committed tiles: s * c2 * key scale);
    // masked columns hold -inf, so exp2 gives them exactly 0
    const int lo = segs.lo[ci], hi = segs.hi[ci];
    const int k0 = committed ? cj * KT : segs.off[ci] + (cj - segs.nc[ci]) * KT;
    const bool scaled = kQuant && committed;
    float kf[KT / 4], vf[KT / 4];   // this thread's columns' key / value factors
    if (scaled) {
#pragma unroll
      for (int x = 0; x < KT / 8; ++x) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          kf[2 * x + e] = c2 * s_ks[st][8 * x + 2 * quad + e];
          vf[2 * x + e] = s_vs[st][8 * x + 2 * quad + e];
        }
      }
    }
    const float cs = scaled ? 1.f : c2;
    float alpha[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const bool row_ok = r_in[hr] && n_r[hr] >= lo && n_r[hr] < hi;
      // the tile's columns [0, vis) are visible to this row; this thread's
      // column 8 x + 2 quad + e is when 8 x + e < lim
      const int vis = (!row_ok ? k0 : (committed ? segs.start[ci] : min(hi, n_r[hr] + 1))) - k0;
      const int lim = vis - 2 * quad;
      float mx = kMinusInf;
#pragma unroll
      for (int x = 0; x < KT / 8; ++x) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float v = s[4 * x + 2 * hr + e];
          if (scaled) v *= kf[2 * x + e];
          if (vis < KT) v = 8 * x + e < lim ? v : kMinusInf;
          s[4 * x + 2 * hr + e] = v;
          mx = fmaxf(mx, v);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m2[hr], mx * cs);
      alpha[hr] = fast_exp2(m2[hr] - m_new);
      m2[hr] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int x = 0; x < KT / 8; ++x) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = fast_exp2(fmaf(s[4 * x + 2 * hr + e], cs, -m_new));
          sum += p;
          // value scale fold: after the denominator took p
          s[4 * x + 2 * hr + e] = scaled ? p * vf[2 * x + e] : p;
        }
      }
      l[hr] = l[hr] * alpha[hr] + sum;
    }
    // P as the register A operand: k16 block kb is accumulator columns
    // 16 kb .. 16 kb + 15, i.e. s[8 kb .. 8 kb + 7] in A-fragment order
    uint32_t pa[KT / 16][4];
#pragma unroll
    for (int kb = 0; kb < KT / 16; ++kb) {
#pragma unroll
      for (int j = 0; j < 4; ++j) pa[kb][j] = pack_bf16(s[8 * kb + 2 * j], s[8 * kb + 2 * j + 1]);
    }
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int x = 0; x < HDP / 8; ++x) {
        o[4 * x] *= alpha[0];
        o[4 * x + 1] *= alpha[0];
        o[4 * x + 2] *= alpha[1];
        o[4 * x + 3] *= alpha[1];
      }
    }
    // O += P V: KT / 16 steps of k16 = 16 key rows, 2048 bytes apart
    fence_regs(o);
    __syncwarp();
    wgmma_fence();
#pragma unroll
    for (int kb = 0; kb < KT / 16; ++kb)
      wgmma_rs<HDP>(o, pa[kb], smem_desc(vd + kb * 16 * 128, KT * 128, 1024));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    advance(ci, cj);
  }

  // epilogue: O / l, zeros where l == 0 (pad rows); columns past hd unstored
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float lt = l[hr];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const int r = r0 + 8 * hr;
    const int n = n_r[hr];
    if (r_in[hr] && n < N) {
      const float inv = lt > 0.f ? 1.f / lt : 0.f;
      __nv_bfloat16* dst =
          out + (static_cast<size_t>(n) * H + static_cast<size_t>(h) * G + r % G) * hd + 2 * quad;
#pragma unroll
      for (int x = 0; x < HDP / 8; ++x) {
        if (8 * x < hd)
          *reinterpret_cast<__nv_bfloat162*>(dst + 8 * x) =
              __floats2bfloat162_rn(o[4 * x + 2 * hr] * inv, o[4 * x + 2 * hr + 1] * inv);
      }
    }
  }
}

template <int HDP, bool kQuant>
int launch_hd(const void* q, const void* ck, const void* cv, const void* pk, const void* pv,
              const void* sk, const void* sv, const void* ptab, const void* slots,
              const void* start, const void* off, const void* len, void* out, int N, int KV, int G,
              int hd, int n_pages, int pg, int mp, int S, int B, cudaStream_t st) {
  constexpr size_t bytes = smem_bytes<HDP, kQuant>();
  cudaError_t err = cudaFuncSetAttribute(ragged_prefill_tc_kernel<HDP, kQuant>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int qt = kRows / G;
  const dim3 grid((N + qt - 1) / qt, KV);
  ragged_prefill_tc_kernel<HDP, kQuant><<<grid, kThreads, bytes, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(ck),
      static_cast<const __nv_bfloat16*>(cv), pk, pv, static_cast<const float*>(sk),
      static_cast<const float*>(sv), static_cast<const int*>(ptab),
      static_cast<const int*>(slots), static_cast<const int*>(start),
      static_cast<const int*>(off), static_cast<const int*>(len),
      static_cast<__nv_bfloat16*>(out), N, KV, G, hd, n_pages, pg, mp, S, B);
  return static_cast<int>(cudaGetLastError());
}

template <bool kQuant>
int launch(const void* q, const void* ck, const void* cv, const void* pk, const void* pv,
           const void* sk, const void* sv, const void* ptab, const void* slots, const void* start,
           const void* off, const void* len, void* out, int N, int KV, int G, int hd, int n_pages,
           int pg, int mp, int S, int B, cudaStream_t st) {
  switch (hd) {
    case 32:
    case 64:
      return launch_hd<64, kQuant>(q, ck, cv, pk, pv, sk, sv, ptab, slots, start, off, len, out,
                                   N, KV, G, hd, n_pages, pg, mp, S, B, st);
    case 128:
      return launch_hd<128, kQuant>(q, ck, cv, pk, pv, sk, sv, ptab, slots, start, off, len, out,
                                    N, KV, G, hd, n_pages, pg, mp, S, B, st);
    case 256:
      return launch_hd<256, kQuant>(q, ck, cv, pk, pv, sk, sv, ptab, slots, start, off, len, out,
                                    N, KV, G, hd, n_pages, pg, mp, S, B, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace tensor_core

}  // namespace

// K2. dtype: 0 = float32 (CUDA-core body), 1 = bfloat16 (tensor-core body);
// q, pack k/v, pages and out alike. mp = 0 launches a FRESH pack: no
// committed rows, pk / pv / ptab are never read (may be null). Returns
// cudaGetLastError() after the launch (0 = success); shapes the kernel does
// not take return cudaErrorInvalidValue without launching.
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
    return cuda_core::launch<float>(q, ck, cv, pk, pv, nullptr, nullptr, ptab, seg_slots,
                                    seg_start, seg_off, seg_len, out, N, KV, G, hd, n_pages, pg,
                                    mp, S, B, st);
  if (dtype == 1)
    return tensor_core::launch<false>(q, ck, cv, pk, pv, nullptr, nullptr, ptab, seg_slots,
                                      seg_start, seg_off, seg_len, out, N, KV, G, hd, n_pages, pg,
                                      mp, S, B, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K2-int8: pages int8, scales float32 [n_pages, pg, KV]; dtype of q, pack
// k/v and out: 0 = float32, 1 = bfloat16. Same return convention as K2.
extern "C" int ragged_prefill_attention_quant_launch(
    const void* q, const void* ck, const void* cv, const void* pk, const void* sk,
    const void* pv, const void* sv, const void* ptab, const void* seg_slots,
    const void* seg_start, const void* seg_off, const void* seg_len, void* out, int N, int KV,
    int G, int hd, int n_pages, int pg, int mp, int S, int B, int dtype, void* stream) {
  if (bad_shape(N, KV, G, hd, S, B) || pg <= 0 || mp <= 0 || n_pages <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return cuda_core::launch<int8_t>(q, ck, cv, pk, pv, sk, sv, ptab, seg_slots, seg_start,
                                     seg_off, seg_len, out, N, KV, G, hd, n_pages, pg, mp, S, B,
                                     st);
  if (dtype == 1)
    return tensor_core::launch<true>(q, ck, cv, pk, pv, sk, sv, ptab, seg_slots, seg_start,
                                     seg_off, seg_len, out, N, KV, G, hd, n_pages, pg, mp, S, B,
                                     st);
  return static_cast<int>(cudaErrorInvalidValue);
}
