// The decode append-attention block shared by K1 and K3 (paged_decode.cu)
// and K4/K5 (contig_decode.cu): one block computes one (slot, kv head) —
// the G query heads of the kv head against the slot's committed rows
// [0, length) plus the current token's own key/value.
//
// The kernels differ only in where logical row c lives, so the walk takes
// a row-address policy (`Rows`: c -> physical row index, -1 for a row on an
// unallocated page):
//   PagedRows   the slot's page-table row (K1, K3);
//   ContigRows  row c of the slot's contiguous [C, KV, hd] block (K4, K5).
//
// Cache element type TC: float / bf16 (K1, K4, K5; TC == T) or int8 with a
// float32 scale per (row, kv head) (K3). An int8 row's key scale multiplies
// its score and its value scale multiplies its probability before the
// value product, the fold of localai_tpu/ops/attention.py::_split_cache, so
// no dequantized row is ever formed. The current token: a float cache walks
// it as logical row `length` (K1's form); an int8 tile cannot hold the
// float token, so the int8 walk covers [0, length) and the token is folded
// into the online softmax after the walk (the `_finish` step of the TPU
// kernel `_kernel_quant`).
//
// Block: 128 threads. Tiles of 64 logical rows are staged in shared memory
// with 16-byte loads from every thread at once; each K/V row leaves device
// memory once for all G heads. Online softmax in f32.
#pragma once

#include "common.cuh"

namespace localai_kernels {
namespace decode {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;    // logical rows per online-softmax step
constexpr int kMaxG = 8;     // query heads per kv head
constexpr int kMaxHd = 256;

// Dynamic shared memory of one block: the K and V tiles (rows padded by one
// 16-byte vector) and the G pre-scaled query rows in f32
template <typename TC>
inline size_t smem_bytes(int hd, int G) {
  const size_t stride = static_cast<size_t>(hd + vec_elems<TC>());
  return 2 * kTile * stride * sizeof(TC) + static_cast<size_t>(G) * hd * sizeof(float);
}

struct PagedRows {
  const int* tab;  // the slot's page-table row [mp]
  int pg, n_pages;
  __device__ __forceinline__ long long operator()(int c) const {
    return page_row_index(tab, c, pg, n_pages);
  }
};

struct ContigRows {
  __device__ __forceinline__ long long operator()(int c) const { return c; }
};

// kb/vb: [rows, KV, hd] store (a page pool, or one slot's contiguous rows);
// skb/svb: its [rows, KV] f32 scales (int8 only, else unused); qh/oh: the
// G query / output rows [G, hd] of this kv head; cur_k/cur_v: [hd].
template <typename T, typename TC, bool kQuant, class Rows>
__device__ __forceinline__ void append_block(const T* __restrict__ qh, const T* __restrict__ cur_k,
                                             const T* __restrict__ cur_v,
                                             const TC* __restrict__ kb, const TC* __restrict__ vb,
                                             const float* __restrict__ skb,
                                             const float* __restrict__ svb, Rows rows, int length,
                                             T* __restrict__ oh, int KV, int h, int G, int hd) {
  constexpr int kVec = vec_elems<TC>();
  const int stride = hd + kVec;
  const int chunks = hd / kVec;      // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TC* k_s = reinterpret_cast<TC*>(smem_raw);                    // [kTile][stride]
  TC* v_s = k_s + kTile * stride;                               // [kTile][stride]
  float* q_s = reinterpret_cast<float*>(v_s + kTile * stride);  // [G][hd]
  __shared__ const TC* s_krow[kTile];
  __shared__ const TC* s_vrow[kTile];
  __shared__ float s_ks[kTile];   // int8: key / value scale of each tile row
  __shared__ float s_vs[kTile];
  __shared__ float s_p[kMaxG][kTile];
  __shared__ float s_m[kMaxG];
  __shared__ float s_l[kMaxG];
  __shared__ float s_alpha[kMaxG];
  __shared__ float s_pself[kMaxG];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float scale = rsqrtf(static_cast<float>(hd));
  const int total = kQuant ? length : length + 1;  // rows of the walk

  for (int e = tid; e < G * hd; e += kThreads) q_s[e] = to_f(qh[e]) * scale;
  if (tid < kMaxG) {
    s_m[tid] = kNegInf;
    s_l[tid] = 0.f;
  }
  // output accumulators: this thread owns dims tid and tid + kThreads
  float acc[kMaxG][2];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) acc[g][0] = acc[g][1] = 0.f;
  // the float walk has at least one tile (the appended token), whose first
  // barrier publishes q_s / s_m / s_l; an int8 walk over length 0 has none
  // before the fold reads them
  if constexpr (kQuant) __syncthreads();

  for (int base = 0; base < total; base += kTile) {
    const int n_rows = min(kTile, total - base);
    // 0. physical row pointers of this tile (nullptr: unallocated page)
    if (tid < n_rows) {
      const int c = base + tid;
      if constexpr (kQuant) {
        const long long r = rows(c);
        s_krow[tid] = row_ptr(kb, r, KV, h, hd);
        s_vrow[tid] = row_ptr(vb, r, KV, h, hd);
        const size_t si = static_cast<size_t>(r < 0 ? 0 : r) * KV + h;
        s_ks[tid] = r < 0 ? 0.f : skb[si];
        s_vs[tid] = r < 0 ? 0.f : svb[si];
      } else {
        if (c == length) {  // the appended token
          s_krow[tid] = cur_k;
          s_vrow[tid] = cur_v;
        } else {
          const long long r = rows(c);
          s_krow[tid] = row_ptr(kb, r, KV, h, hd);
          s_vrow[tid] = row_ptr(vb, r, KV, h, hd);
        }
      }
    }
    __syncthreads();
    // 1. stage K and V rows, 16 bytes per thread per step (zeros on
    //    unallocated pages, like the plain version's zero-fill gather)
    for (int c = tid; c < n_rows * chunks; c += kThreads) {
      const int r = c / chunks, j = c - r * chunks;
      const TC* kr = s_krow[r];
      const TC* vr = s_vrow[r];
      uint4 kv4 = make_uint4(0, 0, 0, 0), vv4 = make_uint4(0, 0, 0, 0);
      if (kr != nullptr) {
        kv4 = *reinterpret_cast<const uint4*>(kr + j * kVec);
        vv4 = *reinterpret_cast<const uint4*>(vr + j * kVec);
      }
      *reinterpret_cast<uint4*>(k_s + r * stride + j * kVec) = kv4;
      *reinterpret_cast<uint4*>(v_s + r * stride + j * kVec) = vv4;
    }
    __syncthreads();
    // 2. scores: thread = (row, a strided subset of the G heads)
    {
      const int r = tid % kTile;
      if (r < n_rows) {
        const TC* krow = k_s + r * stride;
        for (int g = tid / kTile; g < G; g += kThreads / kTile) {
          const float* qg = q_s + g * hd;
          float sum = 0.f;
          for (int j = 0; j < chunks; ++j) {
            float kf[kVec];
            unpack16(krow + j * kVec, kf);
#pragma unroll
            for (int i = 0; i < kVec; ++i) sum += qg[j * kVec + i] * kf[i];
          }
          if constexpr (kQuant) sum *= s_ks[r];   // key scale fold
          s_p[g][r] = sum;
        }
      }
    }
    __syncthreads();
    // 3. online-softmax update: one warp per query head
    for (int g = warp; g < G; g += kWarps) {
      float mx = kNegInf;
      for (int r = lane; r < n_rows; r += 32) mx = fmaxf(mx, s_p[g][r]);
      mx = warp_max(mx);
      const float m_prev = s_m[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int r = lane; r < n_rows; r += 32) {
        const float p = expf(s_p[g][r] - m_new);
        // value scale fold: into the probability the V product reads, not
        // into the denominator
        if constexpr (kQuant) s_p[g][r] = p * s_vs[r];
        else s_p[g][r] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float a = expf(m_prev - m_new);
        s_alpha[g] = a;
        s_l[g] = s_l[g] * a + sum;
        s_m[g] = m_new;
      }
    }
    __syncthreads();
    // 4. acc = acc * alpha + P V, threads along head_dim (conflict-free)
#pragma unroll
    for (int jd = 0; jd < 2; ++jd) {
      const int d = tid + jd * kThreads;
      if (d < hd) {
#pragma unroll
        for (int g = 0; g < kMaxG; ++g)
          if (g < G) acc[g][jd] *= s_alpha[g];
        for (int r = 0; r < n_rows; ++r) {
          const float v = to_f(v_s[r * stride + d]);
#pragma unroll
          for (int g = 0; g < kMaxG; ++g)
            if (g < G) acc[g][jd] += s_p[g][r] * v;
        }
      }
    }
    __syncthreads();
  }

  if constexpr (kQuant) {
    // fold the float current token into each head's running softmax
    for (int g = warp; g < G; g += kWarps) {
      float dot = 0.f;
      for (int i = lane; i < hd; i += 32) dot += q_s[g * hd + i] * to_f(cur_k[i]);
      dot = warp_sum(dot);
      if (lane == 0) {
        const float m_fin = fmaxf(s_m[g], dot);
        const float a = expf(s_m[g] - m_fin);
        const float p = expf(dot - m_fin);
        s_alpha[g] = a;
        s_pself[g] = p;
        s_l[g] = s_l[g] * a + p;
      }
    }
    __syncthreads();
#pragma unroll
    for (int jd = 0; jd < 2; ++jd) {
      const int d = tid + jd * kThreads;
      if (d < hd) {
        const float v = to_f(cur_v[d]);
#pragma unroll
        for (int g = 0; g < kMaxG; ++g)
          if (g < G) acc[g][jd] = acc[g][jd] * s_alpha[g] + s_pself[g] * v;
      }
    }
  }

#pragma unroll
  for (int jd = 0; jd < 2; ++jd) {
    const int d = tid + jd * kThreads;
    if (d < hd) {
#pragma unroll
      for (int g = 0; g < kMaxG; ++g)
        if (g < G) store_f(oh + static_cast<size_t>(g) * hd + d, acc[g][jd] / s_l[g]);
    }
  }
}

// Shapes every decode launcher refuses (cudaErrorInvalidValue, no launch)
inline bool bad_shape(int S, int KV, int G, int hd) {
  return S <= 0 || KV <= 0 || G < 1 || G > kMaxG || hd % 32 != 0 || hd > kMaxHd;
}

}  // namespace decode
}  // namespace localai_kernels
