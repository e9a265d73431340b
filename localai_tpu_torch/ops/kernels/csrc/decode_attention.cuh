// The decode append-attention block shared by K1 and K3 (paged_decode.cu)
// and K4/K5 (contig_decode.cu), split-K (flash-decoding): one C launcher
// call enqueues two kernels on the caller's stream.
//
//  1. The split kernel. Each slot's committed rows are cut into n_split =
//     ceil(rows_cap / split_rows) splits (rows_cap = mp * pg for a page
//     pool, C for a contiguous cache: shapes alone, no host read of the
//     lengths). Grid (S, KV, n_split): block (s, h, k) scores the G query
//     heads of kv head h against split k of slot s, if that split starts
//     before the slot's length, and writes each head's unnormalised
//     partial (running max m, sum l, acc[hd]) to an f32 workspace. A block
//     past the length exits at once and writes nothing: the combine reads
//     only the splits that cover [0, length), so no stale partial of an
//     earlier call is ever read.
//  2. The combine kernel, grid (S, KV): for each query head it merges the
//     splits with the log-sum-exp rescale, folds in the current token's own
//     key/value (every cache type alike), divides by l and stores in T. A
//     length-0 slot has no split: its output is the current token's v.
//
// split_rows is a multiple of kTile, given by the wrapper
// (ops/paged_attention.py::SPLIT_ROWS).
//
// The kernels differ only in where logical row c lives, so the walk takes a
// row-address policy (`Rows`: c -> physical row index, -1 for a row on an
// unallocated page, which reads as zeros like the plain version's gather):
//   PagedRows   the slot's page-table row (K1, K3);
//   ContigRows  row c of the slot's contiguous [C, KV, hd] block (K4, K5).
// Cache element type TC: float / bf16 (K1, K4, K5; TC == T) or int8 with a
// float32 scale per (row, kv head) (K3). An int8 row's key scale multiplies
// its score and its value scale multiplies its probability before the value
// product, the fold of localai_tpu/ops/attention.py::_split_cache, so no
// dequantized row is ever formed.
//
// The split walk: 128 threads, tiles of kTile = 32 rows in a kStages = 3
// cp.async ring (K and V rows 16 bytes per copy from every thread, int8
// scales 4 bytes). The prologue issues a tile into every stage before q is
// staged, so a split of 64 rows is in flight whole; in a longer split tile
// t + 2 (its page-table reads, rows and scales) is issued as soon as tile
// t - 1's stage is free, and loads while tile t is scored. Two barriers
// per tile: one publishes the landed tile and frees the stage the next
// issue refills, one publishes the probabilities to the P V threads.
// Scores and the online softmax need none: warp w owns query heads w and
// w + 4 and scores one row per lane, so each head's max and sum stay in one
// warp's registers. In P V a thread owns two adjacent dims of a run of each
// tile's rows (one 2-element V load and G broadcast P reads per row); the
// runs' sums are added once, after the walk. Online softmax in f32; no
// tensor cores: at 2 * G flops per element read the walk is bound by its
// loads and shared-memory traffic, not by its multiplies.
//
// The combine spreads each (slot, kv head)'s splits over its threads: the
// splits' weights exp(m - max) are staged in shared memory, and thread
// groups sum every P-th split's acc with 16-byte loads, so no thread walks
// the splits one dependent load after another. It is launched as a
// programmatic dependent of the split kernel (griddepcontrol): its blocks
// start while the splits run, read what the split kernel does not write
// (lengths, q, the current token) and wait for the splits' partials only
// then, so the second launch adds little to the call.
#pragma once

#include "common.cuh"

namespace localai_kernels {
namespace decode {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;          // rows per ring stage: one row per lane when scoring
constexpr int kStages = 3;         // ring depth: a split of up to 96 rows is in flight whole
constexpr int kMaxG = 8;           // query heads per kv head
constexpr int kMaxHd = 256;
constexpr int kHeadsPerWarp = kMaxG / kWarps;
constexpr int kCombineChunk = 64;  // splits whose weights the combine stages at once

// Split blocks per SM that ptxas must fit in registers: the bf16 ring at
// the serving shape allows 4 per SM; without a bound ptxas aims at 7 and
// spills. The int8 walk (16 values per 16-byte load) needs more than 128
// registers, so 3.
template <bool kQuant>
constexpr int split_min_blocks() { return kQuant ? 3 : 4; }

// Dynamic shared memory of a split block: the K and V ring (rows padded by
// one 16-byte vector, so 8 lanes reading 8 rows hit 32 distinct banks) and
// the G pre-scaled query rows in f32; after the walk the same bytes hold
// the P V row groups' sums (kThreads / (hd / 2) groups of G * hd floats)
template <typename TC>
inline size_t smem_bytes(int hd, int G) {
  const size_t stride = static_cast<size_t>(hd + vec_elems<TC>());
  const size_t walk = static_cast<size_t>(kStages) * 2 * kTile * stride * sizeof(TC) +
                      static_cast<size_t>(G) * hd * sizeof(float);
  const size_t sums = static_cast<size_t>(kThreads / (hd / 2)) * G * hd * sizeof(float);
  return walk > sums ? walk : sums;
}

inline int n_splits(int rows_cap, int split_rows) { return (rows_cap + split_rows - 1) / split_rows; }

// The f32 workspace of one call, S * KV * n_split * G * (hd + 2) floats:
// acc [S, KV, n_split, G, hd], then (m, l) [S, KV, n_split, G, 2]
struct Partials {
  float* ws;
  int S, KV, G, hd, n_split;
  __device__ __forceinline__ size_t unit(int s, int h, int k) const {
    return (static_cast<size_t>(s) * KV + h) * n_split + k;
  }
  __device__ __forceinline__ float* acc(int s, int h, int k) const {
    return ws + unit(s, h, k) * G * hd;
  }
  __device__ __forceinline__ float* ml(int s, int h, int k) const {
    return ws + static_cast<size_t>(S) * KV * n_split * G * hd + unit(s, h, k) * G * 2;
  }
};

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

// Issues tile t of a split (rows row0 + t * kTile on, up to row_end): its
// K and V rows (zeros on unallocated pages) and, for int8, their scales,
// into ring stage t % kStages, by cp.async from every thread
template <typename TC, bool kQuant, class Rows>
__device__ __forceinline__ void issue_tile(TC* k_s, TC* v_s, float (*s_ks)[kTile],
                                           float (*s_vs)[kTile], const TC* __restrict__ kb,
                                           const TC* __restrict__ vb,
                                           const float* __restrict__ skb,
                                           const float* __restrict__ svb, const Rows& rows, int t,
                                           int row0, int row_end, int KV, int h, int hd) {
  constexpr int kVec = vec_elems<TC>();
  const int stride = hd + kVec;
  const int chunks = hd / kVec;
  const int st = t % kStages;
  const int base = row0 + t * kTile;
  const int n_rows = min(kTile, row_end - base);
  TC* kd = k_s + st * kTile * stride;
  TC* vd = v_s + st * kTile * stride;
  for (int c = threadIdx.x; c < n_rows * chunks; c += kThreads) {
    const int r = c / chunks, j = c - r * chunks;
    const long long pr = rows(base + r);
    const int bytes = pr < 0 ? 0 : 16;
    const size_t e = static_cast<size_t>(pr < 0 ? 0 : pr) * KV * hd + static_cast<size_t>(h) * hd +
                     j * kVec;
    cp_async16(smem_addr(kd + r * stride + j * kVec), kb + e, bytes);
    cp_async16(smem_addr(vd + r * stride + j * kVec), vb + e, bytes);
  }
  if constexpr (kQuant) {
    const int tid = threadIdx.x;
    if (tid < n_rows) {
      const long long pr = rows(base + tid);
      const size_t si = static_cast<size_t>(pr < 0 ? 0 : pr) * KV + h;
      cp_async4(smem_addr(&s_ks[st][tid]), skb + si, pr < 0 ? 0 : 4);
      cp_async4(smem_addr(&s_vs[st][tid]), svb + si, pr < 0 ? 0 : 4);
    }
  }
}

// One split: committed rows [row0, row_end) (row0 < row_end) of one (slot,
// kv head), the whole work of a split block. kb/vb: [rows, KV, hd] store (a
// page pool, or one slot's contiguous rows); skb/svb: its [rows, KV] f32
// scales (int8 only, else unused); qh: the G query rows [G, hd] of this kv
// head; acc_out [G, hd] and ml_out [G, 2]: this split's partials.
template <typename T, typename TC, bool kQuant, class Rows>
__device__ __forceinline__ void split_block(const T* __restrict__ qh, const TC* __restrict__ kb,
                                            const TC* __restrict__ vb,
                                            const float* __restrict__ skb,
                                            const float* __restrict__ svb, Rows rows, int row0,
                                            int row_end, float* __restrict__ acc_out,
                                            float* __restrict__ ml_out, int KV, int h, int G,
                                            int hd) {
  constexpr int kVec = vec_elems<TC>();
  const int stride = hd + kVec;
  const int chunks = hd / kVec;      // 16-byte chunks per row
  const int stage = kTile * stride;  // elements of one K (or V) stage
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TC* k_s = reinterpret_cast<TC*>(smem_raw);                          // [kStages][kTile][stride]
  TC* v_s = k_s + kStages * stage;                                    // [kStages][kTile][stride]
  float* q_s = reinterpret_cast<float*>(v_s + kStages * stage);       // [G][hd]
  __shared__ float s_ks[kStages][kTile];  // int8: key / value scale of each ring row
  __shared__ float s_vs[kStages][kTile];
  __shared__ float s_p[kMaxG][kTile];
  __shared__ float s_alpha[kMaxG];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_tiles = (row_end - row0 + kTile - 1) / kTile;

  // the prologue fills every ring stage (a split of up to kStages tiles is
  // in flight at once); one commit group per stage or loop step, empty
  // past the last tile, so the wait below always leaves exactly the newest
  // kStages - 1 groups in flight
#pragma unroll
  for (int t = 0; t < kStages; ++t) {
    if (t < n_tiles)
      issue_tile<TC, kQuant>(k_s, v_s, s_ks, s_vs, kb, vb, skb, svb, rows, t, row0, row_end, KV,
                             h, hd);
    cp_async_commit();
  }
  const float scale = rsqrtf(static_cast<float>(hd));
  for (int e = tid; e < G * hd; e += kThreads) q_s[e] = to_f(qh[e]) * scale;

  float m[kHeadsPerWarp], l[kHeadsPerWarp];  // this warp's heads warp + i * kWarps
#pragma unroll
  for (int i = 0; i < kHeadsPerWarp; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }
  // P V: thread = (dims 2 * dp and 2 * dp + 1, row group rg): each tile's
  // rows are cut into n_groups runs of rpg rows, and the groups' sums are
  // added once, after the walk
  const int pairs = hd / 2;
  const int n_groups = kThreads / pairs;  // 8 at hd 32 .. 1 at hd >= 160
  const int rpg = (kTile + n_groups - 1) / n_groups;
  const int dp = tid % pairs, rg = tid / pairs;
  const bool pv_thread = rg < n_groups;
  float acc[kMaxG][2];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) acc[g][0] = acc[g][1] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 1>();  // this thread's copies of tile t have landed
    // everyone's copies of tile t (and q_s) are visible, and every thread
    // is done with tile t - 1, whose stage the issue below refills
    __syncthreads();
    if (t > 0 && t + kStages - 1 < n_tiles)
      issue_tile<TC, kQuant>(k_s, v_s, s_ks, s_vs, kb, vb, skb, svb, rows, t + kStages - 1, row0,
                             row_end, KV, h, hd);
    cp_async_commit();
    const int st = t % kStages;
    const int n_rows = min(kTile, row_end - (row0 + t * kTile));
    const TC* kt = k_s + st * stage;
    const TC* vt = v_s + st * stage;
    // scores and online softmax: lane = row, warp-uniform heads
#pragma unroll
    for (int i = 0; i < kHeadsPerWarp; ++i) {
      const int g = warp + i * kWarps;
      if (g < G) {
        float sc = kNegInf;
        if (lane < n_rows) {
          const TC* krow = kt + lane * stride;
          const float* qg = q_s + g * hd;
          float sum = 0.f;
          for (int j = 0; j < chunks; ++j) {
            float kf[kVec];
            unpack16(krow + j * kVec, kf);
#pragma unroll
            for (int x = 0; x < kVec; ++x) sum += qg[j * kVec + x] * kf[x];
          }
          if constexpr (kQuant) sum *= s_ks[st][lane];  // key scale fold
          sc = sum;
        }
        const float m_new = fmaxf(m[i], warp_max(sc));
        float p = lane < n_rows ? expf(sc - m_new) : 0.f;
        const float alpha = expf(m[i] - m_new);
        l[i] = l[i] * alpha + warp_sum(p);
        m[i] = m_new;
        // value scale fold: into the probability the V product reads, not
        // into the denominator
        if constexpr (kQuant) {
          if (lane < n_rows) p *= s_vs[st][lane];
        }
        s_p[g][lane] = p;
        if (lane == 0) s_alpha[g] = alpha;
      }
    }
    __syncthreads();
    // acc = acc * alpha + P V over this thread's rows: one 2-element load of
    // V and G broadcast reads of P per row (consecutive threads on
    // consecutive words: conflict-free)
    if (pv_thread) {
#pragma unroll
      for (int g = 0; g < kMaxG; ++g)
        if (g < G) {
          acc[g][0] *= s_alpha[g];
          acc[g][1] *= s_alpha[g];
        }
      const TC* vcol = vt + 2 * dp;
      const int r_hi = min(n_rows, (rg + 1) * rpg);
#pragma unroll 4
      for (int r = rg * rpg; r < r_hi; ++r) {
        float v0, v1;
        load2(vcol + r * stride, v0, v1);
#pragma unroll
        for (int g = 0; g < kMaxG; ++g)
          if (g < G) {
            const float pr = s_p[g][r];
            acc[g][0] += pr * v0;
            acc[g][1] += pr * v1;
          }
      }
    }
  }
  cp_async_wait_all();  // only empty groups are left; leave none behind

  if (n_groups > 1) {
    // add the row groups' sums in shared memory: the ring and q_s are free
    // now, and smem_bytes holds the sums
    __syncthreads();
    float* red = reinterpret_cast<float*>(smem_raw);  // [n_groups][G][hd]
    if (pv_thread) {
#pragma unroll
      for (int g = 0; g < kMaxG; ++g)
        if (g < G) {
          float* x = red + (static_cast<size_t>(rg) * G + g) * hd + 2 * dp;
          x[0] = acc[g][0];
          x[1] = acc[g][1];
        }
    }
    __syncthreads();
    for (int e = tid; e < G * hd; e += kThreads) {
      float x = 0.f;
      for (int k = 0; k < n_groups; ++k) x += red[static_cast<size_t>(k) * G * hd + e];
      acc_out[e] = x;
    }
  } else if (pv_thread) {
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
      if (g < G) {
        acc_out[static_cast<size_t>(g) * hd + 2 * dp] = acc[g][0];
        acc_out[static_cast<size_t>(g) * hd + 2 * dp + 1] = acc[g][1];
      }
  }
#pragma unroll
  for (int i = 0; i < kHeadsPerWarp; ++i) {
    const int g = warp + i * kWarps;
    if (g < G && lane == 0) {
      ml_out[2 * g] = m[i];
      ml_out[2 * g + 1] = l[i];
    }
  }
}

// The combine of block (s, h): merges the splits covering [0, length) of
// each query head, folds in the current token (cur_k/cur_v [S, KV, hd])
// and writes out [S, KV*G, hd] in T. Each launcher's file wraps it in its
// own __global__ (grid (S, KV), kThreads threads).
template <typename T>
__device__ __forceinline__ void combine_block(const T* __restrict__ q,        // [S, KV*G, hd]
                                              const T* __restrict__ cur_k,    // [S, KV, hd]
                                              const T* __restrict__ cur_v,    // [S, KV, hd]
                                              const int* __restrict__ lengths,  // [S]
                                              const Partials& part, T* __restrict__ out,
                                              int rows_cap, int split_rows) {
  const int s = blockIdx.x;
  const int h = blockIdx.y;
  const int G = part.G, hd = part.hd;
  int length = lengths[s];
  length = length < 0 ? 0 : (length > rows_cap ? rows_cap : length);
  const int n_used = (length + split_rows - 1) / split_rows;
  const size_t H = static_cast<size_t>(part.KV) * G;
  const size_t qo = (static_cast<size_t>(s) * H + static_cast<size_t>(h) * G) * hd;
  const size_t ko = (static_cast<size_t>(s) * part.KV + h) * hd;
  const float* acc0 = part.acc(s, h, 0);  // split i of head g at + (i * G + g) * hd
  const float* ml0 = part.ml(s, h, 0);    // split i of head g at + (i * G + g) * 2
  __shared__ float s_self[kMaxG];  // the current token's score
  __shared__ float s_max[kMaxG];
  __shared__ float s_sum[kMaxG];
  __shared__ float s_w[kCombineChunk][kMaxG];
  __shared__ float4 s_part[kThreads];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nv = hd / 4;  // float4 columns of a row
  // before the split kernel's partials: the current token's score of this
  // warp's heads, and this thread's four columns of its value
  const float scale = rsqrtf(static_cast<float>(hd));
  float dot[kHeadsPerWarp];
#pragma unroll
  for (int i = 0; i < kHeadsPerWarp; ++i) {
    const int g = warp + i * kWarps;
    dot[i] = 0.f;
    if (g < G) {
      for (int j = lane; j < hd; j += 32)
        dot[i] += (to_f(q[qo + static_cast<size_t>(g) * hd + j]) * scale) * to_f(cur_k[ko + j]);
      dot[i] = warp_sum(dot[i]);
    }
  }
  float cv[4] = {0.f, 0.f, 0.f, 0.f};
  if (tid < nv) {
#pragma unroll
    for (int e = 0; e < 4; ++e) cv[e] = to_f(cur_v[ko + 4 * tid + e]);
  }
  grid_dependency_wait();
#pragma unroll
  for (int i = 0; i < kHeadsPerWarp; ++i) {
    const int g = warp + i * kWarps;
    if (g < G) {
      float mx = dot[i];
      for (int k = lane; k < n_used; k += 32) mx = fmaxf(mx, ml0[(k * G + g) * 2]);
      mx = warp_max(mx);
      float sum = 0.f;
      for (int k = lane; k < n_used; k += 32) {
        const float* ml = ml0 + (k * G + g) * 2;
        sum += ml[1] * expf(ml[0] - mx);
      }
      sum = warp_sum(sum) + expf(dot[i] - mx);
      if (lane == 0) {
        s_self[g] = dot[i];
        s_max[g] = mx;
        s_sum[g] = sum;
      }
    }
  }
  __syncthreads();
  // thread = (float4 column v, row group p): group p sums splits p, p + P,
  // ... of every head, with the splits' weights exp(m - max) staged in
  // shared memory a chunk of splits at a time
  const int P = kThreads / nv;  // 16 at hd 32 .. 2 at hd 256
  const int v = tid % nv, p = tid / nv;
  const bool active = p < P;
  float4 acc[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) acc[g] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < n_used; c0 += kCombineChunk) {
    const int cn = min(kCombineChunk, n_used - c0);
    for (int e = tid; e < cn * G; e += kThreads) {
      const int i = e / G, g = e - i * G;
      s_w[i][g] = expf(ml0[((c0 + i) * G + g) * 2] - s_max[g]);
    }
    __syncthreads();
    if (active) {
      for (int i = p; i < cn; i += P) {
        const float4* a =
            reinterpret_cast<const float4*>(acc0 + static_cast<size_t>(c0 + i) * G * hd) + v;
#pragma unroll
        for (int g = 0; g < kMaxG; ++g)
          if (g < G) {
            const float4 x = a[g * nv];
            const float w = s_w[i][g];
            acc[g].x += w * x.x;
            acc[g].y += w * x.y;
            acc[g].z += w * x.z;
            acc[g].w += w * x.w;
          }
      }
    }
    __syncthreads();  // s_w is rewritten by the next chunk
  }
  // per head: add the groups' sums and the current token, divide by l
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g < G) {
      if (active) s_part[tid] = acc[g];
      __syncthreads();
      if (tid < nv) {
        float4 x = s_part[tid];
        for (int k = 1; k < P; ++k) {
          const float4 y = s_part[k * nv + tid];
          x.x += y.x;
          x.y += y.y;
          x.z += y.z;
          x.w += y.w;
        }
        const float ws = expf(s_self[g] - s_max[g]);
        const float sum = s_sum[g];
        T* o = out + qo + static_cast<size_t>(g) * hd + 4 * tid;
        store_f(o, (x.x + ws * cv[0]) / sum);
        store_f(o + 1, (x.y + ws * cv[1]) / sum);
        store_f(o + 2, (x.z + ws * cv[2]) / sum);
        store_f(o + 3, (x.w + ws * cv[3]) / sum);
      }
      __syncthreads();  // s_part is rewritten for the next head
    }
  }
}

// Launches a file's combine kernel, grid (S, KV), as a programmatic
// dependent of the split kernel just launched on `st` (it may start before
// the split kernel ends and waits for it in grid_dependency_wait). Returns
// the launch's error.
template <typename... Params, typename... Args>
inline cudaError_t launch_combine(void (*kernel)(Params...), int S, int KV, cudaStream_t st,
                                  Args&&... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S, KV);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<Args&&>(args)...);
}

// Shapes every decode launcher refuses (cudaErrorInvalidValue, no launch):
// besides the head shape, a split size that is not a positive multiple of
// the tile, and more splits per slot than a grid's z extent holds
inline bool bad_shape(int S, int KV, int G, int hd, int rows_cap, int split_rows) {
  return S <= 0 || KV <= 0 || G < 1 || G > kMaxG || hd % 32 != 0 || hd > kMaxHd ||
         rows_cap <= 0 || split_rows <= 0 || split_rows % kTile != 0 ||
         n_splits(rows_cap, split_rows) > 65535;
}

}  // namespace decode
}  // namespace localai_kernels
