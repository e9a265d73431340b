// Weight-only quantized matrix products: W8 (int8 weights) and W4 (int4
// weights), y[M, N] = x[M, K] @ dequant(q)[K, N], float32 accumulation,
// y in x's dtype (float32 or bfloat16).
//
// Not a TPU kernel: the JAX package has no pallas_call here. Its products
// are einsums over localai_tpu/ops/quant.py:95::mat (models/llama.py
// :229-248, :326, :608), and XLA fuses mat's cast and scale into the
// einsum, so the TPU reads int8 / int4 weights and never a dense copy.
// Eager PyTorch does not fuse `x @ mat(w)`: it would read the int8 weight,
// write a bf16 copy and read it again, ~2.5x the bytes of the bf16 model.
// These kernels are that fusion, for the port (ops/quant.py::quant_matmul).
//
// Layouts (ops/quant.py): int8 q [K, N] with s [N] per output column;
// int4 q packed [K, N/2], byte j of a row holding column 2j in its low
// nibble and 2j + 1 in its high one (two's complement), with s [K/g, N]
// per group of g rows. N is a multiple of 16.
//
// Bound on an H100 (3.35 TB/s): the weight bytes, read once. At Llama-3.1-8B
// widths and M = 8: w_gate 58.7 MB int8 (17.5 us), 29.4 MB int4 + 1.8 MB
// scales (9.3 us); wk 4.2 MB (1.3 us); lm_head 525 MB (157 us); a decode
// step's weights 7.50 GB int8 (2.24 ms) or 4.24 GB int4 with an int8
// lm_head (1.27 ms), against 15.0 GB (4.48 ms) in bf16. A 512-token prefill
// pack's w_gate is 60.1 GFLOP: 61 us at 989 TFLOP/s (bf16 dense), bound by
// operations.
//
// Routes, chosen on the host by x's dtype and the weight's orientation
// (ops/quant.py::quant_matmul), never by a fallback:
//  * bfloat16 x, a [K, N] weight, any M: the tensor-core kernel (namespace
//    tensor_core below). Decode (M <= 16) and prefill packs alike.
//  * float32 x: the CUDA-core skinny kernel for M <= 16, else dequantize +
//    torch.matmul (TF32 tensor cores would break float32's tolerances).
//  * a tied embedding table used transposed (x @ dequant(embed)^T), either
//    dtype: dequantize + torch.matmul.
//
// Tensor-core kernel (sm_90a, wgmma). What held the CUDA-core kernels
// back on the card: at M = 8 the skinny kernel did one decode and 8 FMAs
// per weight, so instruction issue, not bytes, bound it (57 us for w_gate
// against a 17.6 us byte bound); the wide route wrote a dense bf16 copy of
// the weight (117 MB for w_gate) that cuBLAS then read again. Here a block
// of two warpgroups owns 128 weight columns and a token tile of TN rows of
// x (8, 16, 64, 128 or 256), and walks its split of K in tiles of 64 rows:
//   1. cp.async stages the RAW tile (64 x 128 int8, or 64 x 64 bytes of
//      packed int4, plus for W4 the group-scale rows the tile spans) and
//      the x tile into a ring of shared-memory stages (6 deep for decode
//      token tiles, 4 for wider ones);
//   2. all 256 threads WIDEN the raw tile in shared memory into bf16,
//      each weight to bf16(q * s): one f32 product rounded once, the plain
//      version's own arithmetic (ops/quant.py::mat), so the tensor cores
//      see operands bit-identical to the plain version's weights and only
//      the order of the f32 sums differs. Bytes and nibbles become floats
//      with magic-number tricks (decode16, decode16_int4: a byte-permute
//      or one LOP3, then one subtraction), not the int-to-float unit. W8
//      keeps its 16 column scales in registers; W4 with a group that
//      divides the tile (g 128) stages one scale row per tile, and any
//      other group (g = 86 at llama-2's 11008 rows at tp 8) stages the
//      rows the tile spans and follows each row's group without a
//      division. The widened tile goes to one of two buffers in wgmma's
//      128-byte-swizzled layout (wgmma.cuh), rows = K, columns = N;
//   3. swap-AB: each warpgroup runs D[64 weight columns x TN tokens] +=
//      W^T x^T with wgmma, the widened tile as A read MN-major through the
//      transpose bit, the x tile (rows K-contiguous) as a K-major B. At
//      decode TN = 8 or 16, so no tensor-core work pads M up to 64.
//      wgmma runs asynchronously: tile t's product overlaps tile t + 1's
//      widening (two widened buffers), and the copies run S - 2 tiles
//      ahead. Token rows past M are zeros in shared memory and are never
//      stored.
// What bounds it on the card (PERF.md, PR 7): at decode, the cp.async
// stream of the raw tiles (a copy-only variant of the loop takes ~0.035 ms
// of W8's 0.040 at w_gate M = 8) and, for W4, the widening's issue (two
// weights per byte); at a 512-token pack, the L2 -> shared traffic of the
// x tiles (re-read by each of N / 128 column blocks) and the widening,
// which the asynchronous wgmma does not fully hide.
// Split-K for small grids: ops/quant.py::tc_plan splits K so that column
// tiles x token tiles x splits fill one wave (two blocks per SM for TN <=
// 64, one above), from the shapes and the SM count only; partials go to an
// f32 workspace [n_split, M, N] that combine_kernel sums in split order.
// No atomics: the same inputs give the same bits on the same card.
//
// CUDA-core kernels (float32 x, and the transposed table):
//  * skinny (M <= 16): one fused kernel reads each weight byte once. A block
//    of 4 warps owns 512 output columns (a tile) and a chunk of K (split-K
//    across blocks). Each thread owns 16 adjacent columns: one 16-byte load
//    per int8 row, one 8-byte load per int4 row, 4 rows in flight; a warp
//    covers one row's 512 columns. Each warp walks a contiguous quarter of
//    the chunk, so an int4 group's scales are loaded when the group
//    changes, not per row. The chunk's rows of x sit in shared memory,
//    transposed. W8 applies its column scale once at the end; W4 multiplies
//    each decoded weight by its group's scale. The 4 warps' partials are
//    summed in shared memory in a fixed order; with one split the block
//    writes y, otherwise the f32 workspace, summed by combine_kernel.
//  * wide: a dequantize kernel writes the dense weight in x's dtype (16
//    weights per thread, 16-byte loads and stores) into the caller's
//    scratch, and torch.matmul multiplies it: the large product is a plain
//    GEMM, as the JAX package left it to XLA. The same kernel serves a tied
//    embedding's unembed (x @ dequant(embed)^T).

#include <stdint.h>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

using namespace localai_kernels;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kCols = 16;              // output columns per thread
constexpr int kTileN = 32 * kCols;     // output columns per block
constexpr int kUnroll = 4;             // weight rows in flight per thread
constexpr int kMaxChunk = 1024;        // ops/quant.py::MAX_K_CHUNK
constexpr int kMaxM = 16;              // ops/quant.py::SKINNY_M

// one thread's 16 weights of a row: 16 bytes of int8, 8 bytes of int4
template <int BITS>
struct Packed;
template <>
struct Packed<8> {
  using type = uint4;
};
template <>
struct Packed<4> {
  using type = uint2;
};

template <int BITS>
__host__ __device__ constexpr size_t row_bytes(int N) { return BITS == 8 ? N : N / 2; }

// 16 int8 -> floats: byte ^ 0x80 = v + 128 in the low byte of the float
// 2^23 + v + 128, exact
__device__ __forceinline__ void decode16(uint4 p, float* w) {
  const uint32_t words[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t u = words[i] ^ 0x80808080u;
#pragma unroll
    for (int b = 0; b < 4; ++b)
      w[4 * i + b] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540u | b)) - 8388736.0f;
  }
}

// 16 int4 -> floats: nibble n of the little-endian word is column n;
// nibble ^ 8 = v + 8, the low bits of 2^23 + v + 8
__device__ __forceinline__ void decode16(uint2 p, float* w) {
  const uint32_t words[2] = {p.x, p.y};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint32_t u = words[i] ^ 0x88888888u;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      w[8 * i + n] = __uint_as_float(0x4B000000u | ((u >> (4 * n)) & 0xFu)) - 8388616.0f;
  }
}

__device__ __forceinline__ void load_f16x(const float* p, float* f) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p) + i);
    f[4 * i] = t.x;
    f[4 * i + 1] = t.y;
    f[4 * i + 2] = t.z;
    f[4 * i + 3] = t.w;
  }
}

template <typename T, int BITS, int MT>
__global__ void __launch_bounds__(kThreads)
skinny_kernel(const T* __restrict__ x,         // [M, K]
              const uint8_t* __restrict__ q,   // [K, row_bytes]
              const float* __restrict__ s,     // [N] or [K/g, N]
              T* __restrict__ out,             // [M, N] (one split)
              float* __restrict__ ws,          // [n_split, M, N] (several)
              int M, int K, int N, int group, int k_chunk) {
  using P = typename Packed<BITS>::type;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                    // [k_chunk][MT]: x of this chunk, transposed
  float* red = smem + k_chunk * MT;    // [kWarps][kTileN]: the warps' partials
  const int tile = blockIdx.x, split = blockIdx.y, m0 = blockIdx.z * MT;
  const int k0 = split * k_chunk;
  const int rows = min(K - k0, k_chunk);
  for (int i = threadIdx.x; i < MT * rows; i += kThreads) {
    const int m = i / rows, r = i - m * rows;
    xs[r * MT + m] = (m0 + m < M) ? to_f(x[static_cast<size_t>(m0 + m) * K + k0 + r]) : 0.f;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col0 = tile * kTileN + lane * kCols;
  const bool col_ok = col0 < N;
  const int per_warp = (rows + kWarps - 1) / kWarps;
  const int r0 = warp * per_warp, r1 = min(rows, r0 + per_warp);
  float acc[MT][kCols];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[m][c] = 0.f;

  if (col_ok) {
    const size_t rb = row_bytes<BITS>(N);
    const uint8_t* qp = q + static_cast<size_t>(k0) * rb + (BITS == 8 ? col0 : col0 / 2);
    float sc[kCols];
    int cur_g = -1;
    for (int r = r0; r < r1; r += kUnroll) {
      P ld[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (r + u < r1) ld[u] = __ldcs(reinterpret_cast<const P*>(qp + (r + u) * rb));
        else ld[u] = P{};
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (r + u < r1) {
          float w[kCols];
          decode16(ld[u], w);
          if constexpr (BITS == 4) {
            const int g = (k0 + r + u) / group;
            if (g != cur_g) {
              cur_g = g;
              load_f16x(s + static_cast<size_t>(g) * N + col0, sc);
            }
#pragma unroll
            for (int c = 0; c < kCols; ++c) w[c] *= sc[c];
          }
          const float* xr = xs + (r + u) * MT;
          float xv[MT];
          if constexpr (MT >= 4) {
#pragma unroll
            for (int j = 0; j < MT; j += 4) {
              const float4 t = *reinterpret_cast<const float4*>(xr + j);
              xv[j] = t.x;
              xv[j + 1] = t.y;
              xv[j + 2] = t.z;
              xv[j + 3] = t.w;
            }
          } else {
#pragma unroll
            for (int j = 0; j < MT; ++j) xv[j] = xr[j];
          }
#pragma unroll
          for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int c = 0; c < kCols; ++c) acc[m][c] = fmaf(xv[m], w[c], acc[m][c]);
        }
      }
    }
  }

  // the 4 warps' partials of each row of x, summed in warp order
  const bool single = gridDim.y == 1;
  const int j = threadIdx.x * 4;       // this thread's 4 columns of the tile
  const int col = tile * kTileN + j;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (m0 + m < M) {                  // uniform across the block
      __syncthreads();
      if (col_ok) {
        float4* dst = reinterpret_cast<float4*>(red + warp * kTileN + lane * kCols);
#pragma unroll
        for (int i = 0; i < kCols / 4; ++i)
          dst[i] = make_float4(acc[m][4 * i], acc[m][4 * i + 1], acc[m][4 * i + 2],
                               acc[m][4 * i + 3]);
      }
      __syncthreads();
      if (col < N) {
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          v[e] = red[j + e];
#pragma unroll
          for (int wi = 1; wi < kWarps; ++wi) v[e] += red[wi * kTileN + j + e];
        }
        const size_t row = static_cast<size_t>(m0 + m);
        if (single) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            store_f(out + row * N + col + e, BITS == 8 ? v[e] * s[col + e] : v[e]);
        } else {
          *reinterpret_cast<float4*>(ws + (static_cast<size_t>(split) * M + row) * N + col) =
              make_float4(v[0], v[1], v[2], v[3]);
        }
      }
    }
  }
}

// y = (sum over splits, in split order) [* s[col] when kScale: the
// CUDA-core W8]; 4 outputs per thread
template <typename T, bool kScale>
__global__ void __launch_bounds__(256)
combine_kernel(const float* __restrict__ ws, const float* __restrict__ s, T* __restrict__ out,
               int M, int N, int n_split) {
  grid_dependency_wait();   // launched as a programmatic dependent: the partials are written
  const size_t i = (static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x) * 4;
  const size_t total = static_cast<size_t>(M) * N;
  if (i >= total) return;
  float4 a = *reinterpret_cast<const float4*>(ws + i);
  for (int k = 1; k < n_split; ++k) {
    const float4 b = *reinterpret_cast<const float4*>(ws + k * total + i);
    a.x += b.x;
    a.y += b.y;
    a.z += b.z;
    a.w += b.w;
  }
  float v[4] = {a.x, a.y, a.z, a.w};
  const int col = static_cast<int>(i % N);
#pragma unroll
  for (int e = 0; e < 4; ++e) store_f(out + i + e, kScale ? v[e] * s[col + e] : v[e]);
}

__device__ __forceinline__ void store16(float* p, const float* v) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    reinterpret_cast<float4*>(p)[i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
}
__device__ __forceinline__ void store16(__nv_bfloat16* p, const float* v) {
  uint4 o[2];
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(o);
#pragma unroll
  for (int i = 0; i < 8; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  reinterpret_cast<uint4*>(p)[0] = o[0];
  reinterpret_cast<uint4*>(p)[1] = o[1];
}

// the dense weight w [K, N] = q * s (one f32 product, rounded once to T:
// ops/quant.py::mat's arithmetic); 16 weights per thread, grid-stride
template <typename T, int BITS>
__global__ void __launch_bounds__(256)
dequant_kernel(const uint8_t* __restrict__ q, const float* __restrict__ s, T* __restrict__ w,
               int K, int N, int group) {
  using P = typename Packed<BITS>::type;
  const int per_row = N / kCols;
  const size_t total = static_cast<size_t>(K) * per_row;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int k = static_cast<int>(i / per_row);
    const int c0 = static_cast<int>(i - static_cast<size_t>(k) * per_row) * kCols;
    float v[kCols], sc[kCols];
    decode16(__ldcs(reinterpret_cast<const P*>(q + k * row_bytes<BITS>(N) +
                                               (BITS == 8 ? c0 : c0 / 2))),
             v);
    load_f16x(BITS == 8 ? s + c0 : s + static_cast<size_t>(k / group) * N + c0, sc);
#pragma unroll
    for (int c = 0; c < kCols; ++c) v[c] *= sc[c];
    store16(w + static_cast<size_t>(k) * N + c0, v);
  }
}

template <typename T, int BITS, int MT>
int launch_skinny(const void* x, const void* q, const void* s, void* out, void* ws, int M, int K,
                  int N, int group, int k_chunk, cudaStream_t st) {
  const int n_split = (K + k_chunk - 1) / k_chunk;
  const size_t bytes = (static_cast<size_t>(k_chunk) * MT + kWarps * kTileN) * sizeof(float);
  const dim3 grid((N + kTileN - 1) / kTileN, n_split, (M + MT - 1) / MT);
  skinny_kernel<T, BITS, MT><<<grid, kThreads, bytes, st>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(q), static_cast<const float*>(s),
      static_cast<T*>(out), static_cast<float*>(ws), M, K, N, group, k_chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return static_cast<int>(err);
  const size_t quads = static_cast<size_t>(M) * N / 4;
  combine_kernel<T, BITS == 8><<<static_cast<unsigned>((quads + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(ws), static_cast<const float*>(s), static_cast<T*>(out), M, N,
      n_split);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int BITS>
int skinny_rows(const void* x, const void* q, const void* s, void* out, void* ws, int M, int K,
                int N, int group, int k_chunk, cudaStream_t st) {
  if (M <= 1) return launch_skinny<T, BITS, 1>(x, q, s, out, ws, M, K, N, group, k_chunk, st);
  if (M <= 2) return launch_skinny<T, BITS, 2>(x, q, s, out, ws, M, K, N, group, k_chunk, st);
  if (M <= 4) return launch_skinny<T, BITS, 4>(x, q, s, out, ws, M, K, N, group, k_chunk, st);
  return launch_skinny<T, BITS, 8>(x, q, s, out, ws, M, K, N, group, k_chunk, st);
}

template <typename T, int BITS>
int launch_dequant(const void* q, const void* s, void* w, int K, int N, int group,
                   cudaStream_t st) {
  const size_t total = static_cast<size_t>(K) * (N / kCols);
  const size_t blocks = (total + 255) / 256;
  dequant_kernel<T, BITS><<<static_cast<unsigned>(blocks < 8192 ? blocks : 8192), 256, 0, st>>>(
      static_cast<const uint8_t*>(q), static_cast<const float*>(s), static_cast<T*>(w), K, N,
      group);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bfloat16 x: the tensor-core kernel (see the note at the top)
namespace tensor_core {

constexpr int kThreads = 256;       // two warpgroups; warpgroup w owns columns [64 w, 64 w + 64)
constexpr int kTileN = 128;         // weight columns per block (ops/quant.py::TC_TILE_N)
constexpr int kTileK = 64;          // contraction rows per stage (ops/quant.py::TC_TILE_K)
constexpr int kMinGroup = 16;       // the smallest W4 group (quantize_weight_int4's floor)
constexpr int kMaxGroups = (kTileK - 1) / kMinGroup + 2;   // scale rows a tile can span

// Shared memory of one block: two widened bf16 tiles [kTileK x kTileN]
// (swizzled, one 64-column block per warpgroup), then the ring of stages,
// each [x tile TN x kTileK bf16, swizzled | raw weight tile | W4 scale
// rows kMaxGroups x kTileN f32], every part 1024-byte aligned.
template <int BITS, int TN>
struct Tile {
  static constexpr int kStages = TN <= 16 ? 6 : 4;
  static constexpr int kWideBufs = 2;   // widened tiles: tile t widens under tile t - 1's wgmma
  static constexpr int kBlocksPerSM = TN <= 64 ? 2 : 1;     // ops/quant.py::tc_blocks_per_sm
  static constexpr int RAW_ROW = kTileN * BITS / 8;        // bytes of one raw row
  static constexpr int X = TN * kTileK * 2;
  static constexpr int RAW = kTileK * RAW_ROW;
  static constexpr int SC = BITS == 4 ? (kMaxGroups * kTileN * 4 + 1023) / 1024 * 1024 : 0;
  static constexpr int STAGE = X + RAW + SC;
  static constexpr int WIDE = kTileK * kTileN * 2;
  static constexpr size_t BYTES =
      1024 + kWideBufs * static_cast<size_t>(WIDE) + kStages * static_cast<size_t>(STAGE);
};

// Nibble n (bits 4 n .. 4 n + 3, n <= 3) of a half word with its sign bit
// flipped (v + 8) as the float v: it is the low mantissa of a float whose
// ulp there is 1 (2^(23 - 4 n)), so one LOP3 ((h & mask) | magic, the
// magic in a register) and one subtraction decode it exactly
template <int n>
__device__ __forceinline__ float nibble(uint32_t h) {
  constexpr uint32_t kMagic = (150u - 4u * n) << 23;   // the bits of 2^(23 - 4 n)
  constexpr float kBias = static_cast<float>(1u << (23 - 4 * n)) + 8.f;
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;\n" : "=r"(d) : "r"(h), "n"(0xFu << (4 * n)), "r"(kMagic));
  return __uint_as_float(d) - kBias;
}

// 16 int4 -> floats (column n = nibble n of the little-endian words),
// without shifting each nibble down: the upper half word is shifted once
__device__ __forceinline__ void decode16_int4(uint2 p, float* w) {
  const uint32_t words[2] = {p.x, p.y};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint32_t u = words[i] ^ 0x88888888u;
    const uint32_t halves[2] = {u, u >> 16};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      w[8 * i + 4 * h] = nibble<0>(halves[h]);
      w[8 * i + 4 * h + 1] = nibble<1>(halves[h]);
      w[8 * i + 4 * h + 2] = nibble<2>(halves[h]);
      w[8 * i + 4 * h + 3] = nibble<3>(halves[h]);
    }
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);   // lo in the low half
  return *reinterpret_cast<const uint32_t*>(&t);
}

// kTileGroup (W4): the group divides the 64-row tile, so a tile lies in
// one group and has one scale row; otherwise each row looks its group up
template <int BITS, int TN, bool kTileGroup>
__global__ void __launch_bounds__(kThreads, (Tile<BITS, TN>::kBlocksPerSM))
wgmma_kernel(const __nv_bfloat16* __restrict__ x,   // [M, K]
             const uint8_t* __restrict__ q,          // [K, row bytes]
             const float* __restrict__ s,            // [N] or [K/g, N]
             __nv_bfloat16* __restrict__ out,        // [M, N] (one split)
             float* __restrict__ ws,                 // [n_split, M, N] (several)
             int M, int K, int N, int group, int k_chunk) {
  launch_dependents();   // the combine may be scheduled; it waits for this grid
  using C = Tile<BITS, TN>;
  constexpr int S = C::kStages, NB = C::kWideBufs;
  constexpr int X_ROUNDS = (TN * 8 + kThreads - 1) / kThreads;   // x chunks per thread per tile
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + (((smem_addr(smem_raw) + 1023u) & ~1023u) - smem_addr(smem_raw));
  uint8_t* wide = base;                          // [NB][kTileK x kTileN] bf16
  uint8_t* ring = base + NB * C::WIDE;           // [S][x | raw | scales]
  const uint32_t wide_a = smem_addr(wide), ring_a = smem_addr(ring);

  const int tid = threadIdx.x, lane = tid & 31, wg = tid >> 7;
  const int n0 = blockIdx.x * kTileN, split = blockIdx.y, m0 = blockIdx.z * TN;
  const int k0 = split * k_chunk;
  const int k_end = min(K, k0 + k_chunk);
  const int T = (k_end - k0 + kTileK - 1) / kTileK;   // tiles of this split
  const size_t rb = BITS == 8 ? static_cast<size_t>(N) : static_cast<size_t>(N) / 2;

  // Everything a thread copies and widens sits at the same place in every
  // tile, so its addresses are computed once here and only advance by a
  // tile per step.
  // The raw weight unit: 16 columns (cc) of rows wr and wr + 32.
  const int cc = tid & 7, wr = tid >> 3;
  const int col0 = n0 + cc * 16;
  const bool col_ok = col0 < N;   // N % 16 == 0: a unit is wholly in or out
  const uint8_t* q_next = q + static_cast<size_t>(k0 + wr) * rb + (BITS == 8 ? col0 : col0 / 2);
  const uint32_t raw_off = wr * C::RAW_ROW + cc * (2 * BITS);   // within the raw tile
  // x: chunk xc (8 values of K) of token rows xr + 32 i
  const int xc = tid & 7, xr = tid >> 3;
  const __nv_bfloat16* x_next = x + static_cast<size_t>(m0 + xr) * K + k0 + xc * 8;
  const size_t x_round = static_cast<size_t>(32) * K;
  const uint32_t x_off = swz128(TN, xr, xc);                     // + 4096 per round
  // W4: a stage holds the scale rows of groups g_issue .. g_last, those of
  // its first and last row (at most kMaxGroups); this thread copies
  // 16-byte chunk j = tid % 32 (4 columns) of row tid / 32, to chunk j
  // with its low two bits rotated by j / 8: a widening thread reads chunks
  // 4 cc .. 4 cc + 3, and rotated, the 8 threads of a load phase hit 8
  // distinct bank groups
  int g_issue = 0, g_issue_end = 0, g_last = 0, g_last_end = 0;
  if constexpr (BITS == 4) {   // (kTileGroup: g_issue alone, the tile's one group)
    g_issue = k0 / group;
    g_issue_end = (g_issue + 1) * group;
    g_last = (min(k0 + kTileK, k_end) - 1) / group;
    g_last_end = (g_last + 1) * group;
  }
  const int sc_j = tid & 31, sc_col = n0 + sc_j * 4;
  const uint32_t sc_off =
      (tid >> 5) * (kTileN * 4) + ((sc_j & ~3) | ((sc_j + (sc_j >> 3)) & 3)) * 16;

  // The widening: each weight to bf16(q * s). W8 keeps its unit's column
  // scales for the whole walk. W4 with kTileGroup reads the tile's one
  // scale row each tile; otherwise it keeps each row slot's group scales
  // and reloads them from the stage only when the slot's row enters the
  // next group (no division on the way).
  float sc[2][16];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int c = 0; c < 16; ++c) sc[h][c] = 0.f;
  if (BITS == 8 && col_ok) load_f16x(s + col0, sc[0]);
  int g_slot[2] = {0, 0}, g_slot_end[2] = {0, 0};   // W4: each slot's group, and where it ends
  int g_tile = 0, g_tile_end = 0;                   // W4: the widened tile's first group
  if constexpr (BITS == 4 && !kTileGroup) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      g_slot[h] = (k0 + wr + 32 * h) / group;
      g_slot_end[h] = (g_slot[h] + 1) * group;
    }
    g_tile = k0 / group;
    g_tile_end = (g_tile + 1) * group;
  }
  // the two swizzled 16-byte chunks (2 cc, 2 cc + 1) of each slot's row
  // in the widened tile; the upper half of the unit stores its odd chunk
  // first, so the 8 threads of a store phase hit 8 distinct bank groups
  const bool odd_first = cc >= 4;
  uint32_t wide_off[2][2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    wide_off[h][0] = swz128(kTileK, wr + 32 * h, 2 * cc + odd_first);
    wide_off[h][1] = swz128(kTileK, wr + 32 * h, 2 * cc + !odd_first);
  }

  // stage tile t (rows kt = k0 + 64 t ...) into ring stage st; zeros past
  // M, k_end and N. Called for t = 0, 1, 2, ... in order.
  auto issue = [&](int t, int st) {
    const int kt = k0 + t * kTileK;
    const uint32_t xs = ring_a + st * C::STAGE;
#pragma unroll
    for (int i = 0; i < X_ROUNDS; ++i) {
      if (TN * 8 >= kThreads || xr < TN) {
        const bool ok = m0 + xr + 32 * i < M && kt + xc * 8 < k_end;   // K % 8 == 0
        cp_async16(xs + x_off + i * 4096, ok ? x_next + i * x_round : x, ok ? 16 : 0);
      }
    }
    x_next += kTileK;
    const uint32_t raw = xs + C::X + raw_off;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bool ok = col_ok && kt + wr + 32 * h < k_end;
      const uint8_t* src = ok ? q_next + 32 * h * rb : q;
      if constexpr (BITS == 8) cp_async16(raw + h * 32 * C::RAW_ROW, src, ok ? 16 : 0);
      else cp_async8(raw + h * 32 * C::RAW_ROW, src, ok ? 8 : 0);
    }
    q_next += kTileK * rb;
    if constexpr (BITS == 4) {
      while (kt >= g_issue_end) {
        ++g_issue;
        g_issue_end += group;
      }
      const int last_row = min(kt + kTileK, k_end) - 1;
      while (!kTileGroup && last_row >= g_last_end) {
        ++g_last;
        g_last_end += group;
      }
      if (tid < (kTileGroup ? 1 : kMaxGroups) * 32) {
        const int g = g_issue + (tid >> 5);
        const bool ok = (kTileGroup || g <= g_last) && sc_col < N;
        cp_async16(xs + C::X + C::RAW + sc_off, ok ? s + static_cast<size_t>(g) * N + sc_col : s,
                   ok ? 16 : 0);
      }
    }
  };

  // widen raw tile t (ring stage st) into widened buffer t % NB
  auto widen = [&](int t, int st) {
    const int kt = k0 + t * kTileK;
    const uint8_t* raw = ring + st * C::STAGE + C::X;
    uint8_t* dst = wide + (t % NB) * C::WIDE;
    if constexpr (BITS == 4 && !kTileGroup) {
      while (kt >= g_tile_end) {
        ++g_tile;
        g_tile_end += group;
      }
    }
    const uint8_t* scales = raw + C::RAW;   // W4: the staged scale rows
    if constexpr (BITS == 4 && kTileGroup) {   // the tile's one row, for both slots
#pragma unroll
      for (int i = 0; i < 4; ++i) {   // chunk 4 cc + i, rotated as staged
        const float4 f =
            *reinterpret_cast<const float4*>(scales + cc * 64 + ((i + (cc >> 1)) & 3) * 16);
        sc[0][4 * i] = f.x;
        sc[0][4 * i + 1] = f.y;
        sc[0][4 * i + 2] = f.z;
        sc[0][4 * i + 3] = f.w;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float w[16];
      if constexpr (BITS == 8) {
        decode16(*reinterpret_cast<const uint4*>(raw + raw_off + h * 32 * C::RAW_ROW), w);
      } else {
        decode16_int4(*reinterpret_cast<const uint2*>(raw + raw_off + h * 32 * C::RAW_ROW), w);
      }
      if constexpr (BITS == 4 && !kTileGroup) {
        const int k = kt + wr + 32 * h;
        bool fresh = t == 0;
        while (k >= g_slot_end[h]) {   // at most a tile's 64 rows / 16 steps
          ++g_slot[h];
          g_slot_end[h] += group;
          fresh = true;
        }
        if (fresh) {   // the slot's group row, staged at g_slot - g_tile (< kMaxGroups)
          const uint8_t* sr = scales + (g_slot[h] - g_tile) * (kTileN * 4) + cc * 64;
#pragma unroll
          for (int i = 0; i < 4; ++i) {   // chunk 4 cc + i, rotated as staged
            const float4 f = *reinterpret_cast<const float4*>(sr + ((i + (cc >> 1)) & 3) * 16);
            sc[h][4 * i] = f.x;
            sc[h][4 * i + 1] = f.y;
            sc[h][4 * i + 2] = f.z;
            sc[h][4 * i + 3] = f.w;
          }
        }
      }
#pragma unroll
      for (int c = 0; c < 16; ++c) w[c] *= sc[BITS == 8 || kTileGroup ? 0 : h][c];
      const uint4 lo = make_uint4(pack_bf16(w[0], w[1]), pack_bf16(w[2], w[3]),
                                  pack_bf16(w[4], w[5]), pack_bf16(w[6], w[7]));
      const uint4 hi = make_uint4(pack_bf16(w[8], w[9]), pack_bf16(w[10], w[11]),
                                  pack_bf16(w[12], w[13]), pack_bf16(w[14], w[15]));
      // selects, not an indexed array: no local memory
      *reinterpret_cast<uint4*>(dst + wide_off[h][0]) = odd_first ? hi : lo;
      *reinterpret_cast<uint4*>(dst + wide_off[h][1]) = odd_first ? lo : hi;
    }
  };

  float acc[TN / 2];
#pragma unroll
  for (int i = 0; i < TN / 2; ++i) acc[i] = 0.f;
  // The ring: tile t + S - NB is staged while tile t is widened, into the
  // stage of tile t - NB, whose product is then done (NB = 2: the product
  // of tile t - 1 still runs while tile t is widened into the other buffer)
#pragma unroll
  for (int t = 0; t < S - NB; ++t) {
    if (t < T) issue(t, t);
    cp_async_commit();
  }
  int st = 0;   // the ring stage of tile t
  for (int t = 0; t < T; ++t) {
    cp_async_wait<S - NB - 1>();   // tile t landed; the tiles after it may still fly
    wgmma_wait<NB - 1>();          // this warpgroup's product of tile t - NB is done
    __syncthreads();               // tile t visible; every warpgroup is done with tile t - NB
    if (t + S - NB < T) issue(t + S - NB, st >= NB ? st - NB : st + S - NB);
    cp_async_commit();
    widen(t, st);
    fence_proxy_async();      // the widened tile and the landed x tile, to wgmma's proxy
    __syncthreads();
    const uint32_t a = wide_a + (t % NB) * C::WIDE + wg * (kTileK * 128);
    const uint32_t b = ring_a + st * C::STAGE;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kTileK / 16; ++ks)   // k16 steps: 16 rows of A, 32 bytes of B
      wgmma_ss_ta<TN>(acc, smem_desc(a + ks * 16 * 128, kTileK * 128, 1024),
                      smem_desc(b + ks * 32, 16, 1024), 1);
    wgmma_commit();
    st = st + 1 == S ? 0 : st + 1;
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // D row = weight column n0 + 64 wg + 16 (warp % 4) + lane / 4 + 8 hr,
  // D column = token m0 + 8 j + 2 (lane % 4) + e: acc[4 j + 2 hr + e]
  const int col = n0 + wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
  const bool single = gridDim.y == 1;
#pragma unroll
  for (int j = 0; j < TN / 8; ++j) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = col + 8 * hr, m = m0 + 8 * j + 2 * (lane & 3) + e;
        if (n < N && m < M) {
          const float v = acc[4 * j + 2 * hr + e];
          if (single) out[static_cast<size_t>(m) * N + n] = __float2bfloat16(v);
          else ws[(static_cast<size_t>(split) * M + m) * N + n] = v;
        }
      }
    }
  }
}

template <int BITS, int TN, bool kTileGroup>
int launch(const void* x, const void* q, const void* s, void* out, void* ws, int M, int K, int N,
           int group, int k_chunk, cudaStream_t st) {
  constexpr size_t bytes = Tile<BITS, TN>::BYTES;
  // the opt-in above 48 KB, once per device (a driver call on the decode
  // path's 225 calls a step otherwise)
  static unsigned set_on = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 32 || !(set_on & (1u << dev))) {
    err = cudaFuncSetAttribute(wgmma_kernel<BITS, TN, kTileGroup>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 32) set_on |= 1u << dev;
  }
  const int n_split = (K + k_chunk - 1) / k_chunk;
  const dim3 grid((N + kTileN - 1) / kTileN, n_split, (M + TN - 1) / TN);
  wgmma_kernel<BITS, TN, kTileGroup><<<grid, kThreads, bytes, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(q),
      static_cast<const float*>(s), static_cast<__nv_bfloat16*>(out), static_cast<float*>(ws), M,
      K, N, group, k_chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return static_cast<int>(err);
  // the combine as a programmatic dependent: its launch overlaps this grid
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((static_cast<size_t>(M) * N / 4 + 255) / 256));
  cfg.blockDim = dim3(256);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, combine_kernel<__nv_bfloat16, false>,
                                             static_cast<const float*>(ws),
                                             static_cast<const float*>(nullptr),
                                             static_cast<__nv_bfloat16*>(out), M, N, n_split));
}

template <int BITS, bool kTileGroup>
int launch_tile(const void* x, const void* q, const void* s, void* out, void* ws, int M, int K,
                int N, int group, int token_tile, int k_chunk, cudaStream_t st) {
  switch (token_tile) {
    case 8: return launch<BITS, 8, kTileGroup>(x, q, s, out, ws, M, K, N, group, k_chunk, st);
    case 16: return launch<BITS, 16, kTileGroup>(x, q, s, out, ws, M, K, N, group, k_chunk, st);
    case 64: return launch<BITS, 64, kTileGroup>(x, q, s, out, ws, M, K, N, group, k_chunk, st);
    case 128: return launch<BITS, 128, kTileGroup>(x, q, s, out, ws, M, K, N, group, k_chunk, st);
    case 256: return launch<BITS, 256, kTileGroup>(x, q, s, out, ws, M, K, N, group, k_chunk, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace tensor_core

bool bad_weight(int K, int N, int group, int bits) {
  if (K <= 0 || N <= 0 || N % kCols) return true;
  if (bits == 8) return false;
  return bits != 4 || group <= 0 || K % group;
}

}  // namespace

// W8 / W4 on bfloat16 x, the tensor-core kernel: y[M, N] = x[M, K] @
// dequant(q, s), any M >= 1, y bfloat16. bits: 8 (s [N]) or 4 (s [K/group,
// N], group >= 16); K a multiple of 8; token_tile: 8, 16, 64, 128 or 256;
// k_chunk: contraction rows per block, a multiple of 64, n_split =
// ceil(K / k_chunk); ws: n_split * M * N floats when n_split > 1
// (ops/quant.py::tc_plan picks all three). Returns cudaGetLastError()
// after the launches (0 = success); arguments the kernel does not take
// return cudaErrorInvalidValue without launching.
extern "C" int quant_matmul_tc_launch(const void* x, const void* q, const void* s, void* out,
                                      void* ws, int M, int K, int N, int group, int bits,
                                      int token_tile, int k_chunk, void* stream) {
  if (M < 1 || bad_weight(K, N, group, bits) || K % 8 || k_chunk <= 0 ||
      k_chunk % tensor_core::kTileK || (bits == 4 && group < tensor_core::kMinGroup))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (bits == 8)
    return tensor_core::launch_tile<8, false>(x, q, s, out, ws, M, K, N, group, token_tile, k_chunk,
                                              st);
  if (group % tensor_core::kTileK == 0)
    return tensor_core::launch_tile<4, true>(x, q, s, out, ws, M, K, N, group, token_tile, k_chunk,
                                             st);
  return tensor_core::launch_tile<4, false>(x, q, s, out, ws, M, K, N, group, token_tile, k_chunk,
                                            st);
}

// Skinny W8 / W4 on float32 x (the CUDA-core kernel): y[M, N] = x[M, K] @
// dequant(q, s), 1 <= M <= 16. bits: 8 (s [N]) or 4 (s [K/group, N]);
// dtype: 0 = float32 (the only one it takes: bfloat16 x goes to the
// tensor-core kernel); k_chunk: contraction rows per block (a multiple of
// 16, at most 1024), n_split = ceil(K / k_chunk); ws: n_split * M * N
// floats when n_split > 1. Same return convention.
extern "C" int quant_matmul_skinny_launch(const void* x, const void* q, const void* s, void* out,
                                          void* ws, int M, int K, int N, int group, int bits,
                                          int k_chunk, int dtype, void* stream) {
  if (M < 1 || M > kMaxM || bad_weight(K, N, group, bits) || k_chunk <= 0 ||
      k_chunk > kMaxChunk || k_chunk % 16 || dtype != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (bits == 8) return skinny_rows<float, 8>(x, q, s, out, ws, M, K, N, group, k_chunk, st);
  return skinny_rows<float, 4>(x, q, s, out, ws, M, K, N, group, k_chunk, st);
}

// Dequantize q [K, N] (int8, or int4 packed [K, N/2]) with its scales into
// w [K, N] in dtype (0 = float32, 1 = bfloat16). Same return convention.
extern "C" int quant_dequant_launch(const void* q, const void* s, void* w, int K, int N,
                                    int group, int bits, int dtype, void* stream) {
  if (bad_weight(K, N, group, bits)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return bits == 8 ? launch_dequant<float, 8>(q, s, w, K, N, group, st)
                     : launch_dequant<float, 4>(q, s, w, K, N, group, st);
  if (dtype == 1)
    return bits == 8 ? launch_dequant<__nv_bfloat16, 8>(q, s, w, K, N, group, st)
                     : launch_dequant<__nv_bfloat16, 4>(q, s, w, K, N, group, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
