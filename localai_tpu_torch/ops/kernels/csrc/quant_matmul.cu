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
// lm_head (1.27 ms), against 15.0 GB (4.48 ms) in bf16.
//
// Design, two regimes chosen by M on the host:
//  * skinny (M <= 16): decode and a pack's unembed. One fused kernel reads
//    each weight byte once. A block of 4 warps owns 512 output columns
//    (a tile) and a chunk of K (split-K across blocks: wk / wv have only
//    1024 columns, two tiles, which alone could not fill 132 SMs). Each
//    thread owns 16 adjacent columns: one 16-byte load per int8 row, one
//    8-byte load per int4 row (8 bytes keep 16 columns, so the 8 rows x 16
//    columns of f32 accumulators fit in registers), 4 rows in flight; a
//    warp covers one row's 512 columns, 512 (int8) or 256 (int4)
//    contiguous bytes. Each warp walks a contiguous quarter of the chunk,
//    so an int4 group's scales are loaded when the group changes, not per
//    row. The chunk's rows of x sit in shared memory, transposed, so a
//    row's 8 values are two 16-byte loads. Bytes become floats without
//    the int-to-float unit: a byte (or nibble) with its sign bit flipped is
//    the low bits of 2^23 + v + 128 (+ 8), one byte-permute and one add.
//    W8 applies its column scale once at the end; W4 multiplies each
//    decoded weight by its group's scale (one more multiply per weight,
//    instead of a second set of accumulators per group that the registers
//    could not hold). The 4 warps' partials are summed in shared memory in
//    a fixed order; with one split the block writes y, otherwise an f32
//    workspace [n_split, M, N], which a second kernel sums in split order.
//    No atomics: the same inputs give the same bits on the same card.
//  * wide (M > 16): prefill packs. A dequantize kernel writes the dense
//    weight in x's dtype (16 weights per thread, 16-byte loads and stores)
//    into the caller's scratch, and torch.matmul multiplies it: the large
//    product is a plain GEMM, as the JAX package left it to XLA. The same
//    kernel serves a tied embedding's unembed (x @ dequant(embed)^T).

#include <stdint.h>

#include "common.cuh"

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

// y = (sum over splits, in split order) [* s for W8]; 4 outputs per thread
template <typename T, int BITS>
__global__ void __launch_bounds__(256)
combine_kernel(const float* __restrict__ ws, const float* __restrict__ s, T* __restrict__ out,
               int M, int N, int n_split) {
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
  for (int e = 0; e < 4; ++e) store_f(out + i + e, BITS == 8 ? v[e] * s[col + e] : v[e]);
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
  combine_kernel<T, BITS><<<static_cast<unsigned>((quads + 255) / 256), 256, 0, st>>>(
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

template <typename T>
int skinny_bits(const void* x, const void* q, const void* s, void* out, void* ws, int M, int K,
                int N, int group, int bits, int k_chunk, cudaStream_t st) {
  if (bits == 8) return skinny_rows<T, 8>(x, q, s, out, ws, M, K, N, group, k_chunk, st);
  return skinny_rows<T, 4>(x, q, s, out, ws, M, K, N, group, k_chunk, st);
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

bool bad_weight(int K, int N, int group, int bits) {
  if (K <= 0 || N <= 0 || N % kCols) return true;
  if (bits == 8) return false;
  return bits != 4 || group <= 0 || K % group;
}

}  // namespace

// Skinny W8 / W4: y[M, N] = x[M, K] @ dequant(q, s), 1 <= M <= 16. bits: 8
// (s [N]) or 4 (s [K/group, N]); dtype: 0 = float32, 1 = bfloat16 (x and
// y); k_chunk: contraction rows per block (a multiple of 16, at most 1024),
// n_split = ceil(K / k_chunk); ws: n_split * M * N floats when n_split > 1.
// Returns cudaGetLastError() after the launches (0 = success); arguments
// the kernels do not take return cudaErrorInvalidValue without launching.
extern "C" int quant_matmul_skinny_launch(const void* x, const void* q, const void* s, void* out,
                                          void* ws, int M, int K, int N, int group, int bits,
                                          int k_chunk, int dtype, void* stream) {
  if (M < 1 || M > kMaxM || bad_weight(K, N, group, bits) || k_chunk <= 0 ||
      k_chunk > kMaxChunk || k_chunk % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0) return skinny_bits<float>(x, q, s, out, ws, M, K, N, group, bits, k_chunk, st);
  if (dtype == 1)
    return skinny_bits<__nv_bfloat16>(x, q, s, out, ws, M, K, N, group, bits, k_chunk, st);
  return static_cast<int>(cudaErrorInvalidValue);
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
