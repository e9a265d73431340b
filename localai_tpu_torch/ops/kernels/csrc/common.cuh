// Shared helpers for the port's hand-written Hopper kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace localai_kernels {

constexpr float kNegInf = -1e30f;  // the JAX package's finite mask value

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }

__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Elements of T in one 16-byte vector load
template <typename T>
__host__ __device__ constexpr int vec_elems() { return 16 / static_cast<int>(sizeof(T)); }

// 16 bytes of T (4 floats, 8 bf16 or 16 int8) as floats
__device__ __forceinline__ void unpack16(const float* p, float* f) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}
__device__ __forceinline__ void unpack16(const __nv_bfloat16* p, float* f) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}
__device__ __forceinline__ void unpack16(const int8_t* p, float* f) {
  const int4 v = *reinterpret_cast<const int4*>(p);
  const int8_t* b = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
  for (int i = 0; i < 16; ++i) f[i] = static_cast<float>(b[i]);
}

// 8 elements as floats (two 16-byte loads of float, one 8-byte load of
// int8): the common unit when float and int8 rows share a tile
__device__ __forceinline__ void load8(const float* p, float* f) {
  unpack16(p, f);
  unpack16(p + 4, f + 4);
}
__device__ __forceinline__ void load8(const int8_t* p, float* f) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const int8_t* b = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
  for (int i = 0; i < 8; ++i) f[i] = static_cast<float>(b[i]);
}

// Physical row (page * pg + in-page row) of logical row `c` of a slot's
// page-table row `tab`, or -1 when the entry is unallocated (sentinel >=
// n_pages): the plain versions gather such rows as zeros (and their int8
// scales as zeros), and callers treat -1 the same.
__device__ __forceinline__ long long page_row_index(const int* tab, int c, int pg, int n_pages) {
  const int page = tab[c / pg];
  if (page < 0 || page >= n_pages) return -1;
  return static_cast<long long>(page) * pg + (c % pg);
}

// Address of physical row `row` of kv head h in a [rows, KV, hd] store
// (nullptr for row -1)
template <typename T>
__device__ __forceinline__ const T* row_ptr(const T* base, long long row, int kv, int h, int hd) {
  if (row < 0) return nullptr;
  return base + (static_cast<size_t>(row) * kv + h) * hd;
}

// Physical row of logical row `c`, or nullptr when unallocated
template <typename T>
__device__ __forceinline__ const T* page_row(const T* pages, const int* tab, int c, int pg,
                                             int n_pages, int kv, int h, int hd) {
  return row_ptr(pages, page_row_index(tab, c, pg, n_pages), kv, h, hd);
}

}  // namespace localai_kernels
