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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy global -> shared; `bytes` 0 writes zeros
// without reading `src`
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}
// 4-byte asynchronous copy (a scale); `bytes` 0 writes zeros
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}
// 8-byte asynchronous copy; `bytes` 0 writes zeros
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }
// all but this thread's newest committed group have landed
__device__ __forceinline__ void cp_async_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }
// all but this thread's newest N committed groups have landed
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

// Programmatic dependent launch (sm_90): a primary grid lets its dependent
// grid be scheduled early; the dependent waits for the primary's completion
// and memory before reading what it wrote. Both are no-ops when the grid
// was not launched as a programmatic dependent.
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
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

// 2 consecutive elements as floats (one 8-, 4- or 2-byte load)
__device__ __forceinline__ void load2(const float* p, float& a, float& b) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  a = v.x;
  b = v.y;
}
__device__ __forceinline__ void load2(const __nv_bfloat16* p, float& a, float& b) {
  const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  a = v.x;
  b = v.y;
}
__device__ __forceinline__ void load2(const int8_t* p, float& a, float& b) {
  const char2 v = *reinterpret_cast<const char2*>(p);
  a = static_cast<float>(v.x);
  b = static_cast<float>(v.y);
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

}  // namespace localai_kernels
