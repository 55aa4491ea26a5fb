// Shared helpers of the fusion kernels: each thread owns V consecutive
// elements, moved as vectors of up to 16 bytes, with all arithmetic in fp32;
// a block has T threads. (V, T) is the launch shape, a template parameter
// of every kernel, and each library instantiates the fixed set below.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// dtype codes shared with the Python wrappers
enum DType { DT_F32 = 0, DT_BF16 = 1 };

// The fixed set of launch shapes (elements a thread, threads a block) every
// library exports; kernels/build.py SHAPES lists the same pairs, and
// DEFAULT_SHAPES each kernel's default.
#define FOR_EACH_SHAPE(X)                                      \
  X(4, 128) X(4, 256) X(4, 512) X(4, 1024)                      \
  X(8, 128) X(8, 256) X(8, 512) X(8, 1024)                      \
  X(16, 128) X(16, 256) X(16, 512) X(16, 1024)

// The raw register type of one vector of B bytes.
template <int B> struct Raw;
template <> struct Raw<4> { using T = unsigned int; };
template <> struct Raw<8> { using T = uint2; };
template <> struct Raw<16> { using T = uint4; };

// Bytes of the widest vector a thread moves for V elements of type E: the
// whole span up to 16 bytes, else 16-byte pieces.
template <typename E, int V>
__host__ __device__ constexpr int chunk_bytes() {
  return V * static_cast<int>(sizeof(E)) < 16 ? V * static_cast<int>(sizeof(E)) : 16;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);  // round to nearest even
}

// V elements from p (aligned to chunk_bytes<E, V>()) into fp32 registers.
template <typename E, int V>
__device__ __forceinline__ void load_vec(const E* p, float v[V]) {
  constexpr int B = chunk_bytes<E, V>();
  constexpr int PER = B / static_cast<int>(sizeof(E));
  using R = typename Raw<B>::T;
#pragma unroll
  for (int c = 0; c < V / PER; ++c) {
    const R r = __ldg(reinterpret_cast<const R*>(p) + c);
    const E* e = reinterpret_cast<const E*>(&r);
#pragma unroll
    for (int j = 0; j < PER; ++j) v[c * PER + j] = to_f32(e[j]);
  }
}

// V fp32 registers to p (aligned to chunk_bytes<E, V>()), rounded to E.
template <typename E, int V>
__device__ __forceinline__ void store_vec(E* p, const float v[V]) {
  constexpr int B = chunk_bytes<E, V>();
  constexpr int PER = B / static_cast<int>(sizeof(E));
  using R = typename Raw<B>::T;
#pragma unroll
  for (int c = 0; c < V / PER; ++c) {
    R r;
    E* e = reinterpret_cast<E*>(&r);
#pragma unroll
    for (int j = 0; j < PER; ++j) e[j] = from_f32<E>(v[c * PER + j]);
    reinterpret_cast<R*>(p)[c] = r;
  }
}

inline bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) & static_cast<uintptr_t>(bytes - 1)) == 0;
}

// A row of n elements of E, starting at p, takes vector moves at shape V
// when its start is aligned to the vector and (for the rows after the first)
// the row length keeps that alignment.
template <typename E, int V>
inline bool vec_ok(const void* p, long long n) {
  constexpr int B = chunk_bytes<E, V>();
  return aligned(p, B) && (n * static_cast<long long>(sizeof(E))) % B == 0;
}

inline unsigned int blocks_for(long long n, int per_block) {
  return static_cast<unsigned int>((n + per_block - 1) / per_block);
}
