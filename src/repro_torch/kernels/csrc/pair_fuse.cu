// pair_fuse: the paper's coordinate-wise pairwise fusion
//
//   out[i] = f(a[i], b[i]),  f in {mean, wsum, max, min},  math in fp32,
//   out has a's dtype.
//
// Replaces the Pallas TPU kernel src/repro/kernels/pair_fuse.py:46
// (pallas_call at :63, body _make_kernel at :26).
//
// Bound: bytes. Each element is read once from a and b and written once, with
// at most 3 flops, so the kernel can only approach the card's memory rate
// (N * (|a| + |b| + |out|) bytes over 3.35 TB/s on an H100 SXM). The design
// does what that asks: one pass, vector loads and stores of up to 16 bytes
// (V elements a thread, neighbouring threads on neighbouring addresses), op,
// dtypes and the launch shape (V elements a thread, T threads a block: the
// fixed set of common.cuh, default 4 x 256, which the launch-shape search of
// kernels/autotune.py chooses from) as template parameters so the loop
// carries no branches, and the ragged tail handled in place by the last
// thread instead of a padded copy (the TPU kernel pads N up to its block).
// Each element's arithmetic is the same at every shape, so every shape gives
// the same bits. The fp32 accumulator can be read beside a
// bf16 update directly, so the streaming fold reads 2 bytes of update per
// element instead of the 4 of an fp32 copy. wsum and mean round each product
// and sum separately (no FMA contraction), so they agree bit for bit with
// the plain PyTorch version.
#include "common.cuh"

namespace {

enum Op { OP_MEAN = 0, OP_WSUM = 1, OP_MAX = 2, OP_MIN = 3 };

template <int OP>
__device__ __forceinline__ float fuse(float a, float b, float wa, float wb) {
  if (OP == OP_MEAN) return __fmul_rn(0.5f, __fadd_rn(a, b));
  if (OP == OP_WSUM) return __fadd_rn(__fmul_rn(wa, a), __fmul_rn(wb, b));
  // NaN propagates, as jnp.maximum / torch.maximum do
  if (OP == OP_MAX) return (a > b || a != a) ? a : b;
  return (a < b || a != a) ? a : b;
}

// vec: every operand takes vector moves (vec_ok); else all moves are scalar
template <int OP, typename TA, typename TB, int V, int T>
__global__ void __launch_bounds__(T)
pair_fuse_kernel(const TA* __restrict__ a, const TB* __restrict__ b,
                 TA* __restrict__ out, long long n, float wa, float wb,
                 bool vec) {
  const long long i0 =
      (static_cast<long long>(blockIdx.x) * T + threadIdx.x) * V;
  if (i0 >= n) return;
  if (vec && i0 + V <= n) {
    float va[V], vb[V], vo[V];
    load_vec<TA, V>(a + i0, va);
    load_vec<TB, V>(b + i0, vb);
#pragma unroll
    for (int j = 0; j < V; ++j) vo[j] = fuse<OP>(va[j], vb[j], wa, wb);
    store_vec<TA, V>(out + i0, vo);
  } else {
    const long long end = i0 + V < n ? i0 + V : n;
    for (long long i = i0; i < end; ++i) {
      out[i] = from_f32<TA>(fuse<OP>(to_f32(a[i]), to_f32(b[i]), wa, wb));
    }
  }
}

template <int OP, typename TA, typename TB, int V, int T>
void launch(const void* a, const void* b, void* out, long long n, float wa,
            float wb, cudaStream_t stream) {
  // a thread's V elements start V apart, so aligned bases keep every
  // thread's vectors aligned; the ragged tail is scalar in the kernel
  const bool vec = aligned(a, chunk_bytes<TA, V>()) &&
                   aligned(b, chunk_bytes<TB, V>()) &&
                   aligned(out, chunk_bytes<TA, V>());
  const TA* pa = static_cast<const TA*>(a);
  const TB* pb = static_cast<const TB*>(b);
  TA* po = static_cast<TA*>(out);
  pair_fuse_kernel<OP, TA, TB, V, T>
      <<<blocks_for(n, V * T), T, 0, stream>>>(pa, pb, po, n, wa, wb, vec);
}

template <int OP, int V, int T>
int dispatch_dtypes(const void* a, const void* b, void* out, long long n,
                    int a_dtype, int b_dtype, float wa, float wb,
                    cudaStream_t s) {
  using bf16 = __nv_bfloat16;
  if (a_dtype == DT_F32 && b_dtype == DT_F32) launch<OP, float, float, V, T>(a, b, out, n, wa, wb, s);
  else if (a_dtype == DT_F32 && b_dtype == DT_BF16) launch<OP, float, bf16, V, T>(a, b, out, n, wa, wb, s);
  else if (a_dtype == DT_BF16 && b_dtype == DT_F32) launch<OP, bf16, float, V, T>(a, b, out, n, wa, wb, s);
  else if (a_dtype == DT_BF16 && b_dtype == DT_BF16) launch<OP, bf16, bf16, V, T>(a, b, out, n, wa, wb, s);
  else return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

template <int V, int T>
int dispatch_op(const void* a, const void* b, void* out, long long n, int op,
                int a_dtype, int b_dtype, float wa, float wb, cudaStream_t s) {
  switch (op) {
    case OP_MEAN: return dispatch_dtypes<OP_MEAN, V, T>(a, b, out, n, a_dtype, b_dtype, wa, wb, s);
    case OP_WSUM: return dispatch_dtypes<OP_WSUM, V, T>(a, b, out, n, a_dtype, b_dtype, wa, wb, s);
    case OP_MAX: return dispatch_dtypes<OP_MAX, V, T>(a, b, out, n, a_dtype, b_dtype, wa, wb, s);
    case OP_MIN: return dispatch_dtypes<OP_MIN, V, T>(a, b, out, n, a_dtype, b_dtype, wa, wb, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int pair_fuse_launch(const void* a, const void* b, void* out,
                                long long n, int op, int a_dtype, int b_dtype,
                                float wa, float wb, int vec, int threads,
                                void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PAIR_FUSE_SHAPE(V, T) \
  if (vec == V && threads == T) return dispatch_op<V, T>(a, b, out, n, op, a_dtype, b_dtype, wa, wb, s);
  FOR_EACH_SHAPE(PAIR_FUSE_SHAPE)
#undef PAIR_FUSE_SHAPE
  return static_cast<int>(cudaErrorInvalidValue);  // not an exported shape
}
