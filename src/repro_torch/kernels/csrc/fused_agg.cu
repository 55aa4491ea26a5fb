// fused_agg: N-way weighted fusion of K flattened model updates
//
//   out[n] = sum_k w[k] * u[k, n],  accumulated in fp32, out in u's dtype.
//
// Replaces the Pallas TPU kernel src/repro/kernels/fused_agg.py:42
// (pallas_call at :57, body _kernel at :29).
//
// Bound: bytes. Each update element is read once and each output element
// written once, for 2 flops per update element, so the least time is
// (K * N * |u| + N * |out|) bytes over the card's memory rate. The TPU kernel
// walks a (K/kb, N/bn) grid and revisits its fp32 output tile once per K
// slab, which is safe there because a TPU grid runs in order. Blocks on a
// GPU run in no order, so here one block owns a slab of V x T elements of
// N (T threads of V elements: the launch shape, one of common.cuh's fixed
// set, default 8 x 256 = 2048, which the launch-shape search of
// kernels/autotune.py chooses from) and loops over all K itself, keeping the
// fp32 sums in registers: the output is written exactly once, no atomics,
// and each element's sum is taken in the same order (k = 0, 1, ...) at every
// shape and on every run, so the result is the same bit for bit. Loads are
// vectors of up to 16 bytes; the ragged tail of N is handled in place, with
// no padded copy of K or N.
#include "common.cuh"

namespace {

// vec: every row takes vector moves (vec_ok); else all moves are scalar
template <typename E, int V, int T>
__global__ void __launch_bounds__(T)
fused_agg_kernel(const E* __restrict__ u, const float* __restrict__ w,
                 E* __restrict__ out, int k, long long n, bool vec) {
  const long long i0 =
      (static_cast<long long>(blockIdx.x) * T + threadIdx.x) * V;
  if (i0 >= n) return;
  float acc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = 0.0f;
  if (vec && i0 + V <= n) {
    for (int r = 0; r < k; ++r) {
      float v[V];
      load_vec<E, V>(u + static_cast<long long>(r) * n + i0, v);
      const float wr = __ldg(w + r);
#pragma unroll
      for (int j = 0; j < V; ++j) acc[j] = fmaf(wr, v[j], acc[j]);
    }
    store_vec<E, V>(out + i0, acc);
  } else {
    const int m = static_cast<int>(i0 + V < n ? V : n - i0);
    for (int r = 0; r < k; ++r) {
      const float wr = __ldg(w + r);
      const E* row = u + static_cast<long long>(r) * n + i0;
      for (int j = 0; j < m; ++j) acc[j] = fmaf(wr, to_f32(row[j]), acc[j]);
    }
    for (int j = 0; j < m; ++j) out[i0 + j] = from_f32<E>(acc[j]);
  }
}

template <typename E, int V, int T>
void launch(const void* u, const float* w, void* out, int k, long long n,
            cudaStream_t stream) {
  // vector moves need every row start aligned, not only the first
  const bool vec = vec_ok<E, V>(u, n) && vec_ok<E, V>(out, n);
  fused_agg_kernel<E, V, T><<<blocks_for(n, V * T), T, 0, stream>>>(
      static_cast<const E*>(u), w, static_cast<E*>(out), k, n, vec);
}

template <int V, int T>
int dispatch_dtype(const void* u, const float* w, void* out, int k,
                   long long n, int dtype, cudaStream_t s) {
  if (dtype == DT_F32) launch<float, V, T>(u, w, out, k, n, s);
  else if (dtype == DT_BF16) launch<__nv_bfloat16, V, T>(u, w, out, k, n, s);
  else return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fused_agg_launch(const void* updates, const void* weights,
                                void* out, int k, long long n, int dtype,
                                int vec, int threads, void* stream) {
  if (k <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* w = static_cast<const float*>(weights);
#define FUSED_AGG_SHAPE(V, T) \
  if (vec == V && threads == T) return dispatch_dtype<V, T>(updates, w, out, k, n, dtype, s);
  FOR_EACH_SHAPE(FUSED_AGG_SHAPE)
#undef FUSED_AGG_SHAPE
  return static_cast<int>(cudaErrorInvalidValue);  // not an exported shape
}
