// quant_agg: fusion of K int8-quantised model updates with per-row scales
//
//   out[n] = sum_k s[k] * float(q[k, n]),  accumulated in fp32, out fp32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/quant_agg.py:37
// (pallas_call at :51, body _kernel at :24).
//
// Bound: bytes. Each int8 element is read once, each scale once and each
// fp32 output written once, for 2 flops per int8 element, so the least time
// is (K * N * 1 + N * 4 + K * 4) bytes over the card's memory rate; the
// fp32 output is most of it for small K. The TPU kernel pads K to 32 rows
// and N to 4096 and revisits its fp32 output tile once per 32-row slab,
// which is safe there because a TPU grid runs in order. Blocks on a GPU run
// in no order, so here one block owns a slab of V x T elements of N (T
// threads of V int8: the launch shape, one of common.cuh's fixed set,
// default 8 x 256, one 8-byte load per row, which the launch-shape search of
// kernels/autotune.py chooses from) and loops over all K itself, keeping the
// fp32 sums in registers: the dequantised updates never reach device memory,
// each output is written once (V / 4 float4 stores a thread), there are no
// atomics and no padded copy, and each element's sum is taken in the order
// k = 0, 1, ... at every shape and on every run, so they agree bit for bit.
// int8 -> fp32 is exact. With 16 elements a thread (one 16-byte load, four
// float4 stores a thread) the warp's stores spread over twice the span: at
// K = 3, N = 155,582,464 the kernel took 0.436 ms against 0.366 ms with 8,
// in chip_smoke.py on an H100 SXM at 700 W (bound 0.325 ms). A base that is
// not aligned to a thread's vector, or a row length that breaks the
// alignment of later rows, takes the kernel's scalar path.
#include "common.cuh"

namespace {

// vec: every row takes vector moves (vec_ok); else all moves are scalar
template <int V, int T>
__global__ void __launch_bounds__(T)
quant_agg_kernel(const int8_t* __restrict__ q, const float* __restrict__ s,
                 float* __restrict__ out, int k, long long n, bool vec) {
  const long long i0 =
      (static_cast<long long>(blockIdx.x) * T + threadIdx.x) * V;
  if (i0 >= n) return;
  float acc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = 0.0f;
  if (vec && i0 + V <= n) {
#pragma unroll 4
    for (int r = 0; r < k; ++r) {
      float v[V];
      load_vec<int8_t, V>(q + static_cast<long long>(r) * n + i0, v);
      const float sr = __ldg(s + r);
#pragma unroll
      for (int j = 0; j < V; ++j) acc[j] = fmaf(sr, v[j], acc[j]);
    }
    store_vec<float, V>(out + i0, acc);
  } else {
    const int m = static_cast<int>(i0 + V < n ? V : n - i0);
    for (int r = 0; r < k; ++r) {
      const float sr = __ldg(s + r);
      const int8_t* row = q + static_cast<long long>(r) * n + i0;
      for (int j = 0; j < m; ++j) acc[j] = fmaf(sr, static_cast<float>(row[j]), acc[j]);
    }
    for (int j = 0; j < m; ++j) out[i0 + j] = acc[j];
  }
}

template <int V, int T>
int launch(const int8_t* q, const float* s, float* out, int k, long long n,
           cudaStream_t stream) {
  // vector moves need every row start aligned, not only the first
  const bool vec = vec_ok<int8_t, V>(q, n) && vec_ok<float, V>(out, n);
  quant_agg_kernel<V, T><<<blocks_for(n, V * T), T, 0, stream>>>(
      q, s, out, k, n, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int quant_agg_launch(const void* q, const void* scales, void* out,
                                int k, long long n, int vec, int threads,
                                void* stream) {
  if (k <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* pq = static_cast<const int8_t*>(q);
  const float* ps = static_cast<const float*>(scales);
  float* po = static_cast<float*>(out);
#define QUANT_AGG_SHAPE(V, T) \
  if (vec == V && threads == T) return launch<V, T>(pq, ps, po, k, n, st);
  FOR_EACH_SHAPE(QUANT_AGG_SHAPE)
#undef QUANT_AGG_SHAPE
  return static_cast<int>(cudaErrorInvalidValue);  // not an exported shape
}
