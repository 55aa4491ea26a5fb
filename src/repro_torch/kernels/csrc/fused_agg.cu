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
// GPU run in no order, so here one block owns a 2048-element slab of N
// (256 threads x 8 elements) and loops over all K itself, keeping the fp32
// sums in registers: the output is written exactly once, no atomics, and the
// sum is taken in the same order (k = 0, 1, ...) on every run, so the result
// is the same bit for bit from run to run. Loads are 16-byte vectors; the
// ragged tail of N is handled in place, with no padded copy of K or N.
#include "common.cuh"

namespace {

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
fused_agg_kernel(const T* __restrict__ u, const float* __restrict__ w,
                 T* __restrict__ out, int k, long long n) {
  const long long i0 =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * kVec;
  if (i0 >= n) return;
  float acc[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) acc[j] = 0.0f;
  if (VEC && i0 + kVec <= n) {
    for (int r = 0; r < k; ++r) {
      float v[kVec];
      load8(u + static_cast<long long>(r) * n + i0, v);
      const float wr = __ldg(w + r);
#pragma unroll
      for (int j = 0; j < kVec; ++j) acc[j] = fmaf(wr, v[j], acc[j]);
    }
    store8(out + i0, acc);
  } else {
    const int m = static_cast<int>(i0 + kVec < n ? kVec : n - i0);
    for (int r = 0; r < k; ++r) {
      const float wr = __ldg(w + r);
      const T* row = u + static_cast<long long>(r) * n + i0;
      for (int j = 0; j < m; ++j) acc[j] = fmaf(wr, to_f32(row[j]), acc[j]);
    }
    for (int j = 0; j < m; ++j) out[i0 + j] = from_f32<T>(acc[j]);
  }
}

template <typename T>
void launch(const void* u, const float* w, void* out, int k, long long n,
            cudaStream_t stream) {
  // vector loads need every row start 16-byte aligned, not only the first
  const bool vec = aligned16(u) && aligned16(out) &&
                   (n * static_cast<long long>(sizeof(T))) % 16 == 0;
  const T* pu = static_cast<const T*>(u);
  T* po = static_cast<T*>(out);
  if (vec) {
    fused_agg_kernel<T, true><<<blocks_for(n), kThreads, 0, stream>>>(pu, w, po, k, n);
  } else {
    fused_agg_kernel<T, false><<<blocks_for(n), kThreads, 0, stream>>>(pu, w, po, k, n);
  }
}

}  // namespace

extern "C" int fused_agg_launch(const void* updates, const void* weights,
                                void* out, int k, long long n, int dtype,
                                void* stream) {
  if (k <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* w = static_cast<const float*>(weights);
  if (dtype == DT_F32) launch<float>(updates, w, out, k, n, s);
  else if (dtype == DT_BF16) launch<__nv_bfloat16>(updates, w, out, k, n, s);
  else return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
