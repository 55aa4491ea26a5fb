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
// in no order, so here one block owns a 2048-element slab of N (256 threads
// x 8 int8, one 8-byte load per row) and loops over all K itself, keeping
// the fp32 sums in registers: the dequantised updates never reach device
// memory, each output is written once (two float4 stores a thread), there
// are no atomics and no padded copy, and the sum is taken in the order
// k = 0, 1, ... on every run, so runs agree bit for bit. int8 -> fp32 is
// exact. 8 elements a thread, not 16: with 16 (one 16-byte load, four
// float4 stores a thread) the warp's stores spread over twice the span, and
// at K = 3, N = 155,582,464 the kernel took 0.436 ms against 0.366 ms with
// 8, in chip_smoke.py on an H100 SXM at 700 W (bound 0.325 ms). A base that
// is not 8-byte aligned, or a row length that breaks the alignment of later
// rows, takes a scalar instance of the kernel.
#include "common.cuh"

namespace {

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
quant_agg_kernel(const int8_t* __restrict__ q, const float* __restrict__ s,
                 float* __restrict__ out, int k, long long n) {
  const long long i0 =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * kVec;
  if (i0 >= n) return;
  float acc[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) acc[j] = 0.0f;
  if (VEC) {  // n % 8 == 0, so every thread owns 8 whole elements
#pragma unroll 4
    for (int r = 0; r < k; ++r) {
      const int2 x = __ldg(reinterpret_cast<const int2*>(
          q + static_cast<long long>(r) * n + i0));
      const int w[2] = {x.x, x.y};
      const float sr = __ldg(s + r);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float v = static_cast<float>(static_cast<int8_t>(w[j / 4] >> (8 * (j % 4))));
        acc[j] = fmaf(sr, v, acc[j]);
      }
    }
    store8(out + i0, acc);
  } else {
    const int m = static_cast<int>(i0 + kVec < n ? kVec : n - i0);
    for (int r = 0; r < k; ++r) {
      const float sr = __ldg(s + r);
      const int8_t* row = q + static_cast<long long>(r) * n + i0;
      for (int j = 0; j < m; ++j) acc[j] = fmaf(sr, static_cast<float>(row[j]), acc[j]);
    }
    for (int j = 0; j < m; ++j) out[i0 + j] = acc[j];
  }
}

}  // namespace

extern "C" int quant_agg_launch(const void* q, const void* scales, void* out,
                                int k, long long n, void* stream) {
  if (k <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* pq = static_cast<const int8_t*>(q);
  const float* ps = static_cast<const float*>(scales);
  float* po = static_cast<float*>(out);
  // vector loads need every row start 8-byte aligned, not only the first
  const bool vec = (reinterpret_cast<uintptr_t>(q) & 7u) == 0 &&
                   aligned16(out) && n % kVec == 0;
  if (vec) {
    quant_agg_kernel<true><<<blocks_for(n), kThreads, 0, st>>>(pq, ps, po, k, n);
  } else {
    quant_agg_kernel<false><<<blocks_for(n), kThreads, 0, st>>>(pq, ps, po, k, n);
  }
  return static_cast<int>(cudaGetLastError());
}
