// pair_fuse: the paper's coordinate-wise pairwise fusion, over a table of
// pairs in one launch
//
//   out[i] = f(a[i], b[i]),  f in {mean, wsum, max, min},  math in fp32,
//   out has a's dtype; for every pair (a, b, out) of the table.
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
//
// One grid a table. The fold fuses an update into the accumulator leaf by
// leaf: a model of 17 leaves, four of them under 1,000 elements, made 17
// back-to-back launches, and each paid a gap of about 1.4 us between kernels
// and a ramp-up and drain of its own, 8 % of a small model's fold. So one
// launch takes a table of up to TABLE_MAX pairs of one dtype pair, passed by
// value as a __grid_constant__ parameter (it travels with the launch: no
// device allocation, no copy of its own, and no per-thread copy in the
// kernel): the grid spans the pairs' blocks end to end, each block finds
// its pair by a binary search over the entries' first blocks (uniform across
// the block, so the reads of the table are broadcasts) and then runs the
// body above on its V x T elements of that pair. The wrapper orders a table
// largest pair first, so the grid's tail is the small pairs, and decides
// per pair whether all three operands take vector moves. A single pair is a
// table of one.
#include <limits.h>

#include "common.cuh"

namespace {

enum Op { OP_MEAN = 0, OP_WSUM = 1, OP_MAX = 2, OP_MIN = 3 };

// The most pairs one launch takes; kernels/pair_fuse.py TABLE_MAX.
constexpr int TABLE_MAX = 64;
// int64 fields of a row of the wrapper's table: a, b, out, n, first block,
// vector flag
constexpr int ROW = 6;

struct Pair {
  const void* a;
  const void* b;
  void* out;
  long long n;         // elements, > 0
  unsigned int first;  // the pair's first block in the grid
  int vector;          // a, b and out all aligned to their vector moves
};

struct Table {  // 64 x 40 + 8 bytes, under the 4 KB of kernel parameters
  Pair pair[TABLE_MAX];
  int count;
};

template <int OP>
__device__ __forceinline__ float fuse(float a, float b, float wa, float wb) {
  if (OP == OP_MEAN) return __fmul_rn(0.5f, __fadd_rn(a, b));
  if (OP == OP_WSUM) return __fadd_rn(__fmul_rn(wa, a), __fmul_rn(wb, b));
  // NaN propagates, as jnp.maximum / torch.maximum do
  if (OP == OP_MAX) return (a > b || a != a) ? a : b;
  return (a < b || a != a) ? a : b;
}

template <int OP, typename TA, typename TB, int V, int T>
__global__ void __launch_bounds__(T)
pair_fuse_kernel(const __grid_constant__ Table table, float wa, float wb) {
  // the last pair whose first block is at or before this one
  const unsigned int block = blockIdx.x;
  int lo = 0, hi = table.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (table.pair[mid].first <= block) lo = mid;
    else hi = mid - 1;
  }
  const Pair& p = table.pair[lo];
  const TA* __restrict__ a = static_cast<const TA*>(p.a);
  const TB* __restrict__ b = static_cast<const TB*>(p.b);
  TA* __restrict__ out = static_cast<TA*>(p.out);
  const long long n = p.n;
  const long long i0 =
      (static_cast<long long>(block - p.first) * T + threadIdx.x) * V;
  if (i0 >= n) return;
  if (p.vector && i0 + V <= n) {
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

// The table of ``count`` rows, checked: n > 0, the first blocks laid end to
// end from 0, the vector flag only on aligned operands (a thread's V
// elements start V apart, so aligned bases keep every thread's vectors
// aligned; the ragged tail is scalar in the kernel). Returns the grid's
// blocks, or 0 if a row is refused.
template <typename TA, typename TB, int V, int T>
unsigned int fill(const long long* rows, int count, Table* t) {
  long long blocks = 0;
  for (int i = 0; i < count; ++i) {
    const long long* r = rows + ROW * i;
    Pair& p = t->pair[i];
    p.a = reinterpret_cast<const void*>(r[0]);
    p.b = reinterpret_cast<const void*>(r[1]);
    p.out = reinterpret_cast<void*>(r[2]);
    p.n = r[3];
    p.vector = r[5] != 0;
    if (p.n <= 0 || r[4] != blocks) return 0;
    if (p.vector && !(aligned(p.a, chunk_bytes<TA, V>()) &&
                      aligned(p.b, chunk_bytes<TB, V>()) &&
                      aligned(p.out, chunk_bytes<TA, V>()))) {
      return 0;
    }
    p.first = static_cast<unsigned int>(blocks);
    blocks += (p.n + V * T - 1) / (V * T);
    if (blocks > INT_MAX) return 0;  // gridDim.x
  }
  t->count = count;
  return static_cast<unsigned int>(blocks);
}

template <int OP, typename TA, typename TB, int V, int T>
int launch(const long long* rows, int count, float wa, float wb,
           cudaStream_t stream) {
  Table t;
  const unsigned int blocks = fill<TA, TB, V, T>(rows, count, &t);
  if (blocks == 0) return static_cast<int>(cudaErrorInvalidValue);
  pair_fuse_kernel<OP, TA, TB, V, T><<<blocks, T, 0, stream>>>(t, wa, wb);
  return static_cast<int>(cudaGetLastError());
}

template <int OP, int V, int T>
int dispatch_dtypes(const long long* rows, int count, int a_dtype,
                    int b_dtype, float wa, float wb, cudaStream_t s) {
  using bf16 = __nv_bfloat16;
  if (a_dtype == DT_F32 && b_dtype == DT_F32) return launch<OP, float, float, V, T>(rows, count, wa, wb, s);
  if (a_dtype == DT_F32 && b_dtype == DT_BF16) return launch<OP, float, bf16, V, T>(rows, count, wa, wb, s);
  if (a_dtype == DT_BF16 && b_dtype == DT_F32) return launch<OP, bf16, float, V, T>(rows, count, wa, wb, s);
  if (a_dtype == DT_BF16 && b_dtype == DT_BF16) return launch<OP, bf16, bf16, V, T>(rows, count, wa, wb, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int V, int T>
int dispatch_op(const long long* rows, int count, int op, int a_dtype,
                int b_dtype, float wa, float wb, cudaStream_t s) {
  switch (op) {
    case OP_MEAN: return dispatch_dtypes<OP_MEAN, V, T>(rows, count, a_dtype, b_dtype, wa, wb, s);
    case OP_WSUM: return dispatch_dtypes<OP_WSUM, V, T>(rows, count, a_dtype, b_dtype, wa, wb, s);
    case OP_MAX: return dispatch_dtypes<OP_MAX, V, T>(rows, count, a_dtype, b_dtype, wa, wb, s);
    case OP_MIN: return dispatch_dtypes<OP_MIN, V, T>(rows, count, a_dtype, b_dtype, wa, wb, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// rows: count x ROW int64 (a, b, out, n, first block, vector flag), the
// table that kernels/pair_fuse.py plan() lays out; all pairs of one dtype
// pair, each out of a's dtype.
extern "C" int pair_fuse_table_launch(const long long* rows, int count,
                                      int op, int a_dtype, int b_dtype,
                                      float wa, float wb, int vec,
                                      int threads, void* stream) {
  if (count < 1 || count > TABLE_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PAIR_FUSE_SHAPE(V, T) \
  if (vec == V && threads == T) return dispatch_op<V, T>(rows, count, op, a_dtype, b_dtype, wa, wb, s);
  FOR_EACH_SHAPE(PAIR_FUSE_SHAPE)
#undef PAIR_FUSE_SHAPE
  return static_cast<int>(cudaErrorInvalidValue);  // not an exported shape
}
