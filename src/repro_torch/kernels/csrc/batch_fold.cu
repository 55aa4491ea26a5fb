// batch_fold: fold up to C_MAX weighted updates into the fp32 accumulator of
// every leaf of a model, in one pass
//
//   out[i] = acc[i] + w_0 u_0[i] + w_1 u_1[i] + ... + w_{c-1} u_{c-1}[i]
//
// summed in that order, 1 <= c <= C_MAX, for every leaf (acc, u_0..u_{c-1},
// out) of the table; each product and each sum is rounded to fp32 on its own
// (no FMA contraction), so out is bit for bit what c streaming folds give
// (pair_fuse wsum with wa = 1, one update at a time, csrc/pair_fuse.cu). A
// batch that starts the accumulator reads none: out[i] = w_0 u_0[i] + ...,
// from the rounded first product, as the streaming fold's first cast does.
//
// Replaces no TPU kernel. The reference folds a backlog one update at a time
// (pair_fuse); this kernel folds it C_MAX at a time, on the card only, where
// the bytes of the fold are what bound the aggregator.
//
// Bound: bytes. A streaming fold reads the fp32 accumulator (4 B), reads a
// bf16 update (2 B) and writes the accumulator (4 B): 10 B an element and
// update. Here the accumulator is read and written once a pass, so c
// updates move 8 + 2c B an element, 2 + 8 / c an update: 3 B at c = 8, and
// the arithmetic (2c flops) stays far below the card's rate. The design does
// what that asks: one pass over every update of the batch, each thread
// issuing all its loads (vectors of V elements: at the default 4 x 128, 16
// bytes of the fp32 accumulator and 8 of each bf16 update) before it sums,
// so that c + 1 streams are in flight; the sum is kept in registers and
// written once. V = 8 (16-byte loads of every update) ran 10-12 % slower
// (kernels/build.py DEFAULT_SHAPES). Two updates of a batch may be the same
// tensor: the second read hits the cache.
//
// One grid a table, as pair_fuse's: a table of up to TABLE_MAX leaves, each
// row the accumulator read (none when the batch starts it), the output (the
// accumulator itself when it is updated in place), the c update pointers,
// the length, the leaf's first block and its vector flag, is passed by value
// as a __grid_constant__ parameter of 24.6 KB (CUDA 12.1 raised the limit to
// 32,764 bytes): no device allocation and no copy of its own. Each block
// finds its leaf by a binary search over the first blocks, uniform across
// the block, and the wrapper orders the table largest leaf first.
#include <limits.h>

#include "common.cuh"

namespace {

// The most updates one launch folds; kernels/batch_fold.py C_MAX.
constexpr int C_MAX = 8;
// The most leaves one launch takes; kernels/batch_fold.py TABLE_MAX.
constexpr int TABLE_MAX = 256;
// int64 fields of a row of the wrapper's table: in, out, C_MAX update
// pointers, n, first block, vector flag
constexpr int ROW = 2 + C_MAX + 3;

struct Leaf {
  const float* in;      // the accumulator read; unused when the batch starts it
  float* out;           // may be in: each element is read, then written, by one thread
  const void* u[C_MAX];  // the updates' leaves; u[j] for j >= c unused
  long long n;          // elements, > 0
  unsigned int first;   // the leaf's first block in the grid
  int vector;           // in, out and every u[j < c] aligned to their vector moves
};

struct Table {  // 256 x 96 + 40 bytes, under the 32,764 of kernel parameters
  Leaf leaf[TABLE_MAX];
  float w[C_MAX];
  int count;  // leaves
  int c;      // updates
};

// V fp32 accumulator elements from p, with plain loads: the kernel writes
// the same addresses, so the read-only path (__ldg) is not used.
template <int V>
__device__ __forceinline__ void load_acc(const float* p, float v[V]) {
  constexpr int B = chunk_bytes<float, V>();
  constexpr int PER = B / 4;
  using R = typename Raw<B>::T;
#pragma unroll
  for (int c = 0; c < V / PER; ++c) {
    const R r = reinterpret_cast<const R*>(p)[c];
    const float* e = reinterpret_cast<const float*>(&r);
#pragma unroll
    for (int j = 0; j < PER; ++j) v[c * PER + j] = e[j];
  }
}

// START: the batch starts the accumulator, and no ``in`` is read. A
// template parameter, not a field of the table: as a field the kernel ran
// 8 % slower (1.375 against 1.272 ms at 155,582,464 elements).
template <typename TU, bool START, int V, int T>
__global__ void __launch_bounds__(T)
batch_fold_kernel(const __grid_constant__ Table table) {
  // the last leaf whose first block is at or before this one
  const unsigned int block = blockIdx.x;
  int lo = 0, hi = table.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (table.leaf[mid].first <= block) lo = mid;
    else hi = mid - 1;
  }
  const Leaf& l = table.leaf[lo];
  const int c = table.c;
  const long long n = l.n;
  const long long i0 =
      (static_cast<long long>(block - l.first) * T + threadIdx.x) * V;
  if (i0 >= n) return;
  if (l.vector && i0 + V <= n) {
    float u[C_MAX][V];
#pragma unroll
    for (int j = 0; j < C_MAX; ++j) {
      if (j < c) load_vec<TU, V>(static_cast<const TU*>(l.u[j]) + i0, u[j]);
    }
    float s[V];
    if (!START) load_acc<V>(l.in + i0, s);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float p = __fmul_rn(table.w[0], u[0][k]);
      float a = START ? p : __fadd_rn(s[k], p);
#pragma unroll
      for (int j = 1; j < C_MAX; ++j) {
        if (j < c) a = __fadd_rn(a, __fmul_rn(table.w[j], u[j][k]));
      }
      s[k] = a;
    }
    store_vec<float, V>(l.out + i0, s);
  } else {
    const long long end = i0 + V < n ? i0 + V : n;
    for (long long i = i0; i < end; ++i) {
      const float p =
          __fmul_rn(table.w[0], to_f32(static_cast<const TU*>(l.u[0])[i]));
      float a = START ? p : __fadd_rn(l.in[i], p);
      for (int j = 1; j < c; ++j) {
        a = __fadd_rn(a, __fmul_rn(table.w[j],
                                   to_f32(static_cast<const TU*>(l.u[j])[i])));
      }
      l.out[i] = a;
    }
  }
}

// The table of ``count`` rows and ``c`` weights, checked: n > 0, the first
// blocks laid end to end from 0, every pointer the batch reads set, the
// vector flag only on aligned operands (a thread's V elements start V apart,
// so aligned bases keep every thread's vectors aligned; the ragged tail is
// scalar in the kernel). Returns the grid's blocks, or 0 if a row is
// refused.
template <typename TU, int V, int T>
unsigned int fill(const long long* rows, int count, const float* w, int c,
                  bool start, Table* t) {
  long long blocks = 0;
  for (int i = 0; i < count; ++i) {
    const long long* r = rows + ROW * i;
    Leaf& l = t->leaf[i];
    l.in = reinterpret_cast<const float*>(r[0]);
    l.out = reinterpret_cast<float*>(r[1]);
    bool ok = l.out != nullptr && (start || l.in != nullptr);
    bool vec = r[2 + C_MAX + 2] != 0;
    if (vec) {
      ok = ok && aligned(l.out, chunk_bytes<float, V>()) &&
           (start || aligned(l.in, chunk_bytes<float, V>()));
    }
    for (int j = 0; j < C_MAX; ++j) {
      l.u[j] = reinterpret_cast<const void*>(r[2 + j]);
      if (j < c) {
        ok = ok && l.u[j] != nullptr &&
             (!vec || aligned(l.u[j], chunk_bytes<TU, V>()));
      }
    }
    l.n = r[2 + C_MAX];
    l.vector = vec;
    if (!ok || l.n <= 0 || r[2 + C_MAX + 1] != blocks) return 0;
    l.first = static_cast<unsigned int>(blocks);
    blocks += (l.n + V * T - 1) / (V * T);
    if (blocks > INT_MAX) return 0;  // gridDim.x
  }
  for (int j = 0; j < C_MAX; ++j) t->w[j] = j < c ? w[j] : 0.0f;
  t->count = count;
  t->c = c;
  return static_cast<unsigned int>(blocks);
}

template <typename TU, int V, int T>
int launch(const long long* rows, int count, const float* w, int c,
           bool start, cudaStream_t stream) {
  Table t;
  const unsigned int blocks = fill<TU, V, T>(rows, count, w, c, start, &t);
  if (blocks == 0) return static_cast<int>(cudaErrorInvalidValue);
  if (start) {
    batch_fold_kernel<TU, true, V, T><<<blocks, T, 0, stream>>>(t);
  } else {
    batch_fold_kernel<TU, false, V, T><<<blocks, T, 0, stream>>>(t);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int V, int T>
int dispatch(const long long* rows, int count, const float* w, int c,
             bool start, int u_dtype, cudaStream_t s) {
  if (u_dtype == DT_F32) return launch<float, V, T>(rows, count, w, c, start, s);
  if (u_dtype == DT_BF16) return launch<__nv_bfloat16, V, T>(rows, count, w, c, start, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// rows: count x ROW int64 (in, out, C_MAX update pointers, n, first block,
// vector flag), the table that kernels/batch_fold.py plan() lays out, every
// update leaf of one dtype; weights: c floats; start: the batch starts the
// accumulator (no row's ``in`` is read).
extern "C" int batch_fold_table_launch(const long long* rows, int count,
                                       const float* weights, int c,
                                       int start, int u_dtype, int vec,
                                       int threads, void* stream) {
  if (count < 1 || count > TABLE_MAX || c < 1 || c > C_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BATCH_FOLD_SHAPE(V, T) \
  if (vec == V && threads == T) return dispatch<V, T>(rows, count, weights, c, start != 0, u_dtype, s);
  FOR_EACH_SHAPE(BATCH_FOLD_SHAPE)
#undef BATCH_FOLD_SHAPE
  return static_cast<int>(cudaErrorInvalidValue);  // not an exported shape
}
