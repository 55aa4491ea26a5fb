// spill_copy: move a payload's leaves from the card to host memory or to a
// file, piece by piece through two pinned buffers
//
// Not a kernel: host code that drives copies on a stream. It replaces no TPU
// kernel. The queue (core/spill.py) moves each fused model off the card while
// the next round folds, so that the card does not fill with one model a
// round. Called from Python, the same work needs the interpreter's lock
// between every piece and every thread of the copy out, and a busy main
// thread then starves it (2.5 GB models fell behind 0.86-s rounds until the
// card filled); called once through ctypes, all of it runs with the lock
// released.
//
// Bound: the host. The card copies a piece into a pinned buffer at about
// 44 GB/s, and the host copies it out either into new pageable memory, where
// the first touch of each page bounds it (about 2.4 GB/s on one thread, 5.2
// on four on the card's 8-core host), or into a file (about 3.5 GB/s from
// one thread). So the card copies the next piece into one buffer while
// ``threads`` threads copy or write the last one out of the other.
#include <cuda_runtime.h>
#include <errno.h>
#include <string.h>
#include <unistd.h>

#include <algorithm>
#include <thread>
#include <vector>

namespace {

// n bytes from s to d on up to ``threads`` threads
void copy_out(char* d, const char* s, long long n, int threads) {
  const long long step = (n + threads - 1) / threads;
  std::vector<std::thread> pool;
  for (long long a = step; a < n; a += step) {
    const long long m = std::min(step, n - a);
    pool.emplace_back([=] { memcpy(d + a, s + a, m); });
  }
  memcpy(d, s, std::min(step, n));
  for (auto& t : pool) t.join();
}

// n bytes from s to fd at offset off, on one thread; 0, or -errno
int write_part(int fd, const char* s, long long n, long long off) {
  while (n > 0) {
    const ssize_t w = pwrite(fd, s, static_cast<size_t>(n), off);
    if (w < 0) {
      if (errno == EINTR) continue;
      return -errno;
    }
    if (w == 0) return -EIO;
    s += w;
    n -= w;
    off += w;
  }
  return 0;
}

// n bytes from s to fd at offset off on up to ``threads`` threads; 0, or
// the -errno of a part that failed
int write_out(int fd, const char* s, long long n, long long off,
              int threads) {
  const long long step = (n + threads - 1) / threads;
  std::vector<int> rc(threads, 0);
  std::vector<std::thread> pool;
  for (long long a = step, k = 1; a < n; a += step, ++k) {
    const long long m = std::min(step, n - a);
    pool.emplace_back([=, &rc] { rc[k] = write_part(fd, s + a, m, off + a); });
  }
  rc[0] = write_part(fd, s, std::min(step, n), off);
  for (auto& t : pool) t.join();
  for (int r : rc) {
    if (r) return r;
  }
  return 0;
}

}  // namespace

// count leaves: src[i] the leaf's address on the card, bytes[i] its bytes,
// dst[i] its address in host memory or, with fd >= 0, its offset in the
// file fd. stage0 and stage1: pinned buffers of chunk bytes each. The copies
// run on ``stream``, which the caller has made wait for the payload. Returns
// 0, a cudaError_t, or -errno of a failed write.
extern "C" int spill_copy(const long long* src, const long long* dst,
                          const long long* bytes, int count, void* stage0,
                          void* stage1, long long chunk, int fd, int threads,
                          void* stream) {
  if (count < 0 || chunk <= 0 || threads < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  char* stage[2] = {static_cast<char*>(stage0), static_cast<char*>(stage1)};
  cudaEvent_t done[2];
  for (auto& e : done) {
    const cudaError_t err = cudaEventCreateWithFlags(&e, cudaEventDisableTiming);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int rc = 0;
  int cur = 0;  // the buffer the next piece goes into
  long long prev_dst = 0, prev_n = -1;
  // the piece before the one just queued lies in stage[buf]: wait for it and
  // copy it out
  auto finish_prev = [&](int buf) {
    if (prev_n < 0 || rc) return;
    const cudaError_t err = cudaEventSynchronize(done[buf]);
    if (err != cudaSuccess) {
      rc = static_cast<int>(err);
    } else if (fd >= 0) {
      rc = write_out(fd, stage[buf], prev_n, prev_dst, threads);
    } else {
      copy_out(reinterpret_cast<char*>(prev_dst), stage[buf], prev_n,
               threads);
    }
  };
  for (int i = 0; i < count && !rc; ++i) {
    const char* base = reinterpret_cast<const char*>(src[i]);
    for (long long a = 0; a < bytes[i] && !rc; a += chunk) {
      const long long n = std::min(chunk, bytes[i] - a);
      cudaError_t err = cudaMemcpyAsync(stage[cur], base + a, n,
                                        cudaMemcpyDeviceToHost, s);
      if (err == cudaSuccess) err = cudaEventRecord(done[cur], s);
      if (err != cudaSuccess) {
        rc = static_cast<int>(err);
        break;
      }
      finish_prev(cur ^ 1);
      prev_dst = dst[i] + a;
      prev_n = n;
      cur ^= 1;
    }
  }
  finish_prev(cur ^ 1);
  // nothing may still write into the buffers, which are the caller's
  cudaStreamSynchronize(s);
  for (auto& e : done) cudaEventDestroy(e);
  return rc;
}
