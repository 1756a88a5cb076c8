// Host memcpy split over a persistent pool of threads, with a plain C interface
// for ctypes. `staging.py` fills its pinned blocks with it.
//
// A copy is cut into pieces of kPiece bytes that the pool's threads and the
// caller claim off a shared counter, so a thread that is slowed down or
// descheduled holds back one piece, not a fixed share of the copy as a static
// split over the threads (OpenMP's, which torch's CPU `copy_` uses) does. The
// call returns once every piece is copied; no thread touches `src` or `dst`
// after that.
//
//   void host_copy(void* dst, const void* src, size_t n)
//   int host_copy_threads(void)   the pool's threads, the caller not counted
//
// The pool has one thread fewer than the CPUs the process may run on and is
// started by the first call. Between copies its threads spin for kSpinNs, which
// covers the gap between the chunks of one request, then sleep until the next
// copy. One copy runs at a time.
#include <sched.h>

#include <algorithm>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <memory>
#include <mutex>
#include <thread>

namespace {

constexpr size_t kPiece = size_t{512} << 10;  // ~0.15 ms of one core's copy
constexpr int64_t kSpinNs = 200'000;

int64_t now_ns() {
  return std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

struct Copy {
  char* dst;
  const char* src;
  size_t n, pieces;
  std::atomic<size_t> next{0}, done{0};

  Copy(void* d, const void* s, size_t bytes)
      : dst(static_cast<char*>(d)), src(static_cast<const char*>(s)), n(bytes),
        pieces((bytes + kPiece - 1) / kPiece) {}

  // Claims and copies pieces until none is left unclaimed.
  void drain() {
    for (size_t i; (i = next.fetch_add(1)) < pieces;) {
      size_t off = i * kPiece;
      std::memcpy(dst + off, src + off, std::min(kPiece, n - off));
      done.fetch_add(1);
    }
  }
};

struct Pool {
  std::mutex m;
  std::condition_variable cv;
  std::shared_ptr<Copy> job;  // the newest copy, under m
  std::atomic<uint64_t> seq{0};
  std::mutex one_at_a_time;
  int threads;

  Pool() {
    cpu_set_t set;
    int cpus = sched_getaffinity(0, sizeof(set), &set) == 0 ? CPU_COUNT(&set) : 1;
    threads = std::max(cpus - 1, 0);
    for (int w = 0; w < threads; ++w) std::thread(&Pool::run, this).detach();
  }

  void run() {
    uint64_t seen = 0;
    for (;;) {
      for (int64_t t0 = now_ns(); seq.load() == seen && now_ns() - t0 < kSpinNs;) {
      }
      std::shared_ptr<Copy> c;
      {
        std::unique_lock<std::mutex> lk(m);
        cv.wait(lk, [&] { return seq.load() != seen; });
        seen = seq.load();
        c = job;
      }
      c->drain();  // claims nothing if the copy is already done
    }
  }

  void copy(void* dst, const void* src, size_t n) {
    std::lock_guard<std::mutex> g(one_at_a_time);
    auto c = std::make_shared<Copy>(dst, src, n);
    if (c->pieces > 1 && threads > 0) {
      {
        std::lock_guard<std::mutex> lk(m);
        job = c;
        seq.fetch_add(1);
      }
      cv.notify_all();
    }
    c->drain();
    while (c->done.load() < c->pieces) {
    }
  }
};

// Never destroyed: its threads wait on its members until the process ends.
Pool& pool() {
  static Pool* p = new Pool();
  return *p;
}

}  // namespace

extern "C" {

void host_copy(void* dst, const void* src, size_t n) { pool().copy(dst, src, n); }

int host_copy_threads(void) { return pool().threads; }
}
