// A pool of threads that copies one host batch at a time into its staging
// buffer, with streaming stores on x86-64.  The thread that hands a copy
// over returns at once and goes on (it holds Python's interpreter lock,
// which these threads never take); stage_wait copies what the threads
// have not yet claimed and blocks until the copy is done.  Built with g++
// at first use and loaded with ctypes
// (vrgdg_tpu_torch/runtime/batch_stream.py, Stager).

#include <algorithm>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <ctime>
#include <mutex>
#include <pthread.h>
#include <thread>
#include <vector>

#if defined(__x86_64__)
#include <immintrin.h>
#endif

namespace {

// A copy is split into parts of this many bytes, which the threads claim
// one at a time, so a thread the scheduler holds back delays the copy by
// one part at most.
constexpr int64_t kPart = int64_t(1) << 20;

#if defined(__x86_64__)
// Streaming (non-temporal) stores: the staging buffer is read next by the
// card's copy engine, not by the CPU, so its lines skip the caches and
// are not read before they are written.
void copy_part(char* dst, const char* src, int64_t n) {
  int64_t head = (16 - int64_t(reinterpret_cast<uintptr_t>(dst) & 15)) & 15;
  head = std::min(head, n);
  std::memcpy(dst, src, size_t(head));
  dst += head; src += head; n -= head;
  const int64_t blocks = n / 64;
  for (int64_t i = 0; i < blocks; ++i, dst += 64, src += 64) {
    const auto* in = reinterpret_cast<const __m128i*>(src);
    auto* out = reinterpret_cast<__m128i*>(dst);
    const __m128i a = _mm_loadu_si128(in), b = _mm_loadu_si128(in + 1);
    const __m128i c = _mm_loadu_si128(in + 2), d = _mm_loadu_si128(in + 3);
    _mm_stream_si128(out, a);
    _mm_stream_si128(out + 1, b);
    _mm_stream_si128(out + 2, c);
    _mm_stream_si128(out + 3, d);
  }
  std::memcpy(dst, src, size_t(n - blocks * 64));
  _mm_sfence();
}
#else
void copy_part(char* dst, const char* src, int64_t n) {
  std::memcpy(dst, src, size_t(n));
}
#endif

int64_t now_ns() {
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);  // time.perf_counter_ns's clock
  return int64_t(ts.tv_sec) * 1000000000 + ts.tv_nsec;
}

struct Pool {
  std::mutex mu;
  std::condition_variable work, done;
  std::vector<std::thread> threads;
  char* dst = nullptr;
  const char* src = nullptr;
  int64_t bytes = 0, part = 0, ended_ns = 0;
  int parts = 0, next = 0, finished = 0;
  bool stop = false;

  bool idle() const { return finished == parts; }

  // Claims the next part (with `lock` held on `mu`), copies it with the
  // lock released, and counts it done.
  void copy_next(std::unique_lock<std::mutex>& lock) {
    const int64_t offset = next++ * part;
    const int64_t length = std::max<int64_t>(
        0, std::min(part, bytes - offset));
    lock.unlock();
    copy_part(dst + offset, src + offset, length);
    lock.lock();
    if (++finished == parts) {
      ended_ns = now_ns();
      done.notify_all();
    }
  }

  void run() {
    pthread_setname_np(pthread_self(), "vrgdg-stage");
    std::unique_lock<std::mutex> lock(mu);
    for (;;) {
      work.wait(lock, [this] { return stop || next < parts; });
      if (stop) return;
      copy_next(lock);
    }
  }
};

}  // namespace

extern "C" {

// A pool of `threads` copy threads (with none, stage_wait copies it all
// on the caller's thread), or nullptr when it cannot be made (no memory, or the system refuses a thread): nothing may
// throw across this C interface, which ctypes calls.
void* stage_open(int32_t threads) {
  Pool* pool = nullptr;
  try {
    pool = new Pool;
    for (int32_t i = 0; i < threads; ++i) {
      pool->threads.emplace_back([pool] { pool->run(); });
    }
    return pool;
  } catch (...) {
    if (pool != nullptr) {
      {
        std::lock_guard<std::mutex> lock(pool->mu);
        pool->stop = true;
      }
      pool->work.notify_all();
      for (auto& thread : pool->threads) thread.join();
      delete pool;
    }
    return nullptr;
  }
}

// Starts copying `bytes` from `src` to `dst` and returns 0 at once; -1
// while the previous copy is still running, -2 when the pool's lock
// fails.
int32_t stage_copy(void* handle, void* dst, const void* src, int64_t bytes) {
  auto* pool = static_cast<Pool*>(handle);
  try {
    std::lock_guard<std::mutex> lock(pool->mu);
    if (!pool->idle()) return -1;
    pool->dst = static_cast<char*>(dst);
    pool->src = static_cast<const char*>(src);
    pool->bytes = bytes;
    pool->part = kPart;
    pool->parts = int(std::max<int64_t>(1, (bytes + kPart - 1) / kPart));
    pool->next = 0;
    pool->finished = 0;
    // wake no more threads than there are parts: a small batch leaves the
    // rest asleep rather than on the stream's cores
    const int64_t wake =
        std::min<int64_t>(pool->parts, pool->threads.size());
    for (int64_t i = 0; i < wake; ++i) pool->work.notify_one();
    return 0;
  } catch (...) {
    return -2;
  }
}

// 1 when the last copy has finished (or none was started), else 0.
int32_t stage_done(void* handle) {
  auto* pool = static_cast<Pool*>(handle);
  std::lock_guard<std::mutex> lock(pool->mu);
  return pool->idle() ? 1 : 0;
}

// Copies the parts of the last copy that no thread has claimed yet, so a
// pool the scheduler holds back costs the caller no more than copying
// them itself, then blocks until the copy has finished; returns when it
// finished, in CLOCK_MONOTONIC nanoseconds (0 when no copy was started).
int64_t stage_wait(void* handle) {
  auto* pool = static_cast<Pool*>(handle);
  std::unique_lock<std::mutex> lock(pool->mu);
  while (pool->next < pool->parts) pool->copy_next(lock);
  pool->done.wait(lock, [pool] { return pool->idle(); });
  return pool->ended_ns;
}

// Waits for a copy in flight, then stops and joins the threads.
void stage_close(void* handle) {
  auto* pool = static_cast<Pool*>(handle);
  {
    std::unique_lock<std::mutex> lock(pool->mu);
    pool->done.wait(lock, [pool] { return pool->idle(); });
    pool->stop = true;
  }
  pool->work.notify_all();
  for (auto& thread : pool->threads) thread.join();
  delete pool;
}

}  // extern "C"
