// Mutable-object channels: versioned single-writer shared-memory slots with
// acquire/release semantics, for compiled-DAG style actor pipelines.
//
// Reference capability: src/ray/core_worker/experimental_mutable_object_
// manager.h:48 (WriteAcquire :153 / ReadAcquire — versioned mutable plasma
// buffers backing aDAG channels). Redesign: a channel is a fixed shm region
// [128B control block][payload]; the control block holds a C++11 atomic
// sequence counter (seqlock protocol) that Python cannot express — this is
// precisely the piece that must be native. Readers/writers in DIFFERENT
// processes map the same region; release stores publish, acquire loads
// observe (std::memory_order on lock-free 64-bit atomics over shared
// memory).
//
// Protocol (single writer, N readers, bounded wait):
//   seq % 2 == 0  -> stable version seq/2 published, len bytes valid
//   seq % 2 == 1  -> writer mid-update; readers spin/sleep
// A reader that wants "the next version after v" blocks until seq/2 > v.
// Writers overwrite freely (latest-value channel); for lossless pipelines
// the Python layer adds per-reader ack counters in the control block
// (num_read slots) so the writer can wait for all readers to consume the
// previous version before overwriting (bounded queue of depth 1, exactly
// the reference's WriteAcquire blocking semantics).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <ctime>

namespace {

struct Control {
  std::atomic<uint64_t> seq;        // seqlock: 2*version (+1 while writing)
  std::atomic<uint64_t> len;        // payload bytes of the published version
  std::atomic<uint64_t> acks[8];    // per-reader: last version consumed
  std::atomic<uint64_t> closed;     // writer hung up
  uint64_t reserved[4];
};
static_assert(sizeof(Control) <= 128, "control block must fit 128 bytes");

inline Control* ctl(void* base) { return reinterpret_cast<Control*>(base); }

inline void nap() {
  struct timespec ts = {0, 50000};  // 50us
  ::nanosleep(&ts, nullptr);
}

inline uint64_t now_ms() {
  struct timespec ts;
  ::clock_gettime(CLOCK_MONOTONIC, &ts);
  return static_cast<uint64_t>(ts.tv_sec) * 1000 + ts.tv_nsec / 1000000;
}

}  // namespace

extern "C" {

// The payload region starts 128 bytes into the channel mapping.
uint64_t rtpu_chan_header_size() { return 128; }

void rtpu_chan_init(void* base) {
  std::memset(base, 0, 128);
  ctl(base)->seq.store(0, std::memory_order_release);
}

// Writer: begin an update. If `wait_readers` > 0, blocks until every reader
// slot [0, wait_readers) has acked the current version (depth-1 queue /
// lossless mode). Returns the version being written, or -1 on timeout,
// -2 if the channel is closed.
int64_t rtpu_chan_write_acquire(void* base, int wait_readers,
                                uint64_t timeout_ms) {
  Control* c = ctl(base);
  if (c->closed.load(std::memory_order_acquire)) return -2;
  uint64_t deadline = now_ms() + timeout_ms;
  uint64_t seq = c->seq.load(std::memory_order_acquire);
  uint64_t current = seq / 2;
  if (wait_readers > 0 && current > 0) {
    for (;;) {
      bool all = true;
      for (int r = 0; r < wait_readers && r < 8; ++r) {
        if (c->acks[r].load(std::memory_order_acquire) < current) {
          all = false;
          break;
        }
      }
      if (all) break;
      if (c->closed.load(std::memory_order_acquire)) return -2;
      if (now_ms() > deadline) return -1;
      nap();
    }
  }
  c->seq.store(seq + 1, std::memory_order_release);  // odd: writing
  return static_cast<int64_t>(current + 1);
}

// Writer: publish `len` payload bytes as the new version.
void rtpu_chan_write_release(void* base, uint64_t len) {
  Control* c = ctl(base);
  c->len.store(len, std::memory_order_release);
  uint64_t seq = c->seq.load(std::memory_order_relaxed);
  c->seq.store(seq + 1, std::memory_order_release);  // even: published
}

// Reader: block until a version newer than `last_version` is published.
// Returns the new version (payload length in *len_out), or -1 on timeout,
// -2 if closed with no newer version coming.
int64_t rtpu_chan_read_acquire(void* base, uint64_t last_version,
                               uint64_t* len_out, uint64_t timeout_ms) {
  Control* c = ctl(base);
  uint64_t deadline = now_ms() + timeout_ms;
  for (;;) {
    uint64_t seq = c->seq.load(std::memory_order_acquire);
    if (seq % 2 == 0 && seq / 2 > last_version) {
      *len_out = c->len.load(std::memory_order_acquire);
      return static_cast<int64_t>(seq / 2);
    }
    if (c->closed.load(std::memory_order_acquire)) return -2;
    if (now_ms() > deadline) return -1;
    nap();
  }
}

// Reader: re-check that `version` is still the published one (no writer
// started since read_acquire). 1 = consistent read, 0 = torn (retry).
int rtpu_chan_read_validate(void* base, uint64_t version) {
  uint64_t seq = ctl(base)->seq.load(std::memory_order_acquire);
  return (seq % 2 == 0 && seq / 2 == version) ? 1 : 0;
}

// Reader `slot` marks `version` consumed (lossless mode handshake).
void rtpu_chan_read_ack(void* base, int slot, uint64_t version) {
  if (slot >= 0 && slot < 8)
    ctl(base)->acks[slot].store(version, std::memory_order_release);
}

void rtpu_chan_close(void* base) {
  ctl(base)->closed.store(1, std::memory_order_release);
}

int rtpu_chan_is_closed(void* base) {
  return ctl(base)->closed.load(std::memory_order_acquire) ? 1 : 0;
}

uint64_t rtpu_chan_version(void* base) {
  return ctl(base)->seq.load(std::memory_order_acquire) / 2;
}

}  // extern "C"
