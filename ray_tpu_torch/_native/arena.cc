// Shared-memory arena allocator: the native core of the object store.
//
// Reference capability: src/ray/object_manager/plasma/{plasma_allocator.cc,
// dlmalloc.cc, object_store.cc} — one mmap'd arena per node, objects carved
// out of it by a native allocator, readers attach the single segment and get
// zero-copy views. Redesign for this framework: the allocator is
// boundary-tag first-fit with eager coalescing (objects here are few and
// large — task returns / tensor blocks — so a size-class allocator like
// dlmalloc buys nothing over simple coalescing, and first-fit keeps the
// arena compact for the LRU evictor); allocation METADATA lives in the
// owning (node-agent) process, not in shared memory, because exactly one
// process allocates — workers only attach for the base pointer and
// read/write payload bytes at offsets the agent hands out via RPC.
//
// Each allocation is prefixed by a 64-byte in-arena header holding the
// 24-byte object id and the payload size. Readers validate the header
// against the id they expect; a mismatch means the slot was evicted and
// reused between the metadata RPC and the read, and surfaces as a clean
// "object missing" instead of silently returning another object's bytes.
//
// C ABI throughout (loaded via ctypes — no pybind11 in the image).

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <map>
#include <mutex>
#include <string>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>
#include <vector>

namespace {

constexpr uint64_t kAlign = 64;          // TPU-friendly / cacheline alignment
constexpr uint64_t kHeaderSize = 64;     // in-arena per-object header

struct FreeBlock {
  uint64_t size;  // bytes, including any header space of the block
};

struct Arena {
  void* base = nullptr;
  uint64_t capacity = 0;
  bool owner = false;  // created (allocates) vs attached (read/write only)
  std::string path;
  // free list keyed by offset -> size; allocated keyed by offset -> size.
  // Only the owner touches these; guarded for safety anyway.
  std::map<uint64_t, uint64_t> free_blocks;
  std::map<uint64_t, uint64_t> alloc_blocks;
  uint64_t used = 0;
  std::mutex mu;
};

std::mutex g_mu;
std::vector<Arena*> g_arenas;

Arena* get(int64_t h) {
  std::lock_guard<std::mutex> g(g_mu);
  if (h < 0 || h >= static_cast<int64_t>(g_arenas.size())) return nullptr;
  return g_arenas[h];
}

int64_t put(Arena* a) {
  std::lock_guard<std::mutex> g(g_mu);
  for (size_t i = 0; i < g_arenas.size(); ++i) {
    if (g_arenas[i] == nullptr) {
      g_arenas[i] = a;
      return static_cast<int64_t>(i);
    }
  }
  g_arenas.push_back(a);
  return static_cast<int64_t>(g_arenas.size() - 1);
}

uint64_t round_up(uint64_t n, uint64_t a) { return (n + a - 1) / a * a; }

}  // namespace

extern "C" {

// Create a fresh arena file of `capacity` bytes at `path` (a /dev/shm file).
// An existing file at the path (stale predecessor) is replaced. Returns a
// handle >= 0, or -1 (errno left set by the failing syscall).
int64_t rtpu_arena_create(const char* path, uint64_t capacity) {
  ::unlink(path);
  int fd = ::open(path, O_RDWR | O_CREAT | O_EXCL, 0600);
  if (fd < 0) return -1;
  if (::ftruncate(fd, static_cast<off_t>(capacity)) != 0) {
    ::close(fd);
    ::unlink(path);
    return -1;
  }
  void* base =
      ::mmap(nullptr, capacity, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  ::close(fd);
  if (base == MAP_FAILED) {
    ::unlink(path);
    return -1;
  }
  Arena* a = new Arena();
  a->base = base;
  a->capacity = capacity;
  a->owner = true;
  a->path = path;
  a->free_blocks[0] = capacity;
  return put(a);
}

// Attach an existing arena (worker side). Returns handle or -1.
int64_t rtpu_arena_attach(const char* path) {
  int fd = ::open(path, O_RDWR, 0600);
  if (fd < 0) return -1;
  struct stat st;
  if (::fstat(fd, &st) != 0) {
    ::close(fd);
    return -1;
  }
  void* base = ::mmap(nullptr, static_cast<size_t>(st.st_size),
                      PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  ::close(fd);
  if (base == MAP_FAILED) return -1;
  Arena* a = new Arena();
  a->base = base;
  a->capacity = static_cast<uint64_t>(st.st_size);
  a->owner = false;
  a->path = path;
  return put(a);
}

void* rtpu_arena_base(int64_t h) {
  Arena* a = get(h);
  return a ? a->base : nullptr;
}

uint64_t rtpu_arena_capacity(int64_t h) {
  Arena* a = get(h);
  return a ? a->capacity : 0;
}

// Allocate header+payload for `payload_size` bytes; writes the 24-byte
// object id into the header. Returns the PAYLOAD offset (64-aligned), or
// -1 if no free block fits (caller evicts and retries).
int64_t rtpu_arena_alloc(int64_t h, const uint8_t* oid24,
                         uint64_t payload_size) {
  Arena* a = get(h);
  if (a == nullptr || !a->owner) return -1;
  uint64_t need = round_up(kHeaderSize + payload_size, kAlign);
  std::lock_guard<std::mutex> g(a->mu);
  // first fit
  for (auto it = a->free_blocks.begin(); it != a->free_blocks.end(); ++it) {
    if (it->second < need) continue;
    uint64_t off = it->first;
    uint64_t remain = it->second - need;
    a->free_blocks.erase(it);
    if (remain > 0) a->free_blocks[off + need] = remain;
    a->alloc_blocks[off] = need;
    a->used += need;
    // header: [24B oid][8B payload size][32B reserved/zero]
    uint8_t* hdr = static_cast<uint8_t*>(a->base) + off;
    std::memcpy(hdr, oid24, 24);
    std::memcpy(hdr + 24, &payload_size, 8);
    std::memset(hdr + 32, 0, kHeaderSize - 32);
    return static_cast<int64_t>(off + kHeaderSize);
  }
  return -1;
}

// Free the block whose PAYLOAD starts at `payload_off`. Scrubs the header
// (so stale readers fail validation) and coalesces with neighbours.
// Returns 0 on success, -1 if the offset is unknown.
int rtpu_arena_free(int64_t h, uint64_t payload_off) {
  Arena* a = get(h);
  if (a == nullptr || !a->owner || payload_off < kHeaderSize) return -1;
  uint64_t off = payload_off - kHeaderSize;
  std::lock_guard<std::mutex> g(a->mu);
  auto it = a->alloc_blocks.find(off);
  if (it == a->alloc_blocks.end()) return -1;
  uint64_t size = it->second;
  a->alloc_blocks.erase(it);
  a->used -= size;
  std::memset(static_cast<uint8_t*>(a->base) + off, 0, kHeaderSize);
  // coalesce with the next free block
  auto next = a->free_blocks.lower_bound(off);
  if (next != a->free_blocks.end() && next->first == off + size) {
    size += next->second;
    a->free_blocks.erase(next);
  }
  // coalesce with the previous free block
  auto prev = a->free_blocks.lower_bound(off);
  if (prev != a->free_blocks.begin()) {
    --prev;
    if (prev->first + prev->second == off) {
      prev->second += size;
      return 0;
    }
  }
  a->free_blocks[off] = size;
  return 0;
}

// Validate that the header before `payload_off` holds `oid24` and a size
// of exactly `expect_size`. 1 = valid, 0 = mismatch (evicted/reused slot).
int rtpu_arena_validate(int64_t h, const uint8_t* oid24, uint64_t payload_off,
                        uint64_t expect_size) {
  Arena* a = get(h);
  if (a == nullptr || payload_off < kHeaderSize ||
      payload_off + expect_size > a->capacity)
    return 0;
  const uint8_t* hdr =
      static_cast<const uint8_t*>(a->base) + (payload_off - kHeaderSize);
  if (std::memcmp(hdr, oid24, 24) != 0) return 0;
  uint64_t stored;
  std::memcpy(&stored, hdr + 24, 8);
  return stored == expect_size ? 1 : 0;
}

uint64_t rtpu_arena_used(int64_t h) {
  Arena* a = get(h);
  if (a == nullptr) return 0;
  std::lock_guard<std::mutex> g(a->mu);
  return a->used;
}

uint64_t rtpu_arena_num_free_blocks(int64_t h) {
  Arena* a = get(h);
  if (a == nullptr) return 0;
  std::lock_guard<std::mutex> g(a->mu);
  return a->free_blocks.size();
}

// Largest single allocatable payload right now (fragmentation probe).
uint64_t rtpu_arena_largest_free(int64_t h) {
  Arena* a = get(h);
  if (a == nullptr) return 0;
  std::lock_guard<std::mutex> g(a->mu);
  uint64_t best = 0;
  for (auto& kv : a->free_blocks)
    if (kv.second > best) best = kv.second;
  return best > kHeaderSize ? best - kHeaderSize : 0;
}

void rtpu_arena_close(int64_t h) {
  std::lock_guard<std::mutex> g(g_mu);
  if (h < 0 || h >= static_cast<int64_t>(g_arenas.size())) return;
  Arena* a = g_arenas[h];
  g_arenas[h] = nullptr;
  if (a == nullptr) return;
  ::munmap(a->base, a->capacity);
  delete a;
}

int rtpu_arena_unlink(const char* path) { return ::unlink(path); }

}  // extern "C"
