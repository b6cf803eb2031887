// The port's native runtime core (a copy of the JAX package's
// runtime/native/rlt_shm.cpp, kept byte-compatible: the same magics, header
// layouts and C symbols, so a ring or a segment written by either library
// reads in the other). Two components:
//
// 1. Object store segments: POSIX shm with a header carrying a magic, the
//    payload size and an ATOMIC cross-process refcount. The creator starts
//    the count at 1; readers attach and detach with atomic inc/dec; the
//    segment is unlinked by whichever process drops the count to 0, so a
//    main process may exit before slow workers finish reading.
//
// 2. A Vyukov-style bounded MPMC ring buffer in shared memory for the tune
//    and heartbeat queues: fixed slot payloads, per-slot sequence counters,
//    no locks, no server process (the fallback is a queue ACTOR: an extra
//    process and two socket hops per put and get).
//
// Exposed as a plain C ABI for ctypes.

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <new>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t kStoreMagic = 0x524C5453484D0001ULL;  // "RLTSHM" v1
constexpr uint64_t kQueueMagic = 0x524C545155450001ULL;  // "RLTQUE" v1

struct StoreHeader {
  uint64_t magic;
  uint64_t payload_size;
  std::atomic<int64_t> refcount;
};

struct QueueSlot {
  std::atomic<uint64_t> sequence;
  // atomic so a not-yet-claiming consumer may peek it for the capacity
  // check without a formal data race against a producer recycling the slot
  std::atomic<uint32_t> size;
  // payload bytes follow
};

struct QueueHeader {
  uint64_t magic;
  uint64_t capacity;    // number of slots (power of two)
  uint64_t slot_bytes;  // payload bytes per slot
  std::atomic<uint64_t> enqueue_pos;
  std::atomic<uint64_t> dequeue_pos;
};

// Slot stride rounded up to the atomic's alignment so every slot's
// sequence counter stays naturally aligned regardless of slot_bytes.
inline uint64_t slot_stride(uint64_t slot_bytes) {
  constexpr uint64_t kAlign = alignof(QueueSlot);
  return (sizeof(QueueSlot) + slot_bytes + kAlign - 1) & ~(kAlign - 1);
}

inline QueueSlot* slot_at(QueueHeader* h, uint64_t idx) {
  char* base = reinterpret_cast<char*>(h) + sizeof(QueueHeader);
  return reinterpret_cast<QueueSlot*>(
      base + (idx & (h->capacity - 1)) * slot_stride(h->slot_bytes));
}

}  // namespace

extern "C" {

// ------------------------------------------------------------------ //
// object store
// ------------------------------------------------------------------ //

// Create a segment and copy payload in. Returns 0 on success.
int rlt_store_create(const char* name, const uint8_t* data, uint64_t size) {
  int fd = shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) return -errno;
  uint64_t total = sizeof(StoreHeader) + size;
  if (ftruncate(fd, static_cast<off_t>(total)) != 0) {
    int err = -errno;
    close(fd);
    shm_unlink(name);
    return err;
  }
  void* mem = mmap(nullptr, total, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (mem == MAP_FAILED) {
    shm_unlink(name);
    return -errno;
  }
  auto* header = new (mem) StoreHeader();
  header->magic = kStoreMagic;
  header->payload_size = size;
  header->refcount.store(1, std::memory_order_release);
  if (size) std::memcpy(reinterpret_cast<char*>(mem) + sizeof(StoreHeader), data, size);
  munmap(mem, total);
  return 0;
}

// Attach for reading: bumps the refcount, returns payload size via out
// param and a malloc'd copy of the payload (simple + safe for ctypes; the
// zero-copy mmap path is rlt_store_map below).
int64_t rlt_store_size(const char* name) {
  int fd = shm_open(name, O_RDWR, 0600);
  if (fd < 0) return -errno;
  StoreHeader header;
  ssize_t n = pread(fd, &header, sizeof(header), 0);
  close(fd);
  if (n != static_cast<ssize_t>(sizeof(header)) || header.magic != kStoreMagic)
    return -EINVAL;
  return static_cast<int64_t>(header.payload_size);
}

// Map the segment read-only; returns payload pointer, fills handle/total
// for rlt_store_unmap. Also increments the refcount.
void* rlt_store_map(const char* name, uint64_t* payload_size, void** map_base,
                    uint64_t* map_len) {
  int fd = shm_open(name, O_RDWR, 0600);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return nullptr;
  }
  void* mem = mmap(nullptr, st.st_size, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (mem == MAP_FAILED) return nullptr;
  auto* header = reinterpret_cast<StoreHeader*>(mem);
  if (header->magic != kStoreMagic) {
    munmap(mem, st.st_size);
    return nullptr;
  }
  header->refcount.fetch_add(1, std::memory_order_acq_rel);
  *payload_size = header->payload_size;
  *map_base = mem;
  *map_len = static_cast<uint64_t>(st.st_size);
  return reinterpret_cast<char*>(mem) + sizeof(StoreHeader);
}

// Drop a reference taken by rlt_store_map (or the creator's initial ref via
// rlt_store_release). Unlinks the segment when the count reaches zero.
// Returns the refcount after the drop.
int64_t rlt_store_unmap(const char* name, void* map_base, uint64_t map_len) {
  auto* header = reinterpret_cast<StoreHeader*>(map_base);
  int64_t left = header->refcount.fetch_sub(1, std::memory_order_acq_rel) - 1;
  munmap(map_base, map_len);
  if (left <= 0) shm_unlink(name);
  return left;
}

// Creator-side release of the initial reference (no prior map held).
int64_t rlt_store_release(const char* name) {
  uint64_t payload_size, map_len;
  void* map_base;
  void* payload = rlt_store_map(name, &payload_size, &map_base, &map_len);
  if (payload == nullptr) return -EINVAL;
  auto* header = reinterpret_cast<StoreHeader*>(map_base);
  // drop the map's ref AND the creator's initial ref
  int64_t left = header->refcount.fetch_sub(2, std::memory_order_acq_rel) - 2;
  munmap(map_base, map_len);
  if (left <= 0) shm_unlink(name);
  return left;
}

// ------------------------------------------------------------------ //
// MPMC queue
// ------------------------------------------------------------------ //

int rlt_queue_create(const char* name, uint64_t capacity, uint64_t slot_bytes) {
  if (capacity == 0 || (capacity & (capacity - 1)) != 0) return -EINVAL;
  int fd = shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) return -errno;
  uint64_t total = sizeof(QueueHeader) + capacity * slot_stride(slot_bytes);
  if (ftruncate(fd, static_cast<off_t>(total)) != 0) {
    int err = -errno;
    close(fd);
    shm_unlink(name);
    return err;
  }
  void* mem = mmap(nullptr, total, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (mem == MAP_FAILED) {
    shm_unlink(name);
    return -errno;
  }
  auto* header = new (mem) QueueHeader();
  header->magic = kQueueMagic;
  header->capacity = capacity;
  header->slot_bytes = slot_bytes;
  header->enqueue_pos.store(0, std::memory_order_relaxed);
  header->dequeue_pos.store(0, std::memory_order_relaxed);
  for (uint64_t i = 0; i < capacity; ++i)
    slot_at(header, i)->sequence.store(i, std::memory_order_relaxed);
  munmap(mem, total);
  return 0;
}

void* rlt_queue_attach(const char* name, void** map_base, uint64_t* map_len) {
  int fd = shm_open(name, O_RDWR, 0600);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return nullptr;
  }
  void* mem = mmap(nullptr, st.st_size, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (mem == MAP_FAILED) return nullptr;
  auto* header = reinterpret_cast<QueueHeader*>(mem);
  if (header->magic != kQueueMagic) {
    munmap(mem, st.st_size);
    return nullptr;
  }
  *map_base = mem;
  *map_len = static_cast<uint64_t>(st.st_size);
  return mem;
}

void rlt_queue_detach(void* map_base, uint64_t map_len) {
  munmap(map_base, map_len);
}

void rlt_queue_unlink(const char* name) { shm_unlink(name); }

// Vyukov MPMC push. Returns 0 ok, -EAGAIN full, -EMSGSIZE too big.
int rlt_queue_push(void* queue, const uint8_t* data, uint32_t size) {
  auto* header = reinterpret_cast<QueueHeader*>(queue);
  if (size > header->slot_bytes) return -EMSGSIZE;
  uint64_t pos = header->enqueue_pos.load(std::memory_order_relaxed);
  QueueSlot* slot;
  for (;;) {
    slot = slot_at(header, pos);
    uint64_t seq = slot->sequence.load(std::memory_order_acquire);
    intptr_t diff = static_cast<intptr_t>(seq) - static_cast<intptr_t>(pos);
    if (diff == 0) {
      if (header->enqueue_pos.compare_exchange_weak(pos, pos + 1,
                                                    std::memory_order_relaxed))
        break;
    } else if (diff < 0) {
      return -EAGAIN;  // full
    } else {
      pos = header->enqueue_pos.load(std::memory_order_relaxed);
    }
  }
  slot->size.store(size, std::memory_order_relaxed);
  std::memcpy(reinterpret_cast<char*>(slot) + sizeof(QueueSlot), data, size);
  slot->sequence.store(pos + 1, std::memory_order_release);
  return 0;
}

// Vyukov MPMC pop into caller buffer. Returns payload size, -EAGAIN empty,
// -EMSGSIZE buffer too small (message NOT consumed — retry with a buffer of
// at least rlt_queue_slot_bytes()).
int64_t rlt_queue_pop(void* queue, uint8_t* out, uint32_t out_capacity) {
  auto* header = reinterpret_cast<QueueHeader*>(queue);
  uint64_t pos = header->dequeue_pos.load(std::memory_order_relaxed);
  QueueSlot* slot;
  for (;;) {
    slot = slot_at(header, pos);
    uint64_t seq = slot->sequence.load(std::memory_order_acquire);
    intptr_t diff =
        static_cast<intptr_t>(seq) - static_cast<intptr_t>(pos + 1);
    if (diff == 0) {
      // Capacity check BEFORE the claim so -EMSGSIZE never consumes the
      // message. The peeked size must be validated: between the two loads
      // another consumer may pop this slot and a producer recycle it with
      // a different size. Re-reading sequence after the size load closes
      // that window — a recycled slot carries seq = pos + capacity + 1, so
      // observing seq == pos+1 again proves the size belongs to the head
      // message at pos (2^64 ABA wrap is unreachable in practice).
      uint32_t size = slot->size.load(std::memory_order_relaxed);
      // the fence keeps the size load from sinking past the validating
      // re-load of sequence below
      std::atomic_thread_fence(std::memory_order_acquire);
      if (slot->sequence.load(std::memory_order_relaxed) != pos + 1) {
        pos = header->dequeue_pos.load(std::memory_order_relaxed);
        continue;
      }
      if (size > out_capacity) return -EMSGSIZE;  // not consumed
      if (header->dequeue_pos.compare_exchange_weak(pos, pos + 1,
                                                    std::memory_order_relaxed))
        break;
    } else if (diff < 0) {
      return -EAGAIN;  // empty
    } else {
      pos = header->dequeue_pos.load(std::memory_order_relaxed);
    }
  }
  uint32_t size = slot->size.load(std::memory_order_relaxed);
  std::memcpy(out, reinterpret_cast<char*>(slot) + sizeof(QueueSlot), size);
  slot->sequence.store(pos + header->capacity, std::memory_order_release);
  return static_cast<int64_t>(size);
}

uint64_t rlt_queue_slot_bytes(void* queue) {
  return reinterpret_cast<QueueHeader*>(queue)->slot_bytes;
}

// Approximate occupancy (racy by nature; exact when quiescent).
uint64_t rlt_queue_size(void* queue) {
  auto* header = reinterpret_cast<QueueHeader*>(queue);
  uint64_t enq = header->enqueue_pos.load(std::memory_order_acquire);
  uint64_t deq = header->dequeue_pos.load(std::memory_order_acquire);
  return enq >= deq ? enq - deq : 0;
}

}  // extern "C"
