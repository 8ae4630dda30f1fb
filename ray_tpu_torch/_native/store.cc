// Shared-memory arena object store (plasma analog).
//
// Reference: src/ray/object_manager/plasma/ — an mmap'd arena
// (plasma/dlmalloc.cc) holding immutable objects behind an object
// index with create/seal/get/release/delete + LRU eviction
// (object_lifecycle_manager.h, eviction_policy.h). This is the
// TPU-native C++ equivalent: one arena file per node under /dev/shm,
// a process-shared mutex guarding a fixed-slot index + first-fit
// free list with coalescing, and 64-byte aligned payloads so mapped
// buffers feed jax.numpy/dlpack zero-copy.
//
// Exported as a C ABI for the ctypes binding in
// ray_tpu/_native/__init__.py (the environment provides no pybind11;
// ctypes over a stable C surface is the supported binding path).

#include <cerrno>
#include <csignal>
#include <cstdint>
#include <cstring>

#include <fcntl.h>
#include <linux/futex.h>
#include <pthread.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <sys/syscall.h>
#include <time.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMagic = 0x5254535052455632ULL;  // "RTSTOREV2"
constexpr uint32_t kOidBytes = 20;
constexpr uint32_t kAlign = 64;
// Distinct live reader pids tracked per slot; a pin beyond this is
// still taken (reader safety first) but lands in untracked_pins and
// cannot be crash-reclaimed, so keep headroom above the typical
// workers-per-host concurrency on one hot object.
constexpr uint32_t kPinRecsPerSlot = 4;

enum SlotState : uint32_t {
  kFree = 0,
  kCreating = 1,
  kSealed = 2,
  // Deleted while readers still hold pins: invisible to lookups, the
  // range is freed when the last pin drops (plasma defers free to the
  // last client Release the same way).
  kDoomed = 3,
};

struct Slot {
  uint8_t oid[kOidBytes];
  uint32_t state;
  uint32_t pins;
  uint64_t offset;  // into the data heap
  uint64_t size;
  uint64_t lru_tick;
};

// Free-list node stored inside the header's node pool (not in the data
// heap itself, so payload memory stays payload-only).
struct FreeNode {
  uint64_t offset;
  uint64_t size;
  int32_t next;  // index into node pool, -1 == end
  int32_t in_use;
};

// Per-(process, slot) pin accounting so a crashed reader's pins can be
// reclaimed (plasma reclaims a dead client's refs when its socket
// drops; the serverless arena uses pid liveness instead).
struct PinRec {
  int32_t pid;
  int32_t slot;
  uint32_t count;
  uint32_t in_use;
};

struct Header {
  uint64_t magic;
  uint64_t capacity;       // data heap bytes
  uint64_t used;           // allocated bytes
  uint64_t lru_clock;
  uint32_t num_slots;
  uint32_t num_free_nodes;
  int32_t free_head;       // free-list head (node index)
  uint32_t num_pin_recs;
  uint32_t initialized;
  uint32_t _pad;
  // Pins taken while a slot's ledger bucket was full (>kPinRecsPerSlot
  // distinct live pids on one slot): safe but not crash-reclaimable.
  uint64_t untracked_pins;
  pthread_mutex_t mutex;
  // Slot table, node pool, and pin ledger follow; data heap after.
};

struct Handle {
  int fd;
  uint8_t* map;
  uint64_t map_size;
  Header* header;
  Slot* slots;
  FreeNode* nodes;
  PinRec* pins;
  uint8_t* heap;
};

uint64_t AlignUp(uint64_t v, uint64_t a) { return (v + a - 1) / a * a; }

Slot* FindSlot(Handle* h, const uint8_t* oid) {
  // Linear probe from the oid's hash position. Doomed slots are
  // invisible by oid: a deleted-while-pinned object must not block
  // re-creation of the same (immutable) object id by lineage
  // reconstruction — the doomed slot is reachable only through the
  // pin ledger's slot index until its last pin drops.
  uint64_t hash = 1469598103934665603ULL;
  for (uint32_t i = 0; i < kOidBytes; ++i) {
    hash = (hash ^ oid[i]) * 1099511628211ULL;
  }
  const uint32_t n = h->header->num_slots;
  for (uint32_t probe = 0; probe < n; ++probe) {
    Slot* slot = &h->slots[(hash + probe) % n];
    if (slot->state != kFree && slot->state != kDoomed &&
        memcmp(slot->oid, oid, kOidBytes) == 0) {
      return slot;
    }
  }
  return nullptr;
}

void DeleteSlotLocked(Handle* h, Slot* slot);

// Ledger helpers (call with the arena mutex held). Recs are bucketed:
// slot i owns indices [i*kPinRecsPerSlot, (i+1)*kPinRecsPerSlot), so
// pin/unpin touch O(kPinRecsPerSlot) entries, not the whole ledger.
PinRec* FindPinRec(Handle* h, int32_t pid, int32_t slot) {
  for (uint32_t k = 0; k < kPinRecsPerSlot; ++k) {
    PinRec* rec = &h->pins[slot * kPinRecsPerSlot + k];
    if (rec->in_use && rec->pid == pid) return rec;
  }
  return nullptr;
}

// Reclaim bucket entries owned by dead pids (without freeing the slot
// itself — callers handle doomed-slot cleanup).
void ReapBucketLocked(Handle* h, int32_t slot_index) {
  Slot* slot = &h->slots[slot_index];
  for (uint32_t k = 0; k < kPinRecsPerSlot; ++k) {
    PinRec* rec = &h->pins[slot_index * kPinRecsPerSlot + k];
    if (rec->in_use && kill(rec->pid, 0) != 0 && errno == ESRCH) {
      slot->pins =
          (slot->pins > rec->count) ? slot->pins - rec->count : 0;
      rec->in_use = 0;
    }
  }
}

PinRec* AllocPinRec(Handle* h, int32_t slot) {
  for (uint32_t k = 0; k < kPinRecsPerSlot; ++k) {
    PinRec* rec = &h->pins[slot * kPinRecsPerSlot + k];
    if (!rec->in_use) return rec;
  }
  // Bucket full: entries may belong to dead pids — reap and retry so
  // OOM-killed readers can't permanently exhaust a slot's bucket.
  ReapBucketLocked(h, slot);
  for (uint32_t k = 0; k < kPinRecsPerSlot; ++k) {
    PinRec* rec = &h->pins[slot * kPinRecsPerSlot + k];
    if (!rec->in_use) return rec;
  }
  return nullptr;
}

void FreeDoomedIfUnpinned(Handle* h, Slot* slot) {
  if (slot->state == kDoomed && slot->pins == 0) {
    DeleteSlotLocked(h, slot);
  }
}

Slot* FindEmptySlot(Handle* h, const uint8_t* oid) {
  uint64_t hash = 1469598103934665603ULL;
  for (uint32_t i = 0; i < kOidBytes; ++i) {
    hash = (hash ^ oid[i]) * 1099511628211ULL;
  }
  const uint32_t n = h->header->num_slots;
  for (uint32_t probe = 0; probe < n; ++probe) {
    Slot* slot = &h->slots[(hash + probe) % n];
    if (slot->state == kFree) return slot;
  }
  return nullptr;
}

int32_t AllocNode(Handle* h) {
  for (uint32_t i = 0; i < h->header->num_free_nodes; ++i) {
    if (!h->nodes[i].in_use) {
      h->nodes[i].in_use = 1;
      return static_cast<int32_t>(i);
    }
  }
  return -1;
}

// First-fit allocation from the free list.
int64_t HeapAlloc(Handle* h, uint64_t size) {
  Header* hd = h->header;
  int32_t prev = -1;
  int32_t cur = hd->free_head;
  while (cur >= 0) {
    FreeNode* node = &h->nodes[cur];
    if (node->size >= size) {
      uint64_t offset = node->offset;
      if (node->size == size) {
        if (prev < 0) hd->free_head = node->next;
        else h->nodes[prev].next = node->next;
        node->in_use = 0;
      } else {
        node->offset += size;
        node->size -= size;
      }
      hd->used += size;
      return static_cast<int64_t>(offset);
    }
    prev = cur;
    cur = node->next;
  }
  return -1;
}

// Insert a free range, merging neighbors (offset-sorted list).
void HeapFree(Handle* h, uint64_t offset, uint64_t size) {
  Header* hd = h->header;
  hd->used -= size;
  int32_t prev = -1;
  int32_t cur = hd->free_head;
  while (cur >= 0 && h->nodes[cur].offset < offset) {
    prev = cur;
    cur = h->nodes[cur].next;
  }
  // Merge with previous?
  if (prev >= 0 &&
      h->nodes[prev].offset + h->nodes[prev].size == offset) {
    h->nodes[prev].size += size;
    // Merge previous with current?
    if (cur >= 0 && h->nodes[prev].offset + h->nodes[prev].size ==
                        h->nodes[cur].offset) {
      h->nodes[prev].size += h->nodes[cur].size;
      h->nodes[prev].next = h->nodes[cur].next;
      h->nodes[cur].in_use = 0;
    }
    return;
  }
  // Merge with current?
  if (cur >= 0 && offset + size == h->nodes[cur].offset) {
    h->nodes[cur].offset = offset;
    h->nodes[cur].size += size;
    return;
  }
  int32_t fresh = AllocNode(h);
  if (fresh < 0) return;  // node pool exhausted: leak range (rare)
  h->nodes[fresh].offset = offset;
  h->nodes[fresh].size = size;
  h->nodes[fresh].next = cur;
  if (prev < 0) hd->free_head = fresh;
  else h->nodes[prev].next = fresh;
}

void DeleteSlotLocked(Handle* h, Slot* slot) {
  HeapFree(h, slot->offset, AlignUp(slot->size ? slot->size : 1, kAlign));
  slot->state = kFree;
  slot->pins = 0;
}

// Evict the single LRU sealed+unpinned object; false if none exists.
bool EvictOneLocked(Handle* h, uint8_t* evicted_out, int* count,
                    int max_evicted) {
  if (*count >= max_evicted) return false;
  Header* hd = h->header;
  Slot* victim = nullptr;
  for (uint32_t i = 0; i < hd->num_slots; ++i) {
    Slot* slot = &h->slots[i];
    if (slot->state == kSealed && slot->pins == 0 &&
        (victim == nullptr || slot->lru_tick < victim->lru_tick)) {
      victim = slot;
    }
  }
  if (victim == nullptr) return false;
  memcpy(evicted_out + *count * kOidBytes, victim->oid, kOidBytes);
  ++(*count);
  DeleteSlotLocked(h, victim);
  return true;
}

class Locker {
 public:
  explicit Locker(Handle* h) : h_(h) {
    int rc = pthread_mutex_lock(&h_->header->mutex);
    if (rc == EOWNERDEAD) {
      // A process died holding the lock (e.g. the OOM killer SIGKILLed
      // a worker mid-create). The shared state may hold a CREATING
      // slot that will never seal — acceptable garbage — but the
      // mutex must be marked consistent or it becomes permanently
      // unusable (ENOTRECOVERABLE) for every process.
      pthread_mutex_consistent(&h_->header->mutex);
    }
  }
  ~Locker() { pthread_mutex_unlock(&h_->header->mutex); }

 private:
  Handle* h_;
};

}  // namespace

extern "C" {

// Error codes.
#define RTS_OK 0
#define RTS_ERR_EXISTS -2
#define RTS_ERR_FULL -3
#define RTS_ERR_MISSING -4
#define RTS_ERR_STATE -5
#define RTS_ERR_SYS -6

void* rts_open(const char* path, uint64_t capacity, uint32_t num_slots,
               int create) {
  const uint64_t node_pool = num_slots;  // one free node per slot
  const uint64_t pin_pool = num_slots * kPinRecsPerSlot;
  const uint64_t meta_size =
      AlignUp(sizeof(Header) + num_slots * sizeof(Slot) +
                  node_pool * sizeof(FreeNode) +
                  pin_pool * sizeof(PinRec),
              kAlign);
  const uint64_t total = meta_size + capacity;
  int fd = open(path, create ? (O_RDWR | O_CREAT) : O_RDWR, 0600);
  if (fd < 0) return nullptr;
  if (create) {
    if (ftruncate(fd, static_cast<off_t>(total)) != 0) {
      close(fd);
      return nullptr;
    }
  }
  struct stat st;
  if (fstat(fd, &st) != 0 || static_cast<uint64_t>(st.st_size) < total) {
    close(fd);
    return nullptr;
  }
  uint8_t* map = static_cast<uint8_t*>(mmap(
      nullptr, total, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0));
  if (map == MAP_FAILED) {
    close(fd);
    return nullptr;
  }
  Handle* h = new Handle;
  h->fd = fd;
  h->map = map;
  h->map_size = total;
  h->header = reinterpret_cast<Header*>(map);
  h->slots = reinterpret_cast<Slot*>(map + sizeof(Header));
  h->nodes = reinterpret_cast<FreeNode*>(
      map + sizeof(Header) + num_slots * sizeof(Slot));
  h->pins = reinterpret_cast<PinRec*>(
      map + sizeof(Header) + num_slots * sizeof(Slot) +
      node_pool * sizeof(FreeNode));
  h->heap = map + meta_size;
  if (create && h->header->initialized != 1) {
    Header* hd = h->header;
    memset(map, 0, meta_size);
    hd->magic = kMagic;
    hd->capacity = capacity;
    hd->used = 0;
    hd->lru_clock = 0;
    hd->num_slots = num_slots;
    hd->num_free_nodes = static_cast<uint32_t>(node_pool);
    hd->num_pin_recs = static_cast<uint32_t>(pin_pool);
    pthread_mutexattr_t attr;
    pthread_mutexattr_init(&attr);
    pthread_mutexattr_setpshared(&attr, PTHREAD_PROCESS_SHARED);
    pthread_mutexattr_setrobust(&attr, PTHREAD_MUTEX_ROBUST);
    pthread_mutex_init(&hd->mutex, &attr);
    h->nodes[0].offset = 0;
    h->nodes[0].size = capacity;
    h->nodes[0].next = -1;
    h->nodes[0].in_use = 1;
    hd->free_head = 0;
    __sync_synchronize();
    hd->initialized = 1;
  }
  if (h->header->magic != kMagic) {
    munmap(map, total);
    close(fd);
    delete h;
    return nullptr;
  }
  return h;
}

uint8_t* rts_base(void* handle) {
  return static_cast<Handle*>(handle)->heap;
}

int64_t rts_create(void* handle, const uint8_t* oid, uint64_t size,
                   uint8_t* evicted_out, int max_evicted,
                   int* n_evicted) {
  Handle* h = static_cast<Handle*>(handle);
  uint64_t need = AlignUp(size ? size : 1, kAlign);
  Locker lock(h);
  *n_evicted = 0;
  if (FindSlot(h, oid) != nullptr) return RTS_ERR_EXISTS;
  if (need > h->header->capacity) return RTS_ERR_FULL;
  // Keep evicting LRU victims until a contiguous range exists —
  // byte-count checks alone miss fragmentation (freed neighbors must
  // coalesce before a large allocation fits).
  int64_t offset = HeapAlloc(h, need);
  while (offset < 0 &&
         EvictOneLocked(h, evicted_out, n_evicted, max_evicted)) {
    offset = HeapAlloc(h, need);
  }
  if (offset < 0) return RTS_ERR_FULL;
  Slot* slot = FindEmptySlot(h, oid);
  if (slot == nullptr) {
    HeapFree(h, static_cast<uint64_t>(offset), need);
    return RTS_ERR_FULL;
  }
  memcpy(slot->oid, oid, kOidBytes);
  slot->state = kCreating;
  slot->pins = 0;
  slot->offset = static_cast<uint64_t>(offset);
  slot->size = size;
  slot->lru_tick = ++h->header->lru_clock;
#ifdef MADV_POPULATE_WRITE
  // Pre-fault the extent so the producer's memcpy streams into mapped
  // pages instead of paying a page fault per 4K (plasma pre-touches
  // its arena the same way). First writes to fresh /dev/shm pages
  // otherwise dominate large-object put latency. Best-effort: EINVAL
  // on old kernels is fine.
  madvise(h->heap + offset, need, MADV_POPULATE_WRITE);
#endif
  return offset;
}

int rts_seal(void* handle, const uint8_t* oid) {
  Handle* h = static_cast<Handle*>(handle);
  Locker lock(h);
  Slot* slot = FindSlot(h, oid);
  if (slot == nullptr) return RTS_ERR_MISSING;
  if (slot->state != kCreating) return RTS_ERR_STATE;
  slot->state = kSealed;
  return RTS_OK;
}

// Pin accounting for one slot (caller holds the arena lock): ledger
// record for crash reclaim, pin count, LRU touch, and the caller's
// view coordinates. Shared by rts_pin and rts_seal_pinned.
int64_t PinSlotLocked(Handle* h, Slot* slot, uint64_t* offset_out,
                      uint64_t* size_out) {
  int32_t index = static_cast<int32_t>(slot - h->slots);
  int32_t pid = static_cast<int32_t>(getpid());
  PinRec* rec = FindPinRec(h, pid, index);
  if (rec == nullptr) rec = AllocPinRec(h, index);
  if (rec != nullptr) {
    if (!rec->in_use) {
      rec->in_use = 1;
      rec->pid = pid;
      rec->slot = index;
      rec->count = 0;
    }
    rec->count += 1;
  } else {
    // Bucket exhaustion: still pin (reader safety beats reclaim).
    h->header->untracked_pins += 1;
  }
  slot->pins += 1;
  slot->lru_tick = ++h->header->lru_clock;
  *offset_out = slot->offset;
  *size_out = slot->size;
  return index;
}

// Seal + take a reader pin in ONE critical section. A creator that
// seals then pins in two calls leaves a window where the brand-new
// SEALED slot (pins == 0) is an LRU-eviction candidate — a concurrent
// create() in another process could destroy the only copy before the
// daemon's primary pin lands. Returns the slot index (>= 0) for
// rts_unpin_idx, with offset/size for the caller's view.
int64_t rts_seal_pinned(void* handle, const uint8_t* oid,
                        uint64_t* offset_out, uint64_t* size_out) {
  Handle* h = static_cast<Handle*>(handle);
  Locker lock(h);
  Slot* slot = FindSlot(h, oid);
  if (slot == nullptr) return RTS_ERR_MISSING;
  if (slot->state != kCreating) return RTS_ERR_STATE;
  slot->state = kSealed;
  return PinSlotLocked(h, slot, offset_out, size_out);
}

// Looks up a SEALED object; returns offset, fills size. -4 if absent
// or unsealed (sealed_only=0 accepts CREATING too).
int64_t rts_lookup(void* handle, const uint8_t* oid, uint64_t* size_out,
                   int sealed_only) {
  Handle* h = static_cast<Handle*>(handle);
  Locker lock(h);
  Slot* slot = FindSlot(h, oid);
  if (slot == nullptr) return RTS_ERR_MISSING;
  if (sealed_only && slot->state != kSealed) return RTS_ERR_MISSING;
  slot->lru_tick = ++h->header->lru_clock;
  *size_out = slot->size;
  return static_cast<int64_t>(slot->offset);
}

// Atomically pin the SEALED slot holding `oid` and report its
// offset/size under one critical section — the caller must build its
// view from these, never from a separate lookup, or a concurrent
// delete + re-create of the same oid could hand it an unpinned slot's
// memory (ABA). Returns the slot index (>=0) for rts_unpin_idx,
// RTS_ERR_MISSING if absent/doomed, RTS_ERR_STATE if not yet sealed.
// The ledger records (pid, slot, count) so rts_reap_dead_pins can
// reclaim pins of crashed readers.
int64_t rts_pin(void* handle, const uint8_t* oid, uint64_t* offset_out,
                uint64_t* size_out) {
  Handle* h = static_cast<Handle*>(handle);
  Locker lock(h);
  Slot* slot = FindSlot(h, oid);
  if (slot == nullptr) return RTS_ERR_MISSING;
  if (slot->state != kSealed) return RTS_ERR_STATE;
  return PinSlotLocked(h, slot, offset_out, size_out);
}

int rts_unpin_idx(void* handle, int32_t index) {
  Handle* h = static_cast<Handle*>(handle);
  Locker lock(h);
  if (index < 0 ||
      static_cast<uint32_t>(index) >= h->header->num_slots) {
    return RTS_ERR_MISSING;
  }
  Slot* slot = &h->slots[index];
  if (slot->state == kFree) return RTS_ERR_MISSING;
  PinRec* rec = FindPinRec(h, static_cast<int32_t>(getpid()), index);
  if (rec != nullptr) {
    rec->count -= 1;
    if (rec->count == 0) rec->in_use = 0;
  }
  if (slot->pins > 0) slot->pins -= 1;
  FreeDoomedIfUnpinned(h, slot);
  return RTS_OK;
}

// Reclaim pins held by processes that no longer exist. Returns the
// number of pins reclaimed. Intended for the node daemon's periodic
// maintenance tick (and before surfacing an arena-full error).
int rts_reap_dead_pins(void* handle) {
  Handle* h = static_cast<Handle*>(handle);
  Locker lock(h);
  int reclaimed = 0;
  for (uint32_t i = 0; i < h->header->num_pin_recs; ++i) {
    PinRec* rec = &h->pins[i];
    if (!rec->in_use) continue;
    if (kill(rec->pid, 0) != 0 && errno == ESRCH) {
      Slot* slot = &h->slots[i / kPinRecsPerSlot];
      uint32_t n = rec->count;
      if (slot->state != kFree) {
        slot->pins = (slot->pins > n) ? slot->pins - n : 0;
        FreeDoomedIfUnpinned(h, slot);
      }
      reclaimed += static_cast<int>(n);
      rec->in_use = 0;
    }
  }
  return reclaimed;
}

uint64_t rts_untracked_pins(void* handle) {
  Handle* h = static_cast<Handle*>(handle);
  Locker lock(h);
  return h->header->untracked_pins;
}

int rts_delete(void* handle, const uint8_t* oid) {
  Handle* h = static_cast<Handle*>(handle);
  Locker lock(h);
  Slot* slot = FindSlot(h, oid);
  if (slot == nullptr) return RTS_ERR_MISSING;
  if (slot->pins > 0) {
    // Readers still mapped: defer the free to the last unpin so their
    // zero-copy views stay valid (delete-while-mapped safety). The
    // doomed slot is invisible to FindSlot, so the oid can be
    // re-created immediately.
    slot->state = kDoomed;
    return RTS_OK;
  }
  DeleteSlotLocked(h, slot);
  return RTS_OK;
}

int rts_stats(void* handle, uint64_t* capacity, uint64_t* used,
              uint64_t* num_objects) {
  Handle* h = static_cast<Handle*>(handle);
  Locker lock(h);
  *capacity = h->header->capacity;
  *used = h->header->used;
  uint64_t count = 0;
  for (uint32_t i = 0; i < h->header->num_slots; ++i) {
    if (h->slots[i].state != kFree) ++count;
  }
  *num_objects = count;
  return RTS_OK;
}

void rts_close(void* handle, int unlink_file, const char* path) {
  Handle* h = static_cast<Handle*>(handle);
  munmap(h->map, h->map_size);
  close(h->fd);
  if (unlink_file && path != nullptr) unlink(path);
  delete h;
}

// Cross-process atomic accessors for shared-memory ring buffers
// (dag/channels.py): acquire/release orderings make the
// payload-then-counter publication pattern correct on any
// architecture, not just x86-TSO.
uint64_t rts_load_acq_u64(const void* p) {
  return __atomic_load_n(static_cast<const uint64_t*>(p),
                         __ATOMIC_ACQUIRE);
}

void rts_store_rel_u64(void* p, uint64_t v) {
  __atomic_store_n(static_cast<uint64_t*>(p), v, __ATOMIC_RELEASE);
}

// Futex doorbell for the SPSC channel counters (dag/channels.py).
// The waiter sleeps in the kernel on the LOW 32 bits of a u64
// head/tail counter (little-endian: the low word changes on every
// advance) instead of sleep-polling; the peer rings after each
// counter store. Non-PRIVATE futexes are required — the two sides
// are different processes mapping the same segment (reference
// semantics: mutable-object WaitForWritten/WaitForReadable,
// core_worker/experimental_mutable_object_manager.h:48,153).
int rts_futex_wait_u32(void* p, uint32_t expected, int64_t timeout_ns) {
  struct timespec ts;
  struct timespec* tsp = nullptr;
  if (timeout_ns >= 0) {
    ts.tv_sec = timeout_ns / 1000000000;
    ts.tv_nsec = timeout_ns % 1000000000;
    tsp = &ts;
  }
  long rc = syscall(SYS_futex, p, FUTEX_WAIT, expected, tsp, nullptr, 0);
  return rc == 0 ? 0 : -errno;
}

int rts_futex_wake(void* p, int n) {
  long rc = syscall(SYS_futex, p, FUTEX_WAKE, n, nullptr, nullptr, 0);
  return rc >= 0 ? static_cast<int>(rc) : -errno;
}

// ---------------------------------------------------------------------------
// Whole-operation SPSC ring put/get (dag/channels.py hot path).
//
// Same segment layout as the Python implementation (three u64s —
// head/tail/closed — then `capacity` data bytes), so the two
// implementations interoperate and pure Python remains the fallback
// when the toolchain is absent. Collapsing one put or get into a
// single FFI call matters because the Python path pays ~6 ctypes
// round-trips + interpreter bytecode per hop: measured 39us/hop
// two-process ping-pong vs a 6.9us OS-pipe floor on the 1-core CI
// box; this path closes most of that gap (MICROBENCH dag_hop_per_s).
//
// Returns: 0 / payload size on success; -EPIPE closed; -ETIMEDOUT
// deadline passed; -EMSGSIZE record exceeds capacity; -E2BIG caller
// buffer too small (cannot happen when out_cap >= capacity).
// ---------------------------------------------------------------------------

namespace {

constexpr uint64_t kChanHeader = 24;
// Bounded kernel waits so a peer that died WITHOUT setting the closed
// flag (SIGKILL) is noticed by the next deadline check instead of
// sleeping forever; close() rings the futex so the common case wakes
// immediately.
constexpr int64_t kChanWaitChunkNs = 200 * 1000 * 1000;

inline int64_t mono_now_ns() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return static_cast<int64_t>(ts.tv_sec) * 1000000000 + ts.tv_nsec;
}

inline void ring_copy_in(uint8_t* data, uint64_t cap, uint64_t pos,
                         const uint8_t* src, uint64_t n) {
  uint64_t off = pos % cap;
  uint64_t first = n < cap - off ? n : cap - off;
  memcpy(data + off, src, first);
  if (first < n) memcpy(data, src + first, n - first);
}

inline void ring_copy_out(const uint8_t* data, uint64_t cap, uint64_t pos,
                          uint8_t* dst, uint64_t n) {
  uint64_t off = pos % cap;
  uint64_t first = n < cap - off ? n : cap - off;
  memcpy(dst, data + off, first);
  if (first < n) memcpy(dst + first, data, n - first);
}

// Wait for the low u32 of the counter at `watch` to leave `snap`;
// honors an absolute deadline (deadline_ns < 0 = infinite).
inline int chan_wait(uint64_t* watch, uint32_t snap, int64_t deadline_ns) {
  int64_t chunk = kChanWaitChunkNs;
  if (deadline_ns >= 0) {
    int64_t left = deadline_ns - mono_now_ns();
    if (left <= 0) return -ETIMEDOUT;
    if (left < chunk) chunk = left;
  }
  struct timespec ts;
  ts.tv_sec = chunk / 1000000000;
  ts.tv_nsec = chunk % 1000000000;
  syscall(SYS_futex, watch, FUTEX_WAIT, snap, &ts, nullptr, 0);
  return 0;  // EAGAIN/EINTR/timeout chunks all just re-run the loop
}

}  // namespace

int rts_chan_put(void* base, uint64_t cap, const void* payload,
                 uint64_t len, int64_t timeout_ns) {
  uint8_t* b = static_cast<uint8_t*>(base);
  uint64_t* H = reinterpret_cast<uint64_t*>(b);
  uint64_t* T = reinterpret_cast<uint64_t*>(b + 8);
  uint64_t* C = reinterpret_cast<uint64_t*>(b + 16);
  uint8_t* data = b + kChanHeader;
  uint64_t record = len + 8;
  if (record > cap) return -EMSGSIZE;
  int64_t deadline = timeout_ns < 0 ? -1 : mono_now_ns() + timeout_ns;
  for (;;) {
    if (__atomic_load_n(C, __ATOMIC_ACQUIRE)) return -EPIPE;
    uint64_t head = __atomic_load_n(H, __ATOMIC_RELAXED);  // sole writer
    uint64_t tail = __atomic_load_n(T, __ATOMIC_ACQUIRE);
    if (cap - (head - tail) >= record) {
      ring_copy_in(data, cap, head, reinterpret_cast<uint8_t*>(&len), 8);
      ring_copy_in(data, cap, head + 8,
                   static_cast<const uint8_t*>(payload), len);
      __atomic_store_n(H, head + record, __ATOMIC_RELEASE);
      syscall(SYS_futex, H, FUTEX_WAKE, INT32_MAX, nullptr, nullptr, 0);
      return 0;
    }
    int rc = chan_wait(T, static_cast<uint32_t>(tail), deadline);
    if (rc != 0) return rc;
  }
}

int64_t rts_chan_get(void* base, uint64_t cap, void* out,
                     uint64_t out_cap, int64_t timeout_ns) {
  uint8_t* b = static_cast<uint8_t*>(base);
  uint64_t* H = reinterpret_cast<uint64_t*>(b);
  uint64_t* T = reinterpret_cast<uint64_t*>(b + 8);
  uint64_t* C = reinterpret_cast<uint64_t*>(b + 16);
  uint8_t* data = b + kChanHeader;
  int64_t deadline = timeout_ns < 0 ? -1 : mono_now_ns() + timeout_ns;
  for (;;) {
    uint64_t head = __atomic_load_n(H, __ATOMIC_ACQUIRE);
    uint64_t tail = __atomic_load_n(T, __ATOMIC_RELAXED);  // sole reader
    if (head - tail >= 8) {
      uint64_t size;
      ring_copy_out(data, cap, tail, reinterpret_cast<uint8_t*>(&size), 8);
      if (size > out_cap) return -E2BIG;
      ring_copy_out(data, cap, tail + 8, static_cast<uint8_t*>(out),
                    size);
      __atomic_store_n(T, tail + 8 + size, __ATOMIC_RELEASE);
      syscall(SYS_futex, T, FUTEX_WAKE, INT32_MAX, nullptr, nullptr, 0);
      return static_cast<int64_t>(size);
    }
    // Drain-before-close: records buffered ahead of a remote close()
    // are still delivered (matches the Python path's check order).
    if (__atomic_load_n(C, __ATOMIC_ACQUIRE)) return -EPIPE;
    int rc = chan_wait(H, static_cast<uint32_t>(head), deadline);
    if (rc != 0) return rc;
  }
}

}  // extern "C"
