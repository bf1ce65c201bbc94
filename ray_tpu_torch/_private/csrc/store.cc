// plasmax — shared-memory object store for the TPU-native runtime.
//
// Role-equivalent to the reference's plasma store
// (reference: src/ray/object_manager/plasma/{store.cc,object_lifecycle_manager.cc,
// eviction_policy.cc,plasma_allocator.cc}) but redesigned for this runtime:
// instead of a store *server* process with a unix-socket protocol and fd
// passing, the store is a single shared-memory segment (one mmap'd file in
// /dev/shm per node) that every worker process maps directly. All metadata —
// object index, free list, LRU queue — lives inside the segment, guarded by a
// process-shared robust mutex, so create/get/seal are a few hundred ns with no
// IPC round-trip. Rationale: on a TPU host the store's job is staging host
// arrays for jax.device_put / checkpointing; eliminating the socket hop is the
// TPU-first redesign of plasma's client protocol.
//
// Layout of the segment:
//   [Header][Slot * nslots][data heap ...]
// Object index: open-addressed hash table (linear probe) keyed by 24-byte
// object IDs. Allocator: first-fit free list with coalescing, 64-byte aligned
// payloads (zero-copy numpy/jax views need alignment). Eviction: LRU over
// sealed refcount==0 objects (reference: eviction_policy.cc LRU semantics).

#include <cstdint>
#include <cstring>
#include <pthread.h>
#include <cerrno>

namespace {

constexpr uint64_t kMagic = 0x504c41534d415859ULL;  // "PLASMAXY"
constexpr uint64_t kAlign = 64;
constexpr int kIdSize = 24;

enum SlotState : uint8_t {
  kEmpty = 0,
  kCreated = 1,   // allocated, not yet sealed (writer filling it)
  kSealed = 2,    // immutable, readable
  kTombstone = 3, // deleted; probe chains continue through it
};

struct Slot {
  uint8_t id[kIdSize];
  uint8_t state;
  int32_t refcnt;
  uint64_t offset;  // payload offset from segment base
  uint64_t size;
  // LRU doubly-linked list of evictable (sealed, refcnt==0) objects.
  // Values are slot_index + 1; 0 means "not linked".
  uint64_t lru_prev;
  uint64_t lru_next;
};

struct FreeBlock {
  uint64_t size;  // includes this header
  uint64_t next;  // offset of next free block from base; 0 = end
};

struct Header {
  uint64_t magic;
  pthread_mutex_t mutex;
  uint64_t total_size;   // whole segment
  uint64_t data_off;     // start of heap
  uint64_t data_size;    // heap bytes
  uint32_t nslots;       // power of two
  uint32_t nlive;        // created+sealed slots
  uint64_t used_bytes;   // allocated heap bytes (incl. block headers)
  uint64_t free_head;    // offset of first free block; 0 = none
  uint64_t lru_head;     // slot_index+1 of least-recently-used evictable
  uint64_t lru_tail;     // most-recently-used end
  // stats
  uint64_t num_created;
  uint64_t num_evicted;
  uint64_t bytes_evicted;
};

inline Slot* slots(void* base) {
  return reinterpret_cast<Slot*>(static_cast<char*>(base) + sizeof(Header));
}

inline uint64_t hash_id(const uint8_t* id) {
  // FNV-1a over the 24-byte id.
  uint64_t h = 14695981039346656037ULL;
  for (int i = 0; i < kIdSize; i++) {
    h ^= id[i];
    h *= 1099511628211ULL;
  }
  return h;
}

class Locker {
 public:
  explicit Locker(Header* h) : h_(h) {
    int rc = pthread_mutex_lock(&h_->mutex);
    if (rc == EOWNERDEAD) {
      // A process died holding the lock; state is still consistent enough for
      // metadata (we never leave multi-step invariants broken across ops).
      pthread_mutex_consistent(&h_->mutex);
    }
  }
  ~Locker() { pthread_mutex_unlock(&h_->mutex); }

 private:
  Header* h_;
};

// ---- slot index -------------------------------------------------------------

Slot* find_slot(void* base, const uint8_t* id) {
  Header* h = static_cast<Header*>(base);
  Slot* tab = slots(base);
  uint64_t mask = h->nslots - 1;
  uint64_t i = hash_id(id) & mask;
  for (uint32_t probe = 0; probe < h->nslots; probe++, i = (i + 1) & mask) {
    Slot& s = tab[i];
    if (s.state == kEmpty) return nullptr;
    if (s.state != kTombstone && memcmp(s.id, id, kIdSize) == 0) return &s;
  }
  return nullptr;
}

Slot* alloc_slot(void* base, const uint8_t* id) {
  Header* h = static_cast<Header*>(base);
  Slot* tab = slots(base);
  uint64_t mask = h->nslots - 1;
  uint64_t i = hash_id(id) & mask;
  Slot* first_free = nullptr;
  for (uint32_t probe = 0; probe < h->nslots; probe++, i = (i + 1) & mask) {
    Slot& s = tab[i];
    if (s.state == kEmpty) {
      return first_free ? first_free : &s;
    }
    if (s.state == kTombstone) {
      if (!first_free) first_free = &s;
    } else if (memcmp(s.id, id, kIdSize) == 0) {
      return nullptr;  // already exists
    }
  }
  return first_free;  // table full unless a tombstone was found
}

// ---- LRU list ---------------------------------------------------------------

inline uint64_t slot_index(void* base, Slot* s) {
  return static_cast<uint64_t>(s - slots(base));
}

void lru_unlink(void* base, Slot* s) {
  Header* h = static_cast<Header*>(base);
  Slot* tab = slots(base);
  if (s->lru_prev) tab[s->lru_prev - 1].lru_next = s->lru_next;
  else if (h->lru_head == slot_index(base, s) + 1) h->lru_head = s->lru_next;
  if (s->lru_next) tab[s->lru_next - 1].lru_prev = s->lru_prev;
  else if (h->lru_tail == slot_index(base, s) + 1) h->lru_tail = s->lru_prev;
  s->lru_prev = s->lru_next = 0;
}

void lru_push_tail(void* base, Slot* s) {
  Header* h = static_cast<Header*>(base);
  Slot* tab = slots(base);
  uint64_t me = slot_index(base, s) + 1;
  s->lru_prev = h->lru_tail;
  s->lru_next = 0;
  if (h->lru_tail) tab[h->lru_tail - 1].lru_next = me;
  h->lru_tail = me;
  if (!h->lru_head) h->lru_head = me;
}

// ---- allocator --------------------------------------------------------------

inline uint64_t round_up(uint64_t v, uint64_t a) { return (v + a - 1) & ~(a - 1); }

inline FreeBlock* block_at(void* base, uint64_t off) {
  return reinterpret_cast<FreeBlock*>(static_cast<char*>(base) + off);
}

// Allocates `payload` bytes; returns payload offset or 0 on failure.
// Block layout: [uint64 block_size][pad to kAlign][payload]. block_size is
// stashed kAlign bytes before the payload so free() can find it.
uint64_t heap_alloc(void* base, uint64_t payload) {
  Header* h = static_cast<Header*>(base);
  uint64_t need = round_up(payload + kAlign, kAlign);
  uint64_t prev_off = 0;
  uint64_t off = h->free_head;
  while (off) {
    FreeBlock* b = block_at(base, off);
    if (b->size >= need) {
      uint64_t remain = b->size - need;
      uint64_t next;
      if (remain >= 2 * kAlign) {
        // split: keep the tail as a free block
        uint64_t tail_off = off + need;
        FreeBlock* tail = block_at(base, tail_off);
        tail->size = remain;
        tail->next = b->next;
        next = tail_off;
      } else {
        need = b->size;  // absorb the sliver
        next = b->next;
      }
      if (prev_off) block_at(base, prev_off)->next = next;
      else h->free_head = next;
      *reinterpret_cast<uint64_t*>(static_cast<char*>(base) + off) = need;
      h->used_bytes += need;
      return off + kAlign;
    }
    prev_off = off;
    off = b->next;
  }
  return 0;
}

void heap_free(void* base, uint64_t payload_off) {
  Header* h = static_cast<Header*>(base);
  uint64_t off = payload_off - kAlign;
  uint64_t size = *reinterpret_cast<uint64_t*>(static_cast<char*>(base) + off);
  h->used_bytes -= size;
  // insert into address-ordered free list, coalescing neighbors
  uint64_t prev = 0, cur = h->free_head;
  while (cur && cur < off) {
    prev = cur;
    cur = block_at(base, cur)->next;
  }
  uint64_t self = off;
  uint64_t self_size = size;
  // coalesce with next
  if (cur && self + self_size == cur) {
    self_size += block_at(base, cur)->size;
    cur = block_at(base, cur)->next;
  }
  // coalesce with prev
  if (prev && prev + block_at(base, prev)->size == self) {
    block_at(base, prev)->size += self_size;
    block_at(base, prev)->next = cur;
    return;
  }
  FreeBlock* b = block_at(base, self);
  b->size = self_size;
  b->next = cur;
  if (prev) block_at(base, prev)->next = self;
  else h->free_head = self;
}

void remove_object(void* base, Slot* s) {
  Header* h = static_cast<Header*>(base);
  lru_unlink(base, s);
  heap_free(base, s->offset);
  s->state = kTombstone;
  h->nlive--;
}

// Evict LRU sealed refcnt==0 objects until at least `need` payload bytes could
// plausibly be allocated. Returns number evicted.
int evict_for(void* base, uint64_t need) {
  Header* h = static_cast<Header*>(base);
  Slot* tab = slots(base);
  int n = 0;
  while (h->lru_head) {
    // heuristic: stop once free space exceeds need + headers
    if (h->data_size - h->used_bytes >= round_up(need + kAlign, kAlign) * 2) break;
    Slot* victim = &tab[h->lru_head - 1];
    h->num_evicted++;
    h->bytes_evicted += victim->size;
    remove_object(base, victim);
    n++;
  }
  return n;
}

}  // namespace

extern "C" {

// TEST HOOK: acquire the segment mutex and return WITHOUT releasing it.
// Lets a test process die while holding the lock, so the robust-mutex
// EOWNERDEAD recovery path (Locker above) can be exercised
// deterministically from the crash-recovery test suite.
int px_debug_lock(void* base) {
  Header* h = static_cast<Header*>(base);
  int rc = pthread_mutex_lock(&h->mutex);
  if (rc == EOWNERDEAD) {
    pthread_mutex_consistent(&h->mutex);
    return 1;
  }
  return rc == 0 ? 0 : -1;
}

// Returns required segment size for a given heap capacity + slot count.
uint64_t px_segment_size(uint64_t heap_bytes, uint32_t nslots) {
  return round_up(sizeof(Header) + sizeof(Slot) * nslots, kAlign) +
         round_up(heap_bytes, kAlign);
}

int px_init(void* base, uint64_t total_size, uint32_t nslots) {
  if (nslots == 0 || (nslots & (nslots - 1)) != 0) return -1;  // must be pow2
  Header* h = static_cast<Header*>(base);
  memset(h, 0, sizeof(Header));
  pthread_mutexattr_t attr;
  pthread_mutexattr_init(&attr);
  pthread_mutexattr_setpshared(&attr, PTHREAD_PROCESS_SHARED);
  pthread_mutexattr_setrobust(&attr, PTHREAD_MUTEX_ROBUST);
  pthread_mutex_init(&h->mutex, &attr);
  pthread_mutexattr_destroy(&attr);
  h->total_size = total_size;
  h->nslots = nslots;
  memset(slots(base), 0, sizeof(Slot) * nslots);
  h->data_off = round_up(sizeof(Header) + sizeof(Slot) * nslots, kAlign);
  h->data_size = total_size - h->data_off;
  FreeBlock* first = block_at(base, h->data_off);
  first->size = h->data_size;
  first->next = 0;
  h->free_head = h->data_off;
  h->magic = kMagic;  // last: marks segment valid
  return 0;
}

int px_attach_check(void* base) {
  return static_cast<Header*>(base)->magic == kMagic ? 0 : -1;
}

// Create an object. Returns 0 ok (payload offset in *out_off), -1 exists,
// -2 out of memory (after eviction), -3 index full.
int px_create(void* base, const uint8_t* id, uint64_t size, uint64_t* out_off) {
  Header* h = static_cast<Header*>(base);
  Locker lk(h);
  if (find_slot(base, id)) return -1;
  if (h->nlive >= h->nslots - (h->nslots >> 2)) return -3;  // keep load < 75%
  uint64_t off = heap_alloc(base, size);
  if (!off) {
    evict_for(base, size);
    off = heap_alloc(base, size);
    if (!off) return -2;
  }
  Slot* s = alloc_slot(base, id);
  if (!s) {
    heap_free(base, off);
    return -3;
  }
  memcpy(s->id, id, kIdSize);
  s->state = kCreated;
  s->refcnt = 1;  // creator holds a ref until seal+release
  s->offset = off;
  s->size = size;
  s->lru_prev = s->lru_next = 0;
  h->nlive++;
  h->num_created++;
  *out_off = off;
  return 0;
}

int px_seal(void* base, const uint8_t* id) {
  Header* h = static_cast<Header*>(base);
  Locker lk(h);
  Slot* s = find_slot(base, id);
  if (!s || s->state != kCreated) return -1;
  s->state = kSealed;
  return 0;
}

// Abort an unsealed create (writer failed): frees the allocation.
int px_abort(void* base, const uint8_t* id) {
  Header* h = static_cast<Header*>(base);
  Locker lk(h);
  Slot* s = find_slot(base, id);
  if (!s || s->state != kCreated) return -1;
  remove_object(base, s);
  return 0;
}

// Get a sealed object: increments refcount, pins it (unlinks from LRU).
// Returns 0 ok, -1 not found, -2 not sealed yet.
int px_get(void* base, const uint8_t* id, uint64_t* out_off, uint64_t* out_size) {
  Header* h = static_cast<Header*>(base);
  Locker lk(h);
  Slot* s = find_slot(base, id);
  if (!s) return -1;
  if (s->state != kSealed) return -2;
  if (s->refcnt == 0) lru_unlink(base, s);
  s->refcnt++;
  *out_off = s->offset;
  *out_size = s->size;
  return 0;
}

// Release a reference (creator calls once after seal; getters once per get).
// When refcount hits 0 the object becomes evictable (joins LRU tail).
int px_release(void* base, const uint8_t* id) {
  Header* h = static_cast<Header*>(base);
  Locker lk(h);
  Slot* s = find_slot(base, id);
  if (!s || s->refcnt <= 0) return -1;
  s->refcnt--;
  if (s->refcnt == 0 && s->state == kSealed) lru_push_tail(base, s);
  return 0;
}

// Recycle a sealed buffer for in-place rewrite (compiled-DAG channel rings:
// the writer creates the slot once, keeps its creator pin, and cycles
// seal→unseal→refill→seal per invocation — zero allocator churn, so segment
// usage stays flat across repeated graph executions). Requires exactly the
// creator's pin outstanding (refcnt==1): a reader mid-get returns -2 and the
// writer retries. -1 not found / not sealed.
int px_unseal(void* base, const uint8_t* id, uint64_t* out_off) {
  Header* h = static_cast<Header*>(base);
  Locker lk(h);
  Slot* s = find_slot(base, id);
  if (!s || s->state != kSealed) return -1;
  if (s->refcnt != 1) return -2;
  s->state = kCreated;
  *out_off = s->offset;
  return 0;
}

// Delete a sealed object with no outstanding refs. -1 not found, -2 in use.
int px_delete(void* base, const uint8_t* id) {
  Header* h = static_cast<Header*>(base);
  Locker lk(h);
  Slot* s = find_slot(base, id);
  if (!s) return -1;
  if (s->refcnt > 0) return -2;
  remove_object(base, s);
  return 0;
}

int px_contains(void* base, const uint8_t* id) {
  Header* h = static_cast<Header*>(base);
  Locker lk(h);
  Slot* s = find_slot(base, id);
  return (s && s->state == kSealed) ? 1 : 0;
}

// Debug/introspection: current reference count, or -1 if absent.
int px_refcount(void* base, const uint8_t* id) {
  Header* h = static_cast<Header*>(base);
  Locker lk(h);
  Slot* s = find_slot(base, id);
  return s ? static_cast<int>(s->refcnt) : -1;
}

// Pin/unpin: primary copies are pinned by the owning raylet so LRU eviction
// never drops the last copy (reference: pinned objects in local_object_manager).
int px_pin(void* base, const uint8_t* id) {
  Header* h = static_cast<Header*>(base);
  Locker lk(h);
  Slot* s = find_slot(base, id);
  if (!s || s->state != kSealed) return -1;
  if (s->refcnt == 0) lru_unlink(base, s);
  s->refcnt++;
  return 0;
}

uint64_t px_used_bytes(void* base) { return static_cast<Header*>(base)->used_bytes; }
uint64_t px_capacity(void* base) { return static_cast<Header*>(base)->data_size; }
uint64_t px_num_objects(void* base) { return static_cast<Header*>(base)->nlive; }
uint64_t px_num_evicted(void* base) { return static_cast<Header*>(base)->num_evicted; }

// Batched stats readout for metrics export.
void px_stats(void* base, uint64_t* out6) {
  Header* h = static_cast<Header*>(base);
  Locker lk(h);
  out6[0] = h->used_bytes;
  out6[1] = h->data_size;
  out6[2] = h->nlive;
  out6[3] = h->num_created;
  out6[4] = h->num_evicted;
  out6[5] = h->bytes_evicted;
}

}  // extern "C"
