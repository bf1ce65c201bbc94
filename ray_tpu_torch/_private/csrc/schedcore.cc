// schedcore — the raylet's dispatch hot loop in native code.
//
// Reference analogue: src/ray/raylet/scheduling/ — ClusterResourceData's
// fixed-point resource vectors (fixed_point.h), LocalTaskManager's
// per-SchedulingClass pending queues and
// DispatchScheduledTasksToWorkers (local_task_manager.cc:99), and
// placement_group_resource_manager.cc's conversion of committed bundles
// into node-local resource instances.  This is a re-design, not a port:
// one flat ledger owns the node pool, the per-bundle pools, and the
// concrete TPU chip sets, and a single poll() walks scheduling-class
// HEADS, atomically acquiring resources for every dispatchable task —
// the caller (the Python raylet) receives a batch of (task, chips)
// decisions and handles policy (spillback, worker pools, RPCs) above.
//
// Resources are fixed-point int64 at 1/10000 granularity (reference:
// fixed_point.h uses the same idea) so feasibility needs no float
// epsilon.  Built like src/plasmax: plain C ABI, loaded via ctypes,
// compiled on first use with g++.
//
// Semantics mirrored from the Python ledger (raylet.py):
//   - acquire is all-or-nothing: full demand + concrete chip IDs.
//   - a bundle-bound task is only feasible while its pool exists.
//   - releasing into a returned (gone) pool credits the NODE with the
//     chips (and the TPU count follows the chips) but NOT the other
//     resources — those were credited when the bundle was returned.
//   - returning a bundle credits non-TPU resources in full, but only
//     the chips physically in the pool rejoin the node; chips held by
//     a still-running task of the PG come back on its release.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <algorithm>
#include <deque>
#include <unordered_map>
#include <vector>

namespace {

typedef int64_t fp_t;  // fixed-point resource amount
static inline fp_t to_fp(double v) { return (fp_t)llround(v * 10000.0); }
// demands round to NEAREST with a nonzero floor: plain rounding keeps
// parity with the float ledger for non-representable fractions (three
// 1/3-CPU tasks fit on 1.0 CPU: 3*3333 <= 10000), while the floor
// keeps a sub-granularity demand (4e-5 of a resource the node lacks)
// from rounding to "free" and passing feasibility the float path fails
static inline fp_t to_fp_demand(double v) {
  fp_t fp = (fp_t)llround(v * 10000.0);
  if (fp == 0 && v > 0.0) fp = 1;
  return fp;
}
static inline double from_fp(fp_t v) { return (double)v / 10000.0; }

struct Pool {
  std::vector<fp_t> avail;          // indexed by resource id, lazily grown
  std::vector<int32_t> chips;       // sorted ascending
  std::vector<std::pair<int, fp_t>> committed;  // original bundle amounts
};

struct Prepared {                   // bundle between prepare and commit
  std::vector<std::pair<int, fp_t>> res;
  std::vector<int32_t> chips;
};

struct Class {
  std::vector<std::pair<int, fp_t>> demand;  // (res_id, amount)
  int tpu = 0;                // concrete chips needed
  long long bundle = -1;      // -1 = node pool
  std::deque<uint64_t> q;     // queued task tags, FIFO
  bool active = false;        // member of Core::active
};

struct Core {
  std::vector<fp_t> node_avail;
  std::vector<int32_t> node_chips;                 // sorted
  std::unordered_map<long long, Pool> pools;       // committed bundles
  std::unordered_map<long long, Prepared> prepared;
  std::vector<Class> classes;
  std::vector<int> active;                         // classes with queued work
  long long npending = 0;
  int tpu_res = -1;                                // res id of "TPU"
  size_t blocked_rot = 0;   // rotates blocked-head reporting (see scx_poll)
};

static inline fp_t vec_get(const std::vector<fp_t>& v, int id) {
  return (size_t)id < v.size() ? v[(size_t)id] : 0;
}
static inline void vec_add(std::vector<fp_t>& v, int id, fp_t amt) {
  if ((size_t)id >= v.size()) v.resize((size_t)id + 1, 0);
  v[(size_t)id] += amt;
}

static inline void chips_insert(std::vector<int32_t>& dst,
                                const int32_t* chips, int n) {
  if (n <= 0) return;
  dst.insert(dst.end(), chips, chips + n);
  std::sort(dst.begin(), dst.end());
}

// all-or-nothing feasibility of cls against its pool; does not mutate
static bool feasible(Core* c, const Class& k) {
  const std::vector<fp_t>* avail;
  const std::vector<int32_t>* chips;
  if (k.bundle >= 0) {
    auto it = c->pools.find(k.bundle);
    if (it == c->pools.end()) return false;   // pool gone / not committed
    avail = &it->second.avail;
    chips = &it->second.chips;
  } else {
    avail = &c->node_avail;
    chips = &c->node_chips;
  }
  if ((int)chips->size() < k.tpu) return false;
  for (const auto& d : k.demand)
    if (vec_get(*avail, d.first) < d.second) return false;
  return true;
}

// atomic take; fills chips_out; returns chip count or -1 when not
// feasible.  Callers bound the write: scx_poll via maxchips, scx_acquire
// via its maxout parameter.
static int acquire(Core* c, Class& k, int32_t* chips_out) {
  std::vector<fp_t>* avail;
  std::vector<int32_t>* chips;
  if (k.bundle >= 0) {
    auto it = c->pools.find(k.bundle);
    if (it == c->pools.end()) return -1;
    avail = &it->second.avail;
    chips = &it->second.chips;
  } else {
    avail = &c->node_avail;
    chips = &c->node_chips;
  }
  if ((int)chips->size() < k.tpu) return -1;
  for (const auto& d : k.demand)
    if (vec_get(*avail, d.first) < d.second) return -1;
  for (const auto& d : k.demand) vec_add(*avail, d.first, -d.second);
  for (int i = 0; i < k.tpu; i++) chips_out[i] = (*chips)[(size_t)i];
  chips->erase(chips->begin(), chips->begin() + k.tpu);
  return k.tpu;
}

static void activate(Core* c, int cls) {
  Class& k = c->classes[(size_t)cls];
  if (!k.active) { k.active = true; c->active.push_back(cls); }
}

}  // namespace

extern "C" {

void* scx_create() { return new Core(); }
void scx_destroy(void* h) { delete (Core*)h; }

void scx_set_tpu_res(void* h, int res) { ((Core*)h)->tpu_res = res; }

void scx_node_add(void* h, int res, double v) {
  vec_add(((Core*)h)->node_avail, res, to_fp(v));
}

double scx_node_get(void* h, int res) {
  return from_fp(vec_get(((Core*)h)->node_avail, res));
}

int scx_node_nres(void* h) { return (int)((Core*)h)->node_avail.size(); }

void scx_node_chips_add(void* h, const int32_t* chips, int n) {
  chips_insert(((Core*)h)->node_chips, chips, n);
}

int scx_node_chips(void* h, int32_t* out, int maxn) {
  Core* c = (Core*)h;
  int n = (int)std::min((size_t)maxn, c->node_chips.size());
  if (n > 0) memcpy(out, c->node_chips.data(), sizeof(int32_t) * (size_t)n);
  return (int)c->node_chips.size();
}

int scx_class(void* h, const int32_t* res, const double* amt, int n,
              int tpu, long long bundle) {
  Core* c = (Core*)h;
  Class k;
  k.demand.reserve((size_t)n);
  for (int i = 0; i < n; i++)
    k.demand.emplace_back(res[i], to_fp_demand(amt[i]));
  k.tpu = tpu;
  k.bundle = bundle;
  c->classes.push_back(std::move(k));
  return (int)c->classes.size() - 1;
}

// Tombstone empty classes so a long-lived raylet seeing many distinct
// demand vectors does not grow Core::classes without bound (the Python
// side drops its interning entries for the returned ids and a later
// identical demand re-interns a fresh class — accounting-neutral,
// because release() re-interns by demand, and bundle classes re-bind
// their pool through the still-interned bundle id).
int scx_gc(void* h, int32_t* freed, int maxn) {
  Core* c = (Core*)h;
  int n = 0;
  for (size_t ci = 0; ci < c->classes.size() && n < maxn; ci++) {
    Class& k = c->classes[ci];
    if (k.bundle == -2 || !k.q.empty() || k.active) continue;
    if (k.demand.empty() && k.tpu == 0 && k.bundle == -1)
      continue;  // already a tombstone-shaped empty class
    freed[n++] = (int32_t)ci;
    k.demand.clear();
    k.demand.shrink_to_fit();
    k.bundle = -2;
  }
  return n;
}

// ----------------------------------------------------------------- queues

void scx_push(void* h, int cls, uint64_t tag) {
  Core* c = (Core*)h;
  c->classes[(size_t)cls].q.push_back(tag);
  c->npending++;
  activate(c, cls);
}

void scx_push_front(void* h, int cls, uint64_t tag) {
  Core* c = (Core*)h;
  c->classes[(size_t)cls].q.push_front(tag);
  c->npending++;
  activate(c, cls);
}

int scx_remove(void* h, int cls, uint64_t tag) {
  Core* c = (Core*)h;
  auto& q = c->classes[(size_t)cls].q;
  for (auto it = q.begin(); it != q.end(); ++it)
    if (*it == tag) { q.erase(it); c->npending--; return 1; }
  return 0;
}

uint64_t scx_head(void* h, int cls) {
  auto& q = ((Core*)h)->classes[(size_t)cls].q;
  return q.empty() ? 0 : q.front();
}

uint64_t scx_pop_head(void* h, int cls) {
  Core* c = (Core*)h;
  auto& q = c->classes[(size_t)cls].q;
  if (q.empty()) return 0;
  uint64_t t = q.front();
  q.pop_front();
  c->npending--;
  return t;
}

long long scx_pending(void* h) { return ((Core*)h)->npending; }

// ------------------------------------------------------------- resources

int scx_feasible(void* h, int cls) {
  Core* c = (Core*)h;
  return feasible(c, c->classes[(size_t)cls]) ? 1 : 0;
}

int scx_acquire(void* h, int cls, int32_t* chips_out, int maxout) {
  Core* c = (Core*)h;
  Class& k = c->classes[(size_t)cls];
  if (k.tpu > maxout) return -1;  // caller's buffer cannot hold the chips
  return acquire(c, k, chips_out);
}

void scx_release(void* h, int cls, const int32_t* chips, int n) {
  Core* c = (Core*)h;
  Class& k = c->classes[(size_t)cls];
  if (k.bundle >= 0) {
    auto it = c->pools.find(k.bundle);
    if (it != c->pools.end()) {
      for (const auto& d : k.demand) vec_add(it->second.avail, d.first, d.second);
      chips_insert(it->second.chips, chips, n);
    } else {
      // bundle returned while the task ran: chips rejoin the NODE and
      // the node's TPU count follows them; nothing else is credited
      chips_insert(c->node_chips, chips, n);
      if (c->tpu_res >= 0)
        vec_add(c->node_avail, c->tpu_res, to_fp((double)n));
    }
    return;
  }
  for (const auto& d : k.demand) vec_add(c->node_avail, d.first, d.second);
  chips_insert(c->node_chips, chips, n);
}

// --------------------------------------------------------------- bundles

int scx_prepare(void* h, long long bundle, const int32_t* res,
                const double* amt, int n, int n_tpu) {
  Core* c = (Core*)h;
  if (c->prepared.count(bundle) || c->pools.count(bundle)) return 1;  // idempotent
  for (int i = 0; i < n; i++)
    if (vec_get(c->node_avail, res[i]) < to_fp_demand(amt[i])) return 0;
  if ((int)c->node_chips.size() < n_tpu) return 0;
  Prepared p;
  for (int i = 0; i < n; i++) {
    vec_add(c->node_avail, res[i], -to_fp_demand(amt[i]));
    p.res.emplace_back(res[i], to_fp_demand(amt[i]));
  }
  p.chips.assign(c->node_chips.begin(), c->node_chips.begin() + n_tpu);
  c->node_chips.erase(c->node_chips.begin(), c->node_chips.begin() + n_tpu);
  c->prepared.emplace(bundle, std::move(p));
  return 1;
}

int scx_commit(void* h, long long bundle) {
  Core* c = (Core*)h;
  if (c->pools.count(bundle)) return 1;  // idempotent retry
  auto it = c->prepared.find(bundle);
  if (it == c->prepared.end()) return 0;
  Pool pool;
  for (const auto& d : it->second.res) vec_add(pool.avail, d.first, d.second);
  pool.chips = std::move(it->second.chips);
  pool.committed = std::move(it->second.res);
  c->prepared.erase(it);
  c->pools.emplace(bundle, std::move(pool));
  return 1;
}

int scx_cancel_bundle(void* h, long long bundle) {
  Core* c = (Core*)h;
  auto it = c->prepared.find(bundle);
  if (it == c->prepared.end()) return 0;
  for (const auto& d : it->second.res) vec_add(c->node_avail, d.first, d.second);
  chips_insert(c->node_chips, it->second.chips.data(),
               (int)it->second.chips.size());
  c->prepared.erase(it);
  return 1;
}

int scx_return_bundle(void* h, long long bundle) {
  Core* c = (Core*)h;
  auto it = c->pools.find(bundle);
  if (it == c->pools.end()) return 0;
  // Credit the ORIGINAL committed amounts for non-TPU resources (tasks
  // of this PG still running will find the pool gone on release and
  // credit nothing but their chips); only chips physically in the pool
  // rejoin the node now, and the node's TPU count follows the chips.
  for (const auto& d : it->second.committed)
    if (d.first != c->tpu_res) vec_add(c->node_avail, d.first, d.second);
  int nret = (int)it->second.chips.size();
  chips_insert(c->node_chips, it->second.chips.data(), nret);
  if (c->tpu_res >= 0)
    vec_add(c->node_avail, c->tpu_res, to_fp((double)nret));
  c->pools.erase(it);
  return 1;
}

int scx_has_bundle(void* h, long long bundle) {
  Core* c = (Core*)h;
  return (c->prepared.count(bundle) || c->pools.count(bundle)) ? 1 : 0;
}

int scx_bundle_committed(void* h, long long bundle) {
  return ((Core*)h)->pools.count(bundle) ? 1 : 0;
}

// -------------------------------------------------------------- hot loop

// Walk the heads of every active scheduling class; atomically acquire
// resources for each dispatchable head and emit it.  Infeasible heads
// are reported in blocked_* so the caller can run spillback policy.
// When there are more blocked heads than maxblocked, reporting ROTATES
// across polls (blocked_rot) so every stuck class is eventually seen
// by the spillback policy — overflow must not hide a class forever,
// and signalling `more` for it would spin the dispatch loop.
// Returns the number of dispatches; *more is set if the output buffers
// filled while dispatchable work remained (caller should poll again).
int scx_poll(void* h, uint64_t* tags, int32_t* clss, int32_t* chip_off,
             int32_t* chip_cnt, int32_t* chips, int maxn, int maxchips,
             uint64_t* blocked_tags, int32_t* blocked_cls, int* nblocked,
             int maxblocked, int* more) {
  Core* c = (Core*)h;
  int n = 0, nchips = 0, nb = 0;
  long long blocked_total = 0;
  *more = 0;
  size_t w = 0;
  size_t nact = c->active.size();
  size_t rot = nact ? (c->blocked_rot % nact) : 0;
  c->blocked_rot += (size_t)maxblocked;  // window-sized stride
  for (size_t j = 0; j < nact; j++) {
    // dispatch scan stays in stable order; only the blocked-report
    // window rotates, via a rotated *report* index below
    size_t i = j;
    int ci = c->active[i];
    Class& k = c->classes[(size_t)ci];
    if (k.q.empty()) { k.active = false; continue; }  // compact out
    c->active[w++] = ci;
    // Rotating report window: blocked classes (either oversized or
    // currently-infeasible heads) share the maxblocked report slots
    // across polls so none can starve the others.
    const bool in_window =
        (j >= rot && (long long)(j - rot) < (long long)maxblocked) ||
        (j < rot && (long long)(nact - rot + j) < (long long)maxblocked);
    while (!k.q.empty()) {
      if (k.tpu > maxchips) {
        // can NEVER fit the chip buffer: report blocked (the caller's
        // spillback policy handles it) — `more` would busy-spin
        blocked_total++;
        if (in_window && nb < maxblocked) {
          blocked_tags[nb] = k.q.front();
          blocked_cls[nb] = ci;
          nb++;
        }
        break;
      }
      if (n >= maxn || nchips + k.tpu > maxchips) { *more = 1; break; }
      int got = acquire(c, k, chips + nchips);
      if (got < 0) {
        // blocked head: report for spillback policy, rotated window
        blocked_total++;
        if (in_window && nb < maxblocked) {
          blocked_tags[nb] = k.q.front();
          blocked_cls[nb] = ci;
          nb++;
        }
        break;
      }
      tags[n] = k.q.front();
      clss[n] = ci;
      chip_off[n] = nchips;
      chip_cnt[n] = got;
      nchips += got;
      n++;
      k.q.pop_front();
      c->npending--;
    }
    if (k.q.empty()) { k.active = false; w--; }
  }
  c->active.resize(w);
  *nblocked = nb;
  return n;
}

// Drain every queued task of classes bound to `bundle` (the PG was
// returned; they can never run) and FREE those classes — a long-
// running raylet churning placement groups must not accumulate dead
// Class structs.  Returns count written to tags.
int scx_drain_bundle(void* h, long long bundle, uint64_t* tags, int maxn) {
  Core* c = (Core*)h;
  int n = 0;
  for (size_t ci = 0; ci < c->classes.size(); ci++) {
    Class& k = c->classes[ci];
    if (k.bundle != bundle) continue;
    while (!k.q.empty() && n < maxn) {
      tags[n++] = k.q.front();
      k.q.pop_front();
      c->npending--;
    }
    if (k.q.empty()) {
      // tombstone: shrink to nothing; the id is never reused (the
      // Python side drops its interning entry in the same call)
      k.demand.clear();
      k.demand.shrink_to_fit();
      k.bundle = -2;  // never matches a live bundle again
    }
  }
  return n;
}

}  // extern "C"
