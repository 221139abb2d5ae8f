// Open-addressing probe-insert and lookup for Hopper (sm_90a).
//
// Replaces the TPU kernel presto_tpu/ops/pallas_hash.py:_insert_kernel
// (pallas_probe_insert) and the claim loop the JAX package ships in its
// place (presto_tpu/ops/hashtable.py probe_insert / probe_find).  Every
// live row walks a power-of-two table by linear probing from the low bits
// of its 64-bit key hash.  A 1-byte prefix from the hash's high byte
// rejects most occupied slots of other keys; the full key-word compare
// runs only where the prefix matches (PagesHash.java:49).  A row reuses
// the slot of its key or installs itself into the first empty slot.
//
// Table layout (presto_tpu_torch/ops/hashtable.py):
//   t_words int64 [cap, k]: the key words of each slot, row-major;
//   t_ctrl  int32 [cap]:    0 = empty, 1 = claimed (a key is being
//                           written), 0x100 | prefix = ready.
// The prefix lives in the control word, so the reject test reads one
// 4-byte word per probe.  A table written by the plain claim loop is read
// by these kernels and the other way round.
//
// Design.  The TPU kernel walks the rows one after another in a fori_loop;
// here one thread owns one row and all rows walk at once.
//   - Windows of W slots.  A row reads the W control words of an aligned
//     window in one round trip (W = 8: one 32-byte sector, two 16-byte
//     vector loads) and turns them into bit masks (empty, claimed, prefix
//     match).  In the first window the slots before `home` are masked
//     off, and the walk ends at probe distance max_probes, so the slots
//     are visited in linear-probing order: home, home + 1, ...  The prefix
//     matches before the first empty or claimed slot compare their key
//     words, in probe order.  A walk thus costs one dependent load per W
//     slots, and one thread per row keeps every row of a batch in flight.
//   - Insert.  The first empty slot is claimed with atomicCAS (empty ->
//     claimed); the claimer writes the key words, then publishes
//     ready|prefix with atomicExch after a release fence.  A claimed slot
//     met before any empty one is waited on (volatile reads) until it is
//     ready, and the window is read again: the claimed slot may hold this
//     row's key, so no later slot is a candidate before it resolves.  That
//     keeps linear probing's invariant (a key sits in the first slot of
//     its chain that was empty when it arrived) and with it the partition:
//     same key -> same slot, distinct keys -> distinct slots.  Waiting
//     inside a warp is legal under Hopper's independent thread
//     scheduling: the claimer runs on.  A lost CAS reads the window again.
//     Readers fence (acquire) after seeing `ready` and read the key words
//     with volatile loads, so the words they compare are the published
//     ones.
//   - Probe bound: the claim loop's max_rounds, min(cap, 256) slots.  A
//     row that finds no place within it sets the fail word and gets slot
//     cap; the wrapper reports ok = False and the callers rehash bigger
//     and retry, as they do for the claim loop.
//   - Early exit.  A walk that has gone kPollFrom slots reads the fail
//     word once per window and leaves with slot cap once any row has set
//     it.  The callers discard a failed insert's slots, so a full table
//     costs the first row's walk to the bound, not every row's.  Short
//     walks never read the word: 65,536 rows loading one hot word cost
//     more than the walks (PERF.md).
//   - Journal.  A launch reports [fail, claimed] in one 8-byte status
//     word (cleared by a one-block kernel ahead of the walk, which in a
//     CUDA graph costs less than a memset node) and writes a journal: for
//     each row, the slot it claimed or -1.  The claimed count is one
//     fire-and-forget atomicAdd per warp.  The host reads the status once;
//     a caller undoes a failed insert by setting exactly the journalled
//     slots back to empty.
//   - Lookup walks the same windows read-only through the read-only
//     cache (__ldg) and stops at the key (found) or at an empty slot (not
//     found: slot cap).  Given the PagesHash (starts, counts) it writes
//     each row's (lo, cnt) match range itself, so a probe batch is one
//     launch.
// Which thread wins a contended slot is decided by the atomics, so slot
// ids may change from run to run; the partition does not.
//
// W = 8 (kWindow, a compile-time constant; ops/probe_insert.py WINDOW),
// chosen on the card among 1 (a one-slot walk), 4 and 8 at chip_smoke.py's
// phase-2 shapes: 8 was the fastest, or within 0.6 us of it, at each, and
// far the fastest on long walks (a full table, a failed insert, a table
// above the L2) (PERF.md).  A window of W lanes per row (one slot each) was
// slower: W threads a row put a 65,536-row batch past one wave of the
// card.  A shared-memory dedupe of equal keys within a block before the
// walk was dropped: it cost more than it saved at every shape but Q3's
// clustered GROUP BY batch (PERF.md).  The table must hold a whole
// window (cap >= 8) and its control array must be 32-byte aligned, as
// every table of the hash tiers is (at least 1,024 slots, a fresh
// allocation); the entries refuse any other.
//
// Bound: bytes.  Each row streams its k key words (8k bytes), its live
// byte and its 4-byte slot (the PagesHash lookup: its 16-byte range, and
// for a found row the 8 bytes of starts and counts it gathers).
// The table costs at least one 32-byte sector of t_ctrl per walk, plus
// one of t_words where the prefix matches; while the table fits in the
// 50 MB L2 those sectors stay on chip.  Above it (SF10's 2^22-slot
// GroupByHash, 84 MB) every window is a device-memory round trip: the
// window makes it one trip per sector, not per slot.  The hash is a few
// dozen integer operations per word, far below the card's rate.  At the
// main path's batch sizes the card is far from either bound: a launch is
// a few microseconds of latency (the dependent loads and atomics of one
// walk, the kernel boundaries), which the windows, the early exit and one
// thread per row keep short.
//
// Plain C entry points, loaded with ctypes (presto_tpu_torch/ops/
// probe_insert.py).  They launch on the caller's stream, allocate
// nothing, do not synchronise, and return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kEmpty = 0;
constexpr int kClaimed = 1;
constexpr int kReady = 0x100;
constexpr int kThreads = 256;
constexpr int kWindow = 8;     // W: control words per round trip
constexpr int kPollFrom = 16;  // probe distance from which a walk polls
constexpr uint64_t kSeed = 0x2545F4914F6CDD1DULL;

__device__ __forceinline__ uint64_t mix64(uint64_t x) {
  x = (x ^ (x >> 33)) * 0xFF51AFD7ED558CCDULL;
  x = (x ^ (x >> 33)) * 0xC4CEB9FE1A85EC53ULL;
  return x ^ (x >> 33);
}

// the hash of presto_tpu_torch/ops/hashtable.py hash_words
__device__ __forceinline__ uint64_t row_hash(const long long* key, int k) {
  uint64_t acc = kSeed;
  for (int w = 0; w < k; ++w) acc = mix64(acc ^ (uint64_t)__ldg(key + w));
  return acc;
}

__device__ __forceinline__ int load_volatile(const int* p) {
  return *reinterpret_cast<const volatile int*>(p);
}

// With a strong write after it (the claimer's atomicExch), a release;
// after a strong read (a reader's relaxed read of `ready`), an acquire.
// Lighter than __threadfence(), which is sequentially consistent.
__device__ __forceinline__ void fence_acq_rel() {
  asm volatile("fence.acq_rel.gpu;" ::: "memory");
}

// The kWindow control words from p (one aligned 32-byte sector) in one
// round trip: strong relaxed loads for the insert, which other threads
// write while it reads; the read-only path for the lookup.
__device__ __forceinline__ void load_window(const int* p, int (&c)[kWindow]) {
#pragma unroll
  for (int q = 0; q < kWindow; q += 4) {
    asm volatile("ld.relaxed.gpu.global.v4.s32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(c[q]), "=r"(c[q + 1]), "=r"(c[q + 2]), "=r"(c[q + 3])
                 : "l"(p + q)
                 : "memory");
  }
}

__device__ __forceinline__ void load_window_ro(const int* p,
                                               int (&c)[kWindow]) {
#pragma unroll
  for (int q = 0; q < kWindow; q += 4) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(p + q));
    c[q] = v.x;
    c[q + 1] = v.y;
    c[q + 2] = v.z;
    c[q + 3] = v.w;
  }
}

// slot words read through L2 (volatile: never a stale L1 line), after the
// reader has seen the slot ready and fenced
__device__ __forceinline__ bool words_equal_volatile(
    const long long* slot_words, const long long* key, int k) {
  const volatile long long* sw =
      reinterpret_cast<const volatile long long*>(slot_words);
  for (int w = 0; w < k; ++w) {
    if (sw[w] != __ldg(key + w)) return false;
  }
  return true;
}

// words that no thread writes during the launch: the read-only path
__device__ __forceinline__ bool words_equal_ro(const long long* a,
                                               const long long* b, int k) {
  for (int w = 0; w < k; ++w) {
    if (__ldg(a + w) != __ldg(b + w)) return false;
  }
  return true;
}

struct Placed {
  int slot;
  bool claimed;  // this walk turned the slot from empty to ready
};

// The slots of a window, as bit masks (bit v = slot a + v), that a walk
// may visit: probe distance d0 + v in [0, bound).
__device__ __forceinline__ unsigned in_reach(int d0, int bound) {
  constexpr unsigned all = (1u << kWindow) - 1u;
  unsigned m = all;
  if (d0 < 0) m &= all << (-d0);  // the first window starts at `home`
  if (bound - d0 < kWindow) m &= (1u << (bound - d0)) - 1u;
  return m;
}

// One row's insert-or-find walk, a window of kWindow slots per round
// trip.  Windows are aligned to kWindow slots; the first skips the slots
// before `home`, and the walk ends at probe distance max_probes, so it
// visits home, home + 1, ... in linear-probing order.
__device__ Placed walk_insert(const long long* key, int k, uint64_t h,
                              long long* t_words, int* t_ctrl, int cap,
                              int max_probes, const int* status) {
  const unsigned mask = (unsigned)cap - 1u;
  const unsigned home = (unsigned)(h & mask);
  const int want = kReady | (int)(h >> 56);
  unsigned a = home & ~(unsigned)(kWindow - 1);  // the window's first slot
  for (int d0 = (int)a - (int)home; d0 < max_probes;
       d0 += kWindow, a = (a + kWindow) & mask) {
    // early exit: once a row has failed, the caller discards the slots.
    // Only long walks ask (a short one would only load the hot word)
    if (d0 >= kPollFrom && load_volatile(status) != 0) return {cap, false};
    const unsigned reach = in_reach(d0, max_probes);
    for (;;) {  // until the window places the row or sends it on
      int c[kWindow];
      load_window(t_ctrl + a, c);
      unsigned empty = 0, claimed = 0, match = 0;
#pragma unroll
      for (int v = 0; v < kWindow; ++v) {
        empty |= (unsigned)(c[v] == kEmpty) << v;
        claimed |= (unsigned)(c[v] == kClaimed) << v;
        match |= (unsigned)(c[v] == want) << v;
      }
      const unsigned stop = (empty | claimed) & reach;
      // the prefix matches before the first empty or claimed slot, in
      // probe order
      unsigned cand = match & reach & (stop ? (stop & (0u - stop)) - 1u
                                            : 0xFFFFFFFFu);
      if (cand) fence_acq_rel();  // the words published before `ready`
      for (; cand; cand &= cand - 1u) {
        const unsigned s = a + (unsigned)(__ffs(cand) - 1);
        if (words_equal_volatile(t_words + (long long)s * k, key, k)) {
          return {(int)s, false};
        }
      }
      if (!stop) break;  // no empty slot and no claimed one: next window
      const int v = __ffs(stop) - 1;
      const unsigned s = a + (unsigned)v;
      if (((empty >> v) & 1u) &&
          atomicCAS(t_ctrl + s, kEmpty, kClaimed) == kEmpty) {
        // this row owns the slot: key words first, then publish
        long long* dst = t_words + (long long)s * k;
        for (int w = 0; w < k; ++w) dst[w] = __ldg(key + w);
        fence_acq_rel();
        atomicExch(t_ctrl + s, want);
        return {(int)s, true};
      }
      // claimed by another row (or the CAS lost): the slot may hold this
      // row's key, so wait until it is ready and read the window again
      while (load_volatile(t_ctrl + s) == kClaimed) {
      }
    }
  }
  return {cap, false};
}

__device__ int walk_lookup(const long long* key, int k, uint64_t h,
                           const long long* __restrict__ t_words,
                           const int* __restrict__ t_ctrl, int cap) {
  const unsigned mask = (unsigned)cap - 1u;
  const unsigned home = (unsigned)(h & mask);
  const int want = kReady | (int)(h >> 56);
  unsigned a = home & ~(unsigned)(kWindow - 1);
  for (int d0 = (int)a - (int)home; d0 < cap;
       d0 += kWindow, a = (a + kWindow) & mask) {
    int c[kWindow];
    load_window_ro(t_ctrl + a, c);
    unsigned empty = 0, match = 0;
#pragma unroll
    for (int v = 0; v < kWindow; ++v) {
      empty |= (unsigned)(c[v] == kEmpty) << v;
      match |= (unsigned)(c[v] == want) << v;
    }
    const unsigned reach = in_reach(d0, cap);
    const unsigned stop = empty & reach;
    unsigned cand = match & reach & (stop ? (stop & (0u - stop)) - 1u
                                          : 0xFFFFFFFFu);
    for (; cand; cand &= cand - 1u) {
      const unsigned s = a + (unsigned)(__ffs(cand) - 1);
      if (words_equal_ro(t_words + (long long)s * k, key, k)) return (int)s;
    }
    if (stop) return cap;  // an empty slot before the key: not in the table
  }
  return cap;
}

__global__ void clear_status(int* status) {
  if (threadIdx.x < 2) status[threadIdx.x] = 0;
}

__global__ void __launch_bounds__(kThreads)
insert_kernel(const long long* __restrict__ keys, int k,
              const unsigned char* __restrict__ live, long long n,
              long long* t_words, int* t_ctrl, int cap, int max_probes,
              int* __restrict__ slot_out, int* status,
              int* __restrict__ journal) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  Placed placed = {cap, false};
  if (i < n && (live == nullptr || live[i])) {
    const long long* key = keys + i * k;
    placed = walk_insert(key, k, row_hash(key, k), t_words, t_ctrl, cap,
                            max_probes, status);
    if (placed.slot == cap) atomicExch(status, 1);
  }
  if (i < n) {
    slot_out[i] = placed.slot;
    journal[i] = placed.claimed ? placed.slot : -1;
  }
  // the claimed count: one fire-and-forget add per warp
  const unsigned ball = __ballot_sync(0xFFFFFFFFu, placed.claimed);
  if ((threadIdx.x & 31) == 0 && ball) atomicAdd(status + 1, __popc(ball));
}

__global__ void __launch_bounds__(kThreads)
lookup_kernel(const long long* __restrict__ keys, int k,
              const unsigned char* __restrict__ live, long long n,
              const long long* __restrict__ t_words,
              const int* __restrict__ t_ctrl, int cap,
              int* __restrict__ slot_out,
              unsigned char* __restrict__ found_out,
              const int* __restrict__ starts,
              const int* __restrict__ counts,
              long long* __restrict__ lo_out,
              long long* __restrict__ cnt_out) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  int slot = cap;
  if (live == nullptr || live[i]) {
    const long long* key = keys + i * k;
    slot = walk_lookup(key, k, row_hash(key, k), t_words, t_ctrl, cap);
  }
  const bool found = slot != cap;
  if (slot_out != nullptr) {
    slot_out[i] = slot;
    found_out[i] = found;
  }
  if (lo_out != nullptr) {
    lo_out[i] = found ? starts[slot] : 0;
    cnt_out[i] = found ? counts[slot] : 0;
  }
}

// the table holds whole windows, each one aligned sector
bool windows_fit(int cap, const void* t_ctrl) {
  return cap >= kWindow && (uintptr_t)t_ctrl % (4 * kWindow) == 0;
}

unsigned blocks_for(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

// keys: int64 [n, k] row-major; live: bool [n] or null (every row live);
// t_words: int64 [cap, k]; t_ctrl: int32 [cap]; slot_out: int32 [n];
// status: int32 [2], cleared here, then [fail, claimed]: fail = 1 when a
// row exhausted max_probes, claimed = the slots turned from empty to
// ready; journal: int32 [n], the slot row r claimed (one row per claimed
// slot), -1 for every other row.  cap is a power of two, at least kWindow,
// and t_ctrl is 32-byte aligned (else cudaErrorInvalidValue).  The
// wrapper checks shapes, types and devices.
extern "C" int presto_probe_insert(const void* keys, int k, const void* live,
                                   long long n, void* t_words, void* t_ctrl,
                                   int cap, int max_probes, void* slot_out,
                                   void* status, void* journal,
                                   void* stream) {
  if (!windows_fit(cap, t_ctrl)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  clear_status<<<1, 32, 0, st>>>(static_cast<int*>(status));
  if (n > 0) {
    const auto* kp = static_cast<const long long*>(keys);
    const auto* lp = static_cast<const unsigned char*>(live);
    auto* wp = static_cast<long long*>(t_words);
    auto* cp = static_cast<int*>(t_ctrl);
    auto* sp = static_cast<int*>(slot_out);
    auto* stp = static_cast<int*>(status);
    auto* jp = static_cast<int*>(journal);
    insert_kernel<<<blocks_for(n), kThreads, 0, st>>>(
        kp, k, lp, n, wp, cp, cap, max_probes, sp, stp, jp);
  }
  return (int)cudaGetLastError();
}

// Read-only walk.  slot_out int32 [n] and found_out bool [n] (both or
// neither): the row's slot, cap where not found or dead.  starts, counts
// int32 [cap] with lo_out, cnt_out int64 [n] (all or none): the PagesHash
// match range, (0, 0) where not found or dead.  cap and t_ctrl as for
// the insert.
extern "C" int presto_probe_lookup(const void* keys, int k, const void* live,
                                   long long n, const void* t_words,
                                   const void* t_ctrl, int cap,
                                   void* slot_out, void* found_out,
                                   const void* starts, const void* counts,
                                   void* lo_out, void* cnt_out,
                                   void* stream) {
  if (!windows_fit(cap, t_ctrl)) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* kp = static_cast<const long long*>(keys);
  const auto* lp = static_cast<const unsigned char*>(live);
  const auto* wp = static_cast<const long long*>(t_words);
  const auto* cp = static_cast<const int*>(t_ctrl);
  auto* sp = static_cast<int*>(slot_out);
  auto* fp = static_cast<unsigned char*>(found_out);
  const auto* stp = static_cast<const int*>(starts);
  const auto* ctp = static_cast<const int*>(counts);
  auto* lop = static_cast<long long*>(lo_out);
  auto* cnp = static_cast<long long*>(cnt_out);
  lookup_kernel<<<blocks_for(n), kThreads, 0, st>>>(kp, k, lp, n, wp, cp, cap,
                                                    sp, fp, stp, ctp, lop,
                                                    cnp);
  return (int)cudaGetLastError();
}
