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
// 4-byte word per probe.
//
// Design.  The TPU kernel walks the rows one after another in a fori_loop;
// here one thread owns one row and all rows probe at once.
//   - Insert: a row that reads an empty slot claims it with atomicCAS
//     (empty -> claimed), writes its key words, makes them visible with
//     __threadfence(), then publishes ready|prefix with atomicExch.  A row
//     that reads `claimed` waits with volatile reads until the slot is
//     ready (legal inside one warp under Hopper's independent thread
//     scheduling: the claimer runs on), then compares.  A row that loses
//     the CAS compares against the winner's key, which may be its own.
//   - Readers fence after seeing `ready` and read the key words with
//     volatile loads (L2, never a stale L1 line), so the words they
//     compare are the published ones.
//   - The probe bound is the claim loop's max_rounds, min(cap, 256): a row
//     that finds no place within it sets a device flag and gets slot
//     cap.  The wrapper turns the flag into ok = False and the callers
//     rehash bigger and retry, as they do for the claim loop.  A full
//     table therefore costs 256 probes a row, not cap.
//   - Lookup walks the same way read-only and stops at the key (found) or
//     at an empty slot (not found); it returns slot cap when not found.
// Which thread wins a contended slot is decided by the atomics, so slot
// ids may change from run to run; the partition (same key -> same slot,
// distinct keys -> distinct slots) does not.
//
// Bound: bytes.  Each row streams its k key words (8k bytes), its live
// byte and its 4-byte slot (and a found byte for lookup).  The table
// costs at least one 32-byte sector of t_ctrl per probe, plus one of
// t_words where the prefix matches; while the table fits in the 50 MB L2
// those sectors stay on chip and the table crosses device memory once.
// The hash is a few dozen integer operations per word, far below the
// card's rate.  What the design does about it: the prefix reject keeps
// the t_words sector out of every probe of a foreign key, the control
// word carries the prefix so that test is one load, and the key words of
// a slot are adjacent (k <= 4 words fit one sector).  Coalescing of the
// streamed arrays comes from one row per consecutive thread.  The table
// walk itself is a dependent chain of random loads; latency, not
// bandwidth, is its cost above the L2, which a later version can hide
// with more rows in flight per thread.
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
constexpr uint64_t kSeed = 0x2545F4914F6CDD1DULL;

__device__ __forceinline__ uint64_t mix64(uint64_t x) {
  x = (x ^ (x >> 33)) * 0xFF51AFD7ED558CCDULL;
  x = (x ^ (x >> 33)) * 0xC4CEB9FE1A85EC53ULL;
  return x ^ (x >> 33);
}

// the hash of presto_tpu_torch/ops/hashtable.py hash_words
__device__ __forceinline__ uint64_t row_hash(const long long* key, int k) {
  uint64_t acc = kSeed;
  for (int w = 0; w < k; ++w) acc = mix64(acc ^ (uint64_t)key[w]);
  return acc;
}

__device__ __forceinline__ int load_ctrl(const int* p) {
  return *reinterpret_cast<const volatile int*>(p);
}

__device__ __forceinline__ bool words_equal(const long long* slot_words,
                                            const long long* key, int k) {
  const volatile long long* sw =
      reinterpret_cast<const volatile long long*>(slot_words);
  for (int w = 0; w < k; ++w) {
    if (sw[w] != key[w]) return false;
  }
  return true;
}

__global__ void __launch_bounds__(kThreads)
insert_kernel(const long long* __restrict__ keys, int k,
              const unsigned char* __restrict__ live, long long n,
              long long* t_words, int* t_ctrl, int cap, int max_probes,
              int* __restrict__ slot_out, int* fail) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (live != nullptr && !live[i]) {
    slot_out[i] = cap;  // dead row: the drop sentinel
    return;
  }
  const long long* key = keys + i * k;
  const uint64_t h = row_hash(key, k);
  const unsigned mask = (unsigned)cap - 1u;
  unsigned slot = (unsigned)(h & mask);
  const int want = kReady | (int)(h >> 56);
  for (int p = 0; p < max_probes; ++p) {
    int c = load_ctrl(t_ctrl + slot);
    if (c == kEmpty) {
      c = atomicCAS(t_ctrl + slot, kEmpty, kClaimed);
      if (c == kEmpty) {
        // this row owns the slot: key words first, then publish
        long long* dst = t_words + (long long)slot * k;
        for (int w = 0; w < k; ++w) dst[w] = key[w];
        __threadfence();
        atomicExch(t_ctrl + slot, want);
        slot_out[i] = (int)slot;
        return;
      }
    }
    while (c == kClaimed) c = load_ctrl(t_ctrl + slot);
    if (c == want) {
      __threadfence();  // the words published before `ready` are visible
      if (words_equal(t_words + (long long)slot * k, key, k)) {
        slot_out[i] = (int)slot;
        return;
      }
    }
    slot = (slot + 1u) & mask;
  }
  slot_out[i] = cap;
  atomicExch(fail, 1);
}

__global__ void __launch_bounds__(kThreads)
lookup_kernel(const long long* __restrict__ keys, int k,
              const unsigned char* __restrict__ live, long long n,
              const long long* __restrict__ t_words,
              const int* __restrict__ t_ctrl, int cap,
              int* __restrict__ slot_out,
              unsigned char* __restrict__ found_out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  slot_out[i] = cap;
  found_out[i] = 0;
  if (live != nullptr && !live[i]) return;
  const long long* key = keys + i * k;
  const uint64_t h = row_hash(key, k);
  const unsigned mask = (unsigned)cap - 1u;
  unsigned slot = (unsigned)(h & mask);
  const int want = kReady | (int)(h >> 56);
  for (int p = 0; p < cap; ++p) {
    const int c = t_ctrl[slot];
    if (c == kEmpty) return;
    if (c == want) {
      const long long* sw = t_words + (long long)slot * k;
      bool eq = true;
      for (int w = 0; w < k && eq; ++w) eq = sw[w] == key[w];
      if (eq) {
        slot_out[i] = (int)slot;
        found_out[i] = 1;
        return;
      }
    }
    slot = (slot + 1u) & mask;
  }
}

}  // namespace

// keys: int64 [n, k] row-major; live: bool [n] or null (every row live);
// t_words: int64 [cap, k]; t_ctrl: int32 [cap]; slot_out: int32 [n];
// fail: int32 [1], set to 1 when a row exhausts max_probes.  cap is a
// power of two; the wrapper checks shapes, types and devices.
extern "C" int presto_probe_insert(const void* keys, int k, const void* live,
                                   long long n, void* t_words, void* t_ctrl,
                                   int cap, int max_probes, void* slot_out,
                                   void* fail, int blocks, void* stream) {
  if (n <= 0) return 0;
  insert_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(keys), k,
      static_cast<const unsigned char*>(live), n,
      static_cast<long long*>(t_words), static_cast<int*>(t_ctrl), cap,
      max_probes, static_cast<int*>(slot_out), static_cast<int*>(fail));
  return (int)cudaGetLastError();
}

// As above, read-only; found: bool [n].
extern "C" int presto_probe_lookup(const void* keys, int k, const void* live,
                                   long long n, const void* t_words,
                                   const void* t_ctrl, int cap,
                                   void* slot_out, void* found, int blocks,
                                   void* stream) {
  if (n <= 0) return 0;
  lookup_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(keys), k,
      static_cast<const unsigned char*>(live), n,
      static_cast<const long long*>(t_words),
      static_cast<const int*>(t_ctrl), cap, static_cast<int*>(slot_out),
      static_cast<unsigned char*>(found));
  return (int)cudaGetLastError();
}
