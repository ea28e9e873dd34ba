// Flags between ranks that store into each other's device memory: the
// rings' tables and region layouts, acquire waits and release stores at
// system scope. Shared by peer.cu (the exchange of a ring's initial send
// buffer, and the stage and halo rings' exchanges and reductions) and
// sw2d_blocked.cu: the one-launch step's peer mode (which stores both
// halos: the inter-stage one and the next step's step-boundary one) and
// the stage's and the stage adjoint's peer modes (the stage ring's
// exchange and its reverse folded into their launches);
// parallel/peer.py writes the regions and the tables.
//
// Every flag is a 64-bit epoch that only grows, so nothing is ever reset.
// A flag lives in the memory of the rank that waits on it; the other rank
// stores into it through its mapping of that memory (CUDA IPC on one card,
// or over NVLink on a node with several). Each wait backs off with
// __nanosleep and is bounded by %globaltimer: past the table's bound it
// traps, so a lost peer is an error and never a hang.
//
// A region (one cudaMalloc of each rank, zeroed), byte offsets from the
// table:
//   0              the stage-2 receive slots, (B, L, 3) floats
//   [PT_RBB]       the step-boundary receive slots, (B, L, 3) floats
//   [PT_FLAGS]     the epoch (the last step launched here), then four words
//                  a ring offset i: GO2, IN2, GOB, INB (below), then one
//                  word that counts the blocks of this rank's step launch
//                  done with stage 2 (reset by the launch itself)
// For ring offset i (offset d), rank r sends its chunk i to rank r + d and
// receives chunk i from rank r - d (mod S):
//   GO2[i]  r + d's stage-2 slots of chunk i are free (written by r + d)
//   IN2[i]  r - d's stage-1 halo has arrived in r's stage-2 slots
//   GOB[i]  r + d's step-boundary slots of chunk i are free (its stage 1
//           has read them)
//   INB[i]  r - d's step-boundary chunk has arrived in r's slots (stored
//           by r - d's step launch, or before the first step its exchange)
// The table (64-bit words in device memory): this rank's region, the two
// offsets, the wait bound in ns, the number of ring offsets, the slots of
// one offset, two unused words; then, a ring offset each, the region of the
// rank it sends to, then the region of the rank that sends to this one.

//
// The stage ring (the differentiable sharded step and the MPC across
// ranks: parallel/peer.py, StageRing) and the halo ring (the
// element-sharded plain-tensor path across ranks: HaloRing, of which the
// stage ring is the kind sized by the blocked buffers) have a region and a
// table of their own. Its region (byte offsets from its table):
//   0              the forward exchange's receive slots: two slot sets of
//                  SR_CAP words each, one an epoch's parity
//   [SR_REV]       the reverse exchange's receive slots: two sets likewise
//   [SR_SUM]       the reductions' slots, one a rank: S x SR_SUMBYTES
//                  bytes (the sums and the maxima share them)
//   [SR_FLAGS]     four words a ring offset i: FGO, FIN, RGO, RIN; then two
//                  words a rank p: SIN, SGO
//   [SR_COUNT]     two words that count the blocks of this rank's folded
//                  launch done (the stage's, then the stage adjoint's; the
//                  last block resets its word)
// An exchange moves one chunk of words a ring offset, the chunk's size
// given at its launch: chunk i of a row of words lies at i x (words of a
// chunk) in the sender's buffer and at i x slot_cw in the receiver's
// slots, slot_cw fixed for the ring (the stage exchange: rows (B, L, 3)
// floats, a scenario a row, slot_cw its chunk, so that a slot set is a
// (B, L, 3) buffer; the halo exchange: one row, the face rows of every
// offset in offset-major order, of any type, padded to whole words,
// slot_cw the slot set's words over the ring offsets, so that chunk i's
// slots stay chunk i's whatever the call).
// For ring offset i (offset d), the forward exchange sends chunk i of rank
// r to rank r + d and the reverse exchange to rank r - d:
//   FGO[i]  r + d's forward slots of chunk i are free (written by r + d)
//   FIN[i]  r - d's forward chunk has arrived in r's slots
//   RGO[i]  r - d's reverse slots of chunk i are free (written by r - d)
//   RIN[i]  r + d's reverse chunk has arrived in r's slots
//   SIN[p]  rank p's part of the reduction has arrived in r's slot p
//   SGO[p]  p's reduction slot r is free (p has read r's part there; p
//           sets it at its next reduction's start: peer.cu)
// Each use counts its own epochs (the caller passes the epoch: every rank
// makes the same calls in the same order; the sums and the maxima count
// together, over their shared slots). Epoch e of an exchange goes to the
// slot set of e's parity (sr_slots). A GO flag starts at 1, and a receiver
// sets it to e + 1 when it has read epoch e (and so every epoch before,
// read or skipped: no rank waits for an epoch that nobody reads); a sender
// of epoch e waits for GO >= e - 1, the read of epoch e - 2, which filled
// the same slot set last. So a sender never waits for a read of the epoch
// before its own: the folded stage launches of sw2d_blocked.cu (an
// exchange's arrival read at the launch's start, the next exchange's chunk
// stored at its end) wait only on flags that the peers' launches of the
// round before release.
// The table (64-bit words in device memory): this rank's region, the wait
// bound in ns, the ring offsets, the words of a slot set (SR_CAP), the
// ranks, this rank, the bytes of one reduction slot, the offsets of the
// flags, reverse slots, reduction slots and block counts in a region, five
// unused words; then a ring offset each the region of rank + d, then of
// rank - d; then the region of every rank in rank order.

#pragma once

#include <cuda/atomic>

typedef unsigned long long flag_t;

enum { PT_OWN = 0, PT_RBB = 1, PT_FLAGS = 2, PT_TIMEOUT = 3, PT_NOFF = 4,
       PT_CHUNK = 5, PT_HEAD = 8 };
enum { PEER_GO2 = 0, PEER_IN2 = 1, PEER_GOB = 2, PEER_INB = 3 };

__device__ __forceinline__ long long peer_to(const long long* tab, int i) {
  return tab[PT_HEAD + i];
}

__device__ __forceinline__ long long peer_from(const long long* tab, int i) {
  return tab[PT_HEAD + tab[PT_NOFF] + i];
}

// Flag k of ring offset i in the region at `region`.
__device__ __forceinline__ flag_t* peer_flag(const long long* tab,
                                             long long region, int i, int k) {
  return reinterpret_cast<flag_t*>(region + tab[PT_FLAGS]) + 1 + 4 * i + k;
}

__device__ __forceinline__ flag_t* peer_epoch(const long long* tab) {
  return reinterpret_cast<flag_t*>(tab[PT_OWN] + tab[PT_FLAGS]);
}

// The count of this rank's step-launch blocks done with stage 2 (its own
// memory; the launch resets it and counts on it).
__device__ __forceinline__ unsigned* peer_arrivals(const long long* tab) {
  return reinterpret_cast<unsigned*>(peer_epoch(tab) + 1 + 4 * tab[PT_NOFF]);
}


__device__ __forceinline__ unsigned long long peer_clock_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void flag_release(flag_t* f, flag_t v) {
  cuda::atomic_ref<flag_t, cuda::thread_scope_system>(*f).store(
      v, cuda::std::memory_order_release);
}

// A relaxed store at system scope: after a fence of the same thread at
// system scope, a release pattern (PTX memory model), so that a launch
// or a block that sets several flags pays one system fence and not one a
// flag (the folded launches' end, sw2d_blocked.cu's sr_fold_end; the
// rings' exchanges and reductions, peer.cu's block_fence).
__device__ __forceinline__ void flag_store(flag_t* f, flag_t v) {
  cuda::atomic_ref<flag_t, cuda::thread_scope_system>(*f).store(
      v, cuda::std::memory_order_relaxed);
}

// Waits until *f >= v (acquire); traps after timeout_ns.
static __device__ __noinline__ void flag_wait(flag_t* f, flag_t v,
                                              long long timeout_ns) {
  cuda::atomic_ref<flag_t, cuda::thread_scope_system> r(*f);
  if (r.load(cuda::std::memory_order_acquire) >= v) return;
  const unsigned long long t0 = peer_clock_ns();
  unsigned ns = 64;
  while (r.load(cuda::std::memory_order_acquire) < v) {
    if ((long long)(peer_clock_ns() - t0) > timeout_ns) __trap();
    __nanosleep(ns);
    if (ns < 8192) ns *= 2;
  }
}

enum { SR_OWN = 0, SR_TIMEOUT = 1, SR_NOFF = 2, SR_CAP = 3, SR_S = 4,
       SR_RANK = 5, SR_SUMBYTES = 6, SR_FLAGS = 7, SR_REV = 8, SR_SUM = 9,
       SR_COUNT = 10, SR_HEAD = 16 };
enum { SR_FGO = 0, SR_FIN = 1, SR_RGO = 2, SR_RIN = 3 };
enum { SR_SIN = 0, SR_SGO = 1 };

__device__ __forceinline__ long long sr_to(const long long* tab, int i) {
  return tab[SR_HEAD + i];
}

__device__ __forceinline__ long long sr_from(const long long* tab, int i) {
  return tab[SR_HEAD + tab[SR_NOFF] + i];
}

__device__ __forceinline__ long long sr_rank(const long long* tab, int p) {
  return tab[SR_HEAD + 2 * tab[SR_NOFF] + p];
}

// Flag k of ring offset i in a stage or halo ring's region at `region`.
__device__ __forceinline__ flag_t* sr_flag(const long long* tab,
                                           long long region, int i, int k) {
  return reinterpret_cast<flag_t*>(region + tab[SR_FLAGS]) + 4 * i + k;
}

// Flag k of rank p's part of a reduction in the region at `region`.
__device__ __forceinline__ flag_t* sr_sum_flag(const long long* tab,
                                               long long region, int p,
                                               int k) {
  return reinterpret_cast<flag_t*>(region + tab[SR_FLAGS]) +
         4 * tab[SR_NOFF] + 2 * p + k;
}

// The slot set of epoch e of one use (rev: the reverse exchange's) in the
// region at `region`: the set of e's parity.
__device__ __forceinline__ long long sr_slots(const long long* tab,
                                              long long region, int rev,
                                              flag_t e) {
  return region + (rev ? tab[SR_REV] : 0) +
         (long long)(e & 1) * tab[SR_CAP] * 4;
}

// This rank's count of the blocks of its folded launch done (rev: the
// stage adjoint's), in its own memory.
__device__ __forceinline__ unsigned* sr_count(const long long* tab, int rev) {
  return reinterpret_cast<unsigned*>(tab[SR_OWN] + tab[SR_COUNT]) + 2 * rev;
}
