// The grid-wide barrier of the kernels launched cooperatively: kernel G's
// GRID form (pcg.cu), kernel J (obstacle.cu) and kernel M (uzawa.cu); in the
// scene forms of J and M, a team's barrier over the blocks that share a scene. The barrier lives in global
// memory, zeroed before its first use; every launch leaves its count at 0,
// and its generation may hold any value, since a block reads it before it
// arrives. Integer atomics only: no float atomic, no order that changes a
// result.
#pragma once

#include <cuda_runtime.h>

namespace {

// The arrivals and the generation sit on cache lines of their own: the
// blocks that wait read the generation while the others add to the count.
struct Barrier {
  unsigned count;  // blocks arrived at the current barrier; 0 between barriers
  unsigned pad[31];
  unsigned gen;    // barriers completed
};

// A scene form's teams (kernels J and M) each wait on a barrier of their
// own: an array of them, kBarrierInts ints apart (the wrappers' BARRIER_INTS).
constexpr int kBarrierInts = 64;
static_assert(sizeof(Barrier) <= kBarrierInts * sizeof(int), "a barrier's slot");

__device__ __forceinline__ Barrier* team_barrier(Barrier* base, int team) {
  return reinterpret_cast<Barrier*>(reinterpret_cast<int*>(base) + kBarrierInts * team);
}

// Every block arrives, then leaves together; the last to arrive resets the
// count and opens the next generation. Memory order (PTX, device scope): the
// block's writes are ordered before thread 0's arrival by __syncthreads, the
// arrival releases them (an acq_rel add on the count, whose sequence of adds
// the last arrival acquires), the last arrival releases the next generation,
// and the waiting thread 0s acquire it before __syncthreads lets their blocks
// read: the pattern of CUTLASS's GenericBarrier, with no full fence. A block
// that waits more than kBarrierCycles (about 2 s) traps: the launch fails with
// an error instead of hanging, should the grid ever not be resident at once.
constexpr long long kBarrierCycles = 1ll << 32;

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned add_acq_rel(unsigned* p, unsigned v) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], %2;"
               : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}

__device__ __forceinline__ void st_relaxed(unsigned* p, unsigned v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ void add_release(unsigned* p, unsigned v) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ void grid_sync(Barrier* bar, unsigned nb) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned g = ld_acquire(&bar->gen);
    if (add_acq_rel(&bar->count, 1u) == nb - 1) {
      st_relaxed(&bar->count, 0u);
      add_release(&bar->gen, 1u);
    } else {
      const long long t0 = clock64();
      while (ld_acquire(&bar->gen) == g) {
        if (clock64() - t0 > kBarrierCycles) __trap();
      }
    }
  }
  __syncthreads();
}

}  // namespace
