// The executor that runs `sac::sac_step` inside one persistent kernel, over
// a range of the grid's blocks, shared by the per-update SAC kernel
// (sac_update.cu, every block) and the K-blocked kernel (kblock_update.cu,
// every block but the one that runs GAIL).
//
// A phase's jobs run as grid-stride loops over their work items: item t of
// a phase goes to block `first + t mod count`, counting across all the jobs
// of the phase. A phase boundary is a barrier over the range: one arrival
// counter in device memory that only grows, so barrier n is passed when it
// reaches (n + 1) x the blocks (no reset and no second word to release,
// which a generation-word barrier's last block must do while the others
// wait); release (__threadfence before the arrival) and acquire
// (an ld.acquire poll and a __threadfence after it) at gpu scope, as
// cooperative groups' grid barrier does: weak loads after the barrier see
// what other blocks wrote before it, and no L1 line read earlier survives
// it. A GEMM job runs as one non-inlined call (inlined at each of the
// update's 28 call sites, the kernel would grow sixfold), and thread 0
// hands it the job's descriptor through one slot of shared memory (passed
// as an argument, it would go through every thread's local memory: 150
// bytes x 512 threads a call). A one-word flag
// lets one block publish a count (the GAIL steps done) that the others wait
// for. The launching C entry zeroes the words on its stream first: the
// wrappers' scratch comes from torch.empty.
//
// The kernel must be launched cooperatively, so every block is resident and
// a spinning block cannot starve the block it waits for.

#pragma once

#include <cuda_runtime.h>

#include "sac_core.cuh"

namespace gx {

// Sync words a kernel needs: the barrier's one, and the flag.
constexpr int BARRIER_WORDS = 1;
constexpr int FLAG_WORDS = 1;

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Barrier over `count` blocks; *counter counts every arrival since it was
// zeroed.
__device__ inline void barrier(unsigned* counter, unsigned count) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    const unsigned target = (atomicAdd(counter, 1u) / count + 1) * count;
    while ((int)(ld_acquire(counter) - target) < 0) {
    }
    __threadfence();
  }
  __syncthreads();
}

// Publish `value` in a flag after everything this block wrote before.
__device__ inline void publish(unsigned* flag, unsigned value) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicExch(flag, value);
  }
}

// Wait until a flag reaches `value`; then this block sees what the
// publishing block wrote before it.
__device__ inline void wait_for(const unsigned* flag, unsigned value) {
  if (threadIdx.x == 0) {
    while (ld_acquire(flag) < value) {
    }
    __threadfence();
  }
  __syncthreads();
}

// The GEMM job of the block's current phase.
__shared__ sac::Gemm gemm_job;

template <int NT>
struct GridExec {
  int kc;           // the GEMM's chunk depth, gemm_chunk(kmax); the block
                    // has gemm_smem_bytes(kmax) of dynamic shared memory
  unsigned* words;  // the barrier's counter
  int first, count; // the blocks that run the update
  const unsigned* flag = nullptr;  // rewards ready when *flag >= want
  unsigned want = 0;
  int next = 0;

  template <class F>
  __device__ void items(int n, const F& f) {
    const int G = count;
    const int b = (int)blockIdx.x - first;
    const int start = next;
    next += n;
    for (int t = start + (b - start % G + G) % G; t < start + n; t += G) f(t - start);
  }

  __device__ __forceinline__ void gemm(const sac::Gemm& g, int Z) {
    __syncthreads();  // the last job's readers are done
    if (threadIdx.x == 0) gemm_job = g;
    __syncthreads();
    run_gemm(Z);
  }

  __device__ __noinline__ void run_gemm(int Z) {
    const sac::Gemm& g = gemm_job;
    const int tn = sac::cdiv(g.n, sac::TILE), tm = sac::cdiv(g.m, sac::TILE);
    items(tn * tm * Z, [&](int t) {
      sac::gemm_tile<NT>(g, t / (tn * tm), (t / tn) % tm, t % tn, kc);
    });
  }

  template <class F>
  __device__ void rows(int n, const F& f) {
    items(sac::cdiv(n, NT), [&](int c) {
      const int i = c * NT + threadIdx.x;
      if (i < n) f(i);
    });
  }

  // Column sums: items of COLS threads, so a sum over many rows spreads
  // over blocks instead of reading it all through one SM.
  static constexpr int COLS = 64;
  template <class F>
  __device__ void cols(int n, const F& f) {
    items(sac::cdiv(n, COLS), [&](int c) {
      const int i = c * COLS + threadIdx.x;
      if (threadIdx.x < COLS && i < n) f(i);
    });
  }

  template <class F>
  __device__ void block(const F& f) {
    items(1, [&](int) { f(); });
  }

  __device__ void sync() {
    barrier(words, count);
    next = 0;
  }

  __device__ void await_rewards() {
    if (flag) wait_for(flag, want);
  }
};

}  // namespace gx
