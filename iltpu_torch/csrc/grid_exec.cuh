// The executor that runs `sac::sac_step` inside one persistent kernel, over
// a range of the grid's blocks, shared by the per-update SAC kernel
// (sac_update.cu, every block) and the K-blocked kernel (kblock_update.cu,
// every block but those that run GAIL).
//
// A phase's jobs run as grid-stride loops over their work items: item t of
// a phase goes to block `first + t mod count`, counting across all the jobs
// of the phase, so a phase takes about ceil(items / count) rounds of its
// slowest item. A phase boundary is a barrier over the range: one arrival
// counter in device memory that only grows, so barrier n is passed when it
// reaches (n + 1) x the blocks (no reset and no second word to release,
// which a generation-word barrier's last block must do while the others
// wait); release (__threadfence before the arrival) and acquire
// (an ld.acquire poll and a __threadfence after it) at gpu scope, as
// cooperative groups' grid barrier does: weak loads after the barrier see
// what other blocks wrote before it, and no L1 line read earlier survives
// it. An update crosses 21 of them (sac_core.cuh's 21 phases). A row-owned
// item (`row_items`) takes R consecutive batch rows whole, the block
// running the item's functor on them, so a narrow product and the row step
// after it share one phase. A GEMM job runs as one non-inlined call
// (inlined at each of the update's 19 call sites, the kernel would grow
// several-fold), and thread 0
// hands it the job's descriptor through one slot of shared memory (passed
// as an argument, it would go through every thread's local memory: 150
// bytes x 512 threads a call). A one-word flag
// lets one block publish a count (the GAIL steps done) that the others wait
// for. The launching C entry zeroes the words on its stream first: the
// wrappers' scratch comes from torch.empty.
//
// The plan: each GEMM job's output tile (32 or 64 on a side) and each
// column sum's item width are picked on the host (`plan_step`) from the
// update's shapes and the blocks that run it, phase by phase, for the
// least rounds x slowest item (an item's cost: a fixed ITEM_UNITS plus a
// thread's chain work, outputs a thread x depth), fewer rounds breaking a
// tie; a column sum widens from COLS threads to the block only where that
// saves a round (widened, one SM reads the whole sum). The kernel takes the
// picks as an argument, so it runs what `iltpu_sac_plan` reports. Every
// output is the same fmaf chain whatever its tile, so the plan moves no bit.
//
// The kernel must be launched cooperatively, so every block is resident and
// a spinning block cannot starve the block it waits for.

#pragma once

#include <assert.h>
#include <cuda_runtime.h>

#include "sac_core.cuh"

namespace gx {

// Sync words a kernel needs: the barrier's one, and the flag.
constexpr int BARRIER_WORDS = 1;
constexpr int FLAG_WORDS = 1;

constexpr int MAX_JOBS = 32;    // GEMM and column-sum jobs of an update (25)
constexpr int MAX_PHASES = 32;  // phases of an update (21)
constexpr int COLS = 64;        // threads of a column-sum item, unless widened
// An item's fixed cost, in the units of its chain work (one fmaf a
// thread): its panels' trip to L2, the block's syncs, the epilogue. By the
// phase timer on the H100, a round of 32x32 tiles took 5.1 us at depth 12
// and 7.5 us at depth 256, of 64x64 tiles 10.3 us at depth 120 and 16.5 at
// 256: about 2.5 ns a unit above some 5 us, some 2000 units. It makes a
// round dear, so fewer rounds of larger tiles win where the grid is a few
// blocks short of one round.
constexpr int ITEM_UNITS = 2048;

// The picks of one update, in the order sac_step makes its GEMM and
// column-sum jobs: a GEMM job's tile (sac::tile_rows, sac::tile_cols of
// it), a column sum's width (0: COLS threads an item, 1: the block).
struct Plan {
  unsigned char pick[MAX_JOBS];
  int jobs;
};

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
  const Plan* plan; // plan_step's picks for these `count` blocks
  const unsigned* flag = nullptr;  // rewards ready when *flag >= want
  unsigned want = 0;
  int next = 0;
  int job = 0;      // the next pick; back to 0 after an update's last

  __device__ int take() {
    const int p = plan->pick[job];
    job = job + 1 == plan->jobs ? 0 : job + 1;
    return p;
  }

  template <class F>
  __device__ void items(int n, const F& f) {
    const int G = count;
    const int b = (int)blockIdx.x - first;
    const int start = next;
    next += n;
    for (int t = start + (b - start % G + G) % G; t < start + n; t += G) f(t - start);
  }

  __device__ __forceinline__ void gemm(const sac::Gemm& g, int Z) {
    const int t = take();
    __syncthreads();  // the last job's readers are done
    if (threadIdx.x == 0) gemm_job = g;
    __syncthreads();
    run_gemm(Z, t);
  }

  __device__ __noinline__ void run_gemm(int Z, int t) {
    switch (t) {
      case 0: tiles<0>(Z); break;
      case 1: tiles<1>(Z); break;
      case 2: tiles<2>(Z); break;
      default: tiles<3>(Z); break;
    }
  }

  template <int T>
  __device__ __forceinline__ void tiles(int Z) {
    constexpr int TM = sac::tile_rows(T), TN = sac::tile_cols(T);
    static_assert(TM * TN == sac::tile_rm(T) * sac::tile_rn(T) * sac::TILE_THREADS, "a tile's threads");
    const sac::Gemm& g = gemm_job;
    const int tn = sac::cdiv(g.n, TN), tm = sac::cdiv(g.m, TM);
    items(tn * tm * Z, [&](int t) {
      sac::gemm_tile<NT, TM, TN, sac::tile_rm(T), sac::tile_rn(T)>(g, t / (tn * tm), (t / tn) % tm,
                                                                   t % tn, kc);
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
  // over blocks instead of reading it all through one SM; of the block's
  // threads where the plan widens them.
  template <class F>
  __device__ void cols(int n, const F& f) {
    const int w = take() ? NT : COLS;
    items(sac::cdiv(n, w), [&](int c) {
      const int i = c * w + threadIdx.x;
      if (threadIdx.x < w && i < n) f(i);
    });
  }

  template <class F>
  __device__ void block(const F& f) {
    items(1, [&](int) { f(); });
  }

  // Row-owned items: item t owns rows [t R, t R + R) of n, the whole block
  // running f.run<NT>(first row, rows) on them. Inlined: out of line, with
  // the functor handed over in shared memory as a GEMM job's descriptor,
  // the update ran 2% (hopper) to 3% (ant) slower on the H100.
  template <class F>
  __device__ __forceinline__ void row_items(int n, int R, const F& f) {
    items(sac::cdiv(n, R), [&](int t) {
      __syncthreads();  // the last item's readers of shared memory are done
      f.template run<NT>(t * R, n - t * R < R ? n - t * R : R);
    });
  }

  __device__ void sync() {
    barrier(words, count);
    next = 0;
  }

  __device__ void await_rewards() {
    if (flag) wait_for(flag, want);
  }
};

// sac::sac_step run on the host with no data, on blocks of NT threads: it
// records each phase's jobs (the barriers an update crosses delimit them,
// the last one the kernel's end or the next micro-update's barrier) and
// counts the row-owned items.
template <int NT>
struct PlanExec {
  enum Kind { GEMM, COLSUM, OTHER };
  struct Job {
    Kind kind;
    int m, n, k, z;  // a GEMM's; a column sum's n columns of k rows; OTHER: n items
  };
  static constexpr int MAX_PHASE_JOBS = 8;
  int phases = 1, row_items_run = 0;
  int njobs[MAX_PHASES] = {};
  Job jobs[MAX_PHASES][MAX_PHASE_JOBS];

  void add(const Job& j) {
    assert(phases <= MAX_PHASES && njobs[phases - 1] < MAX_PHASE_JOBS);
    jobs[phases - 1][njobs[phases - 1]++] = j;
  }
  void gemm(const sac::Gemm& g, int Z) { add({GEMM, g.m, g.n, g.k, Z}); }
  template <class F>
  void rows(int n, const F&) { add({OTHER, 0, sac::cdiv(n, NT), 0, 1}); }
  template <class F>
  void cols(int n, const F& f) { add({COLSUM, 0, n, f.rows, 1}); }
  template <class F>
  void block(const F&) { add({OTHER, 0, 1, 0, 1}); }
  template <class F>
  void row_items(int n, int R, const F&) {
    row_items_run += sac::cdiv(n, R);
    add({OTHER, 0, sac::cdiv(n, R), 0, 1});
  }
  void sync() { ++phases; }
  void await_rewards() {}
};

// One update's plan on a grid of `blocks` blocks, with its counts.
struct StepPlan {
  Plan plan;
  int phases, row_items;
  int gemm_rounds;      // over the phases with a GEMM job: ceil(items / blocks)
  long long gemm_cost;  // over the same phases: rounds x (ITEM_UNITS + the slowest item)
  int items[MAX_PHASES], rounds[MAX_PHASES];
  int tiles[MAX_PHASES];  // a phase's picks, a base-8 digit a GEMM or column-sum job
                          // from the lowest: 1 + the tile; 5 + the column sum's width
};

// The items and the slowest item's chain work (outputs a thread x depth)
// of a job under `pick`; choices(job) picks in all.
template <int NT>
inline int choices(const typename PlanExec<NT>::Job& j) {
  return j.kind == PlanExec<NT>::GEMM ? sac::TILES : j.kind == PlanExec<NT>::COLSUM ? 2 : 1;
}

template <int NT>
inline void weigh(const typename PlanExec<NT>::Job& j, int pick, long long* items, long long* cost) {
  if (j.kind == PlanExec<NT>::GEMM) {
    *items = (long long)j.z * sac::cdiv(j.m, sac::tile_rows(pick)) * sac::cdiv(j.n, sac::tile_cols(pick));
    *cost = (long long)sac::tile_rm(pick) * sac::tile_rn(pick) * j.k;
  } else if (j.kind == PlanExec<NT>::COLSUM) {
    *items = sac::cdiv(j.n, pick ? NT : COLS);
    *cost = j.k;
  } else {
    *items = j.n;
    *cost = 0;
  }
}

// sac::sac_step's plan at a shape on `blocks` blocks of NT threads: each
// phase's picks, out of every combination of its jobs' choices, for the
// least rounds x (ITEM_UNITS + the slowest item's chain work), then the
// fewest rounds, then the first in order (smaller tiles, narrower column
// sums; the choices of the phase's first job vary fastest).
template <int NT>
StepPlan plan_step(int B, int S, int A, int H, int blocks) {
  PlanExec<NT> ex;
  sac::Scratch sc = {nullptr};
  const sac::Buffers f = sac::carve(sc, B, S, A, H);
  const sac::Ptrs p = {};
  sac::sac_step(ex, p, f, B, S, A, H, sac::Hyper{});
  StepPlan out = {};
  out.phases = ex.phases;
  out.row_items = ex.row_items_run;
  for (int ph = 0; ph < ex.phases; ++ph) {
    const int n = ex.njobs[ph];
    const typename PlanExec<NT>::Job* jobs = ex.jobs[ph];
    int combos = 1;
    bool has_gemm = false;
    for (int j = 0; j < n; ++j) {
      combos *= choices<NT>(jobs[j]);
      has_gemm |= jobs[j].kind == PlanExec<NT>::GEMM;
    }
    int best = 0;
    long long best_cost = -1, best_rounds = 0, best_items = 0;
    for (int c = 0; c < combos; ++c) {
      long long items = 0, slowest = 0;
      for (int j = 0, r = c; j < n; r /= choices<NT>(jobs[j]), ++j) {
        long long it, cost;
        weigh<NT>(jobs[j], r % choices<NT>(jobs[j]), &it, &cost);
        items += it;
        slowest = cost > slowest ? cost : slowest;
      }
      const long long rounds = (items + blocks - 1) / blocks, cost = rounds * (ITEM_UNITS + slowest);
      if (best_cost < 0 || cost < best_cost || (cost == best_cost && rounds < best_rounds)) {
        best = c;
        best_cost = cost;
        best_rounds = rounds;
        best_items = items;
      }
    }
    int digit = 1;
    for (int j = 0, r = best; j < n; r /= choices<NT>(jobs[j]), ++j) {
      if (jobs[j].kind == PlanExec<NT>::OTHER) continue;
      const int pick = r % choices<NT>(jobs[j]);
      assert(out.plan.jobs < MAX_JOBS);
      out.plan.pick[out.plan.jobs++] = (unsigned char)pick;
      out.tiles[ph] += digit * (jobs[j].kind == PlanExec<NT>::GEMM ? 1 + pick : 5 + pick);
      digit *= 8;
    }
    out.items[ph] = (int)best_items;
    out.rounds[ph] = (int)best_rounds;
    if (has_gemm) {
      out.gemm_rounds += (int)best_rounds;
      out.gemm_cost += best_cost;
    }
  }
  return out;
}

// plan_step for the last shape and grid asked for, made once for them.
template <int NT>
const StepPlan& step_plan(int B, int S, int A, int H, int blocks) {
  static StepPlan plan;
  static int key[5] = {-1, -1, -1, -1, -1};
  const int now[5] = {B, S, A, H, blocks};
  bool same = true;
  for (int i = 0; i < 5; ++i) same &= key[i] == now[i];
  if (!same) {
    plan = plan_step<NT>(B, S, A, H, blocks);
    for (int i = 0; i < 5; ++i) key[i] = now[i];
  }
  return plan;
}

}  // namespace gx
