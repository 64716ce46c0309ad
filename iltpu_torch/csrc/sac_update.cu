// One whole SAC update for Hopper (sm_90a), as ONE cooperative persistent
// launch.
//
// Replaces: iltpu/ops/pallas_sac.py, `_sac_kernel` / `_sac_core` (the TPU
// kernel behind sac_update_pallas_leaves and sac_update_pallas).
//
// What bounds it on an H100: at the main path's shapes (batch 256, width
// 256, depth 2, twin critic) one update is about 0.55 GFLOP of fp32 products
// (under 10 us at the 67 TFLOP/s fp32 rate without tensor cores) and moves
// about 6 MB of parameters, moments and target (under 2 us at 3.35 TB/s).
// Neither sets its time: the update is 21 dependent phases of one wave of
// small work items each, so the latency of a phase (one copy into shared
// memory, one 256-long fmaf chain, one barrier) times 21 does, plus the
// host's issue of the call. The design against that:
//  - one launch, not one per job: `sac::sac_step` runs under gx::GridExec
//    (grid_exec.cuh) on every co-resident block (cudaLaunchCooperativeKernel,
//    512 threads a block, expected 132 blocks), each phase a grid-stride
//    loop over its work items, phases separated by a barrier over the grid;
//  - the GEMM tile copies its whole-depth panels into dynamic shared memory
//    at once (sac_core.cuh), opted in past the 48 KB static limit, and runs
//    on 256 threads; each phase's tiles (32 or 64 on a side) are
//    picked on the host from the shapes and the grid for the fewest rounds
//    of items over the blocks (gx::plan_step), cached for the shape, and
//    handed to the kernel, so a phase at batch 1024 runs one round of 64x64
//    tiles, not four of 32x32;
//  - the narrow heads run row-owned, each item a few batch rows whole with
//    the row step after the head in the same phase (sac_core.cuh), so an
//    update crosses 21 barriers, 8 fewer than with tiles;
//    `iltpu_sac_plan` counts them, the row-owned items and the GEMM
//    phases' rounds at a shape and a grid;
//  - the block size and the temperature phase's logical width are the
//    K-blocked kernel's (kblock_update.cu), so K of these launches and one
//    K-blocked launch give the same bits.
// Full fp32 throughout, no TF32: the plain version it is held to is fp32. A
// refused launch (a grid larger than can be co-resident) is returned, never
// run another way.
//
// The state is updated in place. Pointer order of `iltpu_sac_update`:
//   actor W1 b1 W2 b2 W3 b3, its AdamW m (6), v (6),
//   critic W1 b1 W2 b2 W3 b3 ((2, ...)-stacked), its m (6), v (6),
//   target critic (6), log_alpha, its Adam m, v, actor/critic/alpha clocks,
//   s, a, r, s2, terminal, weight, absorbing, eps2, eps_new,
//   out log_probs (B), out min Q (B), out alpha (1).
// The scratch ends with the barrier's words.

#include "grid_exec.cuh"
#include "sac_core.cuh"

namespace {

constexpr int THREADS = 512;

struct SArgs {
  sac::Ptrs p;
  sac::Buffers f;
  sac::Hyper h;
  gx::Plan plan;
  unsigned* words;
  int B, S, A, H, kc;
};

// __grid_constant__: sac_step reads the arguments where they are, with no
// copy in each thread's local memory.
__global__ void __launch_bounds__(THREADS) sac_kernel(const __grid_constant__ SArgs k) {
  gx::GridExec<THREADS> ex{k.kc, k.words, 0, (int)gridDim.x, &k.plan};
  sac::sac_step(ex, k.p, k.f, k.B, k.S, k.A, k.H, k.h);
}

// Dynamic shared memory, co-resident blocks per SM, and SMs. Queried once
// per shared-memory size and cached: a launch then makes no call that a CUDA
// graph capture refuses (the opt-in and the occupancy query are not stream
// work).
cudaError_t config(int B, int S, int A, int H, size_t* smem, int* per_sm, int* sms) {
  static size_t cached_smem = 0;
  static int cached_per_sm = 0, cached_sms = 0;
  *smem = sac::step_smem_bytes(B, S, A, H);
  if (*smem != cached_smem) {
    cudaError_t e = cudaFuncSetAttribute(sac_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)*smem);
    if (e != cudaSuccess) return e;
    int dev = 0;
    e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    e = cudaDeviceGetAttribute(&cached_sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&cached_per_sm, sac_kernel, THREADS, *smem);
    if (e != cudaSuccess) return e;
    cached_smem = *smem;
  }
  *per_sm = cached_per_sm;
  *sms = cached_sms;
  return cudaSuccess;
}

}  // namespace

extern "C" long long iltpu_sac_scratch_floats(int B, int S, int A, int H) {
  return sac::scratch_floats(B, S, A, H) + gx::BARRIER_WORDS;
}

// The scratch buffers' names (space-separated, sac::BUFFER_NAMES) and, for
// a shape, each one's (offset, floats) into `out`, two a name: what a
// measurement reads back from the scratch after an update.
extern "C" const char* iltpu_sac_buffer_names() { return sac::BUFFER_NAMES; }

extern "C" void iltpu_sac_buffers(int B, int S, int A, int H, long long* out) {
  sac::Scratch sc = {nullptr};
  sc.log = out;
  sac::carve(sc, B, S, A, H);
}

// The plan of one update at a shape on `blocks` blocks, made by running
// sac::sac_step on the host (gx::plan_step), as a launch on that grid runs
// it: the barriers it crosses, its row-owned items, and the GEMM phases'
// rounds of items over the blocks; and, phase by phase (gx::MAX_PHASES ints
// each, the first `phases` written), the items, the rounds and the picks
// (gx::StepPlan::tiles).
extern "C" void iltpu_sac_plan(int B, int S, int A, int H, int blocks, int* phases, int* row_items,
                               int* gemm_rounds, int* items, int* rounds, int* tiles) {
  const gx::StepPlan sp = gx::plan_step<THREADS>(B, S, A, H, blocks);
  *phases = sp.phases;
  *row_items = sp.row_items;
  *gemm_rounds = sp.gemm_rounds;
  for (int i = 0; i < sp.phases; ++i) {
    items[i] = sp.items[i];
    rounds[i] = sp.rounds[i];
    tiles[i] = sp.tiles[i];
  }
}

extern "C" const char* iltpu_sac_error(int e) { return cudaGetErrorString((cudaError_t)e); }

// The launch's grid and dynamic shared memory: co-resident blocks per SM,
// SMs, bytes.
extern "C" int iltpu_sac_grid(int B, int S, int A, int H, int* per_sm, int* sms, long long* smem) {
  size_t bytes = 0;
  const cudaError_t e = config(B, S, A, H, &bytes, per_sm, sms);
  *smem = (long long)bytes;
  return (int)e;
}

extern "C" int iltpu_sac_update(void* const* ptr, int B, int S, int A, int H, float lr,
                                float wd, float alpha_lr, float discount,
                                float entropy_target, float polyak, float polyak_c, float min_alpha,
                                void* scratch, void* stream) {
  SArgs k;
  k.p = sac::unpack(ptr);
  sac::Scratch sc = {reinterpret_cast<float*>(scratch)};
  k.f = sac::carve(sc, B, S, A, H);
  k.h = {lr, wd, alpha_lr, discount, entropy_target, polyak, polyak_c, min_alpha};
  k.words = reinterpret_cast<unsigned*>(scratch) + sc.used;
  k.B = B; k.S = S; k.A = A; k.H = H;
  const int kmax = sac::gemm_depth(B, S, A, H);
  k.kc = sac::gemm_chunk(kmax);

  size_t smem = 0;
  int per_sm = 0, sms = 0;
  cudaError_t e = config(B, S, A, H, &smem, &per_sm, &sms);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  k.plan = gx::step_plan<THREADS>(B, S, A, H, per_sm * sms).plan;
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  e = cudaMemsetAsync(k.words, 0, sizeof(unsigned) * gx::BARRIER_WORDS, s);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {&k};
  e = cudaLaunchCooperativeKernel((const void*)sac_kernel, dim3(per_sm * sms), dim3(THREADS), args,
                                  smem, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
