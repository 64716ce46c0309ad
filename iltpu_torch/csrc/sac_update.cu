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
// Neither sets its time: the update is 29 dependent phases of one wave of
// small tiles each, so the latency of a phase (one panel copy, one 256-long
// fmaf chain, one barrier) times 29 does, plus the host's issue of the call.
// The design against that:
//  - one launch, not one per job: `sac::sac_step` runs under gx::GridExec
//    (grid_exec.cuh) on every co-resident block (cudaLaunchCooperativeKernel,
//    512 threads a block, expected 132 blocks), each phase a grid-stride
//    loop over its work items, phases separated by a barrier over the grid;
//  - the GEMM tile copies its whole-depth panels into dynamic shared memory
//    at once (sac_core.cuh), opted in past the 48 KB static limit;
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
  unsigned* words;
  int B, S, A, H, kc;
};

// __grid_constant__: sac_step reads the arguments where they are, with no
// copy in each thread's local memory.
__global__ void __launch_bounds__(THREADS) sac_kernel(const __grid_constant__ SArgs k) {
  gx::GridExec<THREADS> ex{k.kc, k.words, 0, (int)gridDim.x};
  sac::sac_step(ex, k.p, k.f, k.B, k.S, k.A, k.H, k.h);
}

// Dynamic shared memory, co-resident blocks per SM, and SMs.
cudaError_t config(int kmax, size_t* smem, int* per_sm, int* sms) {
  *smem = sac::gemm_smem_bytes(kmax);
  cudaError_t e = cudaFuncSetAttribute(sac_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)*smem);
  if (e != cudaSuccess) return e;
  int dev = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, sac_kernel, THREADS, *smem);
}

}  // namespace

extern "C" long long iltpu_sac_scratch_floats(int B, int S, int A, int H) {
  return sac::scratch_floats(B, S, A, H) + gx::BARRIER_WORDS;
}

extern "C" const char* iltpu_sac_error(int e) { return cudaGetErrorString((cudaError_t)e); }

// The launch's grid and dynamic shared memory: co-resident blocks per SM,
// SMs, bytes.
extern "C" int iltpu_sac_grid(int B, int S, int A, int H, int* per_sm, int* sms, long long* smem) {
  size_t bytes = 0;
  const cudaError_t e = config(sac::gemm_depth(B, S, A, H), &bytes, per_sm, sms);
  *smem = (long long)bytes;
  return (int)e;
}

extern "C" int iltpu_sac_update(void* const* ptr, int B, int S, int A, int H, float lr,
                                float wd, float alpha_lr, float discount,
                                float entropy_target, float polyak, float min_alpha,
                                void* scratch, void* stream) {
  SArgs k;
  k.p = sac::unpack(ptr);
  sac::Scratch sc = {reinterpret_cast<float*>(scratch)};
  k.f = sac::carve(sc, B, S, A, H);
  k.h = {lr, wd, alpha_lr, discount, entropy_target, polyak, min_alpha};
  k.words = reinterpret_cast<unsigned*>(scratch) + sc.used;
  k.B = B; k.S = S; k.A = A; k.H = H;
  const int kmax = sac::gemm_depth(B, S, A, H);
  k.kc = sac::gemm_chunk(kmax);

  size_t smem = 0;
  int per_sm = 0, sms = 0;
  cudaError_t e = config(kmax, &smem, &per_sm, &sms);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  e = cudaMemsetAsync(k.words, 0, sizeof(unsigned) * gx::BARRIER_WORDS, s);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {&k};
  e = cudaLaunchCooperativeKernel((const void*)sac_kernel, dim3(per_sm * sms), dim3(THREADS), args,
                                  smem, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
