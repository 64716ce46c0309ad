// Where the time of one SAC update goes, phase by phase: the update of
// sac_update.cu with a timestamp (%globaltimer, ns) taken by block 0 after
// each phase's barrier, and a kernel of bare barriers to time one crossing.
// A measuring tool (python -m iltpu_torch.profile_phases); the trainer never
// launches it. The arithmetic is sac_core.cuh's, so the timed update is the
// real one.

#include "grid_exec.cuh"
#include "sac_core.cuh"

namespace {

constexpr int THREADS = 512;

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// gx::GridExec with a timestamp after every barrier.
struct TimedExec : gx::GridExec<THREADS> {
  unsigned long long* stamps;
  int phase;
  __device__ void sync() {
    gx::GridExec<THREADS>::sync();
    if (blockIdx.x == 0 && threadIdx.x == 0) stamps[phase] = now_ns();
    ++phase;
  }
};

struct PArgs {
  sac::Ptrs p;
  sac::Buffers f;
  sac::Hyper h;
  gx::Plan plan;
  unsigned* words;
  unsigned long long* stamps;
  int B, S, A, H, kc;
};

// stamps[0] at the start, stamps[i] after phase i (the last phase is closed
// by one more barrier).
__global__ void __launch_bounds__(THREADS) timed_kernel(const __grid_constant__ PArgs k) {
  if (blockIdx.x == 0 && threadIdx.x == 0) k.stamps[0] = now_ns();
  TimedExec ex{{k.kc, k.words, 0, (int)gridDim.x, &k.plan}, k.stamps, 1};
  sac::sac_step(ex, k.p, k.f, k.B, k.S, k.A, k.H, k.h);
  ex.sync();
}

__global__ void __launch_bounds__(THREADS) barrier_kernel(unsigned* words, int n) {
  for (int i = 0; i < n; ++i) gx::barrier(words, gridDim.x);
}

}  // namespace

extern "C" long long iltpu_phases_scratch_floats(int B, int S, int A, int H) {
  return sac::scratch_floats(B, S, A, H) + gx::BARRIER_WORDS;
}

// One timed update on every co-resident block; the pointers and scratch
// are iltpu_sac_update's, `stamps` holds 22 u64 (the update's 21 phases).
extern "C" int iltpu_phases_update(void* const* ptr, int B, int S, int A, int H, float lr, float wd,
                                   float alpha_lr, float discount, float entropy_target,
                                   float polyak, float polyak_c, float min_alpha, void* scratch,
                                   void* stamps, void* stream) {
  PArgs k;
  k.p = sac::unpack(ptr);
  sac::Scratch sc = {reinterpret_cast<float*>(scratch)};
  k.f = sac::carve(sc, B, S, A, H);
  k.h = {lr, wd, alpha_lr, discount, entropy_target, polyak, polyak_c, min_alpha};
  k.words = reinterpret_cast<unsigned*>(scratch) + sc.used;
  k.stamps = reinterpret_cast<unsigned long long*>(stamps);
  k.B = B; k.S = S; k.A = A; k.H = H;
  const int kmax = sac::gemm_depth(B, S, A, H);
  k.kc = sac::gemm_chunk(kmax);
  const size_t smem = sac::step_smem_bytes(B, S, A, H);
  cudaError_t e = cudaFuncSetAttribute(timed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, timed_kernel, THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  k.plan = gx::step_plan<THREADS>(B, S, A, H, per_sm * sms).plan;
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if ((e = cudaMemsetAsync(k.words, 0, sizeof(unsigned) * gx::BARRIER_WORDS, s)) != cudaSuccess)
    return (int)e;
  void* args[] = {&k};
  e = cudaLaunchCooperativeKernel((const void*)timed_kernel, dim3(per_sm * sms), dim3(THREADS), args,
                                  smem, s);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// n bare barriers over `blocks` blocks; `words` holds BARRIER_WORDS.
extern "C" int iltpu_phases_barriers(void* words, int n, int blocks, void* stream) {
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(words, 0, sizeof(unsigned) * gx::BARRIER_WORDS, s);
  if (e != cudaSuccess) return (int)e;
  unsigned* w = reinterpret_cast<unsigned*>(words);
  void* args[] = {&w, &n};
  e = cudaLaunchCooperativeKernel((const void*)barrier_kernel, dim3(blocks), dim3(THREADS), args, 0, s);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}
