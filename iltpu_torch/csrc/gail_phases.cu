// Where the time of one GAIL step goes, phase by phase: the step of
// gail_update.cu with a barrier and a timestamp (%globaltimer, ns) taken by
// thread 0 after each of its six phases (gail_core.cuh). A measuring tool
// (python -m iltpu_torch.profile_phases gail); the trainer never launches
// it. The arithmetic is gail_core.cuh's, so the timed step is the real one,
// but for the barriers of the marks (the tiled variants have none between
// the loss rows and the penalty rows). Either variant can be stamped, or
// run unstamped, at a shape both take: the production entry
// (gail_update.cu) runs the routed one alone.

#include "gail_core.cuh"

namespace {

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// stamps[0] at the start, stamps[k + 1] after phase k.
struct Stamps {
  unsigned long long* at;
  __device__ void operator()(int k) const {
    __syncthreads();
    if (threadIdx.x == 0) at[k + 1] = now_ns();
  }
};

__global__ void __launch_bounds__(gail::THREADS)
timed_kernel(const __grid_constant__ gail::Args g, unsigned long long* stamps) {
  if (threadIdx.x == 0) stamps[0] = now_ns();
  gail::step(g, Stamps{stamps});
}

// The step as gail_update.cu's kernel runs it, of the variant in `g.wide`.
__global__ void __launch_bounds__(gail::THREADS) step_kernel(const __grid_constant__ gail::Args g) {
  gail::step(g, gail::NoMarks{});
}

// iltpu_gail_update's arguments with `variant` (-1 the routed one, 0 tiled,
// 1 wide) in place of the route; the shared memory the step needs, or 0
// where the variant cannot take the shape.
size_t args_of(gail::Args& g, void* const* ptr, int B, int S, int A, int Hd, int sn, int bce,
               int reward_fn, float gp, float lr, float wd, float ent, int variant) {
  g = gail::unpack(ptr, B, S, A, Hd, sn, bce, reward_fn, gp, lr, wd, ent);
  if (variant >= 0) g.wide = variant == 1;
  return gail::fits(B, S + A, Hd, g.wide) ? gail::smem_bytes(B, S + A, Hd, g.wide) : 0;
}

}  // namespace

// Dynamic shared memory of a step of `variant` (as args_of's); 0 where it
// cannot take (D, Hd).
extern "C" long long iltpu_gail_phases_smem_bytes(int B, int D, int Hd, int variant) {
  return (long long)(variant < 0 ? gail::smem_bytes(B, D, Hd)
                                 : gail::smem_bytes(B, D, Hd, variant == 1));
}

// One timed step; the pointers are iltpu_gail_update's, `variant` as
// args_of's, `stamps` holds 7 u64.
extern "C" int iltpu_gail_phases_update(void* const* ptr, int B, int S, int A, int Hd, int sn,
                                        int bce, int reward_fn, float gp, float lr, float wd,
                                        float ent, int variant, void* stamps, void* stream) {
  gail::Args g;
  const size_t smem = args_of(g, ptr, B, S, A, Hd, sn, bce, reward_fn, gp, lr, wd, ent, variant);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  const cudaError_t e =
      cudaFuncSetAttribute(timed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  timed_kernel<<<1, gail::THREADS, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
      g, reinterpret_cast<unsigned long long*>(stamps));
  return (int)cudaGetLastError();
}

// One unstamped step of `variant`, to time the two variants at one shape.
extern "C" int iltpu_gail_phases_step(void* const* ptr, int B, int S, int A, int Hd, int sn,
                                      int bce, int reward_fn, float gp, float lr, float wd,
                                      float ent, int variant, void* stream) {
  gail::Args g;
  const size_t smem = args_of(g, ptr, B, S, A, Hd, sn, bce, reward_fn, gp, lr, wd, ent, variant);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  static size_t opted = 48 * 1024;
  if (smem > opted) {
    const cudaError_t e =
        cudaFuncSetAttribute(step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    opted = smem;
  }
  step_kernel<<<1, gail::THREADS, smem, reinterpret_cast<cudaStream_t>(stream)>>>(g);
  return (int)cudaGetLastError();
}
