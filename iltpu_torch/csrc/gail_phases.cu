// Where the time of one GAIL step goes, phase by phase: the step of
// gail_update.cu with a barrier and a timestamp (%globaltimer, ns) taken by
// thread 0 after each of its six phases (gail_core.cuh). A measuring tool
// (python -m iltpu_torch.profile_phases gail); the trainer never launches
// it. The arithmetic is gail_core.cuh's, so the timed step is the real one,
// but for one barrier the real step does not have, between the loss rows
// and the penalty rows.

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

}  // namespace

// One timed step; the pointers are iltpu_gail_update's, `stamps` holds 7
// u64.
extern "C" int iltpu_gail_phases_update(void* const* ptr, int B, int S, int A, int Hd, int sn,
                                        int bce, int reward_fn, float gp, float lr, float wd,
                                        float ent, void* stamps, void* stream) {
  if (!gail::fits(B, S + A, Hd)) return (int)cudaErrorInvalidValue;
  const gail::Args g = gail::unpack(ptr, B, S, A, Hd, sn, bce, reward_fn, gp, lr, wd, ent);
  const size_t smem = gail::smem_bytes(B, S + A, Hd);
  const cudaError_t e =
      cudaFuncSetAttribute(timed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  timed_kernel<<<1, gail::THREADS, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
      g, reinterpret_cast<unsigned long long*>(stamps));
  return (int)cudaGetLastError();
}
