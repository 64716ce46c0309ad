// Where the time of one GAIL step goes, phase by phase: the step of
// gail_update.cu with a barrier and a timestamp (%globaltimer, ns) taken by
// thread 0 of block 0 after each of its phases (gail_core.cuh: six for a
// tiled step; seven for a wide one, whose third and fourth are the
// cross-block reduction and AdamW behind the cluster's barriers, and whose
// fifth is the new weights' read and the power iteration). A measuring tool
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

// stamps[0] at the start, stamps[k + 1] after phase k, by block 0.
struct Stamps {
  unsigned long long* at;
  __device__ void operator()(int k) const {
    __syncthreads();
    if (threadIdx.x == 0 && blockIdx.x == 0) at[k + 1] = now_ns();
  }
};

__global__ void __launch_bounds__(gail::THREADS)
timed_kernel(const __grid_constant__ gail::Args g, unsigned long long* stamps) {
  if (threadIdx.x == 0) stamps[0] = now_ns();
  gail::step(g, Stamps{stamps});
}

__global__ void __launch_bounds__(gail::THREADS)
timed_wide_kernel(const __grid_constant__ gail::Args g, unsigned long long* stamps) {
  if (threadIdx.x == 0 && blockIdx.x == 0) stamps[0] = now_ns();
  gail::step_cluster(g, Stamps{stamps});
}

// The steps as gail_update.cu's kernels run them.
__global__ void __launch_bounds__(gail::THREADS) step_kernel(const __grid_constant__ gail::Args g) {
  gail::step(g, gail::NoMarks{});
}

__global__ void __launch_bounds__(gail::THREADS)
    wide_kernel(const __grid_constant__ gail::Args g) {
  gail::step_cluster(g, gail::NoMarks{});
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

// One launch of `tiled` (one block), or of the wide step's kernel W (one
// cluster), as g.wide says.
template <auto W, class... P>
int launch(const gail::Args& g, size_t smem, cudaStream_t s, void (*tiled)(gail::Args, P...),
           P... extra) {
  if (g.wide) return gail::launch_wide<W>(g, smem, s, extra...);
  const cudaError_t e =
      cudaFuncSetAttribute(tiled, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  tiled<<<1, gail::THREADS, smem, s>>>(g, extra...);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of a step of `variant` (as args_of's); 0 where it
// cannot take (D, Hd).
extern "C" long long iltpu_gail_phases_smem_bytes(int B, int D, int Hd, int variant) {
  return (long long)(variant < 0 ? gail::smem_bytes(B, D, Hd)
                                 : gail::smem_bytes(B, D, Hd, variant == 1));
}

// One timed step; the pointers are iltpu_gail_update's, `variant` as
// args_of's, `stamps` holds 8 u64.
extern "C" int iltpu_gail_phases_update(void* const* ptr, int B, int S, int A, int Hd, int sn,
                                        int bce, int reward_fn, float gp, float lr, float wd,
                                        float ent, int variant, void* stamps, void* stream) {
  gail::Args g;
  const size_t smem = args_of(g, ptr, B, S, A, Hd, sn, bce, reward_fn, gp, lr, wd, ent, variant);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  return launch<timed_wide_kernel>(g, smem, reinterpret_cast<cudaStream_t>(stream), timed_kernel,
                                   reinterpret_cast<unsigned long long*>(stamps));
}

// One unstamped step of `variant`, to time the two variants at one shape.
extern "C" int iltpu_gail_phases_step(void* const* ptr, int B, int S, int A, int Hd, int sn,
                                      int bce, int reward_fn, float gp, float lr, float wd,
                                      float ent, int variant, void* stream) {
  gail::Args g;
  const size_t smem = args_of(g, ptr, B, S, A, Hd, sn, bce, reward_fn, gp, lr, wd, ent, variant);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  return launch<wide_kernel>(g, smem, reinterpret_cast<cudaStream_t>(stream), step_kernel);
}
