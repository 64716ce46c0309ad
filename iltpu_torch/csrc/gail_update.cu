// One GAIL discriminator step + reward head for Hopper (sm_90a), as one
// single-block kernel.
//
// Replaces: iltpu/ops/pallas_gail.py, `_gail_kernel` / `_gail_core` (the TPU
// kernel behind gail_update_pallas_leaves and gail_update_pallas).
//
// What bounds it on an H100: at the main path's shapes (batch 256, so 512
// loss rows and 256 penalty rows; input D = 7 at pointmass, 15 at hopper;
// width 64) the step is about 2.2 MFLOP at D = 7 and 4.3 at D = 15 and
// reads and writes under 0.1 MB: bound by operations, and small enough for
// one SM (a wider grid would pay more in synchronisation across blocks
// than it saves). One SM's fp32 rate (67 TFLOP/s / 132) puts the floor at
// about 4 us at pointmass and 8 us at hopper, plus the block's barriers and
// the launch. What the design (gail_core.cuh) does about each cause of the
// first version's 0.27 ms (pointmass) and 0.47 ms (hopper):
//  - intermediates went through global scratch, a warp's store touching 32
//    cache lines: the working set is in shared memory (rows, weights, the
//    warps' partial gradients), the activations and masks are recomputed,
//    and nothing but the state and the outputs touches global memory;
//  - every inner loop re-read the row from global memory: the batch is
//    copied once, coalesced, to shared memory, where a row is DP / 4 float4
//    broadcasts and W~1's columns sit in registers;
//  - the penalty rows were serial chains of ~3 D Hd fmaf on half the block:
//    every warp takes rows, its lanes the hidden units, and g = W~1 a is a
//    transposing shuffle reduction;
//  - the weight gradients were one output a thread walking all 768 rows
//    (threads 0-64 twice): each lane keeps its units' partial gradients in
//    registers over its warp's rows, and the 16 warps' partials are summed
//    in warp order;
//  - one thread a row made the time follow the depth of the chains: the
//    chains are now D long (the row's features), and the transcendentals of
//    32 rows run in one pass.
// The K-blocked kernel (kblock_update.cu) runs the same `gail::step`.
//
// The state is updated in place. Pointer order of `iltpu_gail_update`:
//   W1 (D, Hd), b1, W2 (Hd, 1), b2, u1, v1, u2, v2 (null without spectral
//   norm), AdamW m (4), v (4), the step clock (1,), e_s, e_a, e_w, p_s, p_a,
//   p_w, eps_gp, mix (null for BCE), out loss (1), out rewards (B).

#include "gail_core.cuh"

namespace {

// __grid_constant__: the step reads the arguments where they are, with no
// copy in each thread's local memory.
__global__ void __launch_bounds__(gail::THREADS) gail_kernel(const __grid_constant__ gail::Args g) {
  gail::step(g, gail::NoMarks{});
}

}  // namespace

// Dynamic shared memory of a step; 0 where the kernel has no variant for
// (D, Hd). A launch needs 0 < bytes <= iltpu_gail_smem_limit().
extern "C" long long iltpu_gail_smem_bytes(int B, int D, int Hd) {
  return (long long)gail::smem_bytes(B, D, Hd);
}

extern "C" long long iltpu_gail_smem_limit() { return (long long)gail::SMEM_LIMIT; }

extern "C" int iltpu_gail_update(void* const* ptr, int B, int S, int A, int Hd, int sn, int bce,
                                 int reward_fn, float gp, float lr, float wd, float ent, void* stream) {
  if (!gail::fits(B, S + A, Hd)) return (int)cudaErrorInvalidValue;
  const gail::Args g = gail::unpack(ptr, B, S, A, Hd, sn, bce, reward_fn, gp, lr, wd, ent);
  const size_t smem = gail::smem_bytes(B, S + A, Hd);
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(gail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  gail_kernel<<<1, gail::THREADS, smem, reinterpret_cast<cudaStream_t>(stream)>>>(g);
  return (int)cudaGetLastError();
}
