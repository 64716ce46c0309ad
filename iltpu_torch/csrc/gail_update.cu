// One GAIL discriminator step + reward head for Hopper (sm_90a), as one
// single-block kernel.
//
// Replaces: iltpu/ops/pallas_gail.py, `_gail_kernel` / `_gail_core` (the TPU
// kernel behind gail_update_pallas_leaves and gail_update_pallas).
//
// What bounds it on an H100: at the main path's shapes (batch 256, so 512
// loss rows and 256 penalty rows, input 15, width 64) the step is about
// 3 MFLOP and reads and writes about 0.1 MB, which one SM finishes in a few
// microseconds; a wider grid would cost more in synchronisation across
// blocks than it saves. Launch latency and the serial phases inside the
// block bound it. Its design: one block of gail::THREADS (512) threads runs
// `gail::step` of gail_core.cuh, the phases one after another separated by
// __syncthreads(); the K-blocked kernel (kblock_update.cu) runs the same
// function.
//
// The state is updated in place. Pointer order of `iltpu_gail_update`:
//   W1 (D, Hd), b1, W2 (Hd, 1), b2, u1, v1, u2, v2 (null without spectral
//   norm), AdamW m (4), v (4), the step clock (1,), e_s, e_a, e_w, p_s, p_a,
//   p_w, eps_gp, mix (null for BCE), out loss (1), out rewards (B).

#include "gail_core.cuh"

namespace {

__global__ void __launch_bounds__(gail::THREADS) gail_kernel(gail::Args g) {
  extern __shared__ float smem[];
  gail::step(g, smem);
}

}  // namespace

extern "C" long long iltpu_gail_scratch_floats(int B, int D, int Hd, int bce) {
  return gail::scratch_floats(B, D, Hd, bce);
}

extern "C" int iltpu_gail_update(void* const* ptr, int B, int S, int A, int Hd, int sn, int bce,
                                 int reward_fn, float gp, float lr, float wd, float ent,
                                 void* scratch, void* stream) {
  gail::Args g = gail::unpack(ptr, B, S, A, Hd, sn, bce, reward_fn, gp, lr, wd, ent);
  gail::Scratch sc = {reinterpret_cast<float*>(scratch)};
  gail::carve(sc, g, B, S + A, Hd, bce);
  const size_t smem = gail::smem_bytes(S + A, Hd);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(gail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  gail_kernel<<<1, gail::THREADS, smem, reinterpret_cast<cudaStream_t>(stream)>>>(g);
  return (int)cudaGetLastError();
}
