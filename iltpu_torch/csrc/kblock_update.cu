// K sequential GAIL+SAC micro-updates (discriminator step + reward head,
// then a SAC step on those rewards) for Hopper (sm_90a), as ONE cooperative
// persistent launch.
//
// Replaces: iltpu/ops/pallas_fused_block.py, `_kblock_kernel` (the TPU
// kernel behind gail_sac_update_kblock), which runs `_gail_core` and
// `_sac_core` K times inside one kernel with the state resident in VMEM.
//
// What bounds it on an H100: at the main path's shapes (batch 256, width
// 256, discriminator width 64) and K = 16, the products are 16 x 0.55 GFLOP
// (0.13 ms at the 67 TFLOP/s fp32 rate without tensor cores) and GAIL adds
// a few MFLOP, against about 6 MB of state read and written once plus the
// K-stacked batch slabs (2 us at 3.35 TB/s): it is bound by operations.
// Neither sets its time. A micro-update is one GAIL step, which runs on a
// single block (its block-wide sums follow the block; ~0.27 ms), and 29
// dependent SAC phases of one wave of small tiles each. The design against
// that:
//  - GAIL beside SAC, not before it: block 0 runs the GAIL steps of
//    micro-updates 0..K-1 back to back, and blocks 1..G-1 run the SAC steps
//    0..K-1 under gx::GridExec (grid_exec.cuh), with a barrier over their
//    own range between phases. GAIL never reads the SAC state; SAC k reads
//    GAIL k's rewards only in its TD-target phase, so it waits there, and
//    only there, for the flag "GAIL k done" that block 0 publishes. The
//    rewards of micro-update k go to slot k of a (K-1, B) slab in scratch
//    (the last one to the `rewards` output, which so holds the last
//    micro-update's rewards, as the other aux outputs do), so GAIL never
//    waits for SAC and no cycle of waits can form. Once GAIL sets the pace,
//    a launch takes about K GAIL steps plus the SAC phases after the last;
//  - a SAC phase is one panel copy, one fmaf chain and one barrier: the
//    GEMM tile holds its whole-depth panels in dynamic shared memory
//    (sac_core.cuh);
//  - one launch with cudaLaunchCooperativeKernel, so every block is
//    resident while others spin; a grid of every block that can be
//    co-resident (cudaOccupancyMaxActiveBlocksPerMultiprocessor x the SMs),
//    and a refusal returned. The dynamic shared memory is the larger of the
//    GAIL step's and the GEMM panels';
//  - ONE block size for every phase: 512 threads, the GAIL step's own
//    (gail::THREADS), because the order of its block-wide sums follows the
//    block size; the per-update SAC kernel runs the same block size and the
//    temperature sum has a fixed logical width of 256, so the results equal
//    K calls of the two per-update kernels bit for bit (chip_smoke checks
//    it);
//  - the Adam clocks: micro-update k's AdamW phases read the clocks, its
//    last phase (one block) advances them, and a barrier over the SAC blocks
//    follows before micro-update k+1 reads them again; the GAIL step reads
//    and advances its own clock inside its block;
//  - the state (~3 MB of fp32) stays in device memory, L2-resident on the
//    50 MB L2; every read of data another block wrote goes through the
//    coherent path (no __ldg, no `const __restrict__`), after a barrier or
//    the flag's acquire.
//
// `iltpu_kblock_update` takes the two per-update pointer layouts
// (sac_update.cu's and gail_update.cu's), with the batch and noise pointers
// at the bases of (K, B, ...) slabs and the SAC rewards pointer at the GAIL
// rewards output; it updates the state in place. The scratch holds the SAC
// buffers, the GAIL buffers, the rewards slab, then the sync words.

#include "gail_core.cuh"
#include "grid_exec.cuh"
#include "sac_core.cuh"

namespace {

typedef long long ll;

constexpr int THREADS = gail::THREADS;

struct KArgs {
  sac::Ptrs sp;  // batch and noise pointers at the slab bases
  sac::Buffers sf;
  sac::Hyper sh;
  gail::Args ga;  // batch pointers at the slab bases
  float* slab;    // rewards of micro-updates 0..K-2, (K-1, B)
  unsigned* words;  // the SAC blocks' barrier, then the GAIL flag
  int K, H, kc;
};

__device__ __forceinline__ float* rewards_slot(const KArgs& k, int i) {
  return i == k.K - 1 ? k.ga.rewards_out : k.slab + (ll)i * k.ga.B;
}

// A micro-update's arguments, one copy a block in shared memory: a copy
// each thread made would sit in local memory (~500 bytes x 512 threads).
__shared__ gail::Args gail_args;
__shared__ sac::Ptrs sac_ptrs;

// Block 0: the K GAIL steps, each published when done. Its own function,
// so its registers are allocated apart from the SAC blocks' code.
__device__ __noinline__ void gail_block(const KArgs& k) {
  extern __shared__ __align__(16) float smem[];
  const int B = k.ga.B, S = k.ga.S, A = k.ga.A;
  unsigned* flag = k.words + gx::BARRIER_WORDS;
  for (int i = 0; i < k.K; ++i) {
    if (threadIdx.x == 0) {
      const ll bs = (ll)i * B * S, ba = (ll)i * B * A, bb = (ll)i * B;
      gail::Args g = k.ga;
      g.e_s += bs; g.e_a += ba; g.e_w += bb;
      g.p_s += bs; g.p_a += ba; g.p_w += bb;
      g.eps_gp += bb;
      if (g.mix) g.mix += bb;
      g.rewards_out = rewards_slot(k, i);
      gail_args = g;
    }
    __syncthreads();
    gail::step(gail_args, smem);
    gx::publish(flag, (unsigned)(i + 1));  // also keeps gail_args until all are done
  }
}

// Blocks 1..G-1: the K SAC steps, each waiting for its rewards.
__device__ __noinline__ void sac_blocks(const KArgs& k) {
  const int B = k.ga.B, S = k.ga.S, A = k.ga.A;
  gx::GridExec<THREADS> ex{k.kc, k.words, 1, (int)gridDim.x - 1, k.words + gx::BARRIER_WORDS};
  for (int i = 0; i < k.K; ++i) {
    if (threadIdx.x == 0) {
      const ll bs = (ll)i * B * S, ba = (ll)i * B * A, bb = (ll)i * B;
      sac::Ptrs p = k.sp;
      p.s += bs; p.a += ba; p.s2 += bs;
      p.term += bb; p.w += bb; p.ab += bb;
      p.eps2 += ba; p.eps_new += ba;
      p.r = rewards_slot(k, i);
      sac_ptrs = p;
    }
    __syncthreads();  // sac_step's last phase ended in a barrier or is this block's alone
    ex.want = (unsigned)(i + 1);
    sac::sac_step(ex, sac_ptrs, k.sf, B, S, A, k.H, k.sh);
    if (i + 1 < k.K) ex.sync();
  }
}

// __grid_constant__: the functions above read the arguments where they are,
// with no copy in each thread's local memory.
__global__ void __launch_bounds__(THREADS) kblock_kernel(const __grid_constant__ KArgs k) {
  if (blockIdx.x == 0) {
    gail_block(k);
  } else {
    sac_blocks(k);
  }
}

// Dynamic shared memory, co-resident blocks per SM, and SMs.
cudaError_t config(int D, int Hd, int kmax, size_t* smem, int* per_sm, int* sms) {
  const size_t gail_bytes = gail::smem_bytes(D, Hd), gemm_bytes = sac::gemm_smem_bytes(kmax);
  *smem = gail_bytes > gemm_bytes ? gail_bytes : gemm_bytes;
  cudaError_t e = cudaFuncSetAttribute(kblock_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)*smem);
  if (e != cudaSuccess) return e;
  int dev = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kblock_kernel, THREADS, *smem);
}

constexpr int SYNC_WORDS = gx::BARRIER_WORDS + gx::FLAG_WORDS;

}  // namespace

extern "C" long long iltpu_kblock_scratch_floats(int K, int B, int S, int A, int H, int Hd, int bce) {
  sac::Scratch ss = {nullptr};
  sac::carve(ss, B, S, A, H);
  return ss.used + gail::scratch_floats(B, S + A, Hd, bce) + (ll)(K - 1) * B + SYNC_WORDS;
}

extern "C" const char* iltpu_kblock_error(int e) { return cudaGetErrorString((cudaError_t)e); }

// The launch's grid and dynamic shared memory: co-resident blocks per SM,
// SMs, bytes.
extern "C" int iltpu_kblock_grid(int B, int S, int A, int H, int Hd, int* per_sm, int* sms,
                                 long long* smem) {
  size_t bytes = 0;
  const cudaError_t e = config(S + A, Hd, sac::gemm_depth(B, S, A, H), &bytes, per_sm, sms);
  *smem = (long long)bytes;
  return (int)e;
}

extern "C" int iltpu_kblock_update(void* const* sac_ptr, void* const* gail_ptr, int K, int B,
                                   int S, int A, int H, int Hd, int sn, int bce, int reward_fn,
                                   float lr, float wd, float alpha_lr, float discount,
                                   float entropy_target, float polyak, float min_alpha, float gp,
                                   float glr, float gwd, float ent, void* scratch, void* stream) {
  KArgs k;
  k.sp = sac::unpack(sac_ptr);
  k.sh = {lr, wd, alpha_lr, discount, entropy_target, polyak, min_alpha};
  k.ga = gail::unpack(gail_ptr, B, S, A, Hd, sn, bce, reward_fn, gp, glr, gwd, ent);
  k.K = K;
  k.H = H;
  const int kmax = sac::gemm_depth(B, S, A, H);
  k.kc = sac::gemm_chunk(kmax);
  float* base = reinterpret_cast<float*>(scratch);
  sac::Scratch ss = {base};
  k.sf = sac::carve(ss, B, S, A, H);
  gail::Scratch gs = {base + ss.used};
  gail::carve(gs, k.ga, B, S + A, Hd, bce);
  k.slab = base + ss.used + gs.used;
  k.words = reinterpret_cast<unsigned*>(k.slab + (ll)(K - 1) * B);

  size_t smem = 0;
  int per_sm = 0, sms = 0;
  cudaError_t e = config(S + A, Hd, kmax, &smem, &per_sm, &sms);
  if (e != cudaSuccess) return (int)e;
  if (per_sm * sms < 2) return (int)cudaErrorCooperativeLaunchTooLarge;
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  e = cudaMemsetAsync(k.words, 0, sizeof(unsigned) * SYNC_WORDS, s);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {&k};
  e = cudaLaunchCooperativeKernel((const void*)kblock_kernel, dim3(per_sm * sms), dim3(THREADS),
                                  args, smem, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
