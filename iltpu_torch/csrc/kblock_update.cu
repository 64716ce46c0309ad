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
// This first version is bound by neither. Each micro-update is one GAIL
// phase on a single block (the per-update kernel's design, ~0.27 ms) and
// 29 dependent SAC phases, so the serial GAIL block and the grid barriers
// set its time. Its design is simple and exact first:
//  - one launch with cudaLaunchCooperativeKernel, a grid of every block
//    that can be co-resident (cudaOccupancyMaxActiveBlocksPerMultiprocessor
//    x the SMs); a grid larger than that is refused and the error returned;
//  - each former launch of sac_update.cu is a grid-stride loop over that
//    phase's work items (GEMM tiles flattened over (n-tiles, m-tiles,
//    twin), blocks of rows, elements), and independent jobs share a phase;
//    cooperative_groups' grid barrier separates dependent phases. The
//    sequence and every line of arithmetic are sac_core.cuh's and
//    gail_core.cuh's, the same code the per-update kernels run;
//  - ONE block size for every phase: 512 threads, the GAIL step's own
//    (gail::THREADS), because the order of its block-wide sums follows the
//    block size; the GEMM tile then gives each thread 1x2 outputs instead
//    of 2x2 (each output is the same fmaf chain), and the temperature sum
//    has a fixed logical width of 256, so the results equal K calls of the
//    two per-update kernels bit for bit (chip_smoke checks it);
//  - the Adam clocks: micro-update k's AdamW phases read the clocks, its
//    last phase (one block) advances them, and a grid barrier follows
//    before micro-update k+1's SAC reads them again; the GAIL step reads
//    and advances its own clock inside its block;
//  - the state (~3 MB of fp32) stays in device memory, L2-resident on the
//    50 MB L2; every read of data another block wrote goes through the
//    coherent path (no __ldg, no `const __restrict__`), after a barrier;
//  - the GAIL rewards reach the SAC step through the `rewards` output,
//    which thus holds the last micro-update's rewards at the end, as the
//    other aux outputs do.
//
// `iltpu_kblock_update` takes the two per-update pointer layouts
// (sac_update.cu's and gail_update.cu's), with the batch and noise pointers
// at the bases of (K, B, ...) slabs and the SAC rewards pointer at the GAIL
// rewards output; it updates the state in place.

#include <cooperative_groups.h>

#include "gail_core.cuh"
#include "sac_core.cuh"

namespace {

namespace cg = cooperative_groups;
typedef long long ll;

constexpr int THREADS = gail::THREADS;

// Runs the jobs of a phase as grid-stride loops over their work items and
// a phase boundary as a grid barrier. Item t of a phase goes to block
// t mod gridDim.x, counting across all the jobs of the phase.
struct GridExec {
  int next = 0;

  template <class F>
  __device__ void items(int count, const F& f) {
    const int G = gridDim.x;
    const int start = next;
    next += count;
    for (int t = start + ((int)blockIdx.x - start % G + G) % G; t < start + count; t += G)
      f(t - start);
  }

  __device__ void gemm(const sac::Gemm& g, int Z) {
    const int tn = sac::cdiv(g.n, sac::TILE), tm = sac::cdiv(g.m, sac::TILE);
    items(tn * tm * Z, [&](int t) {
      sac::gemm_tile<THREADS>(g, t / (tn * tm), (t / tn) % tm, t % tn);
    });
  }

  template <class F>
  __device__ void rows(int n, const F& f) {
    const int nt = blockDim.x;
    items(sac::cdiv(n, nt), [&](int c) {
      const int i = c * nt + threadIdx.x;
      if (i < n) f(i);
    });
  }

  template <class F>
  __device__ void block(const F& f) {
    items(1, [&](int) { f(); });
  }

  __device__ void sync() {
    cg::this_grid().sync();
    next = 0;
  }
};

struct KArgs {
  sac::Ptrs sp;  // batch and noise pointers at the slab bases
  sac::Buffers sf;
  sac::Hyper sh;
  gail::Args ga;  // batch pointers at the slab bases
  int K, H;
};

__global__ void __launch_bounds__(THREADS) kblock_kernel(KArgs k) {
  extern __shared__ float smem[];
  GridExec ex;
  const int B = k.ga.B, S = k.ga.S, A = k.ga.A;
  for (int i = 0; i < k.K; ++i) {
    const ll bs = (ll)i * B * S, ba = (ll)i * B * A, bb = (ll)i * B;
    gail::Args g = k.ga;
    g.e_s += bs; g.e_a += ba; g.e_w += bb;
    g.p_s += bs; g.p_a += ba; g.p_w += bb;
    g.eps_gp += bb;
    if (g.mix) g.mix += bb;
    // GAIL never reads the SAC state, so it needs no barrier after the
    // previous micro-update's temperature phase.
    ex.block([&] { gail::step(g, smem); });
    ex.sync();
    sac::Ptrs p = k.sp;
    p.s += bs; p.a += ba; p.s2 += bs;
    p.term += bb; p.w += bb; p.ab += bb;
    p.eps2 += ba; p.eps_new += ba;
    sac::sac_step(ex, p, k.sf, B, S, A, k.H, k.sh);
  }
}

// Dynamic shared memory, co-resident blocks per SM, and SMs.
cudaError_t config(int D, int Hd, size_t* smem, int* per_sm, int* sms) {
  *smem = gail::smem_bytes(D, Hd);
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

}  // namespace

extern "C" long long iltpu_kblock_scratch_floats(int B, int S, int A, int H, int Hd, int bce) {
  return sac::scratch_floats(B, S, A, H) + gail::scratch_floats(B, S + A, Hd, bce);
}

extern "C" const char* iltpu_kblock_error(int e) { return cudaGetErrorString((cudaError_t)e); }

// The grid the launch uses: co-resident blocks per SM and SMs.
extern "C" int iltpu_kblock_grid(int D, int Hd, int* per_sm, int* sms) {
  size_t smem = 0;
  return (int)config(D, Hd, &smem, per_sm, sms);
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
  sac::Scratch ss = {reinterpret_cast<float*>(scratch)};
  k.sf = sac::carve(ss, B, S, A, H);
  gail::Scratch gs = {reinterpret_cast<float*>(scratch) + ss.used};
  gail::carve(gs, k.ga, B, S + A, Hd, bce);

  size_t smem = 0;
  int per_sm = 0, sms = 0;
  cudaError_t e = config(S + A, Hd, &smem, &per_sm, &sms);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&k};
  e = cudaLaunchCooperativeKernel((const void*)kblock_kernel, dim3(per_sm * sms), dim3(THREADS),
                                  args, smem, reinterpret_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
