// One whole SAC update for Hopper (sm_90a), as a fixed sequence of plain
// hand-written kernels launched from one C entry.
//
// Replaces: iltpu/ops/pallas_sac.py, `_sac_kernel` / `_sac_core` (the TPU
// kernel behind sac_update_pallas_leaves and sac_update_pallas).
//
// What bounds it on an H100: at the main path's shapes (batch 256, width
// 256, depth 2, twin critic) one update is about 0.6 GFLOP of fp32 products
// (under 10 us at the 67 TFLOP/s fp32 rate without tensor cores) and moves
// about 6 MB of parameters, moments and target (under 2 us at 3.35 TB/s).
// This first version is bound by neither: it is ~43 small dependent
// launches, so launch latency and the small grids (a 256x256 product is 64
// tiles of 32x32) set its time. Its design is simple and exact first:
//  - one tiled fp32 FFMA GEMM (32x32 output tiles, 16-deep k-tiles in
//    shared memory, 2x2 outputs a thread) with any strides, so transposes
//    are free, and an epilogue of bias, relu and relu-mask; the twin critic
//    is blockIdx.z over the (2, ...)-stacked layout;
//  - elementwise kernels for the tanh-Gaussian heads, the TD target and the
//    critic-loss gradient; column sums for the bias gradients;
//  - one multi-tensor AdamW pass per network (the critic's also does the
//    Polyak update) and one single-block temperature kernel that also
//    advances the three Adam clocks.
// Full fp32 throughout, no TF32: the plain version it is held to is fp32.
// The arithmetic and the order of the launches are `sac_core.cuh`'s, which
// the K-blocked kernel (kblock_update.cu) runs too; here every job of the
// sequence is one launch on the stream, and stream order is the barrier.
//
// The state is updated in place. Pointer order of `iltpu_sac_update`:
//   actor W1 b1 W2 b2 W3 b3, its AdamW m (6), v (6),
//   critic W1 b1 W2 b2 W3 b3 ((2, ...)-stacked), its m (6), v (6),
//   target critic (6), log_alpha, its Adam m, v, actor/critic/alpha clocks,
//   s, a, r, s2, terminal, weight, absorbing, eps2, eps_new,
//   out log_probs (B), out min Q (B), out alpha (1).

#include "sac_core.cuh"

namespace {

constexpr int GEMM_THREADS = 256;
constexpr int EW_THREADS = 256;

__global__ void __launch_bounds__(GEMM_THREADS) gemm_kernel(sac::Gemm g) {
  sac::gemm_tile<GEMM_THREADS>(g, blockIdx.z, blockIdx.y, blockIdx.x);
}

template <class F>
__global__ void __launch_bounds__(EW_THREADS) rows_kernel(F f, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) f(i);
}

template <class F>
__global__ void __launch_bounds__(EW_THREADS) block_kernel(F f) {
  f();
}

// Runs each job of sac::sac_step as its own launch on one stream.
struct HostExec {
  cudaStream_t stream;
  cudaError_t err = cudaSuccess;

  void check() {
    const cudaError_t e = cudaGetLastError();
    if (err == cudaSuccess && e != cudaSuccess) err = e;
  }

  void gemm(const sac::Gemm& g, int Z) {
    dim3 grid(sac::cdiv(g.n, sac::TILE), sac::cdiv(g.m, sac::TILE), Z);
    gemm_kernel<<<grid, GEMM_THREADS, 0, stream>>>(g);
    check();
  }

  template <class F>
  void rows(int n, const F& f) {
    rows_kernel<F><<<sac::cdiv(n, EW_THREADS), EW_THREADS, 0, stream>>>(f, n);
    check();
  }

  template <class F>
  void block(const F& f) {
    block_kernel<F><<<1, EW_THREADS, 0, stream>>>(f);
    check();
  }

  void sync() {}
};

}  // namespace

extern "C" long long iltpu_sac_scratch_floats(int B, int S, int A, int H) {
  return sac::scratch_floats(B, S, A, H);
}

extern "C" int iltpu_sac_update(void* const* ptr, int B, int S, int A, int H, float lr,
                                float wd, float alpha_lr, float discount,
                                float entropy_target, float polyak, float min_alpha,
                                void* scratch, void* stream) {
  const sac::Ptrs p = sac::unpack(ptr);
  sac::Scratch sc = {reinterpret_cast<float*>(scratch)};
  const sac::Buffers f = sac::carve(sc, B, S, A, H);
  const sac::Hyper h = {lr, wd, alpha_lr, discount, entropy_target, polyak, min_alpha};
  HostExec ex{reinterpret_cast<cudaStream_t>(stream)};
  sac::sac_step(ex, p, f, B, S, A, H, h);
  return (int)ex.err;
}
