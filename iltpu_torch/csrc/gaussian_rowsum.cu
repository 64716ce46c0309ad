// Weighted two-bandwidth Gaussian row sums for Hopper (sm_90a), GMMIL's
// witness reward:
//   out[i] = sum_j (exp(-g1 d2[i,j]) + exp(-g2 d2[i,j])) w[j],
//   d2[i,j] = max(|x_i|^2 + |y_j|^2 - 2 <x_i, y_j>, 0) / D,
// on x (nx, D) and y (ny, D) already shifted by their shared centre.
//
// Replaces: iltpu/ops/pallas_pairwise.py, `_rowsum_kernel` (the TPU kernel
// behind fused_gaussian_rowsum and gmmil_witness_reward).
//
// What bounds it on an H100: GMMIL's path calls it at 256 x 256 rows of
// D = S + A (7 or 15) features: about 2 MFLOP and 131k exp, and 20 KB read,
// so the card would finish in well under a microsecond and the launch
// bounds it. Its design keeps the TPU kernel's point, that the (nx, ny)
// matrix never reaches device memory, with no padding:
//  - a block of THREADS threads owns THREADS rows of x, one a thread, held
//    in shared memory as (D, THREADS) so a warp's reads are consecutive;
//  - it walks y in tiles of TY rows staged in shared memory with their
//    squared norms and weights, where a warp reads one element at a time;
//  - each thread sums its row's terms in j order within a tile and adds
//    the tile sums in tile order, in registers: a fixed order, and short
//    sums (at most TY terms, then ny / TY tiles) keep the fp32 rounding
//    small; the ragged last rows of x and y are masked, not padded;
//  - the bandwidths are read from device memory, so the caller never
//    waits on the host for them.

#include <cuda_runtime.h>
#include <math.h>

namespace {

typedef long long ll;

constexpr int THREADS = 64;
constexpr int TY = 128;

size_t smem_bytes(int D) { return sizeof(float) * ((size_t)D * THREADS + (size_t)TY * D + 2 * TY); }

__global__ void __launch_bounds__(THREADS)
rowsum_kernel(const float* x, const float* y, const float* w, const float* g1p,
              const float* g2p, int nx, int ny, int D, float invd, float* out) {
  extern __shared__ float sm[];
  float* xs = sm;                // (D, THREADS)
  float* ys = xs + D * THREADS;  // (TY, D)
  float* ysq = ys + TY * D;      // (TY,)
  float* ws = ysq + TY;          // (TY,)
  const int tid = threadIdx.x;
  const int i = blockIdx.x * THREADS + tid;
  const bool live = i < nx;
  float xsq = 0.f;
  for (int d = 0; d < D; ++d) {
    const float v = live ? x[(ll)i * D + d] : 0.f;
    xs[d * THREADS + tid] = v;
    xsq = fmaf(v, v, xsq);
  }
  const float g1 = g1p[0], g2 = g2p[0];
  float total = 0.f;
  for (int j0 = 0; j0 < ny; j0 += TY) {
    const int n = min(TY, ny - j0);
    __syncthreads();  // the previous tile is consumed
    for (int e = tid; e < n * D; e += THREADS) ys[e] = y[(ll)j0 * D + e];
    for (int j = tid; j < n; j += THREADS) ws[j] = w[j0 + j];
    __syncthreads();
    for (int j = tid; j < n; j += THREADS) {
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(ys[j * D + d], ys[j * D + d], s);
      ysq[j] = s;
    }
    __syncthreads();
    float acc = 0.f;
    for (int j = 0; j < n; ++j) {
      float cross = 0.f;
      for (int d = 0; d < D; ++d) cross = fmaf(xs[d * THREADS + tid], ys[j * D + d], cross);
      const float d2 = fmaxf(xsq + ysq[j] - 2.f * cross, 0.f) * invd;
      acc = fmaf(expf(-g1 * d2) + expf(-g2 * d2), ws[j], acc);
    }
    total += acc;
  }
  if (live) out[i] = total;
}

}  // namespace

extern "C" int iltpu_gaussian_rowsum(const void* x, const void* y, const void* w, const void* g1,
                                     const void* g2, int nx, int ny, int D, float invd, void* out,
                                     void* stream) {
  const size_t smem = smem_bytes(D);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(rowsum_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  rowsum_kernel<<<(nx + THREADS - 1) / THREADS, THREADS, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y), static_cast<const float*>(w),
      static_cast<const float*>(g1), static_cast<const float*>(g2), nx, ny, D, invd,
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}
