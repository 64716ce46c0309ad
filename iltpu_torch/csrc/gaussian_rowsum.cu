// Weighted two-bandwidth Gaussian row sums for Hopper (sm_90a), GMMIL's
// witness reward:
//   rowsum(x, y, w)[i] = sum_j (exp(-g1 d2[i,j]) + exp(-g2 d2[i,j])) w[j],
//   d2[i,j] = max(|x_i|^2 + |y_j|^2 - 2 <x_i, y_j>, 0) / D,
// on x (nx, D) and y (ny, D) shifted by their shared centre. One kernel,
// two entries:
//  - iltpu_gaussian_rowsum: one row sum on x and y already centred, w as
//    given;
//  - iltpu_gmmil_reward: the whole reward of gmmil_witness_reward in one
//    launch, r_i = w~_i (rowsum(sa, esa, ew~) - rowsum(sa, sa, w~)) with
//    w~ = w / sum w, ew~ = ew / sum ew, and the two centrings
//    0.5 (mean sa + mean esa) and mean sa done in the kernel; blockIdx.z
//    picks the row sum.
//
// Replaces: iltpu/ops/pallas_pairwise.py, `_rowsum_kernel` (the TPU kernel
// behind fused_gaussian_rowsum and gmmil_witness_reward).
//
// What bounds it on an H100: GMMIL's path makes one reward of 2 x 256 x 256
// pairs of D = S + A (7 or 15) features: about 2.4 MFLOP and 131k exp at
// D = 7, 20 KB read, so the card would finish in well under a microsecond;
// the 256 x 10,001 row sum is 20x that. Latency and the launch bound it,
// so the design is about spreading the pairs over the card and keeping the
// chains short, with the TPU kernel's point that the (nx, ny) matrix never
// reaches device memory:
//  - a grid over (x tiles of TX = 32 rows, y chunks, the two row sums) of
//    256-thread blocks; a chunk is 1 to 8 64-row tiles, as few as keep the
//    grid under about two blocks an SM (64 blocks for the 256 x 256 reward,
//    256 for the 256 x 10,001 row sum; larger chunks, which cut the blocks
//    and the combine, measured slower at 256 x 256);
//  - a block stages its x rows and its chunk of y rows, centred, feature-
//    major in shared memory with the squared norms and the scaled weights;
//    each thread then owns 2 x rows x 4 y rows of a tile: 8 independent
//    fmaf chains of D and 16 expf that overlap;
//  - partial sums combine in a fixed order: each thread over its y rows,
//    the block's 16 threads of an x row in thread order, then the chunks in
//    chunk order by the last block of the x tile to finish (a counter
//    zeroed before the launch; no float atomics), which also forms the
//    reward; a row sum that one chunk covers skips the combine and its
//    counter. Results repeat run to run;
//  - in the fused entry every block computes the means and weight sums it
//    needs itself, in one fixed order, so all blocks get the same bits;
//  - full-precision expf (the tolerance is 1e-5 / 1e-6), and the bandwidths
//    are read from device memory, so the caller never waits on the host.

#include <cuda_runtime.h>
#include <math.h>

namespace {

typedef long long ll;

constexpr int THREADS = 256;
constexpr int TX = 32;             // x rows a block: 16 thread columns x 2
constexpr int TY = 64;             // y rows a tile: 16 thread rows x 4
constexpr int MAX_TILES = 8;       // y tiles a chunk
constexpr int TARGET_BLOCKS = 264; // about two blocks an SM
constexpr int MAX_D = THREADS;     // the column sums give each feature a thread
constexpr size_t SMEM_CAP = 96 * 1024;  // a chunk's y rows shrink to stay under
constexpr size_t SMEM_LIMIT = 232448;
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

struct RArgs {
  const float *x, *y, *wx, *wy, *g1, *g2;  // fused: x = sa, y = esa, wx = w, wy = ew
  float *out, *part;
  unsigned* count;
  int nx, ny, D, fused, tiles, chunks0, chunks1;
  float invd;
};

// Floats of shared memory: centre, the two column sums' thread shares, the
// weight sums' warp shares, the x tile's 16 partial rows, x tile, norms,
// y chunk, norms, weights. The tiles are feature-major with their row
// counts padded by one, so a row's features fall in different banks.
size_t smem_floats(int D, int tiles) {
  const size_t NY = (size_t)tiles * TY;
  return (size_t)D + 2 * THREADS + 16 + 16 * TX + (size_t)D * (TX + 1) + TX + (NY + 1) * D + 2 * NY;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// This thread's share of sum(w[0..n)): a strided sum, then the warp's; lane
// 0 writes it to part[warp]. The block's total is then the warps' in order.
__device__ __forceinline__ void warp_total(const float* w, int n, float* part) {
  float s = 0.f;
#pragma unroll 4
  for (int e = threadIdx.x; e < n; e += THREADS) s += w[e];
  s = warp_sum(s);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = s;
}

__device__ __forceinline__ float warps_total(const float* part) {
  float t = 0.f;
#pragma unroll
  for (int k = 0; k < THREADS / 32; ++k) t += part[k];
  return t;
}

// This thread's share of the column sums of a (n, D): THREADS / D groups of
// D threads walk the flat array (column t % D, coalesced); column d's sum is
// then its groups' in group order (colsum_total).
__device__ __forceinline__ float colsum_part(const float* a, int n, int D) {
  const int span = THREADS / D * D, t = threadIdx.x;
  float s = 0.f;
  if (t < span) {
#pragma unroll 8
    for (ll e = t; e < (ll)n * D; e += span) s += a[e];
  }
  return s;
}

__device__ __forceinline__ float colsum_total(const float* part, int D, int d) {
  float c = 0.f;
  for (int k = d; k < THREADS / D * D; k += D) c += part[k];
  return c;
}

__global__ void __launch_bounds__(THREADS) rowsum_kernel(const __grid_constant__ RArgs a) {
  extern __shared__ __align__(16) float sm[];
  const int z = blockIdx.z, chunk = blockIdx.y, xt = blockIdx.x, tid = threadIdx.x;
  if (chunk >= (z ? a.chunks1 : a.chunks0)) return;
  const int D = a.D, NY = a.tiles * TY, XS = TX + 1, YS = NY + 1;
  const float* y = z ? a.x : a.y;  // the self sum's y rows are the x rows
  const float* wy = z ? a.wx : a.wy;
  const int ny = z ? a.nx : a.ny;
  float* cen = sm;                 // D
  float* colx = cen + D;           // THREADS, then THREADS for y
  float* coly = colx + THREADS;
  float* wpart = coly + THREADS;   // the y weights' warp sums, then the x weights'
  float* red = wpart + 16;         // 16 x TX
  float* xs = red + 16 * TX;       // (D, TX), rows XS apart
  float* xsq = xs + D * XS;
  float* ys = xsq + TX;            // (D, NY), rows YS apart
  float* ysq = ys + D * YS;
  float* wys = ysq + NY;

  // one pass of loads: the raw x tile, y chunk and its weights, and where
  // fused, this thread's share of the means and weight sums
  const int x0 = xt * TX, y0 = chunk * NY, n = min(NY, ny - y0);
#pragma unroll 4
  for (int e = tid; e < TX * D; e += THREADS) {
    const int i = e / D, d = e % D;
    xs[d * XS + i] = x0 + i < a.nx ? a.x[(ll)(x0 + i) * D + d] : 0.f;
  }
#pragma unroll 8
  for (int e = tid; e < n * D; e += THREADS) {
    const int j = e / D, d = e % D;
    ys[d * YS + j] = y[(ll)(y0 + j) * D + d];
  }
  for (int e = tid; e < (NY - n) * D; e += THREADS) {
    const int j = n + e / D, d = e % D;
    ys[d * YS + j] = 0.f;
  }
#pragma unroll 2
  for (int j = tid; j < NY; j += THREADS) wys[j] = j < n ? wy[y0 + j] : 0.f;
  if (a.fused) {
    colx[tid] = colsum_part(a.x, a.nx, D);
    if (z == 0) coly[tid] = colsum_part(a.y, a.ny, D);
    warp_total(wy, ny, wpart);
    warp_total(a.wx, a.nx, wpart + 8);
  }
  __syncthreads();

  // the centre 0.5 (mean x + mean y) and the y weights' scale
  float wscale = 1.f;
  if (a.fused) {
    if (tid < D) {
      const float mx = colsum_total(colx, D, tid) / (float)a.nx;
      cen[tid] = 0.5f * (mx + (z ? mx : colsum_total(coly, D, tid) / (float)a.ny));
    }
    wscale = warps_total(wpart);
  } else if (tid < D) {
    cen[tid] = 0.f;
  }
  __syncthreads();

  // centre the rows in place, with their squared norms; scale the weights
  for (int j = tid; j < NY + TX; j += THREADS) {
    float* v = j < NY ? ys + j : xs + (j - NY);
    const int stride = j < NY ? YS : XS;
    const bool live = j < n || j >= NY;
    float s = 0.f;
    for (int d = 0; d < D; ++d) {
      const float c = live ? v[d * stride] - cen[d] : 0.f;
      v[d * stride] = c;
      s = fmaf(c, c, s);
    }
    if (j < NY) {
      ysq[j] = s;
      wys[j] = a.fused ? wys[j] / wscale : wys[j];
    } else {
      xsq[j - NY] = s;
    }
  }
  __syncthreads();

  // 2 x rows (tx, tx + 16) x 4 y rows (ty + 16 q) of each tile a thread
  const int tx = tid & 15, ty = tid >> 4;
  const float g1 = a.g1[0], g2 = a.g2[0];
  const float xq0 = xsq[tx], xq1 = xsq[tx + 16];
  float acc0 = 0.f, acc1 = 0.f;
  const int span = cdiv(n, TY) * TY;
  for (int tb = 0; tb < span; tb += TY) {
    float c0[4] = {0.f, 0.f, 0.f, 0.f}, c1[4] = {0.f, 0.f, 0.f, 0.f};
    for (int d = 0; d < D; ++d) {
      const float xa = xs[d * XS + tx], xb = xs[d * XS + tx + 16];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float yv = ys[d * YS + tb + ty + 16 * q];
        c0[q] = fmaf(xa, yv, c0[q]);
        c1[q] = fmaf(xb, yv, c1[q]);
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = tb + ty + 16 * q;
      const float yq = ysq[j], w = wys[j];
      const float da = fmaxf(fmaf(-2.f, c0[q], xq0 + yq), 0.f) * a.invd;
      const float db = fmaxf(fmaf(-2.f, c1[q], xq1 + yq), 0.f) * a.invd;
      acc0 = fmaf(expf(-g1 * da) + expf(-g2 * da), w, acc0);
      acc1 = fmaf(expf(-g1 * db) + expf(-g2 * db), w, acc1);
    }
  }
  red[ty * TX + tx] = acc0;
  red[ty * TX + tx + 16] = acc1;
  __syncthreads();
  const int slot = z ? a.chunks0 + chunk : chunk;
  if (tid < TX && x0 + tid < a.nx) {
    float s = 0.f;
    for (int k = 0; k < 16; ++k) s += red[k * TX + tid];
    if (a.chunks0 + a.chunks1 == 1) {  // one block covers the row sums: no combine
      a.out[x0 + tid] = s;
      return;
    }
    a.part[(ll)slot * a.nx + x0 + tid] = s;
  }
  if (a.chunks0 + a.chunks1 == 1) return;

  // the last block of the x tile sums the chunks in chunk order
  __shared__ unsigned last;
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(a.count + xt, 1u) + 1 == (unsigned)(a.chunks0 + a.chunks1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float wsum = a.fused ? warps_total(wpart + 8) : 1.f;
  if (tid < TX && x0 + tid < a.nx) {
    const int i = x0 + tid;
    float sim = 0.f;
    for (int c = 0; c < a.chunks0; ++c) sim += __ldcg(a.part + (ll)c * a.nx + i);
    if (a.fused) {
      float self = 0.f;
      for (int c = 0; c < a.chunks1; ++c) self += __ldcg(a.part + (ll)(a.chunks0 + c) * a.nx + i);
      a.out[i] = (a.wx[i] / wsum) * (sim - self);
    } else {
      a.out[i] = sim;
    }
  }
}

// The grid for nx x ny (and the nx x nx self sum where fused): y tiles a
// chunk, chunks of each sum, x tiles, shared memory; false if it cannot run.
struct Plan {
  int xtiles, tiles, chunks0, chunks1;
  size_t smem;
};

bool plan(int nx, int ny, int D, int fused, Plan* p) {
  if (nx < 1 || ny < 1 || D < 1 || D > MAX_D) return false;
  p->xtiles = cdiv(nx, TX);
  const int yt0 = cdiv(ny, TY), yt1 = fused ? cdiv(nx, TY) : 0;
  int tiles = cdiv(p->xtiles * (yt0 + yt1), TARGET_BLOCKS);
  tiles = tiles > MAX_TILES ? MAX_TILES : tiles;
  while (tiles > 1 && sizeof(float) * smem_floats(D, tiles) > SMEM_CAP) --tiles;
  p->tiles = tiles;
  p->chunks0 = cdiv(yt0, tiles);
  p->chunks1 = fused ? cdiv(yt1, tiles) : 0;
  p->smem = sizeof(float) * smem_floats(D, tiles);
  return p->smem <= SMEM_LIMIT;
}

int launch(RArgs a, int fused, void* scratch, void* stream) {
  Plan p;
  if (!plan(a.nx, a.ny, a.D, fused, &p)) return (int)cudaErrorInvalidValue;
  a.fused = fused;
  a.tiles = p.tiles;
  a.chunks0 = p.chunks0;
  a.chunks1 = p.chunks1;
  a.part = static_cast<float*>(scratch);
  a.count = reinterpret_cast<unsigned*>(a.part + (ll)a.nx * (p.chunks0 + p.chunks1));
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t e = cudaSuccess;
  if (p.chunks0 + p.chunks1 > 1) {  // the counters of the last-block combine
    e = cudaMemsetAsync(a.count, 0, sizeof(unsigned) * p.xtiles, s);
    if (e != cudaSuccess) return (int)e;
  }
  if (p.smem > 48 * 1024) {
    e = cudaFuncSetAttribute(rowsum_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int chunks = p.chunks0 > p.chunks1 ? p.chunks0 : p.chunks1;
  rowsum_kernel<<<dim3(p.xtiles, chunks, fused ? 2 : 1), THREADS, p.smem, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Scratch floats of a launch: the chunks' partial sums, then the x tiles'
// counters; -1 if the shape cannot run.
extern "C" long long iltpu_rowsum_scratch_floats(int nx, int ny, int D, int fused) {
  Plan p;
  if (!plan(nx, ny, D, fused, &p)) return -1;
  return (ll)nx * (p.chunks0 + p.chunks1) + p.xtiles;
}

// One row sum on centred x (nx, D), y (ny, D) with weights w (ny,).
extern "C" int iltpu_gaussian_rowsum(const void* x, const void* y, const void* w, const void* g1,
                                     const void* g2, int nx, int ny, int D, float invd, void* out,
                                     void* scratch, void* stream) {
  RArgs a = {};
  a.x = static_cast<const float*>(x);
  a.y = static_cast<const float*>(y);
  a.wy = static_cast<const float*>(w);
  a.g1 = static_cast<const float*>(g1);
  a.g2 = static_cast<const float*>(g2);
  a.out = static_cast<float*>(out);
  a.nx = nx;
  a.ny = ny;
  a.D = D;
  a.invd = invd;
  return launch(a, 0, scratch, stream);
}

// GMMIL's reward on raw sa (B, D), esa (E, D), weights w (B,), ew (E,).
extern "C" int iltpu_gmmil_reward(const void* sa, const void* esa, const void* w, const void* ew,
                                  const void* g1, const void* g2, int B, int E, int D, float invd,
                                  void* out, void* scratch, void* stream) {
  RArgs a = {};
  a.x = static_cast<const float*>(sa);
  a.y = static_cast<const float*>(esa);
  a.wx = static_cast<const float*>(w);
  a.wy = static_cast<const float*>(ew);
  a.g1 = static_cast<const float*>(g1);
  a.g2 = static_cast<const float*>(g2);
  a.out = static_cast<float*>(out);
  a.nx = B;
  a.ny = E;
  a.D = D;
  a.invd = invd;
  return launch(a, 1, scratch, stream);
}
