// The arithmetic of one SAC update, shared by the per-update kernels
// (sac_update.cu) and the K-blocked persistent kernel (kblock_update.cu),
// so both run one copy of the math, as the TPU's `_sac_core` is shared by
// pallas_sac.py and pallas_fused_block.py.
//
// What bounds an update on the H100: at the main path's shapes (batch 256,
// width 256) it is ~0.55 GFLOP of fp32 products, under 10 us at 67 TFLOP/s,
// spread over 21 dependent phases of up to a few hundred work items each:
// one wave on 132 SMs, so a phase costs the latency of its slowest item
// plus a grid barrier, and an item must not make a dependent trip to L2 per
// step of k. So a tile copies its whole-depth panels into shared memory at
// once (one trip, cp.async), then runs the 256-long fmaf chains from shared
// memory, 4 to 16 outputs on each of 256 threads; a phase's tiles are 32 or
// 64 on a side, chosen from its shapes and the grid (grid_exec.cuh's plan)
// so that it takes as few rounds of items over the blocks as its work
// allows (at batch 1024, one round of 64x64 tiles where 32x32 tiles took
// four). The
// five products whose output is only 1 to
// 2A columns wide (the heads, the action columns of an input gradient) run
// as row-owned items instead, each with the elementwise row step after it
// and the rank-1 input gradient from that step's output fused in: 8 fewer
// phases, and barriers, than running them as tiles.
//
// What lives here:
//  - `gemm_tile<NT, TM, TN, RM, RN>`: one TM x TN output tile of a strided
//    fp32 product, RM x RN outputs a thread, run by a block of NT threads.
//    Every output is one fmaf chain over k in ascending order, so any tile
//    and any instance give the same bits;
//  - elementwise functors, each `operator()(int i)` for one item (a batch
//    row, a column, a parameter element), and the single-block temperature
//    step, whose reduction has a fixed logical width RED whatever the block;
//  - row-owned functors, each `run<NT>(r0, nr)` for the rows [r0, r0 + nr)
//    of one item: a narrow product as one fmaf chain an output, the same
//    chains as the tile's, then the row step's functor on those rows;
//  - `sac_step<Exec>`: the update as a sequence of phases. `Exec` runs a
//    phase's jobs (`gemm`, `rows`, `cols`, `block`, `row_items`) as
//    grid-stride loops over a range of blocks, `sync()` is a barrier over
//    that range between phases that depend on each other, and
//    `await_rewards()` waits, just before the first phase that reads the
//    rewards, for those of another block's GAIL step where there is one
//    (grid_exec.cuh). Jobs within a phase are independent of each other.
//    `gx::PlanExec` runs it on the host with no data, recording each
//    phase's jobs, from which `gx::plan_step` picks the tiles.
//
// Nothing reads a tensor through __ldg or `const __restrict__`: another
// block wrote it in an earlier phase. Panels are copied with .cg (L2) loads.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace sac {

typedef long long ll;

constexpr int RED = 256;  // logical width of the temperature reduction

constexpr float B1 = 0.9f;
constexpr float B2 = 0.999f;
constexpr float OMB1 = (float)(1.0 - 0.9);
constexpr float OMB2 = (float)(1.0 - 0.999);
constexpr float ADAM_EPS = 1e-8f;
constexpr float LOG_B1 = (float)-0.10536051565782628;   // log(0.9)
constexpr float LOG_B2 = (float)-0.0010005003335835335; // log(0.999)
constexpr float LOG2 = (float)0.6931471805599453;
constexpr float LOG2PI = (float)1.8378770664093453;

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

struct Gemm {
  // C[z](m, n) = sum_k A[z](m, k) B[z](k, n) (+ bias[z](n)) (relu) (* mask>0)
  const float* a; ll a_z, a_m, a_k;
  const float* b; ll b_z, b_k, b_n;
  float* c; ll c_z, c_m, c_n;
  const float* bias; ll bias_z;
  const float* mask; ll mask_z, mask_m, mask_n;
  int m, n, k, relu;
};

// ---- the GEMM tile: whole-depth panels in dynamic shared memory ----------
//
// An output tile is TM x TN, each 32 or 64 (`tile_rows`, `tile_cols` of the
// tile's index, chosen a GEMM job by the executor's plan: grid_exec.cuh).
// Its A panel (TM rows x depth) and B panel (depth x TN columns) are copied
// into shared memory at once (16-byte cp.async.cg where the source is
// contiguous and aligned, 4-byte L2 loads elsewhere) by all the block's
// threads, then TILE_THREADS of them run the fmaf chains from shared
// memory, RM x RN outputs each (tile_rm, tile_rn). A depth past KWHOLE goes in
// KRING-deep chunks through a ring of two stages, the next chunk copied
// while this one is computed. The k padding of a panel is zero, and
// fmaf(0, 0, acc) == acc (acc starts at +0 and is never -0), so each output
// is the same chain over k as without padding, whatever the tile.
//
// A panel is stored k-major (element (o, k) at k * O + o, O its TM or TN)
// when its source is contiguous along the outer index, else outer-major (at
// o * ld + k, ld = the depth rounded up to 8, plus 4). The threads of a warp
// cover 4 x 8 of the tile's thread grid, and a thread's outputs lie where
// its loads are widest: along a k-major panel, its RM rows (RN columns)
// side by side, read as one vector a k; across an outer-major one, a grid's
// height (width) apart, each read as a float4 along k, the warp's 4 (8)
// neighbouring rows in distinct banks since ld is 4 mod 8.

constexpr int TILE = 32;      // the smaller tile edge
constexpr int TILE_MAX = 64;  // the larger: a panel's rows in shared memory
constexpr int TILES = 4;      // 32x32, 64x32, 32x64, 64x64
constexpr int KWHOLE = 256;   // deepest product held whole (a 64-row panel pair: 133 KB)
constexpr int KRING = 128;    // chunk depth past KWHOLE

__host__ __device__ constexpr int tile_rows(int t) { return TILE << (t & 1); }
__host__ __device__ constexpr int tile_cols(int t) { return TILE << (t >> 1); }
// A thread's outputs in tile t, rows by columns: every tile runs on
// TILE_THREADS threads, 4, 8, 8 and 16 outputs a thread. The block's
// shared memory serves one 128-byte wavefront a cycle and a thread reads
// one float for each row and each column of its outputs at each k, so the
// fewer outputs a thread, the more reads an fmaf: on all 512 threads (2 to
// 8 outputs) every tile ran slower on the H100 than on these 256 (at batch
// 1024 the update took 425 us against 357, at hopper's 180 against 166).
constexpr int TILE_THREADS = 256;
__host__ __device__ constexpr int tile_rm(int t) { return t == 1 || t == 3 ? 4 : 2; }
__host__ __device__ constexpr int tile_rn(int t) { return t < 2 ? 2 : 4; }

__host__ __device__ inline int round_up(int a, int b) { return (a + b - 1) / b * b; }

// Floats of one panel of depth kc in either layout, at the larger edge.
__host__ __device__ inline int panel_floats(int kc) { return TILE_MAX * (round_up(kc, 8) + 4); }

// The chunk depth for products up to kmax deep: the whole depth if it fits.
__host__ __device__ inline int gemm_chunk(int kmax) {
  return kmax <= KWHOLE ? round_up(kmax, 4) : KRING;
}

// Dynamic shared memory of the GEMM for products up to kmax deep: one stage
// of two panels, or a ring of two stages.
__host__ __device__ inline size_t gemm_smem_bytes(int kmax) {
  return sizeof(float) * (kmax <= KWHOLE ? 1 : 2) * 2 * (size_t)panel_floats(gemm_chunk(kmax));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

// Elements [0, n) of a 4-byte copy, NT threads, 8 loads a thread in flight
// before their 8 stores: f(e, true, _) loads element e, f(e, false, v)
// stores it. Loads interleaved with stores through a pointer the compiler
// cannot tell from global memory would each wait for the last.
template <int NT, class F>
__device__ __forceinline__ void for_batched(int n, const F& f) {
  constexpr int U = 8;
  for (int e0 = threadIdx.x; e0 < n; e0 += U * NT) {
    float v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) v[u] = e0 + u * NT < n ? f(e0 + u * NT, true, 0.f) : 0.f;
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (e0 + u * NT < n) f(e0 + u * NT, false, v[u]);
  }
}

// Copy rows [o0, o0 + O) x depth [k0, k0 + kc) of a source with `no` rows
// and `nk` deep (strides so, sk) into panel s; zeros outside.
template <int NT, int O>
__device__ void load_panel(float* s, const float* src, ll so, ll sk, int o0, int no, int k0, int nk,
                           int kc) {
  const bool om = sk == 1 && so != 1;  // outer-major
  const int ld = round_up(kc, 8) + 4;
  const bool aligned = ((unsigned long long)src & 15) == 0 && (k0 & 3) == 0;
  if (om) {
    if (aligned && so % 4 == 0) {
      const int q = kc / 4;
      for (int e = threadIdx.x; e < O * q; e += NT) {
        const int r = e / q, kk = 4 * (e % q);
        const int go = o0 + r, gk = k0 + kk;
        float* d = s + r * ld + kk;
        if (go < no && gk + 3 < nk) {
          cp_async16(d, src + go * so + gk);
        } else {
          for (int j = 0; j < 4; ++j) d[j] = (go < no && gk + j < nk) ? __ldcg(src + go * so + gk + j) : 0.f;
        }
      }
    } else {
      for_batched<NT>(O * kc, [&](int e, bool load, float v) {
        const int r = e / kc, kk = e % kc;
        const int go = o0 + r, gk = k0 + kk;
        if (load) return (go < no && gk < nk) ? __ldcg(src + go * so + gk) : 0.f;
        s[r * ld + kk] = v;
        return 0.f;
      });
    }
  } else {
    if (aligned && so == 1 && sk % 4 == 0) {
      for (int e = threadIdx.x; e < kc * (O / 4); e += NT) {
        const int kk = e / (O / 4), r = 4 * (e % (O / 4));
        const int go = o0 + r, gk = k0 + kk;
        float* d = s + kk * O + r;
        if (gk < nk && go + 3 < no) {
          cp_async16(d, src + go + gk * sk);
        } else {
          for (int j = 0; j < 4; ++j) d[j] = (gk < nk && go + j < no) ? __ldcg(src + go + j + gk * sk) : 0.f;
        }
      }
    } else {
      for_batched<NT>(kc * O, [&](int e, bool load, float v) {
        const int kk = e / O, r = e % O;
        const int go = o0 + r, gk = k0 + kk;
        if (load) return (go < no && gk < nk) ? __ldcg(src + go * so + gk * sk) : 0.f;
        s[kk * O + r] = v;
        return 0.f;
      });
    }
  }
}

// R consecutive floats of shared memory, one load (R = 1, 2 or 4).
template <int R>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[R]) {
  if constexpr (R == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else if constexpr (R == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x; v[1] = t.y;
  } else {
    static_assert(R == 1, "one, two or four floats");
    v[0] = *p;
  }
}

// A tile's threads: a GY x GX grid (GY = TM / RM, GX = TN / RN), each
// thread RM x RN outputs; a warp covers 4 neighbouring ty by 8 neighbouring
// tx. Thread (ty, tx)'s output row i and column j.
template <int GX>
__device__ __forceinline__ int tile_ty() {
  return (int)(threadIdx.x >> 5) / (GX / 8) * 4 + (int)((threadIdx.x & 31) >> 3);
}
template <int GX>
__device__ __forceinline__ int tile_tx() {
  return (int)(threadIdx.x >> 5) % (GX / 8) * 8 + (int)(threadIdx.x & 7);
}
template <int GY, int RM>
__device__ __forceinline__ int out_row(bool aom, int ty, int i) { return aom ? ty + GY * i : ty * RM + i; }
template <int GX, int RN>
__device__ __forceinline__ int out_col(bool bom, int tx, int j) { return bom ? tx + GX * j : tx * RN + j; }

// acc[i][j] += sum over the kc-deep chunk of A(out_row(i), k) B(k,
// out_col(j)), in ascending k; AOM / BOM: the panel is outer-major.
template <bool AOM, bool BOM, int TM, int TN, int RM, int RN>
__device__ __forceinline__ void chunk_fma(const float* as, const float* bs, int kc,
                                          float (&acc)[RM][RN], int ty, int tx) {
  constexpr int GY = TM / RM, GX = TN / RN;
  const int ld = round_up(kc, 8) + 4;
  const float* ap = AOM ? as + ty * ld : as + ty * RM;
  const float* bp = BOM ? bs + tx * ld : bs + tx * RN;
  for (int k0 = 0; k0 < kc; k0 += 4) {
    float a[RM][4], b[RN][4];
    if (AOM) {
#pragma unroll
      for (int i = 0; i < RM; ++i) load_vec<4>(ap + GY * i * ld + k0, a[i]);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float v[RM];
        load_vec<RM>(ap + (k0 + q) * TM, v);
#pragma unroll
        for (int i = 0; i < RM; ++i) a[i][q] = v[i];
      }
    }
    if (BOM) {
#pragma unroll
      for (int j = 0; j < RN; ++j) load_vec<4>(bp + GX * j * ld + k0, b[j]);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float v[RN];
        load_vec<RN>(bp + (k0 + q) * TN, v);
#pragma unroll
        for (int j = 0; j < RN; ++j) b[j][q] = v[j];
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(a[i][q], b[j][q], acc[i][j]);
  }
}

// Output tile (tm, tn) of twin z, TM x TN, RM x RN outputs on each of the
// first TM TN / (RM RN) of the block's NT threads (every thread copies);
// the block's dynamic shared memory holds gemm_smem_bytes(kmax) for a chunk
// depth kc = gemm_chunk(kmax). It is reached through an extern __shared__
// array, not a pointer handed in, so the compiler keeps shared-memory loads
// (LDS) rather than generic ones, which run the tile at about half speed.
// Ends with the block synchronised, so the panels can be reused.
template <int NT, int TM, int TN, int RM, int RN>
__device__ void gemm_tile(const Gemm& g, int z, int tm, int tn, int kc) {
  constexpr int GY = TM / RM, GX = TN / RN, CT = GY * GX;  // CT threads compute
  static_assert(TM % RM == 0 && TN % RN == 0 && GX % 8 == 0 && GY % 4 == 0 && CT <= NT,
                "a tile's computing threads are whole warps of 4 x 8");
  extern __shared__ __align__(16) float smem[];
  const int m0 = tm * TM;
  const int n0 = tn * TN;
  const float* A = g.a + z * g.a_z;
  const float* Bm = g.b + z * g.b_z;
  const bool aom = g.a_k == 1 && g.a_m != 1;
  const bool bom = g.b_k == 1 && g.b_n != 1;
  const int nch = cdiv(g.k, kc);
  const int c = nch == 1 ? round_up(g.k, 4) : kc;  // this product's chunk depth
  const int pf = panel_floats(kc);
  const int stage = 2 * pf;
  auto load = [&](int ch) {
    float* st = smem + (ch & 1) * stage;
    load_panel<NT, TM>(st, A, g.a_m, g.a_k, m0, g.m, ch * c, g.k, c);
    load_panel<NT, TN>(st + pf, Bm, g.b_n, g.b_k, n0, g.n, ch * c, g.k, c);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  const int ty = tile_ty<GX>(), tx = tile_tx<GX>();
  float acc[RM][RN] = {};
  load(0);
  for (int ch = 0; ch < nch; ++ch) {
    if (ch + 1 < nch) {
      load(ch + 1);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    if (CT == NT || (int)threadIdx.x < CT) {
      const float* as = smem + (ch & 1) * stage;
      const float* bs = as + pf;
      if (aom && bom) chunk_fma<true, true, TM, TN, RM, RN>(as, bs, c, acc, ty, tx);
      else if (aom) chunk_fma<true, false, TM, TN, RM, RN>(as, bs, c, acc, ty, tx);
      else if (bom) chunk_fma<false, true, TM, TN, RM, RN>(as, bs, c, acc, ty, tx);
      else chunk_fma<false, false, TM, TN, RM, RN>(as, bs, c, acc, ty, tx);
    }
    __syncthreads();
  }
  if (CT < NT && (int)threadIdx.x >= CT) return;
  for (int i = 0; i < RM; ++i) {
    for (int j = 0; j < RN; ++j) {
      const int gm = m0 + out_row<GY, RM>(aom, ty, i);
      const int gn = n0 + out_col<GX, RN>(bom, tx, j);
      if (gm >= g.m || gn >= g.n) continue;
      float v = acc[i][j];
      if (g.bias) v += g.bias[z * g.bias_z + gn];
      if (g.relu) v = fmaxf(v, 0.f);
      if (g.mask && !(g.mask[z * g.mask_z + gm * g.mask_m + gn * g.mask_n] > 0.f)) v = 0.f;
      g.c[z * g.c_z + gm * g.c_m + gn * g.c_n] = v;
    }
  }
}

// The deepest product of an update: k is S, X or H forward, B for the
// weight gradients, H, 1 or 2A for the input gradients.
__host__ __device__ inline int gemm_depth(int B, int S, int A, int H) {
  const int X = S + A;
  int k = B > H ? B : H;
  k = k > X ? k : X;
  return k > 2 * A ? k : 2 * A;
}

// out[z] (M, N) = x[z] (M, K) @ W[z] (K, N) + b[z] (relu); row-major.
__host__ __device__ inline Gemm linear(const float* x, ll x_z, const float* W, const float* b,
                                       float* out, int M, int K, int N, bool relu) {
  Gemm g = {};
  g.a = x; g.a_z = x_z; g.a_m = K; g.a_k = 1;
  g.b = W; g.b_z = (ll)K * N; g.b_k = N; g.b_n = 1;
  g.c = out; g.c_z = (ll)M * N; g.c_m = N; g.c_n = 1;
  g.bias = b; g.bias_z = N;
  g.m = M; g.n = N; g.k = K; g.relu = relu;
  return g;
}

// gW[z] (K, N) = h[z]^T (K, M) @ dz[z] (M, N)
__host__ __device__ inline Gemm weight_grad(const float* h, ll h_z, const float* dz, float* gW,
                                            int M, int K, int N) {
  Gemm g = {};
  g.a = h; g.a_z = h_z; g.a_m = 1; g.a_k = K;
  g.b = dz; g.b_z = (ll)M * N; g.b_k = N; g.b_n = 1;
  g.c = gW; g.c_z = (ll)K * N; g.c_m = N; g.c_n = 1;
  g.m = K; g.n = N; g.k = M;
  return g;
}

// out[z] (M, Kin) = (dz[z] (M, N) @ W[z]^T) * (mask[z] > 0), W[z] (Kin, N)
// row-major with twin stride w_z; `out` has row stride out_m.
__host__ __device__ inline Gemm input_grad(const float* dz, const float* W, ll w_z,
                                           const float* mask, float* out, ll out_m, int M,
                                           int Kin, int N) {
  Gemm g = {};
  g.a = dz; g.a_z = (ll)M * N; g.a_m = N; g.a_k = 1;
  g.b = W; g.b_z = w_z; g.b_k = 1; g.b_n = N;
  g.c = out; g.c_z = (ll)M * out_m; g.c_m = out_m; g.c_n = 1;
  g.mask = mask; g.mask_z = (ll)M * Kin; g.mask_m = Kin; g.mask_n = 1;
  g.m = M; g.n = Kin; g.k = N;
  return g;
}

__device__ __forceinline__ float softplusf(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float alpha_of(const float* la, float min_alpha) {
  const float a = expf(la[0]);
  return min_alpha > 0.f ? fmaxf(a, min_alpha) : a;
}

// Tanh-Gaussian log-prob of z = mu + exp(ls) eps, summed over the actions.
__device__ inline float head_log_prob(const float* o, const float* eps, int A) {
  float lp = 0.f;
  for (int j = 0; j < A; ++j) {
    const float ls = fminf(fmaxf(o[A + j], -20.f), 2.f);
    const float e = eps[j];
    const float zz = o[j] + expf(ls) * e;
    const float n = -0.5f * (e * e + 2.f * ls + LOG2PI);
    const float t = 2.f * (LOG2 - zz - softplusf(-2.f * zz));
    lp += n - t;
  }
  return lp;
}

// Rows [0, n) x columns [0, k) of src (row stride ss) into dst (row stride
// ds), the block's threads along the rows. A plain loop: with a few
// elements a thread, for_batched's L2 loads made a phase 3 us longer on the
// H100.
template <int NT>
__device__ void copy_rows(float* dst, ll ds, const float* src, ll ss, int n, int k) {
  for (int e = threadIdx.x; e < n * k; e += NT) {
    const int r = e / k, c = e % k;
    dst[r * ds + c] = src[r * ss + c];
  }
}

// A row step of a row-owned phase is `operator()(b)`, a thread a row, run
// after the narrow product's chains, and `stage<NT>(r0, nr)`, run by the
// block over the item's rows while their inputs are copied in: the copies
// into the next product's input rows that need no output of this one
// (done a thread a row inside the step, they were its longest part).

// Sample from the actor head o (B, 2A): log-probs, and the critic input
// rows x = [s, keep * tanh(z)] with keep = 1 - absorbing (or 1). Row b;
// `stage` copies the rows' s.
struct HeadSample {
  const float *o, *eps, *s, *ab;
  int S, A;
  float *lp, *x;
  template <int NT>
  __device__ void stage(int r0, int nr) const {
    copy_rows<NT>(x + (ll)r0 * (S + A), S + A, s + (ll)r0 * S, S, nr, S);
  }
  __device__ void operator()(int b) const {
    const float* ob = o + (ll)b * 2 * A;
    const float* eb = eps + (ll)b * A;
    lp[b] = head_log_prob(ob, eb, A);
    const int X = S + A;
    const float keep = ab ? 1.f - ab[b] : 1.f;
    for (int j = 0; j < A; ++j) {
      const float ls = fminf(fmaxf(ob[A + j], -20.f), 2.f);
      const float zz = ob[j] + expf(ls) * eb[j];
      x[(ll)b * X + S + j] = keep * tanhf(zz);
    }
  }
};

// TD target from the target twin's q (2, B); `stage` writes the critic
// input [s, a].
struct Td {
  const float *tq, *r, *term, *ab, *lp2, *la;
  float min_alpha, discount;
  const float *s, *a;
  int B, S, A;
  float *td, *x;
  template <int NT>
  __device__ void stage(int r0, int nr) const {
    const int X = S + A;
    copy_rows<NT>(x + (ll)r0 * X, X, s + (ll)r0 * S, S, nr, S);
    copy_rows<NT>(x + (ll)r0 * X + S, X, a + (ll)r0 * A, A, nr, A);
  }
  __device__ void operator()(int b) const {
    const float alpha = alpha_of(la, min_alpha);
    const float target_v = fminf(tq[b], tq[B + b]) - (1.f - ab[b]) * alpha * lp2[b];
    td[b] = r[b] + (1.f - term[b]) * discount * target_v;
  }
};

// d(critic loss)/dq for both twins, and min Q for the aux output.
struct CriticDq {
  const float *q, *td, *w;
  int B;
  float *dq, *min_q;
  template <int NT>
  __device__ void stage(int, int) const {}
  __device__ void operator()(int b) const {
    const float c = 2.f / (float)B;
    dq[b] = c * w[b] * (q[b] - td[b]);
    dq[B + b] = c * w[b] * (q[B + b] - td[b]);
    min_q[b] = fminf(q[b], q[B + b]);
  }
};

// d(-mean min(q1, q2))/dq against the updated critic; ties pick twin 1.
struct SelectDq {
  const float* q;
  int B;
  float* dq;
  template <int NT>
  __device__ void stage(int, int) const {}
  __device__ void operator()(int b) const {
    const float sel1 = q[b] <= q[B + b] ? 1.f : 0.f;
    const float c = -1.f / (float)B;
    dq[b] = c * sel1;
    dq[B + b] = c * (1.f - sel1);
  }
};

// Hand-derived tanh-Gaussian backward: the gradient of the actor loss at
// the head output, dout (B, 2A), from the critic's action gradient da (2, B, A).
struct HeadBackward {
  const float *o, *eps, *da, *w, *ab, *la;
  float min_alpha;
  int B, A;
  float* dout;
  __device__ void operator()(int b) const {
    const float alpha = alpha_of(la, min_alpha);
    const float c_ent = w[b] * (1.f - ab[b]) * alpha / (float)B;
    for (int j = 0; j < A; ++j) {
      const float mu = o[(ll)b * 2 * A + j];
      const float l_raw = o[(ll)b * 2 * A + A + j];
      const float ls = fminf(fmaxf(l_raw, -20.f), 2.f);
      const float sg = expf(ls);
      const float e = eps[(ll)b * A + j];
      const float tz = tanhf(mu + sg * e);
      const float sech2 = 1.f - tz * tz;
      const float d = da[(ll)b * A + j] + da[(ll)(B + b) * A + j];
      const float g_mu = c_ent * (2.f * tz) + d * sech2;
      float g_ls = c_ent * (-1.f + 2.f * sg * e * tz) + d * sech2 * sg * e;
      if (!(l_raw >= -20.f && l_raw <= 2.f)) g_ls = 0.f;
      dout[(ll)b * 2 * A + j] = g_mu;
      dout[(ll)b * 2 * A + A + j] = g_ls;
    }
  }
};

// out[z](n) = sum over rows of x[z](rows, n), in row order; item z * cols + n.
struct Colsum {
  const float* x;
  int rows, cols;
  float* out;
  __device__ void operator()(int e) const {
    const int z = e / cols, n = e % cols;
    const float* xz = x + (ll)z * rows * cols;
    float acc = 0.f;
#pragma unroll 16
    for (int r = 0; r < rows; ++r) acc += xz[(ll)r * cols + n];
    out[(ll)z * cols + n] = acc;
  }
};

// AdamW on one tensor, element j (and Polyak when a target is given); the
// step clock is read here and advanced by Temperature. One job per tensor,
// so no pointer is picked by a run-time index (which put the pointer tables
// in local memory).
struct Adam {
  float* p;
  const float* g;
  float *m, *v, *target;
  const float* count;
  float lr, wd, polyak, polyak_c;
  __device__ void operator()(int j) const {
    const float t = count[0] + 1.f;
    const float gj = g[j];
    const float mm = B1 * m[j] + OMB1 * gj;
    const float vv = B2 * v[j] + OMB2 * gj * gj;
    const float mh = mm / (1.f - expf(t * LOG_B1));
    const float vh = vv / (1.f - expf(t * LOG_B2));
    const float pj = p[j];
    const float np = pj - lr * (mh / (sqrtf(vh) + ADAM_EPS) + wd * pj);
    m[j] = mm;
    v[j] = vv;
    p[j] = np;
    // rounded as the plain version's multi-tensor ops, with 1 - polyak taken
    // in double on the host
    if (target) target[j] = __fadd_rn(__fmul_rn(polyak, target[j]), __fmul_rn(polyak_c, np));
  }
};

// Temperature, one block of at least RED threads: plain Adam on log_alpha
// with the RAW alpha in its gradient; the floored pre-update alpha for the
// aux; then all three clocks advance.
struct Temperature {
  const float *lp, *w, *ab;
  int B;
  float entropy_target, alpha_lr, min_alpha;
  float *la, *lam, *lav, *ta, *tc, *tal, *alpha_out;
  __device__ void operator()() const {
    __shared__ float red[RED];
    const int tid = threadIdx.x;
    if (tid < RED) {
      float acc = 0.f;
      for (int b = tid; b < B; b += RED) acc += w[b] * (1.f - ab[b]) * (lp[b] + entropy_target);
      red[tid] = acc;
    }
    __syncthreads();
    for (int s = RED / 2; s > 0; s >>= 1) {
      if (tid < s) red[tid] += red[tid + s];
      __syncthreads();
    }
    if (tid == 0) {
      const float alpha_raw = expf(la[0]);
      const float g = -red[0] / (float)B * alpha_raw;
      const float t = tal[0] + 1.f;
      const float m = B1 * lam[0] + OMB1 * g;
      const float v = B2 * lav[0] + OMB2 * g * g;
      const float mh = m / (1.f - expf(t * LOG_B1));
      const float vh = v / (1.f - expf(t * LOG_B2));
      alpha_out[0] = fmaxf(alpha_raw, min_alpha);
      la[0] = la[0] - alpha_lr * (mh / (sqrtf(vh) + ADAM_EPS));
      lam[0] = m;
      lav[0] = v;
      ta[0] += 1.f;
      tc[0] += 1.f;
      tal[0] = t;
    }
  }
};

// ---- row-owned phases: a narrow product and the row step after it --------
//
// An item owns R consecutive batch rows. It copies their inputs and the
// narrow weights into shared memory (cp.async where 16-byte aligned), runs
// each output's fmaf chain over k in ascending order from +0 on one thread,
// then, as the tile's epilogue, adds the bias (and masks); it stores the
// outputs (the buffers keep what the tiles left in them) and runs the row
// step's functor on its own rows. Each output is the padded tile's bit for
// bit: the tile's padding only adds fmaf(0, 0, acc) == acc. Shared memory
// is the block's dynamic array, as for the tile.

constexpr int ROW_WAVE = 128;  // items a row-owned phase aims at: one round
                               // on the K-blocked kernel's SAC blocks (129)

// Row stride of staged rows of k floats: 16-byte rows that put the rows of
// neighbouring threads' chains in distinct banks.
__host__ __device__ inline int row_ld(int k) { return round_up(k, 4) + 4; }

// Floats an item of R rows stages, at most: the action rows' dz1 (2R rows),
// the critic's W1 action rows (2A), the actor's h2 (R) and its W3 (H x 2A).
__host__ __device__ inline int row_floats(int R, int A, int H) {
  return (3 * R + 2 * A) * row_ld(H) + round_up(2 * A * H, 4);
}

// R: the batch over ROW_WAVE items, fewer rows where they would outgrow the
// GEMM's shared memory (at least 1: the kernel's shared memory then grows).
__host__ __device__ inline int head_rows(int B, int S, int A, int H) {
  const int have = (int)(gemm_smem_bytes(gemm_depth(B, S, A, H)) / sizeof(float));
  int R = cdiv(B, ROW_WAVE);
  while (R > 1 && row_floats(R, A, H) > have) --R;
  return R;
}

// Dynamic shared memory of an update: the GEMM's or a row-owned item's.
__host__ __device__ inline size_t step_smem_bytes(int B, int S, int A, int H) {
  const size_t g = gemm_smem_bytes(gemm_depth(B, S, A, H));
  const size_t r = sizeof(float) * (size_t)row_floats(head_rows(B, S, A, H), A, H);
  return g > r ? g : r;
}

// Rows [0, n) of k floats at src (row stride so) into dst (row stride ld, a
// multiple of 4), committed as one cp.async group; see `staged`.
template <int NT>
__device__ void stage_rows(float* dst, int ld, const float* src, ll so, int n, int k) {
  if (((unsigned long long)src & 15) == 0 && k % 4 == 0 && so % 4 == 0) {
    const int q = k / 4;
    for (int e = threadIdx.x; e < n * q; e += NT) {
      const int r = e / q, c = 4 * (e % q);
      cp_async16(dst + r * ld + c, src + r * so + c);
    }
  } else {
    for_batched<NT>(n * k, [&](int e, bool load, float v) {
      const int r = e / k, c = e % k;
      if (load) return __ldcg(src + r * so + c);
      dst[r * ld + c] = v;
      return 0.f;
    });
  }
}

// Every staged copy landed and is seen by the whole block.
__device__ __forceinline__ void staged() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
}

// sum_k x[k] w[k wk], one fmaf chain in ascending k from +0.
__device__ __forceinline__ float row_chain(const float* x, const float* w, int wk, int k) {
  float acc = 0.f;
#pragma unroll 8
  for (int i = 0; i < k; ++i) acc = fmaf(x[i], w[i * wk], acc);
  return acc;
}

// The actor's head on s' and on s, o (B, 2A) = h2 (B, H) @ W3 (H, 2A) + b3,
// then HeadSample on each: the tiles' phase and the head samples' phase.
struct ActorHeads {
  const float *h2a, *h2b, *W, *bias;  // ah2, bh2; the actor's W3, b3
  int H, O;
  float *oa, *ob;                     // ao, bo
  HeadSample sa, sb;
  template <int NT>
  __device__ void run(int r0, int nr) const {
    extern __shared__ __align__(16) float smem[];
    const int ld = row_ld(H);
    float* xs = smem;  // product p's row r at (p nr + r) ld
    float* ws = smem + 2 * nr * ld;
    stage_rows<NT>(xs, ld, h2a + (ll)r0 * H, H, nr, H);
    stage_rows<NT>(xs + nr * ld, ld, h2b + (ll)r0 * H, H, nr, H);
    stage_rows<NT>(ws, 0, W, 0, 1, H * O);
    sa.template stage<NT>(r0, nr);
    sb.template stage<NT>(r0, nr);
    staged();
    for (int e = threadIdx.x; e < 2 * nr * O; e += NT) {
      const int pr = e / O, n = e % O;
      const float v = row_chain(xs + pr * ld, ws + n, O, H) + bias[n];
      (pr < nr ? oa : ob)[(ll)(r0 + pr % nr) * O + n] = v;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < 2 * nr; e += NT) {
      if (e < nr) sa(r0 + e);
      else sb(r0 + e - nr);
    }
  }
};

// Both twins' Q head, q[z](b) = h2[z] (B, H) @ W3[z] (H, 1) + b3[z], then
// the row step F on the rows; where dz2 is given, also dz2[z] (B, H) =
// (dq[z] W3[z]^T) * (h2[z] > 0), the rank-1 input gradient of the step's
// dq, as the tile's k = 1 product: fmaf(dq, W3, +0), masked.
template <class F>
struct TwinHead {
  const float *h2, *W, *bias;  // h2 (2, B, H); the critic's W3 (2, H, 1), b3 (2, 1)
  int B, H;
  float* q;                    // (2, B)
  F step;
  const float* dq;             // (2, B), the step's output, where dz2 is given
  float* dz2;
  template <int NT>
  __device__ void run(int r0, int nr) const {
    extern __shared__ __align__(16) float smem[];
    const int ld = row_ld(H);
    float* xs = smem;  // twin z's row r at (z nr + r) ld
    float* ws = smem + 2 * nr * ld;
    stage_rows<NT>(xs, ld, h2 + (ll)r0 * H, H, nr, H);
    stage_rows<NT>(xs + nr * ld, ld, h2 + (ll)(B + r0) * H, H, nr, H);
    stage_rows<NT>(ws, 0, W, 0, 1, 2 * H);
    step.template stage<NT>(r0, nr);
    staged();
    for (int e = threadIdx.x; e < 2 * nr; e += NT) {
      const int z = e / nr, r = e % nr;
      q[(ll)z * B + r0 + r] = row_chain(xs + e * ld, ws + z * H, 1, H) + bias[z];
    }
    __syncthreads();
    for (int r = threadIdx.x; r < nr; r += NT) step(r0 + r);
    if (!dz2) return;
    __syncthreads();
    for (int e = threadIdx.x; e < 2 * nr * H; e += NT) {
      const int zr = e / H, h = e % H, z = zr / nr;
      const ll b = (ll)z * B + r0 + zr % nr;
      dz2[b * H + h] = xs[zr * ld + h] > 0.f ? fmaf(dq[b], ws[z * H + h], 0.f) : 0.f;
    }
  }
};

// The action columns of the updated critic's input gradient, da[z] (B, A) =
// dz1[z] (B, H) @ W1[z][S:, :]^T; HeadBackward on the rows; then the actor's
// adz2 (B, H) = (dout (B, 2A) @ W3^T) * (h2 > 0), a 2A-deep chain.
struct ActionRows {
  const float *dz1, *W1a;  // dz1 (2, B, H); the critic's W1 from row S, twin stride X H
  ll w_z;
  int B, A, H;
  float* da;               // (2, B, A)
  HeadBackward back;       // writes dout (B, 2A)
  const float *h2, *W3;    // the actor's bh2 (B, H) and W3 (H, 2A)
  float* adz2;
  template <int NT>
  __device__ void run(int r0, int nr) const {
    extern __shared__ __align__(16) float smem[];
    const int ld = row_ld(H), O = 2 * A;
    float* xs = smem;               // twin z's dz1 row r at (z nr + r) ld
    float* ws = xs + 2 * nr * ld;   // twin z's W1 row S + j at (z A + j) ld
    float* hs = ws + 2 * A * ld;    // h2 row r at r ld
    float* w3 = hs + nr * ld;       // W3 (H, 2A) transposed: (k, h) at k H + h
    stage_rows<NT>(xs, ld, dz1 + (ll)r0 * H, H, nr, H);
    stage_rows<NT>(xs + nr * ld, ld, dz1 + (ll)(B + r0) * H, H, nr, H);
    stage_rows<NT>(ws, ld, W1a, H, A, H);
    stage_rows<NT>(ws + A * ld, ld, W1a + w_z, H, A, H);
    stage_rows<NT>(hs, ld, h2 + (ll)r0 * H, H, nr, H);
    for (int e = threadIdx.x; e < H * O; e += NT) w3[e] = W3[(ll)(e % H) * O + e / H];
    staged();
    for (int e = threadIdx.x; e < 2 * nr * A; e += NT) {
      const int zr = e / A, j = e % A, z = zr / nr;
      da[((ll)z * B + r0 + zr % nr) * A + j] = row_chain(xs + zr * ld, ws + (z * A + j) * ld, 1, H);
    }
    __syncthreads();
    for (int r = threadIdx.x; r < nr; r += NT) back(r0 + r);
    __syncthreads();
    for (int e = threadIdx.x; e < nr * H; e += NT) {
      const int r = e / H, h = e % H;
      const float* d = back.dout + (ll)(r0 + r) * O;
      float v = 0.f;
      if (hs[r * ld + h] > 0.f) {
        for (int k = 0; k < O; ++k) v = fmaf(d[k], w3[k * H + h], v);
      }
      adz2[(ll)(r0 + r) * H + h] = v;
    }
  }
};

// ------------------------------------------------------------ the update

struct Hyper {
  float lr, wd, alpha_lr, discount, entropy_target, polyak, polyak_c, min_alpha;
};

// The state, one micro-update's batch and noise, and the aux outputs.
struct Ptrs {
  float *aw[6], *am[6], *av[6];  // actor W1 b1 W2 b2 W3 b3, its AdamW m, v
  float *cw[6], *cm[6], *cv[6];  // twin critic, (2, ...)-stacked
  float* tw[6];                  // target critic
  float *la, *lam, *lav, *ta, *tc, *tal;
  const float *s, *a, *r, *s2, *term, *w, *ab, *eps2, *eps_new;
  float *lp_out, *minq_out, *alpha_out;
};

// Pointer order: the 48 state tensors as above, then s, a, r, s2, terminal,
// weight, absorbing, eps2, eps_new, then out log_probs, min Q, alpha.
inline Ptrs unpack(void* const* ptr) {
  float* const* P = reinterpret_cast<float* const*>(ptr);
  Ptrs p;
  for (int i = 0; i < 6; ++i) {
    p.aw[i] = P[i]; p.am[i] = P[6 + i]; p.av[i] = P[12 + i];
    p.cw[i] = P[18 + i]; p.cm[i] = P[24 + i]; p.cv[i] = P[30 + i];
    p.tw[i] = P[36 + i];
  }
  p.la = P[42]; p.lam = P[43]; p.lav = P[44];
  p.ta = P[45]; p.tc = P[46]; p.tal = P[47];
  p.s = P[48]; p.a = P[49]; p.r = P[50]; p.s2 = P[51]; p.term = P[52];
  p.w = P[53]; p.ab = P[54]; p.eps2 = P[55]; p.eps_new = P[56];
  p.lp_out = P[57]; p.minq_out = P[58]; p.alpha_out = P[59];
  return p;
}

// Buffers start on 16-byte boundaries, so the GEMM copies them 16 bytes at
// a time.
struct Scratch {
  float* base;
  ll used = 0;
  ll* log = nullptr;  // where given, each buffer's (offset, floats) in turn
  float* take(ll n) {
    float* p = base ? base + used : nullptr;
    if (log) {
      log[0] = used;
      log[1] = n;
      log += 2;
    }
    used += (n + 3) / 4 * 4;
    return p;
  }
};

struct Buffers {
  float *x2, *x, *xn;
  float *ah1, *ah2, *ao, *bh1, *bh2, *bo;
  float *lp2, *td;
  float *th1, *th2, *tq, *ch1, *ch2, *cq;
  float *dq, *dz2, *dz1, *gc[6];
  float *da, *dout, *adz2, *adz1, *ga[6];
};

// The buffers' names, in the order carve takes them.
constexpr const char* BUFFER_NAMES =
    "x2 x xn ah1 ah2 ao bh1 bh2 bo lp2 td th1 th2 tq ch1 ch2 cq dq dz2 dz1 gc0 gc1 gc2 gc3 gc4 gc5 "
    "da dout adz2 adz1 ga0 ga1 ga2 ga3 ga4 ga5";

inline Buffers carve(Scratch& sc, int B, int S, int A, int H) {
  const ll X = S + A, O = 2 * A, BH = (ll)B * H;
  Buffers f;
  f.x2 = sc.take(B * X); f.x = sc.take(B * X); f.xn = sc.take(B * X);
  f.ah1 = sc.take(BH); f.ah2 = sc.take(BH); f.ao = sc.take(B * O);
  f.bh1 = sc.take(BH); f.bh2 = sc.take(BH); f.bo = sc.take(B * O);
  f.lp2 = sc.take(B); f.td = sc.take(B);
  f.th1 = sc.take(2 * BH); f.th2 = sc.take(2 * BH); f.tq = sc.take(2 * B);
  f.ch1 = sc.take(2 * BH); f.ch2 = sc.take(2 * BH); f.cq = sc.take(2 * B);
  f.dq = sc.take(2 * B); f.dz2 = sc.take(2 * BH); f.dz1 = sc.take(2 * BH);
  const ll csz[6] = {2 * X * H, 2LL * H, 2LL * H * H, 2LL * H, 2LL * H, 2};
  for (int i = 0; i < 6; ++i) f.gc[i] = sc.take(csz[i]);
  f.da = sc.take(2LL * B * A); f.dout = sc.take(B * O);
  f.adz2 = sc.take(BH); f.adz1 = sc.take(BH);
  const ll asz[6] = {(ll)S * H, H, (ll)H * H, H, (ll)H * O, O};
  for (int i = 0; i < 6; ++i) f.ga[i] = sc.take(asz[i]);
  return f;
}

inline ll scratch_floats(int B, int S, int A, int H) {
  Scratch sc = {nullptr};
  carve(sc, B, S, A, H);
  return sc.used;
}

// One SAC update in place, as 21 phases:
//   TD target (actor on s' -> head samples -> target twin -> td), with the
//   actor's forward on s alongside, since the actor is not written before
//   its own AdamW; critic forward, backward, AdamW + Polyak; the UPDATED
//   critic's action gradient; the actor backward and AdamW; last the
//   temperature, which alone advances the three Adam clocks. The narrow
//   heads run row-owned with their row steps (phases 3, 6, 9, 15, 17); the
//   last layers' weight and bias gradients, whose tiles are as deep as the
//   first layers', share the first layers' weight-gradient phases (11, 19),
//   which have room in one round. Host and device: gx::PlanExec records it.
#pragma nv_exec_check_disable
template <class Exec>
__host__ __device__ void sac_step(Exec& ex, const Ptrs& p, const Buffers& f, int B, int S, int A,
                                  int H, const Hyper& h) {
  const int X = S + A, O = 2 * A;
  const ll BH = (ll)B * H;
  const int R = head_rows(B, S, A, H);

  // ---- actor on s' (TD target) and on s (actor step) -----------------------
  ex.gemm(linear(p.s2, 0, p.aw[0], p.aw[1], f.ah1, B, S, H, true), 1);
  ex.gemm(linear(p.s, 0, p.aw[0], p.aw[1], f.bh1, B, S, H, true), 1);
  ex.sync();
  ex.gemm(linear(f.ah1, 0, p.aw[2], p.aw[3], f.ah2, B, H, H, true), 1);
  ex.gemm(linear(f.bh1, 0, p.aw[2], p.aw[3], f.bh2, B, H, H, true), 1);
  ex.sync();
  ex.row_items(B, R, ActorHeads{f.ah2, f.bh2, p.aw[4], p.aw[5], H, O, f.ao, f.bo,
                                HeadSample{f.ao, p.eps2, p.s2, p.ab, S, A, f.lp2, f.x2},
                                HeadSample{f.bo, p.eps_new, p.s, nullptr, S, A, p.lp_out, f.xn}});
  ex.sync();

  // ---- target twin on [s', a'], TD target ---------------------------------
  ex.gemm(linear(f.x2, 0, p.tw[0], p.tw[1], f.th1, B, X, H, true), 2);
  ex.sync();
  ex.gemm(linear(f.th1, BH, p.tw[2], p.tw[3], f.th2, B, H, H, true), 2);
  ex.sync();
  ex.await_rewards();  // the first phase that reads p.r
  ex.row_items(B, R, TwinHead<Td>{f.th2, p.tw[4], p.tw[5], B, H, f.tq,
                                  Td{f.tq, p.r, p.term, p.ab, f.lp2, p.la, h.min_alpha,
                                     h.discount, p.s, p.a, B, S, A, f.td, f.x},
                                  nullptr, nullptr});
  ex.sync();

  // ---- critic forward, backward, AdamW + Polyak ---------------------------
  ex.gemm(linear(f.x, 0, p.cw[0], p.cw[1], f.ch1, B, X, H, true), 2);
  ex.sync();
  ex.gemm(linear(f.ch1, BH, p.cw[2], p.cw[3], f.ch2, B, H, H, true), 2);
  ex.sync();
  ex.row_items(B, R, TwinHead<CriticDq>{f.ch2, p.cw[4], p.cw[5], B, H, f.cq,
                                        CriticDq{f.cq, f.td, p.w, B, f.dq, p.minq_out},
                                        f.dq, f.dz2});
  ex.sync();
  ex.gemm(weight_grad(f.ch1, BH, f.dz2, f.gc[2], B, H, H), 2);
  ex.cols(2 * H, Colsum{f.dz2, B, H, f.gc[3]});
  ex.gemm(input_grad(f.dz2, p.cw[2], (ll)H * H, f.ch1, f.dz1, H, B, H, H), 2);
  ex.sync();
  ex.gemm(weight_grad(f.x, 0, f.dz1, f.gc[0], B, X, H), 2);
  ex.cols(2 * H, Colsum{f.dz1, B, H, f.gc[1]});
  ex.gemm(weight_grad(f.ch2, BH, f.dq, f.gc[4], B, H, 1), 2);
  ex.cols(2, Colsum{f.dq, B, 1, f.gc[5]});
  ex.sync();
  const ll csz[6] = {2LL * X * H, 2LL * H, 2LL * H * H, 2LL * H, 2LL * H, 2};
#pragma unroll
  for (int i = 0; i < 6; ++i)
    ex.rows((int)csz[i],
            Adam{p.cw[i], f.gc[i], p.cm[i], p.cv[i], p.tw[i], p.tc, h.lr, h.wd, h.polyak, h.polyak_c});
  ex.sync();

  // ---- the UPDATED critic's action gradient at [s, tanh(z)] ---------------
  ex.gemm(linear(f.xn, 0, p.cw[0], p.cw[1], f.th1, B, X, H, true), 2);
  ex.sync();
  ex.gemm(linear(f.th1, BH, p.cw[2], p.cw[3], f.th2, B, H, H, true), 2);
  ex.sync();
  ex.row_items(B, R, TwinHead<SelectDq>{f.th2, p.cw[4], p.cw[5], B, H, f.tq,
                                        SelectDq{f.tq, B, f.dq}, f.dq, f.dz2});
  ex.sync();
  ex.gemm(input_grad(f.dz2, p.cw[2], (ll)H * H, f.th1, f.dz1, H, B, H, H), 2);
  ex.sync();
  // only the action columns of dx: dz1 @ W1[S:, :]^T, no mask; then the
  // actor's head backward and its adz2
  ex.row_items(B, R, ActionRows{f.dz1, p.cw[0] + (ll)S * H, (ll)X * H, B, A, H, f.da,
                                HeadBackward{f.bo, p.eps_new, f.da, p.w, p.ab, p.la, h.min_alpha,
                                             B, A, f.dout},
                                f.bh2, p.aw[4], f.adz2});
  ex.sync();

  // ---- actor backward + AdamW ---------------------------------------------
  ex.gemm(weight_grad(f.bh1, 0, f.adz2, f.ga[2], B, H, H), 1);
  ex.cols(H, Colsum{f.adz2, B, H, f.ga[3]});
  ex.gemm(input_grad(f.adz2, p.aw[2], 0, f.bh1, f.adz1, H, B, H, H), 1);
  ex.sync();
  ex.gemm(weight_grad(p.s, 0, f.adz1, f.ga[0], B, S, H), 1);
  ex.cols(H, Colsum{f.adz1, B, H, f.ga[1]});
  ex.gemm(weight_grad(f.bh2, 0, f.dout, f.ga[4], B, H, O), 1);
  ex.cols(O, Colsum{f.dout, B, O, f.ga[5]});
  ex.sync();
  const ll asz[6] = {(ll)S * H, H, (ll)H * H, H, (ll)H * O, O};
#pragma unroll
  for (int i = 0; i < 6; ++i)
    ex.rows((int)asz[i], Adam{p.aw[i], f.ga[i], p.am[i], p.av[i], nullptr, p.ta, h.lr, h.wd, 0.f, 0.f});
  ex.sync();

  // ---- temperature, clocks, aux alpha -------------------------------------
  ex.block(Temperature{p.lp_out, p.w, p.ab, B, h.entropy_target, h.alpha_lr, h.min_alpha, p.la,
                       p.lam, p.lav, p.ta, p.tc, p.tal, p.alpha_out});
}

}  // namespace sac
