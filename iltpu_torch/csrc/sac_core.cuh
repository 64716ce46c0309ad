// The arithmetic of one SAC update, shared by the per-update kernels
// (sac_update.cu) and the K-blocked persistent kernel (kblock_update.cu),
// so both run one copy of the math, as the TPU's `_sac_core` is shared by
// pallas_sac.py and pallas_fused_block.py.
//
// What bounds an update on the H100: at the main path's shapes (batch 256,
// width 256) it is ~0.55 GFLOP of fp32 products, under 10 us at 67 TFLOP/s,
// spread over 29 dependent phases of 64 to 128 output tiles each: one wave
// on 132 SMs, so a phase costs the latency of its slowest tile plus a grid
// barrier, and a tile must not make a dependent trip to L2 per step of k.
// So a tile copies its whole-depth panels into shared memory at once (one
// trip, cp.async), then runs the 256-long fmaf chains from shared memory
// with 4x2 outputs on each of 128 threads, so that shared-memory reads and
// fmaf issue balance.
//
// What lives here:
//  - `gemm_tile<NT>`: one 32x32 output tile of a strided fp32 product, run
//    by a block of NT >= 128 threads. Every output is one fmaf chain over k
//    in ascending order, so any instance gives the same bits;
//  - elementwise functors, each `operator()(int i)` for one item (a batch
//    row, a column, a parameter element), and the single-block temperature
//    step, whose reduction has a fixed logical width RED whatever the block;
//  - `sac_step<Exec>`: the update as a sequence of phases. `Exec` runs a
//    phase's jobs (`gemm`, `rows`, `block`) as grid-stride loops over a
//    range of blocks, `sync()` is a barrier over that range between phases
//    that depend on each other, and `await_rewards()` waits, just before the
//    TD target, for the rewards of another block's GAIL step where there is
//    one (grid_exec.cuh). Jobs within a phase are independent of each other.
//
// Nothing reads a tensor through __ldg or `const __restrict__`: another
// block wrote it in an earlier phase. Panels are copied with .cg (L2) loads.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace sac {

typedef long long ll;

constexpr int TILE = 32;
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
// A tile's A panel (32 rows x depth) and B panel (depth x 32 columns) are
// copied into shared memory at once (16-byte cp.async.cg where the source
// is contiguous and aligned, 4-byte L2 loads elsewhere), then 128 threads
// run the fmaf chains from shared memory, 4 rows x 2 columns a thread. A
// depth past KWHOLE goes in KRING-deep chunks through a ring of two stages,
// the next chunk copied while this one is computed. The k padding of a
// panel is zero, and fmaf(0, 0, acc) == acc (acc starts at +0 and is never
// -0), so each output is the same chain over k as without padding.
//
// A panel is stored k-major (element (o, k) at k * TILE + o) when its source
// is contiguous along the outer index, else outer-major (at o * ld + k, ld =
// the depth rounded up to 8, plus 4, so the float4 reads of 8 neighbouring
// rows hit distinct banks).

constexpr int GEMM_THREADS = 128;  // the threads that compute; all copy
constexpr int KWHOLE = 512;        // deepest product held whole
constexpr int KRING = 128;         // chunk depth past KWHOLE

__host__ __device__ inline int round_up(int a, int b) { return (a + b - 1) / b * b; }

// Floats of one panel of depth kc in either layout.
__host__ __device__ inline int panel_floats(int kc) { return TILE * (round_up(kc, 8) + 4); }

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

// Copy rows [o0, o0 + TILE) x depth [k0, k0 + kc) of a source with `no`
// rows and `nk` deep (strides so, sk) into panel s; zeros outside.
template <int NT>
__device__ void load_panel(float* s, const float* src, ll so, ll sk, int o0, int no, int k0, int nk,
                           int kc) {
  const bool om = sk == 1 && so != 1;  // outer-major
  const int ld = round_up(kc, 8) + 4;
  const bool aligned = ((unsigned long long)src & 15) == 0 && (k0 & 3) == 0;
  if (om) {
    if (aligned && so % 4 == 0) {
      const int q = kc / 4;
      for (int e = threadIdx.x; e < TILE * q; e += NT) {
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
      for_batched<NT>(TILE * kc, [&](int e, bool load, float v) {
        const int r = e / kc, kk = e % kc;
        const int go = o0 + r, gk = k0 + kk;
        if (load) return (go < no && gk < nk) ? __ldcg(src + go * so + gk) : 0.f;
        s[r * ld + kk] = v;
        return 0.f;
      });
    }
  } else {
    if (aligned && so == 1 && sk % 4 == 0) {
      for (int e = threadIdx.x; e < kc * (TILE / 4); e += NT) {
        const int kk = e / (TILE / 4), r = 4 * (e % (TILE / 4));
        const int go = o0 + r, gk = k0 + kk;
        float* d = s + kk * TILE + r;
        if (gk < nk && go + 3 < no) {
          cp_async16(d, src + go + gk * sk);
        } else {
          for (int j = 0; j < 4; ++j) d[j] = (gk < nk && go + j < no) ? __ldcg(src + go + j + gk * sk) : 0.f;
        }
      }
    } else {
      for_batched<NT>(kc * TILE, [&](int e, bool load, float v) {
        const int kk = e / TILE, r = e % TILE;
        const int go = o0 + r, gk = k0 + kk;
        if (load) return (go < no && gk < nk) ? __ldcg(src + go * so + gk * sk) : 0.f;
        s[kk * TILE + r] = v;
        return 0.f;
      });
    }
  }
}

// acc[i][j] += sum over the kc-deep chunk of A(4 ty + i, k) B(k, tx + 16 j),
// in ascending k; AOM / BOM: the panel is outer-major.
template <bool AOM, bool BOM>
__device__ __forceinline__ void chunk_fma(const float* as, const float* bs, int kc, float (&acc)[4][2]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int ld = round_up(kc, 8) + 4;
  for (int k0 = 0; k0 < kc; k0 += 4) {
    float a[4][4], b[2][4];
    if (AOM) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 v = *reinterpret_cast<const float4*>(as + (4 * ty + i) * ld + k0);
        a[i][0] = v.x; a[i][1] = v.y; a[i][2] = v.z; a[i][3] = v.w;
      }
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(as + (k0 + q) * TILE + 4 * ty);
        a[0][q] = v.x; a[1][q] = v.y; a[2][q] = v.z; a[3][q] = v.w;
      }
    }
    if (BOM) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float4 v = *reinterpret_cast<const float4*>(bs + (tx + 16 * j) * ld + k0);
        b[j][0] = v.x; b[j][1] = v.y; b[j][2] = v.z; b[j][3] = v.w;
      }
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        b[0][q] = bs[(k0 + q) * TILE + tx];
        b[1][q] = bs[(k0 + q) * TILE + tx + 16];
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) acc[i][j] = fmaf(a[i][q], b[j][q], acc[i][j]);
  }
}

// Output tile (tm, tn) of twin z, by the NT threads of a block; the block's
// dynamic shared memory holds gemm_smem_bytes(kmax) for a chunk depth kc =
// gemm_chunk(kmax). It is reached through an extern __shared__ array, not
// a pointer handed in, so the compiler keeps shared-memory loads (LDS)
// rather than generic ones, which run the tile at about half speed. Ends
// with the block synchronised, so the panels can be reused.
template <int NT>
__device__ void gemm_tile(const Gemm& g, int z, int tm, int tn, int kc) {
  static_assert(NT >= GEMM_THREADS && NT % 32 == 0, "too few threads for the GEMM tile");
  extern __shared__ __align__(16) float smem[];
  const int m0 = tm * TILE;
  const int n0 = tn * TILE;
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
    load_panel<NT>(st, A, g.a_m, g.a_k, m0, g.m, ch * c, g.k, c);
    load_panel<NT>(st + pf, Bm, g.b_n, g.b_k, n0, g.n, ch * c, g.k, c);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  float acc[4][2] = {};
  load(0);
  for (int ch = 0; ch < nch; ++ch) {
    if (ch + 1 < nch) {
      load(ch + 1);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    if (threadIdx.x < GEMM_THREADS) {
      const float* as = smem + (ch & 1) * stage;
      const float* bs = as + pf;
      if (aom && bom) chunk_fma<true, true>(as, bs, c, acc);
      else if (aom) chunk_fma<true, false>(as, bs, c, acc);
      else if (bom) chunk_fma<false, true>(as, bs, c, acc);
      else chunk_fma<false, false>(as, bs, c, acc);
    }
    __syncthreads();
  }
  if (threadIdx.x >= GEMM_THREADS) return;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  for (int i = 0; i < 4; ++i) {
    for (int j = 0; j < 2; ++j) {
      const int gm = m0 + 4 * ty + i;
      const int gn = n0 + tx + 16 * j;
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

// Sample from the actor head o (B, 2A): log-probs, and the critic input
// rows x = [s, keep * tanh(z)] with keep = 1 - absorbing (or 1). Row b.
struct HeadSample {
  const float *o, *eps, *s, *ab;
  int S, A;
  float *lp, *x;
  __device__ void operator()(int b) const {
    const float* ob = o + (ll)b * 2 * A;
    const float* eb = eps + (ll)b * A;
    lp[b] = head_log_prob(ob, eb, A);
    const int X = S + A;
    for (int d = 0; d < S; ++d) x[(ll)b * X + d] = s[(ll)b * S + d];
    const float keep = ab ? 1.f - ab[b] : 1.f;
    for (int j = 0; j < A; ++j) {
      const float ls = fminf(fmaxf(ob[A + j], -20.f), 2.f);
      const float zz = ob[j] + expf(ls) * eb[j];
      x[(ll)b * X + S + j] = keep * tanhf(zz);
    }
  }
};

// TD target from the target twin's q (2, B); also the critic input [s, a].
struct Td {
  const float *tq, *r, *term, *ab, *lp2, *la;
  float min_alpha, discount;
  const float *s, *a;
  int B, S, A;
  float *td, *x;
  __device__ void operator()(int b) const {
    const float alpha = alpha_of(la, min_alpha);
    const float target_v = fminf(tq[b], tq[B + b]) - (1.f - ab[b]) * alpha * lp2[b];
    td[b] = r[b] + (1.f - term[b]) * discount * target_v;
    const int X = S + A;
    for (int d = 0; d < S; ++d) x[(ll)b * X + d] = s[(ll)b * S + d];
    for (int j = 0; j < A; ++j) x[(ll)b * X + S + j] = a[(ll)b * A + j];
  }
};

// d(critic loss)/dq for both twins, and min Q for the aux output.
struct CriticDq {
  const float *q, *td, *w;
  int B;
  float *dq, *min_q;
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
  float lr, wd, polyak;
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
    if (target) target[j] = polyak * target[j] + (1.f - polyak) * np;
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

// ------------------------------------------------------------ the update

struct Hyper {
  float lr, wd, alpha_lr, discount, entropy_target, polyak, min_alpha;
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
  float* take(ll n) {
    float* p = base ? base + used : nullptr;
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

// One SAC update in place, as 29 phases:
//   TD target (actor on s' -> head sample -> target twin -> td), with the
//   actor's forward on s alongside, since the actor is not written before
//   its own AdamW; critic forward, backward, AdamW + Polyak; the UPDATED
//   critic's action gradient; the actor backward and AdamW; last the
//   temperature, which alone advances the three Adam clocks.
template <class Exec>
__device__ void sac_step(Exec& ex, const Ptrs& p, const Buffers& f, int B, int S, int A,
                                  int H, const Hyper& h) {
  const int X = S + A, O = 2 * A;
  const ll BH = (ll)B * H;

  // ---- actor on s' (TD target) and on s (actor step) -----------------------
  ex.gemm(linear(p.s2, 0, p.aw[0], p.aw[1], f.ah1, B, S, H, true), 1);
  ex.gemm(linear(p.s, 0, p.aw[0], p.aw[1], f.bh1, B, S, H, true), 1);
  ex.sync();
  ex.gemm(linear(f.ah1, 0, p.aw[2], p.aw[3], f.ah2, B, H, H, true), 1);
  ex.gemm(linear(f.bh1, 0, p.aw[2], p.aw[3], f.bh2, B, H, H, true), 1);
  ex.sync();
  ex.gemm(linear(f.ah2, 0, p.aw[4], p.aw[5], f.ao, B, H, O, false), 1);
  ex.gemm(linear(f.bh2, 0, p.aw[4], p.aw[5], f.bo, B, H, O, false), 1);
  ex.sync();
  ex.rows(B, HeadSample{f.ao, p.eps2, p.s2, p.ab, S, A, f.lp2, f.x2});
  ex.rows(B, HeadSample{f.bo, p.eps_new, p.s, nullptr, S, A, p.lp_out, f.xn});
  ex.sync();

  // ---- target twin on [s', a'], TD target ---------------------------------
  ex.gemm(linear(f.x2, 0, p.tw[0], p.tw[1], f.th1, B, X, H, true), 2);
  ex.sync();
  ex.gemm(linear(f.th1, BH, p.tw[2], p.tw[3], f.th2, B, H, H, true), 2);
  ex.sync();
  ex.gemm(linear(f.th2, BH, p.tw[4], p.tw[5], f.tq, B, H, 1, false), 2);
  ex.sync();
  ex.await_rewards();  // the first phase that reads p.r
  ex.rows(B, Td{f.tq, p.r, p.term, p.ab, f.lp2, p.la, h.min_alpha, h.discount, p.s, p.a, B, S, A,
                f.td, f.x});
  ex.sync();

  // ---- critic forward, backward, AdamW + Polyak ---------------------------
  ex.gemm(linear(f.x, 0, p.cw[0], p.cw[1], f.ch1, B, X, H, true), 2);
  ex.sync();
  ex.gemm(linear(f.ch1, BH, p.cw[2], p.cw[3], f.ch2, B, H, H, true), 2);
  ex.sync();
  ex.gemm(linear(f.ch2, BH, p.cw[4], p.cw[5], f.cq, B, H, 1, false), 2);
  ex.sync();
  ex.rows(B, CriticDq{f.cq, f.td, p.w, B, f.dq, p.minq_out});
  ex.sync();
  ex.gemm(weight_grad(f.ch2, BH, f.dq, f.gc[4], B, H, 1), 2);
  ex.cols(2, Colsum{f.dq, B, 1, f.gc[5]});
  ex.gemm(input_grad(f.dq, p.cw[4], H, f.ch2, f.dz2, H, B, H, 1), 2);
  ex.sync();
  ex.gemm(weight_grad(f.ch1, BH, f.dz2, f.gc[2], B, H, H), 2);
  ex.cols(2 * H, Colsum{f.dz2, B, H, f.gc[3]});
  ex.gemm(input_grad(f.dz2, p.cw[2], (ll)H * H, f.ch1, f.dz1, H, B, H, H), 2);
  ex.sync();
  ex.gemm(weight_grad(f.x, 0, f.dz1, f.gc[0], B, X, H), 2);
  ex.cols(2 * H, Colsum{f.dz1, B, H, f.gc[1]});
  ex.sync();
  const ll csz[6] = {2LL * X * H, 2LL * H, 2LL * H * H, 2LL * H, 2LL * H, 2};
#pragma unroll
  for (int i = 0; i < 6; ++i)
    ex.rows((int)csz[i], Adam{p.cw[i], f.gc[i], p.cm[i], p.cv[i], p.tw[i], p.tc, h.lr, h.wd, h.polyak});
  ex.sync();

  // ---- the UPDATED critic's action gradient at [s, tanh(z)] ---------------
  ex.gemm(linear(f.xn, 0, p.cw[0], p.cw[1], f.th1, B, X, H, true), 2);
  ex.sync();
  ex.gemm(linear(f.th1, BH, p.cw[2], p.cw[3], f.th2, B, H, H, true), 2);
  ex.sync();
  ex.gemm(linear(f.th2, BH, p.cw[4], p.cw[5], f.tq, B, H, 1, false), 2);
  ex.sync();
  ex.rows(B, SelectDq{f.tq, B, f.dq});
  ex.sync();
  ex.gemm(input_grad(f.dq, p.cw[4], H, f.th2, f.dz2, H, B, H, 1), 2);
  ex.sync();
  ex.gemm(input_grad(f.dz2, p.cw[2], (ll)H * H, f.th1, f.dz1, H, B, H, H), 2);
  ex.sync();
  // only the action columns of dx: dz1 @ W1[S:, :]^T, no mask
  ex.gemm(input_grad(f.dz1, p.cw[0] + (ll)S * H, (ll)X * H, nullptr, f.da, A, B, A, H), 2);
  ex.sync();

  // ---- actor backward + AdamW ---------------------------------------------
  ex.rows(B, HeadBackward{f.bo, p.eps_new, f.da, p.w, p.ab, p.la, h.min_alpha, B, A, f.dout});
  ex.sync();
  ex.gemm(weight_grad(f.bh2, 0, f.dout, f.ga[4], B, H, O), 1);
  ex.cols(O, Colsum{f.dout, B, O, f.ga[5]});
  ex.gemm(input_grad(f.dout, p.aw[4], 0, f.bh2, f.adz2, H, B, H, O), 1);
  ex.sync();
  ex.gemm(weight_grad(f.bh1, 0, f.adz2, f.ga[2], B, H, H), 1);
  ex.cols(H, Colsum{f.adz2, B, H, f.ga[3]});
  ex.gemm(input_grad(f.adz2, p.aw[2], 0, f.bh1, f.adz1, H, B, H, H), 1);
  ex.sync();
  ex.gemm(weight_grad(p.s, 0, f.adz1, f.ga[0], B, S, H), 1);
  ex.cols(H, Colsum{f.adz1, B, H, f.ga[1]});
  ex.sync();
  const ll asz[6] = {(ll)S * H, H, (ll)H * H, H, (ll)H * O, O};
#pragma unroll
  for (int i = 0; i < 6; ++i)
    ex.rows((int)asz[i], Adam{p.aw[i], f.ga[i], p.am[i], p.av[i], nullptr, p.ta, h.lr, h.wd, 0.f});
  ex.sync();

  // ---- temperature, clocks, aux alpha -------------------------------------
  ex.block(Temperature{p.lp_out, p.w, p.ab, B, h.entropy_target, h.alpha_lr, h.min_alpha, p.la,
                       p.lam, p.lav, p.ta, p.tc, p.tal, p.alpha_out});
}

}  // namespace sac
