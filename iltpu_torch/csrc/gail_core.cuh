// The arithmetic of one GAIL discriminator step + reward head, shared by
// the per-update kernel (gail_update.cu), the K-blocked persistent kernel
// (kblock_update.cu) and the phase timer (gail_phases.cu), as the TPU's
// `_gail_core` is shared by pallas_gail.py and pallas_fused_block.py.
//
// Two families of variants, chosen by the shape (`routes_wide`): the tiled
// variants (`gail::step`, one block) where they fit and were timed faster on
// an H100 (inputs up to 8 features at batches up to 256, up to 16 at batches
// up to 128 and widths up to 64), the wide variant (`step_wide`, several
// blocks) everywhere else. Blocks are THREADS threads (16 warps). Every sum
// runs in an order that follows the shape alone, so every kernel that runs a
// step gets the same bits. The working sets live in dynamic shared memory
// (smem_bytes(B, D, Hd)); only the wide variant's K-blocked exchange uses
// global scratch.
//
// The tiled variants (`step_t`, `layout`) hold the whole batch:
//  - the batch rows e = [e_s, e_a] and p = [p_s, p_a], each (B, DP): the
//    D = S + A features padded with zeros to DP (8 or 16), so a row is
//    DP / 4 float4 broadcasts; the per-row weights, eps_gp and mix. The loss
//    rows (e | p, or Mixup's mix e + (1 - mix) p) and the penalty rows
//    (eps_gp e + (1 - eps_gp) p) are formed from them where they are used;
//  - W~1 = W1 / sigma1 as (DP, HP), the hidden units padded with zeros to
//    HP = 32 NU (NU = 1, 2 or 4; DP NU <= 32), with b1, W2 and the
//    spectral-norm vectors;
//  - each warp's partial weight gradients (DP HP + 2 HP floats a warp),
//    combined in warp order, a warp's row of the penalty's g = W~1 a, and
//    the block sums.
// The hidden activations, relu masks and the penalty's a = m * w~2 and
// q = m * (W~1^T G) are never stored: they are recomputed from the rows
// where needed (D fmaf each). Nothing but the state and the outputs goes to
// global memory.
//
// Threads spread over rows x hidden units. Lane l of a warp owns the units
// l + 32 u (u < NU), with their columns of W~1 and its partial weight
// gradients in registers; a warp owns a contiguous slice of the rows. For a
// row, the
// warp forms the hidden units from the row's features (float4 broadcasts
// from shared memory), and the dot product with w~2 is a butterfly of
// shuffles that leaves the same bits in every lane. Loss rows go 32 at a
// time: the forward of each row, then the loss and d loss / d logit of row
// k by lane k (one pass of transcendentals for 32 rows), then the backward
// of each row with its d loss / d logit shuffled from its lane. The
// penalty's g = W~1 a sums over the units, so over the lanes: a transposing
// shuffle reduction (transpose_sum) leaves each lane one of the DP sums.
//
// The wide variant (`step_wide`, `wide_layout`) takes inputs up to WIDE_D =
// 128 features (ant's 120) and widths up to 128 at any batch, on several
// blocks. What bounds it at ant's largest shape (batch 1024, D 120, width
// 128: ~0.28 GFLOP) is arithmetic: 0.56 ms at one SM's fp32 rate. So:
//  - the rows (2B loss rows for BCE or B for Mixup, B penalty rows, B
//    reward rows) are cut into wide_segments(B) = ceil(B / 32) (at most 16)
//    segments, fixed by the shape; a block runs its segments, and the
//    segments' partial sums (the weight gradients, b1's, w2's, b2's and the
//    loss terms) are summed in segment order by the block whose slice of
//    the entries holds them, the slices' shares of <G, W> likewise, so the
//    bits follow the shape, not the blocks (`Ex`: a cluster's distributed
//    shared memory in gail_update.cu, global scratch behind a barrier in
//    kblock_update.cu). Each block computes sigma itself; the slices' owners
//    run AdamW, and every block reads the new weights back for the power
//    iteration (the same bits in each) and its segments' rewards;
//  - a block streams its segments' rows through shared memory RC = 32 at a
//    time, the next chunk landing by cp.async while this one is computed:
//    W~1 as (DK, HP + 4), DK = D rounded up to 8; a chunk's rows (RC, XS),
//    formed there (Mixup's and the penalty's mixed rows from the landed
//    expert and policy rows); its pre-activations Z = X W~1, and for the
//    penalty rows a = m * w~2, g = a W~1^T, then c g, and q = (c g) W~1;
//  - those chunk products and the weight gradient's X^T dz and (c g)^T a
//    run on the tensor cores, mma.sync m16n8k8 in 3xTF32 (each operand
//    split into TF32 hi and lo parts; hi hi + hi lo + lo hi, fp32
//    accumulation: about fp32's accuracy). A warp holds its tiles of the
//    (D x HP) gradient in registers over the segment's chunks; the column
//    sums of b1's and w2's gradients are each thread's over its rows, then
//    the row groups in order; the per-row loss terms lane r of warp 0's.
//
// Phases of a tiled step, with barriers only between them: 0 state and
// batch to shared memory, sigma; 1 loss rows; 2 penalty rows; 3 the weight
// gradients (the warps' partials in warp order), through sigma, AdamW; 4
// one power iteration (v first, then u) on the updated weights; 5 the
// reward of the policy rows with the new parameters. A wide step's: 0
// state, sigma; 1 loss rows; 2 penalty rows; 3 the segments' partial sums
// and the cross-block sums and dot products; 4 through sigma, AdamW; 5 the
// new weights read back, power iteration; 6 reward rows. The penalty's
// parameter gradient is derived by hand (ops/gail_update.py): per
// interpolated row i, with a_i = m_i * w~2 and g_i = W~1 a_i, dP/dW~1 gets
// c_i g_i a_i^T and dP/dw~2 gets c_i m_i * (W~1^T g_i), c_i = 2 gp g_w_i /
// B; gradients then go through sigma = v^T W u with u and v held fixed.
//
// Full fp32 (the wide variant's chunk products 3xTF32). Every product that
// meets an add is written out as fmaf, __fmul_rn or an mma, so no
// contraction is left to the compiler that could differ between the
// kernels. Nothing is read through __ldg or
// `const __restrict__`: the state is updated in place.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace gail {

typedef long long ll;

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr size_t SMEM_LIMIT = 232448;  // dynamic shared memory a block may opt into (sm_90)
constexpr float B1 = 0.9f;
constexpr float B2 = 0.999f;
constexpr float OMB1 = (float)(1.0 - 0.9);
constexpr float OMB2 = (float)(1.0 - 0.999);
constexpr float ADAM_EPS = 1e-8f;
constexpr float LOG_B1 = (float)-0.10536051565782628;   // log(0.9)
constexpr float LOG_B2 = (float)-0.0010005003335835335; // log(0.999)

// The step's dynamic shared memory. Every access names this array (rows are
// offsets into it, not pointers), so the compiler emits shared-memory loads
// rather than generic ones.
extern __shared__ __align__(16) float gsm[];

struct Args {
  float *W1, *b1, *W2, *b2;
  float *u1, *v1, *u2, *v2;
  float *m[4], *v[4];
  float* t;
  const float *e_s, *e_a, *e_w, *p_s, *p_a, *p_w, *eps_gp, *mix;
  float *loss_out, *rewards_out;
  int B, S, A, Hd, sn, bce, reward_fn;
  int wide;  // the wide variant runs (else the tiled one of (D, Hd))
  float gp, lr, wd, ent;
};

constexpr int WIDE_D = 128;  // features the wide variant takes at most
constexpr int RC = 32;       // rows of a chunk of the wide variant

// The tiled variants: features padded to DP, units to 32 NU.
__host__ __device__ inline int padded_features(int D) {
  return D < 1 ? 0 : D <= 8 ? 8 : D <= 16 ? 16 : 0;
}
__host__ __device__ inline int unit_groups(int Hd) {
  return Hd < 1 ? 0 : Hd <= 32 ? 1 : Hd <= 64 ? 2 : Hd <= 128 ? 4 : 0;
}

// Offsets in floats into the dynamic shared memory; each 16-byte aligned.
struct Layout {
  int wt, b1, w2, u1, v1, pv, pvn, pu, pun, pv2, scal, ex, px, g, part, red, ew, pw, egp, mix, total;
};

__host__ __device__ inline int take(int& at, int n) {
  const int here = at;
  at += (n + 3) / 4 * 4;
  return here;
}

__host__ __device__ inline Layout layout(int B, int DP, int HP) {
  Layout L;
  int o = 0;
  L.wt = take(o, DP * HP);  // W~1 (raw W1 after AdamW)
  L.b1 = take(o, HP);
  L.w2 = take(o, HP);       // raw W2
  L.u1 = take(o, HP);       // u1, v1 as the step found them
  L.v1 = take(o, DP);
  L.pv = take(o, DP);       // power iteration: W1 u, then v, then W1^T v, u, v2
  L.pvn = take(o, DP);
  L.pu = take(o, HP);
  L.pun = take(o, HP);
  L.pv2 = take(o, HP);      // v2 as found, then the new one
  L.scal = take(o, 4);      // new b2, old u2, new u2
  L.ex = take(o, B * DP);
  L.px = take(o, B * DP);
  L.g = take(o, WARPS * DP);
  L.part = take(o, WARPS * (DP * HP + 2 * HP));
  L.red = take(o, WARPS * 8);
  L.ew = take(o, B);
  L.pw = take(o, B);
  L.egp = take(o, B);
  L.mix = take(o, B);
  L.total = o;
  return L;
}

// Dynamic shared memory of the tiled variant of (D, Hd); 0 where none
// takes it (past 16 features, or 16 features at width 128: the wide variant
// was faster at every such shape of iltpu's configurations, PERF.md §6).
// A launch also needs it <= SMEM_LIMIT.
__host__ __device__ inline size_t tiled_smem_bytes(int B, int D, int Hd) {
  const int dp = padded_features(D), nu = unit_groups(Hd);
  if (B < 1 || !dp || !nu || dp * nu > 32) return 0;
  return sizeof(float) * (size_t)layout(B, dp, 32 * nu).total;
}

// The wide variant's offsets in floats; each 16-byte aligned. DK = D
// rounded up to 8 (the products' depth over the features), DM = D rounded
// up to 16 (the weight gradient's rows), XS = DM + 4 and WS = ZS = HP + 4
// (row strides that spread a fragment's loads over the banks).
struct WideLayout {
  int DK, DM, XS, WS, ZS;
  int wt, b1, w2, w2n, u1, v1, pv, pvn, pu, pun, pv2, scal, rows, red, cs, dots;
  int es[2], ps[2], gq, z, am, q;  // the chunk area
  int part, total;
};

__host__ __device__ inline WideLayout wide_layout(int D, int HP) {
  WideLayout L;
  L.DK = (D + 7) / 8 * 8;
  L.DM = (D + 15) / 16 * 16;
  L.XS = L.DM + 4;
  L.WS = L.ZS = HP + 4;
  int o = 0;
  L.wt = take(o, L.DK * L.WS);  // W~1 (raw W1 after AdamW), rows >= D zero
  L.b1 = take(o, HP);
  L.w2 = take(o, HP);       // raw W2
  L.w2n = take(o, HP);      // w~2 = W2 / sigma2
  L.u1 = take(o, HP);
  L.v1 = take(o, L.DK);
  L.pv = take(o, L.DK);     // the power iteration's, as the tiled layout's
  L.pvn = take(o, L.DK);
  L.pu = take(o, HP);
  L.pun = take(o, HP);
  L.pv2 = take(o, HP);
  L.scal = take(o, 4);      // new b2, old u2, new u2
  L.rows = take(o, 4 * RC); // a chunk's loss, entropy, d loss / d logit, penalty terms
  L.red = take(o, 2 * WARPS);
  L.cs = take(o, 2 * THREADS);  // the threads' column sums of b1's and w2's gradients
  L.dots = take(o, 2);      // this block's slice of <G, W1> and <G, W2>
  const int chunk = RC * L.XS;
  L.part = o;               // a segment's partial sums (wide_partial_floats) reuse the chunk area
  for (int s = 0; s < 2; ++s) {
    L.es[s] = take(o, chunk);  // the expert rows landing, then the chunk's rows
    L.ps[s] = take(o, chunk);  // the policy rows landing (mixed rows)
  }
  L.gq = take(o, chunk);    // the penalty rows' g, then c g
  L.z = take(o, RC * L.ZS); // the chunk's pre-activations
  L.am = take(o, RC * L.ZS);  // the penalty rows' a = m * w~2
  L.q = take(o, RC * L.ZS);   // the penalty rows' masked (c g) W~1
  L.total = o;
  return L;
}

// A segment's partial sums: the W1 gradient (D, Hd), b1's and W2's (Hd
// each), b2's, then the loss, entropy and penalty terms; the first
// wide_entries of them are the parameters' gradient.
__host__ __device__ inline int wide_entries(int D, int Hd) { return D * Hd + 2 * Hd + 1; }
__host__ __device__ inline int wide_partial_floats(int D, int Hd) {
  return (wide_entries(D, Hd) + 3 + 3) / 4 * 4;
}

// The row segments of a wide step, set by the batch alone: one a chunk of
// RC policy rows, at most MAX_SEGMENTS. The bits of a step follow them, not
// the blocks that run it.
constexpr int MAX_SEGMENTS = 16;
__host__ __device__ inline int wide_segments(int B) {
  const int s = (B + RC - 1) / RC;
  return s < 1 ? 1 : s > MAX_SEGMENTS ? MAX_SEGMENTS : s;
}

// Dynamic shared memory of the wide variant; 0 past WIDE_D features or
// width 128. It does not depend on the batch.
__host__ __device__ inline size_t wide_smem_bytes(int D, int Hd) {
  const int nu = unit_groups(Hd);
  if (D < 1 || D > WIDE_D || !nu) return 0;
  const WideLayout L = wide_layout(D, 32 * nu);
  if (L.part + wide_partial_floats(D, Hd) > L.total) return 0;
  return sizeof(float) * (size_t)L.total;
}

// The route, from both variants timed in turns on an H100 at every shape
// of iltpu's configurations (PERF.md §6): a tiled variant where it fits
// and won both turns, at inputs of up to 8 features and batches up to 256,
// or up to 16 features (widths up to 64) at batches up to 128; the wide
// variant at every other shape.
__host__ __device__ inline bool routes_wide(int B, int D, int Hd) {
  const size_t tiled = tiled_smem_bytes(B, D, Hd);
  if (tiled == 0 || tiled > SMEM_LIMIT) return true;
  return !(B <= 256 && (padded_features(D) == 8 || B <= 128));
}

// Dynamic shared memory of a step of the given variant, or of the routed
// one; 0 where it cannot take the shape. A launch also needs it <=
// SMEM_LIMIT.
__host__ __device__ inline size_t smem_bytes(int B, int D, int Hd, bool wide) {
  if (B < 1) return 0;
  return wide ? wide_smem_bytes(D, Hd) : tiled_smem_bytes(B, D, Hd);
}

__host__ __device__ inline size_t smem_bytes(int B, int D, int Hd) {
  return smem_bytes(B, D, Hd, routes_wide(B, D, Hd));
}

__device__ __forceinline__ float softplusf(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }

// e x + (1 - e) y, rounded as the plain version's three ops.
__device__ __forceinline__ float mixf(float e, float x, float y) {
  return __fadd_rn(__fmul_rn(e, x), __fmul_rn(1.f - e, y));
}

// The warp's sum, the same bits in every lane.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// Sums of two values over the block, in warp order; every thread gets
// them. `red` holds 2 WARPS floats.
__device__ inline void block_sum2(float& a, float& b, float* red) {
  a = warp_sum(a);
  b = warp_sum(b);
  const int w = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    red[2 * w] = a;
    red[2 * w + 1] = b;
  }
  __syncthreads();
  a = 0.f;
  b = 0.f;
  for (int i = 0; i < WARPS; ++i) {
    a += red[2 * i];
    b += red[2 * i + 1];
  }
}

// The sums over the warp's lanes of p[0..DP-1]. Each step halves what a
// lane holds: it keeps one half of its values and adds its partner's sums
// of that half; butterflies finish where DP < 32. Lane l ends with the sum
// for d = transposed_index<DP>(l), the same bits in every lane that holds
// that d. DP - 1 + log2(32 / DP) shuffles instead of 5 DP.
template <int DP>
__device__ __forceinline__ float transpose_sum(float (&p)[DP], int lane) {
#pragma unroll
  for (int half = DP / 2, off = 16; half >= 1; half /= 2, off /= 2) {
    const bool upper = lane & off;
#pragma unroll
    for (int k = 0; k < half; ++k) {
      const float send = upper ? p[k] : p[k + half];
      const float keep = upper ? p[k + half] : p[k];
      p[k] = keep + __shfl_xor_sync(FULL, send, off);
    }
  }
  float v = p[0];
#pragma unroll
  for (int off = 16 / DP; off > 0; off /= 2) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

template <int DP>
__device__ __forceinline__ int transposed_index(int lane) {
  int d = 0;
#pragma unroll
  for (int half = DP / 2, off = 16; half >= 1; half /= 2, off /= 2)
    if (lane & off) d += half;
  return d;
}

// The lane's columns of W~1 (units lane + 32 u), in registers.
template <int DP, int NU>
struct Cols {
  static constexpr int HP = 32 * NU;
  static_assert(DP * NU <= 32, "the tiled variants hold DP NU <= 32 columns a lane");
  float r[DP][NU];
  __device__ __forceinline__ void load(int wt, int lane) {
#pragma unroll
    for (int d = 0; d < DP; ++d)
#pragma unroll
      for (int u = 0; u < NU; ++u) r[d][u] = gsm[wt + lane + d * HP + 32 * u];
  }
  __device__ __forceinline__ float operator()(int d, int u) const { return r[d][u]; }
};

// A row in shared memory, by offsets (16-byte aligned): a, or for MIXED
// rows eps a + (1 - eps) b.
struct Row {
  int a, b;
  float eps;
};

template <bool MIXED>
__device__ __forceinline__ float4 chunk(const Row& row, int c) {
  const float4 x = reinterpret_cast<const float4*>(gsm + row.a)[c];
  if constexpr (!MIXED) {
    return x;
  } else {
    const float4 y = reinterpret_cast<const float4*>(gsm + row.b)[c];
    const float e = row.eps;
    return make_float4(mixf(e, x.x, y.x), mixf(e, x.y, y.y), mixf(e, x.z, y.z), mixf(e, x.w, y.w));
  }
}

// z[u] = sum_d x_d W~1[d, unit u], summed in d order (b1 not added).
template <bool MIXED, int DP, int NU>
__device__ __forceinline__ void pre_activation(const Row& row, const Cols<DP, NU>& W, float (&z)[NU]) {
#pragma unroll
  for (int u = 0; u < NU; ++u) z[u] = 0.f;
#pragma unroll
  for (int c = 0; c < DP / 4; ++c) {
    const float4 x = chunk<MIXED>(row, c);
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      z[u] = fmaf(x.x, W(4 * c, u), z[u]);
      z[u] = fmaf(x.y, W(4 * c + 1, u), z[u]);
      z[u] = fmaf(x.z, W(4 * c + 2, u), z[u]);
      z[u] = fmaf(x.w, W(4 * c + 3, u), z[u]);
    }
  }
}

// The logit less b2: sum_j relu(z_j + b1_j) w~2_j over the warp.
template <bool MIXED, int DP, int NU>
__device__ __forceinline__ float logit(const Row& row, const Cols<DP, NU>& W, const float (&b1)[NU],
                                       const float (&w2)[NU]) {
  float z[NU];
  pre_activation<MIXED>(row, W, z);
  float f = 0.f;
#pragma unroll
  for (int u = 0; u < NU; ++u) f = fmaf(fmaxf(z[u] + b1[u], 0.f), w2[u], f);
  return warp_sum(f);
}

// sigma1 = v^T W1 u over the weights in shared memory, rows of stride WS;
// each warp computes it alike.
template <int NU, int WS = 32 * NU>
__device__ __forceinline__ float sigma1(const float* wt, const float* u, const float* v, int D, int lane) {
  float acc = 0.f;
  for (int d = 0; d < D; ++d)
#pragma unroll
    for (int k = 0; k < NU; ++k) {
      const int j = lane + 32 * k;
      acc = fmaf(__fmul_rn(v[d], wt[d * WS + j]), u[j], acc);
    }
  return warp_sum(acc);
}

// sigma2 = v2^T W2 u2, likewise.
template <int NU>
__device__ __forceinline__ float sigma2(const float* w2, const float* v2, float u2, int lane) {
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < NU; ++k) {
    const int j = lane + 32 * k;
    acc = fmaf(__fmul_rn(v2[j], w2[j]), u2, acc);
  }
  return warp_sum(acc);
}

// One AdamW step in place, rounded as the plain version's ops; returns the
// new parameter. bc1, bc2: the bias corrections 1 - b^t.
__device__ __forceinline__ float adamw(float* p, float g, float* m, float* v, float bc1, float bc2,
                                       float lr, float wd) {
  const float mm = __fadd_rn(__fmul_rn(B1, *m), __fmul_rn(OMB1, g));
  const float vv = __fadd_rn(__fmul_rn(B2, *v), __fmul_rn(__fmul_rn(OMB2, g), g));
  const float upd = __fadd_rn((mm / bc1) / (sqrtf(vv / bc2) + ADAM_EPS), __fmul_rn(wd, *p));
  const float np = __fsub_rn(*p, __fmul_rn(lr, upd));
  *m = mm;
  *v = vv;
  *p = np;
  return np;
}

// A loss row's terms and d loss / d logit, shared by both variants.
struct RowLoss {
  float loss, ent, dl;
};

// Loss row r: BCE's row r of e | p (weight e_w or p_w, target 1 or 0), or
// Mixup's (weight mix e_w + (1 - mix) p_w, target mix), at logit f (b2
// included), with entropy bonus `ent` (the result's `ent` is its term, 0
// without a bonus).
__device__ __forceinline__ RowLoss row_loss(bool mixed, int r, int B, const float* e_w,
                                            const float* p_w, const float* mix, float f,
                                            float ent) {
  float w, tg;
  if (mixed) {
    w = mixf(mix[r], e_w[r], p_w[r]);
    tg = mix[r];
  } else {
    w = r < B ? e_w[r] : p_w[r - B];
    tg = r < B ? 1.f : 0.f;
  }
  const float sg = sigmoidf(f);
  RowLoss o;
  o.loss = __fmul_rn(w, __fadd_rn(softplusf(-f), __fmul_rn(1.f - tg, f)));
  o.dl = __fmul_rn(w, sg - tg) / (float)B;
  o.ent = 0.f;
  if (ent > 0.f) {
    o.ent = __fmul_rn(w, __fsub_rn(softplusf(f), __fmul_rn(f, sg)));
    o.dl = __fadd_rn(o.dl, ent * w * f * sg * (1.f - sg) / (float)B);
  }
  return o;
}

// The reward head of a policy row's logit f (b2 included): GAIL, AIRL or
// FAIRL (reward_fn 0, 1, 2).
__device__ __forceinline__ float reward_of(float f, int reward_fn) {
  const float Dx = sigmoidf(f);
  if (reward_fn == 0) return -log1pf(-Dx + 1e-6f);
  const float r = logf(Dx + 1e-6f) - log1pf(-Dx + 1e-6f);
  return reward_fn == 2 ? expf(r) * -r : r;
}

// One power iteration on the updated weights (raw W1 in shared memory,
// rows of stride WS; W2 raw), from the old u: v first, then u. Writes the
// new vectors to shared memory and, with `write`, to the state; leaves W~1
// = W1 / sigma1 in place of W1, and returns the new sigmas.
template <int NU, int WS>
__device__ __forceinline__ void power_iteration(const Args& g, int D, int DP, float* wt, float* u1s,
                                                float* pv, float* pvn, float* pu, float* pun,
                                                float* w2s, float* pv2, float* scal, float& s1n,
                                                float& s2n, bool write = true) {
  constexpr int HP = 32 * NU;
  const int Hd = g.Hd, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int d = warp; d < D; d += WARPS) {
    float a = 0.f;
#pragma unroll
    for (int u = 0; u < NU; ++u) a = fmaf(wt[d * WS + lane + 32 * u], u1s[lane + 32 * u], a);
    a = warp_sum(a);
    if (lane == 0) pv[d] = a;
  }
  __syncthreads();
  float nv = 0.f;
  for (int d = 0; d < D; ++d) nv = fmaf(pv[d], pv[d], nv);
  nv = sqrtf(nv) + 1e-12f;
  if (tid < DP) {
    const float vd = tid < D ? pv[tid] / nv : 0.f;
    pvn[tid] = vd;
    if (write && tid < D) g.v1[tid] = vd;
  }
  if (tid < HP) {
    float a = 0.f;
    for (int d = 0; d < D; ++d) a = fmaf(wt[d * WS + tid], pv[d] / nv, a);
    pu[tid] = a;
  }
  __syncthreads();
  float nu = 0.f;
#pragma unroll
  for (int u = 0; u < NU; ++u) nu = fmaf(pu[lane + 32 * u], pu[lane + 32 * u], nu);
  nu = sqrtf(warp_sum(nu)) + 1e-12f;
  if (tid < HP) {
    const float uj = pu[tid] / nu;
    pun[tid] = uj;
    if (write && tid < Hd) g.u1[tid] = uj;
  }
  // layer 2: W2 (Hd, 1), u2 (1,)
  const float u2 = scal[1];
  float n2 = 0.f;
#pragma unroll
  for (int u = 0; u < NU; ++u) {
    const float a = __fmul_rn(w2s[lane + 32 * u], u2);
    n2 = fmaf(a, a, n2);
  }
  n2 = sqrtf(warp_sum(n2)) + 1e-12f;
  float u2n = 0.f;
#pragma unroll
  for (int u = 0; u < NU; ++u) {
    const float w = w2s[lane + 32 * u];
    u2n = fmaf(w, __fmul_rn(w, u2) / n2, u2n);
  }
  u2n = warp_sum(u2n);
  u2n = u2n / (sqrtf(u2n * u2n) + 1e-12f);
  if (tid < HP) {
    const float vj = __fmul_rn(w2s[tid], u2) / n2;
    pv2[tid] = vj;
    if (write && tid < Hd) g.v2[tid] = vj;
  }
  if (tid == 0) {
    if (write) g.u2[0] = u2n;
    scal[2] = u2n;
  }
  __syncthreads();
  s1n = sigma1<NU, WS>(wt, pun, pvn, D, lane);
  s2n = sigma2<NU>(w2s, pv2, u2n, lane);
  __syncthreads();  // every warp has read the raw W1
  for (int e = tid; e < DP * WS; e += THREADS) wt[e] = wt[e] / s1n;
  __syncthreads();
}

// The phase marks of a step that is not timed.
struct NoMarks {
  __device__ __forceinline__ void operator()(int) const {}
};

// One step in place, by one block of THREADS threads, with
// smem_bytes(B, D, Hd) of dynamic shared memory. mark(k) runs after
// phase k.
template <bool V>
struct Flag {
  static constexpr bool value = V;
};

template <int DP, int NU, class Mark>
__device__ __noinline__ void step_t(const Args& g, const Mark& mark) {
  constexpr int HP = 32 * NU;
  constexpr int PW = DP * HP + 2 * HP;  // one warp's partial gradients
  constexpr int NO = (PW + 1 + THREADS - 1) / THREADS;  // gradient outputs a thread, at most
  // the arguments the loops read, in registers
  const int S = g.S, A = g.A, D = S + A, Hd = g.Hd, B = g.B, bce = g.bce, sn = g.sn;
  const float gp = g.gp, ent = g.ent;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Layout L = layout(B, DP, HP);
  float *wt = gsm + L.wt, *b1s = gsm + L.b1, *w2s = gsm + L.w2, *u1s = gsm + L.u1;
  float *v1s = gsm + L.v1, *pv = gsm + L.pv, *pvn = gsm + L.pvn, *pu = gsm + L.pu;
  float *pun = gsm + L.pun, *pv2 = gsm + L.pv2, *scal = gsm + L.scal;
  float *ex = gsm + L.ex, *px = gsm + L.px, *gbuf = gsm + L.g + warp * DP;
  float *part = gsm + L.part, *red = gsm + L.red;
  float *ew = gsm + L.ew, *pw = gsm + L.pw, *egp = gsm + L.egp, *mix = gsm + L.mix;

  // ---- 0. state and batch to shared memory (zero padded); sigma ---------
  {
    const float *W1 = g.W1, *e_s = g.e_s, *e_a = g.e_a, *p_s = g.p_s, *p_a = g.p_a;
    for (int e = tid; e < DP * HP; e += THREADS) {
      const int d = e / HP, j = e % HP;
      wt[e] = d < D && j < Hd ? W1[d * Hd + j] : 0.f;
    }
    for (int j = tid; j < HP; j += THREADS) {
      const bool in = j < Hd;
      b1s[j] = in ? g.b1[j] : 0.f;
      w2s[j] = in ? g.W2[j] : 0.f;
      u1s[j] = in && sn ? g.u1[j] : 0.f;
      pv2[j] = in && sn ? g.v2[j] : 0.f;
    }
    for (int d = tid; d < DP; d += THREADS) v1s[d] = d < D && sn ? g.v1[d] : 0.f;
    if (tid == 0) scal[1] = sn ? g.u2[0] : 0.f;
#pragma unroll 4
    for (int e = tid; e < B * DP; e += THREADS) {
      const int i = e / DP, d = e % DP;
      ex[e] = d < S ? e_s[(ll)i * S + d] : d < D ? e_a[(ll)i * A + d - S] : 0.f;
      px[e] = d < S ? p_s[(ll)i * S + d] : d < D ? p_a[(ll)i * A + d - S] : 0.f;
    }
    const float *e_w = g.e_w, *p_w = g.p_w, *eps_gp = g.eps_gp, *mx = g.mix;
    for (int i = tid; i < B; i += THREADS) {
      ew[i] = e_w[i];
      pw[i] = p_w[i];
      egp[i] = eps_gp[i];
      if (!bce) mix[i] = mx[i];
    }
  }
  __syncthreads();
  float s1 = 1.f, s2 = 1.f;
  if (sn) {
    s1 = sigma1<NU>(wt, u1s, v1s, D, lane);
    s2 = sigma2<NU>(w2s, pv2, scal[1], lane);
    __syncthreads();  // every warp has read the raw W1
    for (int e = tid; e < DP * HP; e += THREADS) wt[e] = wt[e] / s1;
    __syncthreads();
  }
  Cols<DP, NU> W;
  W.load(L.wt, lane);
  float b1r[NU], w2r[NU];
#pragma unroll
  for (int u = 0; u < NU; ++u) {
    b1r[u] = b1s[lane + 32 * u];
    w2r[u] = w2s[lane + 32 * u] / s2;
  }
  const float b2 = g.b2[0];
  mark(0);

  // The lane's partial sums: weight gradients of its units over the warp's
  // rows; the loss terms and b2's gradient of the rows it owns.
  float gW[DP][NU], gb1[NU], gw2[NU];
#pragma unroll
  for (int u = 0; u < NU; ++u) {
    gb1[u] = 0.f;
    gw2[u] = 0.f;
#pragma unroll
    for (int d = 0; d < DP; ++d) gW[d][u] = 0.f;
  }
  float lacc = 0.f, eacc = 0.f, pacc = 0.f, gb2 = 0.f;

  // ---- 1. loss rows: forward, loss, d loss / d logit, backward ----------
  // BCE's rows are e | p; Mixup's mix e + (1 - mix) p (MIXED).
  auto loss_rows = [&](auto mixed) {
    constexpr bool MIXED = decltype(mixed)::value;
    const int R = MIXED ? B : 2 * B;
    const int per = (R + WARPS - 1) / WARPS, lo = min(R, warp * per), hi = min(R, lo + per);
    auto row = [&](int r) -> Row {
      if (MIXED) return Row{L.ex + r * DP, L.px + r * DP, mix[r]};
      return Row{r < B ? L.ex + r * DP : L.px + (r - B) * DP, 0, 0.f};
    };
    for (int r0 = lo; r0 < hi; r0 += 32) {
      const int n = min(32, hi - r0);
      float f = 0.f;  // the logit of row r0 + lane
#pragma unroll 2
      for (int k = 0; k < n; ++k) {
        const float fk = logit<MIXED>(row(r0 + k), W, b1r, w2r);
        if (lane == k) f = fk;
      }
      float dl = 0.f;
      if (lane < n) {
        const RowLoss o = row_loss(MIXED, r0 + lane, B, ew, pw, mix, f + b2, ent);
        lacc += o.loss;
        eacc += o.ent;
        dl = o.dl;
        gb2 += dl;
      }
#pragma unroll 2
      for (int k = 0; k < n; ++k) {
        const float d = __shfl_sync(FULL, dl, k);
        const Row x = row(r0 + k);
        float z[NU], dz[NU];
        pre_activation<MIXED>(x, W, z);
#pragma unroll
        for (int u = 0; u < NU; ++u) {
          const float h = fmaxf(z[u] + b1r[u], 0.f);
          dz[u] = h > 0.f ? __fmul_rn(d, w2r[u]) : 0.f;
          gb1[u] += dz[u];
          gw2[u] = fmaf(h, d, gw2[u]);
        }
#pragma unroll
        for (int c = 0; c < DP / 4; ++c) {
          const float4 xc = chunk<MIXED>(x, c);
#pragma unroll
          for (int u = 0; u < NU; ++u) {
            gW[4 * c][u] = fmaf(xc.x, dz[u], gW[4 * c][u]);
            gW[4 * c + 1][u] = fmaf(xc.y, dz[u], gW[4 * c + 1][u]);
            gW[4 * c + 2][u] = fmaf(xc.z, dz[u], gW[4 * c + 2][u]);
            gW[4 * c + 3][u] = fmaf(xc.w, dz[u], gW[4 * c + 3][u]);
          }
        }
      }
    }
  };
  if (bce) {
    loss_rows(Flag<false>{});
  } else {
    loss_rows(Flag<true>{});
  }
  mark(1);

  // ---- 2. penalty rows: a = m * w~2, g = W~1 a, q = m * (W~1^T c g) -----
  if (gp > 0.f) {
    const int per = (B + WARPS - 1) / WARPS, lo = min(B, warp * per), hi = min(B, lo + per);
    const int dg = transposed_index<DP>(lane);
    const bool writer = (lane & (32 / DP - 1)) == 0;
    for (int i = lo; i < hi; ++i) {
      const float eps = egp[i];
      float z[NU], am[NU];
      bool on[NU];
      pre_activation<true>(Row{L.ex + i * DP, L.px + i * DP, eps}, W, z);
#pragma unroll
      for (int u = 0; u < NU; ++u) {
        on[u] = z[u] + b1r[u] > 0.f;
        am[u] = on[u] ? w2r[u] : 0.f;
      }
      float p[DP];
#pragma unroll
      for (int d = 0; d < DP; ++d) {
        p[d] = __fmul_rn(W(d, 0), am[0]);
#pragma unroll
        for (int u = 1; u < NU; ++u) p[d] = fmaf(W(d, u), am[u], p[d]);
      }
      const float gd = transpose_sum<DP>(p, lane);
      if (writer) gbuf[dg] = gd;
      __syncwarp();
      const float gwi = mixf(eps, ew[i], pw[i]);
      const float c = __fmul_rn(2.f * gp, gwi) / (float)B;
      float sq = 0.f, q[NU];
#pragma unroll
      for (int u = 0; u < NU; ++u) q[u] = 0.f;
#pragma unroll
      for (int c4 = 0; c4 < DP / 4; ++c4) {
        const float4 g4 = reinterpret_cast<const float4*>(gbuf)[c4];
        const float gv[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int d = 4 * c4 + k;
          sq = fmaf(gv[k], gv[k], sq);
          const float G = __fmul_rn(c, gv[k]);
#pragma unroll
          for (int u = 0; u < NU; ++u) {
            q[u] = fmaf(G, W(d, u), q[u]);
            gW[d][u] = fmaf(G, am[u], gW[d][u]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < NU; ++u) gw2[u] += on[u] ? q[u] : 0.f;
      pacc += __fmul_rn(gwi, sq);  // the same in every lane
      __syncwarp();  // gbuf is read before the next row writes it
    }
  }
  mark(2);

  // ---- 3. weight gradients (warp partials in warp order), sigma, AdamW ---
  {
    float* mine = part + warp * PW;
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      const int j = lane + 32 * u;
#pragma unroll
      for (int d = 0; d < DP; ++d) mine[d * HP + j] = gW[d][u];
      mine[DP * HP + j] = gb1[u];
      mine[DP * HP + HP + j] = gw2[u];
    }
    lacc = warp_sum(lacc);
    eacc = warp_sum(eacc);
    gb2 = warp_sum(gb2);
    if (lane == 0) {
      red[4 * warp] = lacc;
      red[4 * warp + 1] = eacc;
      red[4 * warp + 2] = pacc;
      red[4 * warp + 3] = gb2;
    }
  }
  __syncthreads();
  float loss = 0.f;
  if (tid == 0) {
    float ls = 0.f, es = 0.f, ps = 0.f;
    for (int w = 0; w < WARPS; ++w) {
      ls += red[4 * w];
      es += red[4 * w + 1];
      ps += red[4 * w + 2];
    }
    loss = ls / (float)B;
    if (ent > 0.f) loss = __fsub_rn(loss, __fmul_rn(ent, es) / (float)B);
    if (gp > 0.f) loss = __fadd_rn(loss, __fmul_rn(gp, ps / (float)B));
  }
  const int nW = D * Hd, nout = nW + 2 * Hd + 1;
  float gr[NO];
  float dot1 = 0.f, dot2 = 0.f;
#pragma unroll
  for (int k = 0; k < NO; ++k) {
    const int o = tid + k * THREADS;
    float s = 0.f;
    if (o < nW + 2 * Hd) {
      const int at = o < nW ? (o / Hd) * HP + o % Hd : DP * HP + (o < nW + Hd ? o - nW : HP + o - nW - Hd);
      for (int w = 0; w < WARPS; ++w) s += part[w * PW + at];
      if (o < nW) {
        dot1 += __fmul_rn(s, g.W1[o]);
      } else if (o >= nW + Hd) {
        dot2 += __fmul_rn(s, g.W2[o - nW - Hd]);
      }
    } else if (o < nout) {
      for (int w = 0; w < WARPS; ++w) s += red[4 * w + 3];
    }
    gr[k] = s;
  }
  if (sn) block_sum2(dot1, dot2, red + 4 * WARPS);
  // dL/dW = G / sigma - (<G, W> / sigma^2) v u^T, rounded as the plain
  // version's ops
  const float t = g.t[0] + 1.f;
  const float bc1 = 1.f - expf(t * LOG_B1), bc2 = 1.f - expf(t * LOG_B2);
  const float c1 = dot1 / (s1 * s1), c2 = dot2 / (s2 * s2);
#pragma unroll
  for (int k = 0; k < NO; ++k) {
    const int o = tid + k * THREADS;
    float gk = gr[k];
    if (o < nW) {
      const int d = o / Hd, j = o % Hd;
      if (sn) gk = __fsub_rn(gk / s1, __fmul_rn(c1, __fmul_rn(v1s[d], u1s[j])));
      wt[d * HP + j] = adamw(g.W1 + o, gk, g.m[0] + o, g.v[0] + o, bc1, bc2, g.lr, g.wd);
    } else if (o < nW + Hd) {
      const int j = o - nW;
      b1s[j] = adamw(g.b1 + j, gk, g.m[1] + j, g.v[1] + j, bc1, bc2, g.lr, g.wd);
    } else if (o < nW + 2 * Hd) {
      const int j = o - nW - Hd;
      if (sn) gk = __fsub_rn(gk / s2, __fmul_rn(c2, __fmul_rn(pv2[j], scal[1])));
      w2s[j] = adamw(g.W2 + j, gk, g.m[2] + j, g.v[2] + j, bc1, bc2, g.lr, g.wd);
    } else if (o < nout) {
      scal[0] = adamw(g.b2, gk, g.m[3], g.v[3], bc1, bc2, g.lr, g.wd);
    }
  }
  mark(3);
  __syncthreads();  // the new weights are in shared memory

  // ---- 4. power iteration on the updated weights: v first, then u -------
  float s1n = 1.f, s2n = 1.f;
  if (sn) power_iteration<NU, HP>(g, D, DP, wt, u1s, pv, pvn, pu, pun, w2s, pv2, scal, s1n, s2n);
  mark(4);

  // ---- 5. reward of the policy rows with the updated network ------------
  W.load(L.wt, lane);
#pragma unroll
  for (int u = 0; u < NU; ++u) {
    b1r[u] = b1s[lane + 32 * u];
    w2r[u] = w2s[lane + 32 * u] / s2n;
  }
  const float nb2 = scal[0];
  {
    const int per = (B + WARPS - 1) / WARPS, lo = min(B, warp * per), hi = min(B, lo + per);
    for (int r0 = lo; r0 < hi; r0 += 32) {
      const int n = min(32, hi - r0);
      float f = 0.f;
      for (int k = 0; k < n; ++k) {
        const float fk = logit<false>(Row{L.px + (r0 + k) * DP, 0, 0.f}, W, b1r, w2r);
        if (lane == k) f = fk;
      }
      if (lane < n) g.rewards_out[r0 + lane] = reward_of(f + nb2, g.reward_fn);
    }
  }
  if (tid == 0) {
    g.loss_out[0] = loss;
    g.t[0] = t;
  }
  mark(5);
}

// ---- the wide variant --------------------------------------------------
// One step of inputs up to WIDE_D features and width HP = 32 NU, at any
// batch, over the blocks an exchange `Ex` names (header): each block runs
// its row segments, then every block takes part in the segments' sum.

// A float rounded to TF32 (to nearest, ties away), in a 32-bit register.
__device__ __forceinline__ unsigned tf32_bits(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, each TF32; x - hi - lo is within 2^-22 |x|.
template <int N>
__device__ __forceinline__ void split_tf32(const float (&x)[N], unsigned (&hi)[N], unsigned (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    hi[i] = tf32_bits(x[i]);
    lo[i] = tf32_bits(__fsub_rn(x[i], __uint_as_float(hi[i])));
  }
}

// d += a b over one 16 x 8 x 8 tile on the tensor cores, fp32 accumulate.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4], const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in 3xTF32: the two cross terms, then hi hi (lo lo, within 2^-22
// of a b, is dropped), so a product keeps about fp32's accuracy.
__device__ __forceinline__ void mma3(float (&d)[4], const unsigned (&ah)[4], const unsigned (&al)[4],
                                     const unsigned (&bh)[2], const unsigned (&bl)[2]) {
  mma_tf32(d, al, bh);
  mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
}

// The A fragment of the 16 x 8 tile at (m0, k0) of A(m, k) = gsm[a + m sm +
// k sk]: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4), with g
// = lane / 4, t = lane % 4 (mma.m16n8k8's layout).
__device__ __forceinline__ void frag_a(float (&f)[4], int a, int sm, int sk, int m0, int k0, int lane) {
  const int o = a + (m0 + (lane >> 2)) * sm + (k0 + (lane & 3)) * sk;
  f[0] = gsm[o];
  f[1] = gsm[o + 8 * sm];
  f[2] = gsm[o + 4 * sk];
  f[3] = gsm[o + 8 * sm + 4 * sk];
}

// The B fragment of the 8 x 8 tile at (k0, n0) of B(k, n) = gsm[b + k sk +
// n sn]: b0 (t, g), b1 (t + 4, g).
__device__ __forceinline__ void frag_b(float (&f)[2], int b, int sk, int sn, int k0, int n0, int lane) {
  const int o = b + (k0 + (lane & 3)) * sk + (n0 + (lane >> 2)) * sn;
  f[0] = gsm[o];
  f[1] = gsm[o + 4 * sk];
}

// C = A B over a chunk: C (RC x N), A (RC x K) at offset a (strides a_m,
// a_k), B (K x N) at b (strides b_k, b_n), K and N multiples of 8, in
// 3xTF32. Warp w takes the output tiles w and w + WARPS of the 2 N / 8,
// both in one pass over k, and hands each element to out(row, col, value).
template <class Out>
__device__ __forceinline__ void chunk_product(int a, int a_m, int a_k, int b, int b_k, int b_n, int K,
                                              int N, const Out& out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nt = N / 8, tiles = 2 * nt;
  if (warp >= tiles) return;  // the warp's tiles, warp-uniform
  bool on[2];
  int m0[2], n0[2];
  float d[2][4] = {};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = warp + WARPS * i;
    on[i] = t < tiles;
    m0[i] = 16 * (t / nt);
    n0[i] = 8 * (t % nt);
  }
  for (int k0 = 0; k0 < K; k0 += 8) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (!on[i]) continue;
      float fa[4], fb[2];
      unsigned ah[4], al[4], bh[2], bl[2];
      frag_a(fa, a, a_m, a_k, m0[i], k0, lane);
      frag_b(fb, b, b_k, b_n, k0, n0[i], lane);
      split_tf32(fa, ah, al);
      split_tf32(fb, bh, bl);
      mma3(d[i], ah, al, bh, bl);
    }
  }
  const int g = lane >> 2, c = 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!on[i]) continue;
    out(m0[i] + g, n0[i] + c, d[i][0]);
    out(m0[i] + g, n0[i] + c + 1, d[i][1]);
    out(m0[i] + g + 8, n0[i] + c, d[i][2]);
    out(m0[i] + g + 8, n0[i] + c + 1, d[i][3]);
  }
}

// acc += A^T B over a chunk's RC rows, in 3xTF32: A (RC x DM) at offset a,
// rows of stride xs; B (RC x HP) at b, rows of stride zs. The warp's tiles
// of the (DM x HP) gradient are w + WARPS i (i < 2 NU) over 4 NU column
// tiles, all in column tile w mod 4 NU, so one B fragment serves them at a
// step of k; a tile past the mtiles row tiles is skipped.
template <int NU>
__device__ __forceinline__ void grad_product(float (&acc)[2 * NU][4], int a, int xs, int b, int zs,
                                             int mtiles) {
  constexpr int NT = 4 * NU;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n0 = 8 * (warp % NT);
#pragma unroll
  for (int k0 = 0; k0 < RC; k0 += 8) {
    float fb[2];
    unsigned bh[2], bl[2];
    frag_b(fb, b, zs, 1, k0, n0, lane);
    split_tf32(fb, bh, bl);
#pragma unroll
    for (int i = 0; i < 2 * NU; ++i) {
      const int mt = (warp + WARPS * i) / NT;
      if (mt >= mtiles) continue;  // warp-uniform
      float fa[4];
      unsigned ah[4], al[4];
      frag_a(fa, a, 1, xs, 16 * mt, k0, lane);  // A^T(d, r) = A(r, d)
      split_tf32(fa, ah, al);
      mma3(acc[i], ah, al, bh, bl);
    }
  }
}

__device__ __forceinline__ void cp_async4(int dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(gsm + dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

// The slice of the nR reduced entries that segment s's block sums.
__device__ __forceinline__ int slice_start(int s, int nR, int NS) { return (int)((ll)s * nR / NS); }

template <int NU, class Ex, class Mark>
__device__ __noinline__ void step_wide(const Args& g, const Ex ex, const Mark& mark) {
  constexpr int HP = 32 * NU, WS = HP + 4;
  constexpr int GR = THREADS / HP;  // row groups: the threads of one unit
  constexpr int RPT = RC / GR;      // chunk rows a thread takes in a column pass
  static_assert(RC == 32 && RC % GR == 0, "warp 0's lanes sum a chunk's rows");
  const int S = g.S, A = g.A, D = S + A, Hd = g.Hd, B = g.B, bce = g.bce, sn = g.sn;
  const float gp = g.gp, ent = g.ent;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j = tid % HP, grp = tid / HP;  // the thread's unit and row group in column passes
  const WideLayout L = wide_layout(D, HP);
  const int DK = L.DK, XS = L.XS, ZS = L.ZS, mtiles = L.DM / 16;
  const int NS = wide_segments(B), nW = D * Hd, nE = wide_entries(D, Hd), nR = nE + 3;
  float *wt = gsm + L.wt, *b1s = gsm + L.b1, *w2s = gsm + L.w2, *w2n = gsm + L.w2n;
  float *u1s = gsm + L.u1, *v1s = gsm + L.v1, *pv2 = gsm + L.pv2, *scal = gsm + L.scal;
  float *gq = gsm + L.gq, *zs = gsm + L.z, *ams = gsm + L.am, *qs = gsm + L.q, *cs = gsm + L.cs;
  float *rl = gsm + L.rows, *re = rl + RC, *dls = re + RC, *rp = dls + RC;
  const float *e_s = g.e_s, *e_a = g.e_a, *p_s = g.p_s, *p_a = g.p_a;

  // ---- 0. state to shared memory (zero padded); sigma ---------------------
  for (int e = tid; e < DK * WS; e += THREADS) {
    const int d = e / WS, c = e % WS;
    wt[e] = d < D && c < Hd ? g.W1[d * Hd + c] : 0.f;
  }
  for (int c = tid; c < HP; c += THREADS) {
    const bool in = c < Hd;
    b1s[c] = in ? g.b1[c] : 0.f;
    w2s[c] = in ? g.W2[c] : 0.f;
    u1s[c] = in && sn ? g.u1[c] : 0.f;
    pv2[c] = in && sn ? g.v2[c] : 0.f;
  }
  for (int d = tid; d < DK; d += THREADS) v1s[d] = d < D && sn ? g.v1[d] : 0.f;
  if (tid == 0) scal[1] = sn ? g.u2[0] : 0.f;
  __syncthreads();
  float s1 = 1.f, s2 = 1.f;
  if (sn) {
    s1 = sigma1<NU, WS>(wt, u1s, v1s, D, lane);
    s2 = sigma2<NU>(w2s, pv2, scal[1], lane);
    __syncthreads();  // every warp has read the raw W1
    for (int e = tid; e < DK * WS; e += THREADS) wt[e] = wt[e] / s1;
  }
  if (tid < HP) w2n[tid] = w2s[tid] / s2;
  const float b2 = g.b2[0];
  __syncthreads();
  float b1j = b1s[j], w2j = w2n[j];
  mark(0);

  // Rows r0 .. r0 + n - 1 of a chunk into stage st, zero padded to RC x XS,
  // by cp.async (a warp a row, lanes over the features): kind 0 row i of
  // e | p (BCE's loss rows) into es; 1 expert row i into es and policy row i
  // into ps (mixed rows); 2 policy row i into es (reward rows).
  auto land = [&](int kind, int r0, int n, int st) {
    const int E = L.es[st], P = L.ps[st];
    for (int r = warp; r < RC; r += WARPS) {
      const int i = r0 + r;
      const bool in = r < n;
      const bool pol = kind == 2 || (kind == 0 && i >= B);
      const int ii = kind == 0 && i >= B ? i - B : i;
      const float* xs_ = in ? (pol ? p_s : e_s) + (ll)ii * S : nullptr;
      const float* xa_ = in ? (pol ? p_a : e_a) + (ll)ii * A : nullptr;
      for (int d = lane; d < XS; d += 32) {
        if (in && d < D) {
          cp_async4(E + r * XS + d, d < S ? xs_ + d : xa_ + (d - S));
          if (kind == 1) cp_async4(P + r * XS + d, d < S ? p_s + (ll)i * S + d : p_a + (ll)i * A + (d - S));
        } else {
          gsm[E + r * XS + d] = 0.f;
          if (kind == 1) gsm[P + r * XS + d] = 0.f;
        }
      }
    }
    cp_async_commit();
  };
  // es[st] = coef e + (1 - coef) p over the chunk's rows (rows past n stay 0).
  auto mix_rows = [&](int st, int r0, int n, const float* coef) {
    const int E = L.es[st], P = L.ps[st];
    for (int r = warp; r < n; r += WARPS) {
      const float c = coef[r0 + r];
      for (int d = lane; d < D; d += 32)
        gsm[E + r * XS + d] = mixf(c, gsm[E + r * XS + d], gsm[P + r * XS + d]);
    }
    __syncthreads();
  };
  // chunks 0 .. N - 1, the next one landing while this one is computed:
  // land(c, stage), then compute(c, stage) once its rows are in.
  auto pipeline = [&](int N, const auto& issue, const auto& compute) {
    if (N == 0) return;
    issue(0, 0);
    for (int c = 0; c < N; ++c) {
      __syncthreads();  // the other stage's last chunk is read
      if (c + 1 < N) {
        issue(c + 1, (c + 1) & 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();  // chunk c has landed
      compute(c, c & 1);
    }
  };
  // zs = X W~1 over a chunk at es[st]; with AM also the penalty's a = (z +
  // b1 > 0) * w~2.
  auto forward = [&](int st, bool am) {
    chunk_product(L.es[st], XS, 1, L.wt, WS, 1, DK, HP, [&](int r, int c, float v) {
      zs[r * ZS + c] = v;
      if (am) ams[r * ZS + c] = v + b1s[c] > 0.f ? w2n[c] : 0.f;
    });
    __syncthreads();
  };
  // The logit less b2 of chunk row r, the same bits in every lane (logit).
  auto logit_of = [&](int r) {
    float f = 0.f;
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      const int c = lane + 32 * u;
      f = fmaf(fmaxf(zs[r * ZS + c] + b1s[c], 0.f), w2n[c], f);
    }
    return warp_sum(f);
  };

  // ---- 1, 2. each segment's loss and penalty rows, into its partial sums ---
  for (int s = ex.first(); s < ex.last(); ++s) {
    const int R = bce ? 2 * B : B;
    const int l0 = (int)((ll)s * R / NS), l1 = (int)((ll)(s + 1) * R / NS);
    const int p0 = (int)((ll)s * B / NS), p1 = (int)((ll)(s + 1) * B / NS);
    const int nl = (l1 - l0 + RC - 1) / RC, np = gp > 0.f ? (p1 - p0 + RC - 1) / RC : 0;
    // the warp's tiles of the weight gradient (unit columns, feature rows);
    // the thread's column sums of b1's and w2's gradients over its rows;
    // lane r of warp 0's sums of chunk row r's loss terms and b2's gradient
    float acc[2 * NU][4] = {};
    float gb1 = 0.f, gw2 = 0.f, lacc = 0.f, eacc = 0.f, pacc = 0.f, gb2 = 0.f;
    auto issue = [&](int c, int st) {
      if (c < nl) land(bce ? 0 : 1, l0 + RC * c, min(RC, l1 - l0 - RC * c), st);
      else land(1, p0 + RC * (c - nl), min(RC, p1 - p0 - RC * (c - nl)), st);
    };
    auto compute = [&](int c, int st) {
      const int X = L.es[st];
      if (c < nl) {  // loss rows: BCE's e | p, Mixup's mix e + (1 - mix) p
        const int r0 = l0 + RC * c, n = min(RC, l1 - r0);
        if (!bce) mix_rows(st, r0, n, g.mix);
        forward(st, false);
        for (int r = warp; r < RC; r += WARPS) {
          const float f = logit_of(r);
          if (lane == 0) {
            RowLoss o = {0.f, 0.f, 0.f};
            if (r < n) o = row_loss(!bce, r0 + r, B, g.e_w, g.p_w, g.mix, f + b2, ent);
            rl[r] = o.loss;
            re[r] = o.ent;
            dls[r] = o.dl;
          }
        }
        __syncthreads();
#pragma unroll
        for (int i = 0; i < RPT; ++i) {  // dz in place of z
          const int r = grp + GR * i;
          const float h = fmaxf(zs[r * ZS + j] + b1j, 0.f), dl = dls[r];
          const float dz = h > 0.f ? __fmul_rn(dl, w2j) : 0.f;
          zs[r * ZS + j] = dz;
          gb1 += dz;
          gw2 = fmaf(h, dl, gw2);
        }
        if (tid < n) {
          lacc += rl[tid];
          eacc += re[tid];
          gb2 += dls[tid];
        }
        __syncthreads();
        grad_product<NU>(acc, X, XS, L.z, ZS, mtiles);  // X^T dz
      } else {  // penalty rows: a = m * w~2, g = a W~1^T, q = m * ((c g) W~1)
        if (c == nl) mark(1);
        const int r0 = p0 + RC * (c - nl), n = min(RC, p1 - r0);
        mix_rows(st, r0, n, g.eps_gp);
        forward(st, true);
        chunk_product(L.am, ZS, 1, L.wt, 1, WS, HP, DK,
                      [&](int r, int d, float v) { gq[r * XS + d] = v; });
        __syncthreads();
        for (int r = warp; r < RC; r += WARPS) {  // |g|^2, then g -> c g
          float gwi = 0.f, cr = 0.f;
          if (r < n) {
            const int i = r0 + r;
            gwi = mixf(g.eps_gp[i], g.e_w[i], g.p_w[i]);
            cr = __fmul_rn(2.f * gp, gwi) / (float)B;
          }
          float sq = 0.f;
          for (int d = lane; d < D; d += 32) sq = fmaf(gq[r * XS + d], gq[r * XS + d], sq);
          sq = warp_sum(sq);
          for (int d = lane; d < DK; d += 32) gq[r * XS + d] = __fmul_rn(cr, gq[r * XS + d]);
          if (lane == 0) rp[r] = __fmul_rn(gwi, sq);
        }
        __syncthreads();
        chunk_product(L.gq, XS, 1, L.wt, WS, 1, DK, HP, [&](int r, int cc, float v) {
          qs[r * ZS + cc] = zs[r * ZS + cc] + b1s[cc] > 0.f ? v : 0.f;
        });
        __syncthreads();
#pragma unroll
        for (int i = 0; i < RPT; ++i) gw2 += qs[(grp + GR * i) * ZS + j];
        if (tid < n) pacc += rp[tid];
        grad_product<NU>(acc, L.gq, XS, L.am, ZS, mtiles);  // (c g)^T a
      }
    };
    pipeline(nl + np, issue, compute);
    if (np == 0) mark(1);
    mark(2);

    // the segment's partial sums (the chunk area is free)
    __syncthreads();
    float* P = ex.out(s);
    {
      const int g8 = lane >> 2, c2 = 2 * (lane & 3), n0 = 8 * (warp % (4 * NU));
#pragma unroll
      for (int i = 0; i < 2 * NU; ++i) {
        const int mt = (warp + WARPS * i) / (4 * NU);
        if (mt >= mtiles) continue;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int d = 16 * mt + g8 + (q >> 1) * 8, c = n0 + c2 + (q & 1);
          if (d < D && c < Hd) P[d * Hd + c] = acc[i][q];
        }
      }
    }
    cs[grp * HP + j] = gb1;
    cs[THREADS + grp * HP + j] = gw2;
    if (warp == 0) {
      lacc = warp_sum(lacc);
      eacc = warp_sum(eacc);
      pacc = warp_sum(pacc);
      gb2 = warp_sum(gb2);
      if (lane == 0) {
        P[nE - 1] = gb2;
        P[nE] = lacc;
        P[nE + 1] = eacc;
        P[nE + 2] = pacc;
      }
    }
    __syncthreads();
    if (tid < Hd) {  // the row groups in order
      float a = 0.f, b = 0.f;
#pragma unroll
      for (int q = 0; q < GR; ++q) {
        a += cs[q * HP + tid];
        b += cs[THREADS + q * HP + tid];
      }
      P[nW + tid] = a;
      P[nW + Hd + tid] = b;
    }
  }
  ex.sync();  // every segment's partial sums are written

  // ---- 3. the sums over the segments, in segment order; <G, W> ------------
  // Entry e's sum is taken by the block of the slice holding it, which
  // leaves it in place of its own segment's partial (no other block reads
  // that entry of it); each slice's share of the dot products is a block
  // sum, and the slices' shares are summed in slice order.
  for (int s = ex.first(); s < ex.last(); ++s) {
    float* P = ex.out(s);
    float dot1 = 0.f, dot2 = 0.f;
    for (int e = slice_start(s, nR, NS) + tid; e < slice_start(s + 1, nR, NS); e += THREADS) {
      float G = 0.f;
      for (int q = 0; q < NS; ++q) G += ex.get(q, e);
      P[e] = G;
      if (e < nW) {
        dot1 += __fmul_rn(G, g.W1[e]);
      } else if (e >= nW + Hd && e < nW + 2 * Hd) {
        dot2 += __fmul_rn(G, g.W2[e - nW - Hd]);
      }
    }
    if (sn) {
      block_sum2(dot1, dot2, gsm + L.red);
      if (tid == 0) {
        ex.dot_out(s)[0] = dot1;
        ex.dot_out(s)[1] = dot2;
      }
      __syncthreads();  // red is read before the next slice's sums
    }
  }
  ex.sync();  // every entry's sum and every slice's dot products are in
  mark(3);

  // ---- 4. through sigma, AdamW on the block's slices -----------------------
  // dL/dW = G / sigma - (<G, W> / sigma^2) v u^T, rounded as the plain
  // version's ops
  float dot1 = 0.f, dot2 = 0.f;
  if (sn)
    for (int q = 0; q < NS; ++q) {
      dot1 += ex.dot(q, 0);
      dot2 += ex.dot(q, 1);
    }
  const float t = g.t[0] + 1.f;
  const float bc1 = 1.f - expf(t * LOG_B1), bc2 = 1.f - expf(t * LOG_B2);
  const float c1 = dot1 / (s1 * s1), c2 = dot2 / (s2 * s2);
  for (int s = ex.first(); s < ex.last(); ++s) {
    const int e1 = min(slice_start(s + 1, nR, NS), nE);
    for (int e = slice_start(s, nR, NS) + tid; e < e1; e += THREADS) {
      float gk = ex.get(s, e);
      if (e < nW) {
        const int d = e / Hd, c = e % Hd;
        if (sn) gk = __fsub_rn(gk / s1, __fmul_rn(c1, __fmul_rn(v1s[d], u1s[c])));
        adamw(g.W1 + e, gk, g.m[0] + e, g.v[0] + e, bc1, bc2, g.lr, g.wd);
      } else if (e < nW + Hd) {
        const int c = e - nW;
        adamw(g.b1 + c, gk, g.m[1] + c, g.v[1] + c, bc1, bc2, g.lr, g.wd);
      } else if (e < nW + 2 * Hd) {
        const int c = e - nW - Hd;
        if (sn) gk = __fsub_rn(gk / s2, __fmul_rn(c2, __fmul_rn(pv2[c], scal[1])));
        adamw(g.W2 + c, gk, g.m[2] + c, g.v[2] + c, bc1, bc2, g.lr, g.wd);
      } else {
        adamw(g.b2, gk, g.m[3], g.v[3], bc1, bc2, g.lr, g.wd);
      }
    }
  }
  float loss = 0.f;  // the lead block's thread 0's
  if (ex.lead() && tid == 0) {
    float terms[3];
    for (int k = 0; k < 3; ++k) {  // the loss terms' sums, from the slices that hold them
      int q = NS - 1;
      while (slice_start(q, nR, NS) > nE + k) --q;
      terms[k] = ex.get(q, nE + k);
    }
    loss = terms[0] / (float)B;
    if (ent > 0.f) loss = __fsub_rn(loss, __fmul_rn(ent, terms[1]) / (float)B);
    if (gp > 0.f) loss = __fadd_rn(loss, __fmul_rn(gp, terms[2] / (float)B));
  }
  ex.sync();  // the new parameters are in the state, and nothing reads another block's shared memory
  mark(4);

  // ---- 5. the new weights (written by other blocks: L2 loads); power iteration
  for (int e = tid; e < DK * WS; e += THREADS) {
    const int d = e / WS, c = e % WS;
    wt[e] = d < D && c < Hd ? __ldcg(g.W1 + d * Hd + c) : 0.f;
  }
  for (int c = tid; c < HP; c += THREADS) {
    const bool in = c < Hd;
    b1s[c] = in ? __ldcg(g.b1 + c) : 0.f;
    w2s[c] = in ? __ldcg(g.W2 + c) : 0.f;
  }
  if (tid == 0) scal[0] = __ldcg(g.b2);
  __syncthreads();
  float s1n = 1.f, s2n = 1.f;
  if (sn)
    power_iteration<NU, WS>(g, D, DK, wt, u1s, gsm + L.pv, gsm + L.pvn, gsm + L.pu, gsm + L.pun, w2s,
                            pv2, scal, s1n, s2n, ex.lead());
  if (tid < HP) w2n[tid] = w2s[tid] / s2n;
  const float nb2 = scal[0];
  __syncthreads();
  b1j = b1s[j];
  w2j = w2n[j];
  mark(5);

  // ---- 6. reward of the segments' policy rows with the updated network ----
  for (int s = ex.first(); s < ex.last(); ++s) {
    const int p0 = (int)((ll)s * B / NS), p1 = (int)((ll)(s + 1) * B / NS);
    pipeline(
        (p1 - p0 + RC - 1) / RC,
        [&](int c, int st) { land(2, p0 + RC * c, min(RC, p1 - p0 - RC * c), st); },
        [&](int c, int st) {
          const int r0 = p0 + RC * c, n = min(RC, p1 - r0);
          forward(st, false);
          for (int r = warp; r < n; r += WARPS) {
            const float f = logit_of(r);
            if (lane == 0) g.rewards_out[r0 + r] = reward_of(f + nb2, g.reward_fn);
          }
        });
  }
  if (ex.lead() && tid == 0) {
    g.loss_out[0] = loss;
    g.t[0] = t;
  }
  mark(6);
}

// The exchange of a step run by one thread-block cluster, one segment a
// block: the partial sums and dot products in each block's shared memory,
// read by the others through distributed shared memory.
struct ClusterEx {
  int rank, part, dots;  // the block's segment; offsets into gsm
  __device__ int first() const { return rank; }
  __device__ int last() const { return rank + 1; }
  __device__ bool lead() const { return rank == 0; }
  __device__ float* out(int) const { return gsm + part; }
  __device__ float get(int s, int e) const {
    return cooperative_groups::this_cluster().map_shared_rank(gsm + part, (unsigned)s)[e];
  }
  __device__ float* dot_out(int) const { return gsm + dots; }
  __device__ float dot(int s, int i) const {
    return cooperative_groups::this_cluster().map_shared_rank(gsm + dots, (unsigned)s)[i];
  }
  __device__ void sync() const { cooperative_groups::this_cluster().sync(); }
};

template <class Ex, class Mark>
__device__ inline void step_wide_of(const Args& g, const Ex ex, const Mark& mark) {
  switch (unit_groups(g.Hd)) {
    case 1: step_wide<1>(g, ex, mark); break;
    case 2: step_wide<2>(g, ex, mark); break;
    case 4: step_wide<4>(g, ex, mark); break;
    default: break;
  }
}

// A wide step by the cluster of wide_segments(B) blocks that runs it.
template <class Mark>
__device__ inline void step_cluster(const Args& g, const Mark& mark) {
  const WideLayout L = wide_layout(g.S + g.A, 32 * unit_groups(g.Hd));
  const ClusterEx ex{(int)cooperative_groups::this_cluster().block_rank(), L.part, L.dots};
  step_wide_of(g, ex, mark);
}

// One step of the tiled variant of (D, Hd) by one block; a shape it cannot
// take does nothing (the C entries refuse it before the launch).
template <class Mark>
__device__ inline void step(const Args& g, const Mark& mark) {
  const int dp = padded_features(g.S + g.A), nu = unit_groups(g.Hd);
  switch (dp * 8 + nu) {
    case 8 * 8 + 1: step_t<8, 1>(g, mark); break;
    case 8 * 8 + 2: step_t<8, 2>(g, mark); break;
    case 8 * 8 + 4: step_t<8, 4>(g, mark); break;
    case 16 * 8 + 1: step_t<16, 1>(g, mark); break;
    case 16 * 8 + 2: step_t<16, 2>(g, mark); break;
    default: break;
  }
}

// Whether a launch of the given variant, or of the routed one, can take
// the shape: the variant and the shared memory.
inline bool fits(int B, int D, int Hd, bool wide) {
  const size_t bytes = smem_bytes(B, D, Hd, wide);
  return bytes > 0 && bytes <= SMEM_LIMIT;
}

inline bool fits(int B, int D, int Hd) { return fits(B, D, Hd, routes_wide(B, D, Hd)); }

// Pointer order: W1 (D, Hd), b1, W2 (Hd, 1), b2, u1, v1, u2, v2 (null
// without spectral norm), AdamW m (4), v (4), the step clock (1,), e_s, e_a,
// e_w, p_s, p_a, p_w, eps_gp, mix (null for BCE), out loss (1), out rewards
// (B). The variant is the routed one.
inline Args unpack(void* const* ptr, int B, int S, int A, int Hd, int sn, int bce, int reward_fn,
                   float gp, float lr, float wd, float ent) {
  float* const* P = reinterpret_cast<float* const*>(ptr);
  Args g = {};
  g.W1 = P[0]; g.b1 = P[1]; g.W2 = P[2]; g.b2 = P[3];
  if (sn) { g.u1 = P[4]; g.v1 = P[5]; g.u2 = P[6]; g.v2 = P[7]; }
  for (int i = 0; i < 4; ++i) {
    g.m[i] = P[8 + i];
    g.v[i] = P[12 + i];
  }
  g.t = P[16];
  g.e_s = P[17]; g.e_a = P[18]; g.e_w = P[19];
  g.p_s = P[20]; g.p_a = P[21]; g.p_w = P[22];
  g.eps_gp = P[23]; g.mix = P[24];
  g.loss_out = P[25]; g.rewards_out = P[26];
  g.B = B; g.S = S; g.A = A; g.Hd = Hd; g.sn = sn; g.bce = bce; g.reward_fn = reward_fn;
  g.wide = routes_wide(B, S + A, Hd);
  g.gp = gp; g.lr = lr; g.wd = wd; g.ent = ent;
  return g;
}

// ---- the per-update launch of a wide step: one cluster ------------------

constexpr int ERR_CLUSTER = -1000;  // the card cannot hold the step's cluster

inline cudaLaunchConfig_t cluster_config(int blocks, size_t smem, cudaStream_t s,
                                         cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3((unsigned)THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Opt `kernel` into `opt_in` (>= smem) bytes of dynamic shared memory and
// into clusters past the portable 8, and ask the card whether a cluster of
// `blocks` of its blocks with `smem` bytes each can be resident: 0, a CUDA
// error, or ERR_CLUSTER. The opt-in is one attribute of the kernel, so a
// caller only ever raises it (a lower one would refuse a larger shape asked
// before). Not stream work: the launching entries ask once a cluster size
// and shared memory and cache the answer (a CUDA graph capture then meets
// the launch alone).
template <class K>
inline int prepare_cluster(K* kernel, int blocks, size_t opt_in, size_t smem) {
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)opt_in);
  if (e != cudaSuccess) return (int)e;
  if (blocks > 8) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(blocks, smem, 0, attr);
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  if (e != cudaSuccess) return (int)e;
  return n > 0 ? 0 : ERR_CLUSTER;
}

// One launch of the wide step's kernel K (its first argument the step's
// Args) as one cluster of wide_segments(B) blocks on stream s. The opt-in
// (only raised) and the residency question once per cluster size and
// shared memory.
template <auto K, class... Q>
inline int launch_wide(const Args& g, size_t smem, cudaStream_t s, Q... extra) {
  static size_t opted = 0, ready[MAX_SEGMENTS + 1] = {};
  const int blocks = wide_segments(g.B);
  if (ready[blocks] != smem || smem > opted) {
    const size_t opt_in = smem > opted ? smem : opted;
    const int e = prepare_cluster(K, blocks, opt_in, smem);
    if (e != 0) return e;
    opted = opt_in;
    ready[blocks] = smem;
  }
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(blocks, smem, s, attr);
  const cudaError_t e = cudaLaunchKernelEx(&cfg, K, g, extra...);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace gail
