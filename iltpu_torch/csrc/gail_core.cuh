// The arithmetic of one GAIL discriminator step + reward head, shared by
// the per-update kernel (gail_update.cu), the K-blocked persistent kernel
// (kblock_update.cu) and the phase timer (gail_phases.cu), as the TPU's
// `_gail_core` is shared by pallas_gail.py and pallas_fused_block.py.
//
// `gail::step` is run by ONE block of exactly THREADS threads (16 warps).
// Every sum runs in an order that follows the block alone, so every kernel
// that runs it gets the same bits. Its working set lives in dynamic shared
// memory (smem_bytes(B, D, Hd)), not in global scratch. Two families of
// variants, chosen by the shape (`routes_wide`):
//
// The tiled variants (`step_t`, `layout`) hold the whole batch:
//  - the batch rows e = [e_s, e_a] and p = [p_s, p_a], each (B, DP): the
//    D = S + A features padded with zeros to DP (8, 16 or 32), so a row is
//    DP / 4 float4 broadcasts; the per-row weights, eps_gp and mix. The loss
//    rows (e | p, or Mixup's mix e + (1 - mix) p) and the penalty rows
//    (eps_gp e + (1 - eps_gp) p) are formed from them where they are used;
//  - W~1 = W1 / sigma1 as (DP, HP), the hidden units padded with zeros to
//    HP = 32 NU (NU = 1, 2 or 4), with b1, W2 and the spectral-norm vectors;
//  - each warp's partial weight gradients (DP HP + 2 HP floats a warp),
//    combined in warp order, a warp's row of the penalty's g = W~1 a, and
//    the block sums.
// The hidden activations, relu masks and the penalty's a = m * w~2 and
// q = m * (W~1^T G) are never stored: they are recomputed from the rows
// where needed (D fmaf each). Nothing but the state and the outputs goes to
// global memory.
//
// Threads spread over rows x hidden units. Lane l of a warp owns the units
// l + 32 u (u < NU), with their columns of W~1 in registers (read from
// shared memory where DP NU > 32) and its partial weight gradients in
// registers; a warp owns a contiguous slice of the rows. For a row, the
// warp forms the hidden units from the row's features (float4 broadcasts
// from shared memory), and the dot product with w~2 is a butterfly of
// shuffles that leaves the same bits in every lane. Loss rows go 32 at a
// time: the forward of each row, then the loss and d loss / d logit of row
// k by lane k (one pass of transcendentals for 32 rows), then the backward
// of each row with its d loss / d logit shuffled from its lane. The
// penalty's g = W~1 a sums over the units, so over the lanes: a transposing
// shuffle reduction (transpose_sum) leaves each lane one of the DP sums.
//
// The wide variant (`step_wide`, `wide_layout`) takes what the tiled ones
// cannot: inputs up to WIDE_D = 128 features (ant's 120), and the batches
// and widths whose rows (2 B DP floats) and 16 warps' partials (16 (DP HP +
// 2 HP)) pass a block's shared memory (width 128 at D = 15 or 24, batch
// 1024). Its working set does not grow with the batch:
//  - W~1 as (D4, HP + 1), D4 = D rounded up to 4, the odd row stride
//    keeping the penalty's column reads (lanes over features) free of bank
//    conflicts; b1, W2, w~2 and the spectral-norm vectors;
//  - one chunk of RC = 32 rows at a time, read from global memory (the
//    batch is a read-only input, L2-resident) into (RC, D4), formed as the
//    tiled variants form them; its pre-activations Z = X W~1 (RC, HP), and
//    for the penalty rows a = m * w~2, g = a W~1^T then c g (RC, D4), and
//    q = (c g) W~1 (RC, HP).
// Thread t owns unit j = t % HP in row group t / HP: it forms the chunk's
// pre-activations of unit j (rows t / HP + GR i, D fmaf in feature order,
// as the tiled variants), and owns the weight gradient of unit j at the
// features t / HP + GR k (the DP x HP gradient split into 512 fixed tiles
// of up to 32 entries, in registers), which it sums over the chunk's rows
// in row order, chunk after chunk: the GEMMs X^T Delta of the loss rows
// and (c g)^T a of the penalty rows, with no per-warp partials to combine.
// A warp takes a chunk row's logit (a butterfly over the units) and its
// squared |g|; the per-row loss terms are summed by lane r of warp 0 over
// the chunks, then over the lanes.
//
// Phases, with barriers only between them: 0 state (and, tiled, the batch)
// to shared memory, sigma; 1 loss rows; 2 penalty rows; 3 the weight
// gradients (tiled: the warps' partials in warp order), through sigma,
// AdamW; 4 one power iteration (v first, then u) on the updated weights; 5
// the reward of the policy rows with the new parameters. The penalty's
// parameter gradient is derived by hand (ops/gail_update.py): per
// interpolated row i, with a_i = m_i * w~2 and g_i = W~1 a_i, dP/dW~1 gets
// c_i g_i a_i^T and dP/dw~2 gets c_i m_i * (W~1^T g_i), c_i = 2 gp g_w_i /
// B; gradients then go through sigma = v^T W u with u and v held fixed.
//
// Full fp32. Every product that meets an add is written out as fmaf or
// __fmul_rn, so no contraction is left to the compiler that could differ
// between the kernels. Nothing is read through __ldg or
// `const __restrict__`: the state is updated in place.

#pragma once

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
  return D < 1 ? 0 : D <= 8 ? 8 : D <= 16 ? 16 : D <= 32 ? 32 : 0;
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
// takes it. A launch also needs it <= SMEM_LIMIT.
__host__ __device__ inline size_t tiled_smem_bytes(int B, int D, int Hd) {
  const int dp = padded_features(D), nu = unit_groups(Hd);
  if (B < 1 || !dp || !nu || dp * nu > 64) return 0;
  return sizeof(float) * (size_t)layout(B, dp, 32 * nu).total;
}

// The wide variant's offsets in floats; each 16-byte aligned.
struct WideLayout {
  int wt, b1, w2, w2n, u1, v1, pv, pvn, pu, pun, pv2, scal, x, gq, z, am, q, rows, red, total;
};

__host__ __device__ inline WideLayout wide_layout(int D, int HP) {
  const int D4 = (D + 3) / 4 * 4;
  WideLayout L;
  int o = 0;
  L.wt = take(o, D4 * (HP + 1));  // W~1 (raw W1 after AdamW), rows of stride HP + 1
  L.b1 = take(o, HP);
  L.w2 = take(o, HP);       // raw W2
  L.w2n = take(o, HP);      // w~2 = W2 / sigma2
  L.u1 = take(o, HP);
  L.v1 = take(o, D4);
  L.pv = take(o, D4);       // the power iteration's, as the tiled layout's
  L.pvn = take(o, D4);
  L.pu = take(o, HP);
  L.pun = take(o, HP);
  L.pv2 = take(o, HP);
  L.scal = take(o, 4);      // new b2, old u2, new u2
  L.x = take(o, RC * D4);   // a chunk's rows
  L.gq = take(o, RC * D4);  // the penalty rows' g, then c g
  L.z = take(o, RC * HP);   // the chunk's pre-activations
  L.am = take(o, RC * HP);  // the penalty rows' a = m * w~2
  L.q = take(o, RC * HP);   // the penalty rows' (c g) W~1
  L.rows = take(o, 4 * RC); // a chunk's d loss / d logit and its loss, entropy, penalty terms
  L.red = take(o, 2 * WARPS);
  L.total = o;
  return L;
}

// Dynamic shared memory of the wide variant; 0 past WIDE_D features or
// width 128. It does not depend on the batch.
__host__ __device__ inline size_t wide_smem_bytes(int D, int Hd) {
  const int nu = unit_groups(Hd);
  if (D < 1 || D > WIDE_D || !nu) return 0;
  return sizeof(float) * (size_t)wide_layout(D, 32 * nu).total;
}

// The route: the wide variant takes every shape that no tiled variant fits.
__host__ __device__ inline bool routes_wide(int B, int D, int Hd) {
  const size_t tiled = tiled_smem_bytes(B, D, Hd);
  return tiled == 0 || tiled > SMEM_LIMIT;
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

// The lane's columns of W~1 (units lane + 32 u): in registers where
// DP NU <= 32, else read from shared memory (offset s), where lanes read
// consecutive words.
template <int DP, int NU>
struct Cols {
  static constexpr int HP = 32 * NU;
  static constexpr bool REG = DP * NU <= 32;
  float r[REG ? DP : 1][NU];
  int s;
  __device__ __forceinline__ void load(int wt, int lane) {
    s = wt + lane;
    if constexpr (REG) {
#pragma unroll
      for (int d = 0; d < DP; ++d)
#pragma unroll
        for (int u = 0; u < NU; ++u) r[d][u] = gsm[s + d * HP + 32 * u];
    }
  }
  __device__ __forceinline__ float operator()(int d, int u) const {
    if constexpr (REG) {
      return r[d][u];
    } else {
      return gsm[s + d * HP + 32 * u];
    }
  }
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
// new vectors to the state and to shared memory, leaves W~1 = W1 / sigma1
// in place of W1, and returns the new sigmas.
template <int NU, int WS>
__device__ __forceinline__ void power_iteration(const Args& g, int D, int DP, float* wt, float* u1s,
                                                float* pv, float* pvn, float* pu, float* pun,
                                                float* w2s, float* pv2, float* scal, float& s1n,
                                                float& s2n) {
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
    if (tid < D) g.v1[tid] = vd;
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
    if (tid < Hd) g.u1[tid] = uj;
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
    if (tid < Hd) g.v2[tid] = vj;
  }
  if (tid == 0) {
    g.u2[0] = u2n;
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
// batch: the rows stream through shared memory RC at a time (header).
template <int NU, class Mark>
__device__ __noinline__ void step_wide(const Args& g, const Mark& mark) {
  constexpr int HP = 32 * NU, WS = HP + 1;
  constexpr int GR = THREADS / HP;  // row groups: the threads of one unit
  constexpr int RPT = RC / GR;      // chunk rows whose pre-activations a thread forms
  constexpr int NK = WIDE_D / GR;   // weight-gradient entries a thread owns, at most
  static_assert(RC == 32 && RC % GR == 0, "warp 0's lanes sum a chunk's rows");
  const int S = g.S, A = g.A, D = S + A, Hd = g.Hd, B = g.B, bce = g.bce, sn = g.sn;
  const int D4 = (D + 3) / 4 * 4;
  const float gp = g.gp, ent = g.ent;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j = tid % HP, grp = tid / HP;  // the thread's unit and row group
  const WideLayout L = wide_layout(D, HP);
  float *wt = gsm + L.wt, *b1s = gsm + L.b1, *w2s = gsm + L.w2, *w2n = gsm + L.w2n;
  float *u1s = gsm + L.u1, *v1s = gsm + L.v1, *pv2 = gsm + L.pv2, *scal = gsm + L.scal;
  float *xs = gsm + L.x, *gq = gsm + L.gq, *zs = gsm + L.z, *ams = gsm + L.am, *qs = gsm + L.q;
  float *dls = gsm + L.rows, *rl = dls + RC, *re = rl + RC, *rp = re + RC;
  const float *e_s = g.e_s, *e_a = g.e_a, *p_s = g.p_s, *p_a = g.p_a;

  // ---- 0. state to shared memory (zero padded); sigma ---------------------
  for (int e = tid; e < D4 * WS; e += THREADS) {
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
  for (int d = tid; d < D4; d += THREADS) v1s[d] = d < D && sn ? g.v1[d] : 0.f;
  if (tid == 0) scal[1] = sn ? g.u2[0] : 0.f;
  __syncthreads();
  float s1 = 1.f, s2 = 1.f;
  if (sn) {
    s1 = sigma1<NU, WS>(wt, u1s, v1s, D, lane);
    s2 = sigma2<NU>(w2s, pv2, scal[1], lane);
    __syncthreads();  // every warp has read the raw W1
    for (int e = tid; e < D4 * WS; e += THREADS) wt[e] = wt[e] / s1;
  }
  float b1j = b1s[j], w2j = w2s[j] / s2;
  if (tid < HP) w2n[tid] = w2s[tid] / s2;
  const float b2 = g.b2[0];
  mark(0);

  // A chunk's rows r0 .. r0 + n - 1 into xs as (RC, D4), zero padded;
  // row(i, d) gives feature d < D of row i.
  auto load = [&](auto row, int r0, int n) {
    __syncthreads();  // the last chunk's rows are read
    for (int e = tid; e < RC * D4; e += THREADS) {
      const int r = e / D4, d = e % D4;
      xs[e] = r < n && d < D ? row(r0 + r, d) : 0.f;
    }
    __syncthreads();
  };
  auto expert = [&](int i, int d) { return d < S ? e_s[(ll)i * S + d] : e_a[(ll)i * A + d - S]; };
  auto policy = [&](int i, int d) { return d < S ? p_s[(ll)i * S + d] : p_a[(ll)i * A + d - S]; };
  // out[r][j] = sum_d in[r][d] W~1[d][j] over the chunk (in: gsm offset,
  // rows of D4; summed in feature order from 0, as pre_activation); with
  // AM also the penalty's a = (z + b1 > 0) * w~2.
  auto forward = [&](int in, int out, auto am) {
    constexpr bool AM = decltype(am)::value;
    float z[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) z[i] = 0.f;
    for (int c = 0; c < D4; c += 4) {
      const float w0 = wt[c * WS + j], w1 = wt[(c + 1) * WS + j];
      const float w2 = wt[(c + 2) * WS + j], w3 = wt[(c + 3) * WS + j];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float4 x = reinterpret_cast<const float4*>(gsm + in + (grp + GR * i) * D4)[c >> 2];
        z[i] = fmaf(x.x, w0, z[i]);
        z[i] = fmaf(x.y, w1, z[i]);
        z[i] = fmaf(x.z, w2, z[i]);
        z[i] = fmaf(x.w, w3, z[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = grp + GR * i;
      gsm[out + r * HP + j] = z[i];
      if constexpr (AM) ams[r * HP + j] = z[i] + b1j > 0.f ? w2j : 0.f;
    }
    __syncthreads();
  };
  // The logit less b2 of chunk row r, the same bits in every lane (logit).
  auto logit_of = [&](int r) {
    float f = 0.f;
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      const int c = lane + 32 * u;
      f = fmaf(fmaxf(zs[r * HP + c] + b1s[c], 0.f), w2n[c], f);
    }
    return warp_sum(f);
  };

  // The thread's weight gradients (unit j, features grp + GR k) and, in
  // row group 0, those of b1_j and w2_j; lane r of warp 0 sums chunk row
  // r's loss terms and b2's gradient.
  float gW[NK], gb1 = 0.f, gw2 = 0.f;
#pragma unroll
  for (int k = 0; k < NK; ++k) gW[k] = 0.f;
  float lacc = 0.f, eacc = 0.f, pacc = 0.f, gb2 = 0.f;

  // ---- 1. loss rows: forward, loss, d loss / d logit, backward ----------
  // BCE's rows are e | p; Mixup's mix e + (1 - mix) p.
  const int R = bce ? 2 * B : B;
  for (int r0 = 0; r0 < R; r0 += RC) {
    const int n = min(RC, R - r0);
    if (bce) {
      load([&](int i, int d) { return i < B ? expert(i, d) : policy(i - B, d); }, r0, n);
    } else {
      load([&](int i, int d) { return mixf(g.mix[i], expert(i, d), policy(i, d)); }, r0, n);
    }
    forward(L.x, L.z, Flag<false>{});
    for (int r = warp; r < n; r += WARPS) {
      const float f = logit_of(r);
      if (lane == 0) {
        const RowLoss o = row_loss(!bce, r0 + r, B, g.e_w, g.p_w, g.mix, f + b2, ent);
        rl[r] = o.loss;
        re[r] = o.ent;
        dls[r] = o.dl;
      }
    }
    __syncthreads();
    for (int r = 0; r < n; ++r) {
      const float h = fmaxf(zs[r * HP + j] + b1j, 0.f), d = dls[r];
      const float dz = h > 0.f ? __fmul_rn(d, w2j) : 0.f;
      gb1 += dz;
      gw2 = fmaf(h, d, gw2);
      const float* x = xs + r * D4;
#pragma unroll
      for (int k = 0; k < NK; ++k)
        if (grp + GR * k < D) gW[k] = fmaf(x[grp + GR * k], dz, gW[k]);
    }
    if (tid < n) {
      lacc += rl[tid];
      eacc += re[tid];
      gb2 += dls[tid];
    }
  }
  mark(1);

  // ---- 2. penalty rows: a = m * w~2, g = W~1 a, q = m * (W~1^T c g) -----
  if (gp > 0.f) {
    const int DG = (D + 31) / 32 * 32;  // a warp's 32 outputs share a row
    for (int r0 = 0; r0 < B; r0 += RC) {
      const int n = min(RC, B - r0);
      load([&](int i, int d) { return mixf(g.eps_gp[i], expert(i, d), policy(i, d)); }, r0, n);
      forward(L.x, L.z, Flag<true>{});
      for (int o = tid; o < RC * DG; o += THREADS) {  // g = a W~1^T, summed in unit order
        const int r = o / DG, d = o % DG;
        if (d < D4) {
          float acc = 0.f;
          if (d < D) {
#pragma unroll 4
            for (int c = 0; c < HP; ++c) acc = fmaf(wt[d * WS + c], ams[r * HP + c], acc);
          }
          gq[r * D4 + d] = acc;
        }
      }
      __syncthreads();
      for (int r = warp; r < n; r += WARPS) {  // |g|^2, then g -> c g
        const int i = r0 + r;
        const float gwi = mixf(g.eps_gp[i], g.e_w[i], g.p_w[i]);
        const float c = __fmul_rn(2.f * gp, gwi) / (float)B;
        float sq = 0.f;
        for (int d = lane; d < D; d += 32) sq = fmaf(gq[r * D4 + d], gq[r * D4 + d], sq);
        sq = warp_sum(sq);
        for (int d = lane; d < D; d += 32) gq[r * D4 + d] = __fmul_rn(c, gq[r * D4 + d]);
        if (lane == 0) rp[r] = __fmul_rn(gwi, sq);
      }
      __syncthreads();
      forward(L.gq, L.q, Flag<false>{});
      for (int r = 0; r < n; ++r) {
        const float a = ams[r * HP + j];
        gw2 += zs[r * HP + j] + b1j > 0.f ? qs[r * HP + j] : 0.f;
        const float* G = gq + r * D4;
#pragma unroll
        for (int k = 0; k < NK; ++k)
          if (grp + GR * k < D) gW[k] = fmaf(G[grp + GR * k], a, gW[k]);
      }
      if (tid < n) pacc += rp[tid];
    }
  }
  mark(2);

  // ---- 3. the sums, through sigma, AdamW ----------------------------------
  float loss = 0.f;  // thread 0's
  if (warp == 0) {
    lacc = warp_sum(lacc);
    eacc = warp_sum(eacc);
    pacc = warp_sum(pacc);
    gb2 = warp_sum(gb2);
    loss = lacc / (float)B;
    if (ent > 0.f) loss = __fsub_rn(loss, __fmul_rn(ent, eacc) / (float)B);
    if (gp > 0.f) loss = __fadd_rn(loss, __fmul_rn(gp, pacc / (float)B));
  }
  const bool col = j < Hd, head = col && grp == 0;  // row group 0 owns b1_j, w2_j
  float dot1 = 0.f, dot2 = 0.f;
#pragma unroll
  for (int k = 0; k < NK; ++k) {
    const int d = grp + GR * k;
    if (col && d < D) dot1 += __fmul_rn(gW[k], g.W1[d * Hd + j]);
  }
  if (head) dot2 = __fmul_rn(gw2, g.W2[j]);
  __syncthreads();  // every thread has read the chunks (and W~1)
  if (sn) block_sum2(dot1, dot2, gsm + L.red);
  // dL/dW = G / sigma - (<G, W> / sigma^2) v u^T, rounded as the plain
  // version's ops
  const float t = g.t[0] + 1.f;
  const float bc1 = 1.f - expf(t * LOG_B1), bc2 = 1.f - expf(t * LOG_B2);
  const float c1 = dot1 / (s1 * s1), c2 = dot2 / (s2 * s2);
#pragma unroll
  for (int k = 0; k < NK; ++k) {
    const int d = grp + GR * k;
    if (col && d < D) {
      const int o = d * Hd + j;
      float gk = gW[k];
      if (sn) gk = __fsub_rn(gk / s1, __fmul_rn(c1, __fmul_rn(v1s[d], u1s[j])));
      wt[d * WS + j] = adamw(g.W1 + o, gk, g.m[0] + o, g.v[0] + o, bc1, bc2, g.lr, g.wd);
    }
  }
  if (head) {
    b1s[j] = adamw(g.b1 + j, gb1, g.m[1] + j, g.v[1] + j, bc1, bc2, g.lr, g.wd);
    float gk = gw2;
    if (sn) gk = __fsub_rn(gk / s2, __fmul_rn(c2, __fmul_rn(pv2[j], scal[1])));
    w2s[j] = adamw(g.W2 + j, gk, g.m[2] + j, g.v[2] + j, bc1, bc2, g.lr, g.wd);
  }
  if (tid == 0) scal[0] = adamw(g.b2, gb2, g.m[3], g.v[3], bc1, bc2, g.lr, g.wd);
  mark(3);
  __syncthreads();  // the new weights are in shared memory

  // ---- 4. power iteration on the updated weights: v first, then u -------
  float s1n = 1.f, s2n = 1.f;
  if (sn)
    power_iteration<NU, WS>(g, D, D4, wt, u1s, gsm + L.pv, gsm + L.pvn, gsm + L.pu, gsm + L.pun,
                            w2s, pv2, scal, s1n, s2n);
  mark(4);

  // ---- 5. reward of the policy rows with the updated network ------------
  b1j = b1s[j];
  w2j = w2s[j] / s2n;
  if (tid < HP) w2n[tid] = w2s[tid] / s2n;
  const float nb2 = scal[0];
  for (int r0 = 0; r0 < B; r0 += RC) {
    const int n = min(RC, B - r0);
    load(policy, r0, n);
    forward(L.x, L.z, Flag<false>{});
    for (int r = warp; r < n; r += WARPS) {
      const float f = logit_of(r);
      if (lane == 0) g.rewards_out[r0 + r] = reward_of(f + nb2, g.reward_fn);
    }
  }
  if (tid == 0) {
    g.loss_out[0] = loss;
    g.t[0] = t;
  }
  mark(5);
}

// One step of the variant `g.wide` names for (D, Hd); a shape smem_bytes
// refuses does nothing (the C entries refuse it before the launch).
template <class Mark>
__device__ inline void step(const Args& g, const Mark& mark) {
  const int dp = padded_features(g.S + g.A), nu = unit_groups(g.Hd);
  if (g.wide) {
    switch (nu) {
      case 1: step_wide<1>(g, mark); break;
      case 2: step_wide<2>(g, mark); break;
      case 4: step_wide<4>(g, mark); break;
      default: break;
    }
    return;
  }
  switch (dp * 8 + nu) {
    case 8 * 8 + 1: step_t<8, 1>(g, mark); break;
    case 8 * 8 + 2: step_t<8, 2>(g, mark); break;
    case 8 * 8 + 4: step_t<8, 4>(g, mark); break;
    case 16 * 8 + 1: step_t<16, 1>(g, mark); break;
    case 16 * 8 + 2: step_t<16, 2>(g, mark); break;
    case 16 * 8 + 4: step_t<16, 4>(g, mark); break;
    case 32 * 8 + 1: step_t<32, 1>(g, mark); break;
    case 32 * 8 + 2: step_t<32, 2>(g, mark); break;
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

}  // namespace gail
