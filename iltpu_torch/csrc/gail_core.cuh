// The arithmetic of one GAIL discriminator step + reward head, shared by
// the per-update kernel (gail_update.cu), the K-blocked persistent kernel
// (kblock_update.cu) and the phase timer (gail_phases.cu), as the TPU's
// `_gail_core` is shared by pallas_gail.py and pallas_fused_block.py.
//
// `gail::step` is run by ONE block of exactly THREADS threads (16 warps).
// Every sum runs in an order that follows the block alone, so every kernel
// that runs it gets the same bits. Its working set lives in dynamic shared
// memory (smem_bytes(B, D, Hd); `layout` below), not in global scratch:
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
// Phases, with barriers only between them: 0 state and batch to shared
// memory, sigma; 1 loss rows; 2 penalty rows; 3 the weight gradients (the
// warps' partials in warp order), through sigma, AdamW; 4 one power
// iteration (v first, then u) on the updated weights; 5 the reward of the
// policy rows with the new parameters. The penalty's parameter gradient is
// derived by hand (ops/gail_update.py): per interpolated row i, with
// a_i = m_i * w~2 and g_i = W~1 a_i, dP/dW~1 gets c_i g_i a_i^T and dP/dw~2
// gets c_i m_i * (W~1^T g_i), c_i = 2 gp g_w_i / B; gradients then go
// through sigma = v^T W u with u and v held fixed.
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
  float gp, lr, wd, ent;
};

// The step's variants: features padded to DP, units to 32 NU.
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

// Dynamic shared memory of a step; 0 where no variant takes (D, Hd). A
// launch also needs it <= SMEM_LIMIT.
__host__ __device__ inline size_t smem_bytes(int B, int D, int Hd) {
  const int dp = padded_features(D), nu = unit_groups(Hd);
  if (B < 1 || !dp || !nu || dp * nu > 64) return 0;
  return sizeof(float) * (size_t)layout(B, dp, 32 * nu).total;
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

// sigma1 = v^T W1 u over the (D, HP) weights in shared memory; each warp
// computes it alike.
template <int NU>
__device__ __forceinline__ float sigma1(const float* wt, const float* u, const float* v, int D, int lane) {
  float acc = 0.f;
  for (int d = 0; d < D; ++d)
#pragma unroll
    for (int k = 0; k < NU; ++k) {
      const int j = lane + 32 * k;
      acc = fmaf(__fmul_rn(v[d], wt[d * 32 * NU + j]), u[j], acc);
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
        const int r = r0 + lane;
        float w, tg;
        if (MIXED) {
          w = mixf(mix[r], ew[r], pw[r]);
          tg = mix[r];
        } else {
          w = r < B ? ew[r] : pw[r - B];
          tg = r < B ? 1.f : 0.f;
        }
        f += b2;
        const float sg = sigmoidf(f);
        lacc += __fmul_rn(w, __fadd_rn(softplusf(-f), __fmul_rn(1.f - tg, f)));
        dl = __fmul_rn(w, sg - tg) / (float)B;
        if (ent > 0.f) {
          eacc += __fmul_rn(w, __fsub_rn(softplusf(f), __fmul_rn(f, sg)));
          dl = __fadd_rn(dl, ent * w * f * sg * (1.f - sg) / (float)B);
        }
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
  if (sn) {
    for (int d = warp; d < D; d += WARPS) {
      float a = 0.f;
#pragma unroll
      for (int u = 0; u < NU; ++u) a = fmaf(wt[d * HP + lane + 32 * u], u1s[lane + 32 * u], a);
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
      for (int d = 0; d < D; ++d) a = fmaf(wt[d * HP + tid], pv[d] / nv, a);
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
    s1n = sigma1<NU>(wt, pun, pvn, D, lane);
    s2n = sigma2<NU>(w2s, pv2, u2n, lane);
    __syncthreads();  // every warp has read the raw W1
    for (int e = tid; e < DP * HP; e += THREADS) wt[e] = wt[e] / s1n;
    __syncthreads();
  }
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
      if (lane < n) {
        const float Dx = sigmoidf(f + nb2);
        float r;
        if (g.reward_fn == 0) {  // GAIL
          r = -log1pf(-Dx + 1e-6f);
        } else {  // AIRL, FAIRL
          r = logf(Dx + 1e-6f) - log1pf(-Dx + 1e-6f);
          if (g.reward_fn == 2) r = expf(r) * -r;
        }
        g.rewards_out[r0 + lane] = r;
      }
    }
  }
  if (tid == 0) {
    g.loss_out[0] = loss;
    g.t[0] = t;
  }
  mark(5);
}

// One step of the variant that takes (D, Hd); a shape smem_bytes refuses
// does nothing (the C entries refuse it before the launch).
template <class Mark>
__device__ inline void step(const Args& g, const Mark& mark) {
  const int dp = padded_features(g.S + g.A), nu = unit_groups(g.Hd);
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

// Whether a launch can take the shape: a variant and the shared memory.
inline bool fits(int B, int D, int Hd) {
  const size_t bytes = smem_bytes(B, D, Hd);
  return bytes > 0 && bytes <= SMEM_LIMIT;
}

// Pointer order: W1 (D, Hd), b1, W2 (Hd, 1), b2, u1, v1, u2, v2 (null
// without spectral norm), AdamW m (4), v (4), the step clock (1,), e_s, e_a,
// e_w, p_s, p_a, p_w, eps_gp, mix (null for BCE), out loss (1), out rewards
// (B).
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
  g.gp = gp; g.lr = lr; g.wd = wd; g.ent = ent;
  return g;
}

}  // namespace gail
