// The arithmetic of one GAIL discriminator step + reward head, shared by
// the per-update kernel (gail_update.cu) and the K-blocked persistent
// kernel (kblock_update.cu), as the TPU's `_gail_core` is shared by
// pallas_gail.py and pallas_fused_block.py.
//
// `gail::step` is run by ONE block of exactly THREADS threads: the order of
// every block-wide sum follows THREADS, so both kernels sum in one order.
// It needs smem_bytes(D, Hd) of dynamic shared memory. Its phases:
//  - the loss rows (expert | policy, or Mixup) and the penalty rows, then
//    each row's forward, loss and d loss / d logit, one thread a row; rows
//    and intermediates live in a global scratch buffer (L1/L2-resident at
//    these sizes), the normalised weights in shared memory, where every
//    thread of a warp reads the same element;
//  - the penalty's parameter gradient derived by hand (see
//    ops/gail_update.py): per interpolated row i, with a_i = m_i * w~2 and
//    g_i = W~1 a_i, dP/dW~1 gets c_i g_i a_i^T and dP/dw~2 gets
//    c_i m_i * (W~1^T g_i), c_i = 2 gp g_w_i / B; the data rows and the
//    penalty rows then reduce into the weight gradients in one pass;
//  - spectral norm: gradients go through sigma = v^T W u with u and v held
//    fixed, then AdamW, then one power iteration (v first, then u) on the
//    updated weights, then the reward of the policy rows with the new
//    parameters and the new u and v.
// Full fp32, deterministic (every sum runs in a fixed order). Nothing is
// read through __ldg or `const __restrict__`.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace gail {

typedef long long ll;

constexpr int THREADS = 512;
constexpr float B1 = 0.9f;
constexpr float B2 = 0.999f;
constexpr float OMB1 = (float)(1.0 - 0.9);
constexpr float OMB2 = (float)(1.0 - 0.999);
constexpr float ADAM_EPS = 1e-8f;
constexpr float LOG_B1 = (float)-0.10536051565782628;   // log(0.9)
constexpr float LOG_B2 = (float)-0.0010005003335835335; // log(0.999)

struct Args {
  float *W1, *b1, *W2, *b2;
  float *u1, *v1, *u2, *v2;
  float *m[4], *v[4];
  float* t;
  const float *e_s, *e_a, *e_w, *p_s, *p_a, *p_w, *eps_gp, *mix;
  float *loss_out, *rewards_out;
  // scratch
  float *X, *cw, *tgt, *Hb, *delta, *Xg, *gw, *G, *Am, *Q, *gW1, *gb1, *gw2, *gb2;
  int B, S, A, Hd, sn, bce, reward_fn;
  float gp, lr, wd, ent;
};

__device__ __forceinline__ float softplusf(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }

// Sum of one value per thread over the block; every thread gets the sum.
__device__ inline float block_sum(float v, float* red) {
  red[threadIdx.x] = v;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  const float out = red[0];
  __syncthreads();
  return out;
}

// Feature d of row i of [s, a].
__device__ __forceinline__ float feature(const float* s, const float* a, int S, int A, int i, int d) {
  return d < S ? s[(ll)i * S + d] : a[(ll)i * A + d - S];
}

__device__ __forceinline__ void adamw(float* p, float g, float* m, float* v, float t, float lr, float wd) {
  const float mm = B1 * *m + OMB1 * g;
  const float vv = B2 * *v + OMB2 * g * g;
  const float mh = mm / (1.f - expf(t * LOG_B1));
  const float vh = vv / (1.f - expf(t * LOG_B2));
  *m = mm;
  *v = vv;
  *p = *p - lr * (mh / (sqrtf(vh) + ADAM_EPS) + wd * *p);
}

// The normalised weights W~1 = W1 / sigma1 and w~2 = W2 / sigma2, and b1,
// into shared memory (sigma = v^T W u, or 1 without spectral norm).
__device__ inline void load_weights(const Args& g, int D, float* Wt1, float* b1s, float* w2t, float* red) {
  const int Hd = g.Hd;
  float s1 = 1.f, s2 = 1.f;
  if (g.sn) {
    float acc = 0.f;
    for (int e = threadIdx.x; e < D * Hd; e += blockDim.x)
      acc += g.v1[e / Hd] * g.W1[e] * g.u1[e % Hd];
    s1 = block_sum(acc, red);
    acc = 0.f;
    for (int j = threadIdx.x; j < Hd; j += blockDim.x) acc += g.v2[j] * g.W2[j] * g.u2[0];
    s2 = block_sum(acc, red);
  }
  for (int e = threadIdx.x; e < D * Hd; e += blockDim.x) Wt1[e] = g.W1[e] / s1;
  for (int j = threadIdx.x; j < Hd; j += blockDim.x) {
    b1s[j] = g.b1[j];
    w2t[j] = g.W2[j] / s2;
  }
  red[THREADS] = s1;
  red[THREADS + 1] = s2;
  __syncthreads();
}

__host__ __device__ inline size_t smem_bytes(int D, int Hd) {
  return sizeof(float) * ((size_t)D * Hd + 3 * Hd + D + THREADS + 2);
}

// One step in place, by one block of THREADS threads; smem holds
// smem_bytes(D, Hd).
__device__ inline void step(const Args& g, float* smem) {
  const int S = g.S, A = g.A, D = S + A, Hd = g.Hd, B = g.B;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int R = g.bce ? 2 * B : B;
  float* Wt1 = smem;
  float* b1s = Wt1 + D * Hd;
  float* w2t = b1s + Hd;
  float* vs = w2t + Hd;
  float* us = vs + D;
  float* red = us + Hd;  // THREADS + 2 floats

  load_weights(g, D, Wt1, b1s, w2t, red);
  const float s1 = red[THREADS], s2 = red[THREADS + 1];
  const float b2 = g.b2[0];

  // ---- rows: the loss rows (expert | policy, or Mixup) and penalty rows --
  for (int r = tid; r < R; r += nt) {
    for (int d = 0; d < D; ++d) {
      float x;
      if (g.bce) {
        x = r < B ? feature(g.e_s, g.e_a, S, A, r, d) : feature(g.p_s, g.p_a, S, A, r - B, d);
      } else {
        const float eps = g.mix[r];
        x = eps * feature(g.e_s, g.e_a, S, A, r, d) + (1.f - eps) * feature(g.p_s, g.p_a, S, A, r, d);
      }
      g.X[(ll)r * D + d] = x;
    }
    if (g.bce) {
      g.cw[r] = r < B ? g.e_w[r] : g.p_w[r - B];
      g.tgt[r] = r < B ? 1.f : 0.f;
    } else {
      const float eps = g.mix[r];
      g.cw[r] = eps * g.e_w[r] + (1.f - eps) * g.p_w[r];
      g.tgt[r] = eps;
    }
  }
  if (g.gp > 0.f) {
    for (int i = tid; i < B; i += nt) {
      const float eps = g.eps_gp[i];
      for (int d = 0; d < D; ++d)
        g.Xg[(ll)i * D + d] =
            eps * feature(g.e_s, g.e_a, S, A, i, d) + (1.f - eps) * feature(g.p_s, g.p_a, S, A, i, d);
      g.gw[i] = eps * g.e_w[i] + (1.f - eps) * g.p_w[i];
    }
  }
  __syncthreads();

  // ---- loss rows: forward, loss, d loss / d logit -------------------------
  float lacc = 0.f, eacc = 0.f;
  for (int r = tid; r < R; r += nt) {
    const float* x = g.X + (ll)r * D;
    float f = 0.f;
    for (int j = 0; j < Hd; ++j) {
      float z = 0.f;
      for (int d = 0; d < D; ++d) z = fmaf(x[d], Wt1[d * Hd + j], z);
      const float h = fmaxf(z + b1s[j], 0.f);
      g.Hb[(ll)r * Hd + j] = h;
      f = fmaf(h, w2t[j], f);
    }
    f += b2;
    const float sg = sigmoidf(f);
    const float w = g.cw[r], t = g.tgt[r];
    lacc += w * (softplusf(-f) + (1.f - t) * f);
    float dl = w * (sg - t) / (float)B;
    if (g.ent > 0.f) {
      eacc += w * (softplusf(f) - f * sg);
      dl += g.ent * w * f * sg * (1.f - sg) / (float)B;
    }
    g.delta[r] = dl;
  }
  float loss = block_sum(lacc, red) / (float)B;
  if (g.ent > 0.f) loss -= g.ent * block_sum(eacc, red) / (float)B;

  // ---- gradient penalty rows: a = m * w~2, g = W~1 a, c (W~1^T g) masked -
  float pacc = 0.f;
  if (g.gp > 0.f) {
    for (int i = tid; i < B; i += nt) {
      const float* x = g.Xg + (ll)i * D;
      float* am = g.Am + (ll)i * Hd;
      float* q = g.Q + (ll)i * Hd;
      float* G = g.G + (ll)i * D;
      for (int j = 0; j < Hd; ++j) {
        float z = 0.f;
        for (int d = 0; d < D; ++d) z = fmaf(x[d], Wt1[d * Hd + j], z);
        const bool on = z + b1s[j] > 0.f;
        am[j] = on ? w2t[j] : 0.f;
        q[j] = on ? 1.f : 0.f;
      }
      const float c = 2.f * g.gp * g.gw[i] / (float)B;
      float sq = 0.f;
      for (int d = 0; d < D; ++d) {
        float gd = 0.f;
        for (int j = 0; j < Hd; ++j) gd = fmaf(Wt1[d * Hd + j], am[j], gd);
        sq = fmaf(gd, gd, sq);
        G[d] = c * gd;
      }
      pacc += g.gw[i] * sq;
      for (int j = 0; j < Hd; ++j) {
        if (q[j] == 0.f) continue;
        float qq = 0.f;
        for (int d = 0; d < D; ++d) qq = fmaf(G[d], Wt1[d * Hd + j], qq);
        q[j] = qq;
      }
    }
    loss += g.gp * (block_sum(pacc, red) / (float)B);
  }
  __syncthreads();

  // ---- gradients w.r.t. W~1, b1, w~2, b2: one reduction over all rows -----
  const int nout = D * Hd + 2 * Hd + 1;
  for (int o = tid; o < nout; o += nt) {
    float acc = 0.f;
    if (o < D * Hd) {
      const int d = o / Hd, j = o % Hd;
      for (int r = 0; r < R; ++r)
        if (g.Hb[(ll)r * Hd + j] > 0.f) acc = fmaf(g.X[(ll)r * D + d], g.delta[r] * w2t[j], acc);
      if (g.gp > 0.f)
        for (int i = 0; i < B; ++i) acc = fmaf(g.G[(ll)i * D + d], g.Am[(ll)i * Hd + j], acc);
      g.gW1[o] = acc;
    } else if (o < D * Hd + Hd) {
      const int j = o - D * Hd;
      for (int r = 0; r < R; ++r)
        if (g.Hb[(ll)r * Hd + j] > 0.f) acc += g.delta[r] * w2t[j];
      g.gb1[j] = acc;
    } else if (o < D * Hd + 2 * Hd) {
      const int j = o - D * Hd - Hd;
      for (int r = 0; r < R; ++r) acc = fmaf(g.Hb[(ll)r * Hd + j], g.delta[r], acc);
      if (g.gp > 0.f)
        for (int i = 0; i < B; ++i) acc += g.Q[(ll)i * Hd + j];
      g.gw2[j] = acc;
    } else {
      for (int r = 0; r < R; ++r) acc += g.delta[r];
      g.gb2[0] = acc;
    }
  }
  __syncthreads();

  // ---- through sigma, then AdamW ----------------------------------------
  float dot1 = 0.f, dot2 = 0.f;
  if (g.sn) {
    float acc = 0.f;
    for (int e = tid; e < D * Hd; e += nt) acc += g.gW1[e] * g.W1[e];
    dot1 = block_sum(acc, red);
    acc = 0.f;
    for (int j = tid; j < Hd; j += nt) acc += g.gw2[j] * g.W2[j];
    dot2 = block_sum(acc, red);
  }
  // dL/dW = G / sigma - (<G, W> / sigma^2) v u^T, with the fma written out:
  // left to the compiler, its contraction differed between this kernel
  // and the K-blocked one
  const float t = g.t[0] + 1.f;
  const float c1 = dot1 / (s1 * s1), c2 = dot2 / (s2 * s2);
  for (int e = tid; e < D * Hd; e += nt) {
    float gr = g.gW1[e];
    if (g.sn) gr = fmaf(-c1, g.v1[e / Hd] * g.u1[e % Hd], gr / s1);
    adamw(&g.W1[e], gr, &g.m[0][e], &g.v[0][e], t, g.lr, g.wd);
  }
  for (int j = tid; j < Hd; j += nt) {
    adamw(&g.b1[j], g.gb1[j], &g.m[1][j], &g.v[1][j], t, g.lr, g.wd);
    float gr = g.gw2[j];
    if (g.sn) gr = fmaf(-c2, g.v2[j] * g.u2[0], gr / s2);
    adamw(&g.W2[j], gr, &g.m[2][j], &g.v[2][j], t, g.lr, g.wd);
  }
  if (tid == 0) adamw(&g.b2[0], g.gb2[0], &g.m[3][0], &g.v[3][0], t, g.lr, g.wd);
  __syncthreads();

  // ---- power iteration on the updated weights: v first, then u ----------
  if (g.sn) {
    for (int d = tid; d < D; d += nt) {
      float acc = 0.f;
      for (int j = 0; j < Hd; ++j) acc = fmaf(g.W1[d * Hd + j], g.u1[j], acc);
      vs[d] = acc;
    }
    __syncthreads();
    float acc = 0.f;
    for (int d = tid; d < D; d += nt) acc += vs[d] * vs[d];
    const float nv = sqrtf(block_sum(acc, red)) + 1e-12f;
    for (int d = tid; d < D; d += nt) vs[d] = vs[d] / nv;
    __syncthreads();
    for (int j = tid; j < Hd; j += nt) {
      float a2 = 0.f;
      for (int d = 0; d < D; ++d) a2 = fmaf(g.W1[d * Hd + j], vs[d], a2);
      us[j] = a2;
    }
    __syncthreads();
    acc = 0.f;
    for (int j = tid; j < Hd; j += nt) acc += us[j] * us[j];
    const float nu = sqrtf(block_sum(acc, red)) + 1e-12f;
    for (int j = tid; j < Hd; j += nt) g.u1[j] = us[j] / nu;
    for (int d = tid; d < D; d += nt) g.v1[d] = vs[d];
    // layer 2: W2 (Hd, 1), u2 (1,)
    const float u2 = g.u2[0];
    acc = 0.f;
    for (int j = tid; j < Hd; j += nt) {
      us[j] = g.W2[j] * u2;
      acc += us[j] * us[j];
    }
    const float nv2 = sqrtf(block_sum(acc, red)) + 1e-12f;
    acc = 0.f;
    for (int j = tid; j < Hd; j += nt) {
      const float vj = us[j] / nv2;
      g.v2[j] = vj;
      acc = fmaf(g.W2[j], vj, acc);
    }
    const float u2n = block_sum(acc, red);
    if (tid == 0) g.u2[0] = u2n / (sqrtf(u2n * u2n) + 1e-12f);
    __syncthreads();
  }

  // ---- reward of the policy rows with the updated network ---------------
  load_weights(g, D, Wt1, b1s, w2t, red);
  const float nb2 = g.b2[0];
  for (int i = tid; i < B; i += nt) {
    float f = 0.f;
    for (int j = 0; j < Hd; ++j) {
      float z = 0.f;
      for (int d = 0; d < D; ++d) z = fmaf(feature(g.p_s, g.p_a, S, A, i, d), Wt1[d * Hd + j], z);
      f = fmaf(fmaxf(z + b1s[j], 0.f), w2t[j], f);
    }
    const float Dx = sigmoidf(f + nb2);
    float r;
    if (g.reward_fn == 0) {  // GAIL
      r = -log1pf(-Dx + 1e-6f);
    } else {  // AIRL, FAIRL
      r = logf(Dx + 1e-6f) - log1pf(-Dx + 1e-6f);
      if (g.reward_fn == 2) r = expf(r) * -r;
    }
    g.rewards_out[i] = r;
  }
  if (tid == 0) {
    g.loss_out[0] = loss;
    g.t[0] = t;
  }
}

struct Scratch {
  float* base;
  ll used = 0;
  float* take(ll n) {
    float* p = base ? base + used : nullptr;
    used += n;
    return p;
  }
};

inline void carve(Scratch& sc, Args& g, int B, int D, int Hd, int bce) {
  const ll R = bce ? 2LL * B : B;
  g.X = sc.take(R * D); g.cw = sc.take(R); g.tgt = sc.take(R);
  g.Hb = sc.take(R * Hd); g.delta = sc.take(R);
  g.Xg = sc.take((ll)B * D); g.gw = sc.take(B); g.G = sc.take((ll)B * D);
  g.Am = sc.take((ll)B * Hd); g.Q = sc.take((ll)B * Hd);
  g.gW1 = sc.take((ll)D * Hd); g.gb1 = sc.take(Hd); g.gw2 = sc.take(Hd); g.gb2 = sc.take(1);
}

inline ll scratch_floats(int B, int D, int Hd, int bce) {
  Scratch sc = {nullptr};
  Args g = {};
  carve(sc, g, B, D, Hd, bce);
  return sc.used;
}

// Pointer order: W1 (D, Hd), b1, W2 (Hd, 1), b2, u1, v1, u2, v2 (null
// without spectral norm), AdamW m (4), v (4), the step clock (1,), e_s, e_a,
// e_w, p_s, p_a, p_w, eps_gp, mix (null for BCE), out loss (1), out rewards
// (B). The scratch pointers are left for `carve`.
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
