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
//
// The state is updated in place. Pointer order of `iltpu_sac_update`:
//   actor W1 b1 W2 b2 W3 b3, its AdamW m (6), v (6),
//   critic W1 b1 W2 b2 W3 b3 ((2, ...)-stacked), its m (6), v (6),
//   target critic (6), log_alpha, its Adam m, v, actor/critic/alpha clocks,
//   s, a, r, s2, terminal, weight, absorbing, eps2, eps_new,
//   out log_probs (B), out min Q (B), out alpha (1).

#include <cuda_runtime.h>
#include <math.h>

namespace {

typedef long long ll;

constexpr int TILE = 32;
constexpr int KT = 16;
constexpr int GEMM_THREADS = 256;
constexpr int EW_THREADS = 256;

constexpr float B1 = 0.9f;
constexpr float B2 = 0.999f;
constexpr float OMB1 = (float)(1.0 - 0.9);
constexpr float OMB2 = (float)(1.0 - 0.999);
constexpr float ADAM_EPS = 1e-8f;
constexpr float LOG_B1 = (float)-0.10536051565782628;   // log(0.9)
constexpr float LOG_B2 = (float)-0.0010005003335835335; // log(0.999)
constexpr float LOG2 = (float)0.6931471805599453;
constexpr float LOG2PI = (float)1.8378770664093453;

struct Gemm {
  // C[z](m, n) = sum_k A[z](m, k) B[z](k, n) (+ bias[z](n)) (relu) (* mask>0)
  const float* a; ll a_z, a_m, a_k;
  const float* b; ll b_z, b_k, b_n;
  float* c; ll c_z, c_m, c_n;
  const float* bias; ll bias_z;
  const float* mask; ll mask_z, mask_m, mask_n;
  int m, n, k, relu;
};

__global__ void __launch_bounds__(GEMM_THREADS) gemm_kernel(Gemm g) {
  __shared__ float as[KT][TILE + 1];
  __shared__ float bs[KT][TILE + 1];
  const int z = blockIdx.z;
  const int m0 = blockIdx.y * TILE;
  const int n0 = blockIdx.x * TILE;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const float* A = g.a + z * g.a_z;
  const float* Bm = g.b + z * g.b_z;
  float acc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  for (int k0 = 0; k0 < g.k; k0 += KT) {
    for (int e = threadIdx.x; e < KT * TILE; e += GEMM_THREADS) {
      const int kk = e / TILE;
      const int r = e % TILE;
      const int gk = k0 + kk;
      const int gm = m0 + r;
      const int gn = n0 + r;
      as[kk][r] = (gm < g.m && gk < g.k) ? A[gm * g.a_m + gk * g.a_k] : 0.f;
      bs[kk][r] = (gn < g.n && gk < g.k) ? Bm[gk * g.b_k + gn * g.b_n] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      const float a0 = as[kk][2 * ty], a1 = as[kk][2 * ty + 1];
      const float b0 = bs[kk][2 * tx], b1 = bs[kk][2 * tx + 1];
      acc[0][0] = fmaf(a0, b0, acc[0][0]);
      acc[0][1] = fmaf(a0, b1, acc[0][1]);
      acc[1][0] = fmaf(a1, b0, acc[1][0]);
      acc[1][1] = fmaf(a1, b1, acc[1][1]);
    }
    __syncthreads();
  }
  for (int i = 0; i < 2; ++i) {
    for (int j = 0; j < 2; ++j) {
      const int gm = m0 + 2 * ty + i;
      const int gn = n0 + 2 * tx + j;
      if (gm >= g.m || gn >= g.n) continue;
      float v = acc[i][j];
      if (g.bias) v += g.bias[z * g.bias_z + gn];
      if (g.relu) v = fmaxf(v, 0.f);
      if (g.mask && !(g.mask[z * g.mask_z + gm * g.mask_m + gn * g.mask_n] > 0.f)) v = 0.f;
      g.c[z * g.c_z + gm * g.c_m + gn * g.c_n] = v;
    }
  }
}

__device__ __forceinline__ float softplusf(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float alpha_of(const float* la, float min_alpha) {
  const float a = expf(la[0]);
  return min_alpha > 0.f ? fmaxf(a, min_alpha) : a;
}

// Tanh-Gaussian log-prob of z = mu + exp(ls) eps, summed over the actions.
__device__ float head_log_prob(const float* o, const float* eps, int A) {
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
// rows x = [s, keep * tanh(z)] with keep = 1 - absorbing (or 1).
__global__ void head_sample_kernel(const float* o, const float* eps, const float* s,
                                   const float* ab, int B, int S, int A,
                                   float* lp, float* x) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
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

// TD target from the target twin's q (2, B); also the critic input [s, a].
__global__ void td_kernel(const float* tq, const float* r, const float* term,
                          const float* ab, const float* lp2, const float* la,
                          float min_alpha, float discount, const float* s,
                          const float* a, int B, int S, int A, float* td, float* x) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const float alpha = alpha_of(la, min_alpha);
  const float target_v = fminf(tq[b], tq[B + b]) - (1.f - ab[b]) * alpha * lp2[b];
  td[b] = r[b] + (1.f - term[b]) * discount * target_v;
  const int X = S + A;
  for (int d = 0; d < S; ++d) x[(ll)b * X + d] = s[(ll)b * S + d];
  for (int j = 0; j < A; ++j) x[(ll)b * X + S + j] = a[(ll)b * A + j];
}

// d(critic loss)/dq for both twins, and min Q for the aux output.
__global__ void critic_dq_kernel(const float* q, const float* td, const float* w,
                                 int B, float* dq, float* min_q) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const float c = 2.f / (float)B;
  dq[b] = c * w[b] * (q[b] - td[b]);
  dq[B + b] = c * w[b] * (q[B + b] - td[b]);
  min_q[b] = fminf(q[b], q[B + b]);
}

// d(-mean min(q1, q2))/dq against the updated critic; ties pick twin 1.
__global__ void select_dq_kernel(const float* q, int B, float* dq) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const float sel1 = q[b] <= q[B + b] ? 1.f : 0.f;
  const float c = -1.f / (float)B;
  dq[b] = c * sel1;
  dq[B + b] = c * (1.f - sel1);
}

// Hand-derived tanh-Gaussian backward: the gradient of the actor loss at
// the head output, do (B, 2A), from the critic's action gradient da (2, B, A).
__global__ void head_backward_kernel(const float* o, const float* eps, const float* da,
                                     const float* w, const float* ab, const float* la,
                                     float min_alpha, int B, int A, float* dout) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
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

// out[z](n) = sum over rows of x[z](rows, n), in row order.
__global__ void colsum_kernel(const float* x, ll x_z, int rows, int cols, float* out, ll out_z) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  const int z = blockIdx.y;
  if (n >= cols) return;
  const float* xz = x + z * x_z;
  float acc = 0.f;
  for (int r = 0; r < rows; ++r) acc += xz[(ll)r * cols + n];
  out[z * out_z + n] = acc;
}

constexpr int MAX_TENSORS = 6;

struct AdamArgs {
  float* p[MAX_TENSORS];
  const float* g[MAX_TENSORS];
  float* m[MAX_TENSORS];
  float* v[MAX_TENSORS];
  float* target[MAX_TENSORS];  // Polyak target, or null
  ll end[MAX_TENSORS];         // running element counts
  int n;
};

// AdamW over several tensors in one pass (and Polyak when targets are
// given); the step clock is read here and advanced by temperature_kernel.
__global__ void adam_kernel(AdamArgs args, const float* count, float lr, float wd, float polyak) {
  const ll e = (ll)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= args.end[args.n - 1]) return;
  int i = 0;
  while (e >= args.end[i]) ++i;
  const ll j = e - (i ? args.end[i - 1] : 0);
  const float t = count[0] + 1.f;
  const float g = args.g[i][j];
  const float m = B1 * args.m[i][j] + OMB1 * g;
  const float v = B2 * args.v[i][j] + OMB2 * g * g;
  const float mh = m / (1.f - expf(t * LOG_B1));
  const float vh = v / (1.f - expf(t * LOG_B2));
  const float p = args.p[i][j];
  const float np = p - lr * (mh / (sqrtf(vh) + ADAM_EPS) + wd * p);
  args.m[i][j] = m;
  args.v[i][j] = v;
  args.p[i][j] = np;
  if (args.target[i]) args.target[i][j] = polyak * args.target[i][j] + (1.f - polyak) * np;
}

// Temperature: plain Adam on log_alpha with the RAW alpha in its gradient;
// the floored pre-update alpha for the aux; then all three clocks advance.
__global__ void temperature_kernel(const float* lp, const float* w, const float* ab, int B,
                                   float entropy_target, float alpha_lr, float min_alpha,
                                   float* la, float* lam, float* lav, float* ta, float* tc,
                                   float* tal, float* alpha_out) {
  __shared__ float red[EW_THREADS];
  float acc = 0.f;
  for (int b = threadIdx.x; b < B; b += blockDim.x) acc += w[b] * (1.f - ab[b]) * (lp[b] + entropy_target);
  red[threadIdx.x] = acc;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
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

// ----------------------------------------------------------------- host

struct Launcher {
  cudaStream_t stream;
  cudaError_t err = cudaSuccess;

  void check() {
    const cudaError_t e = cudaGetLastError();
    if (err == cudaSuccess && e != cudaSuccess) err = e;
  }

  void gemm(const Gemm& g, int Z) {
    dim3 grid((g.n + TILE - 1) / TILE, (g.m + TILE - 1) / TILE, Z);
    gemm_kernel<<<grid, GEMM_THREADS, 0, stream>>>(g);
    check();
  }

  // out[z] (M, N) = x[z] (M, K) @ W[z] (K, N) + b[z] (relu); row-major.
  void linear(int Z, const float* x, ll x_z, const float* W, const float* b,
              float* out, int M, int K, int N, bool relu) {
    Gemm g = {};
    g.a = x; g.a_z = x_z; g.a_m = K; g.a_k = 1;
    g.b = W; g.b_z = (ll)K * N; g.b_k = N; g.b_n = 1;
    g.c = out; g.c_z = (ll)M * N; g.c_m = N; g.c_n = 1;
    g.bias = b; g.bias_z = N;
    g.m = M; g.n = N; g.k = K; g.relu = relu;
    gemm(g, Z);
  }

  // gW[z] (K, N) = h[z]^T (K, M) @ dz[z] (M, N)
  void weight_grad(int Z, const float* h, ll h_z, const float* dz, float* gW, int M, int K, int N) {
    Gemm g = {};
    g.a = h; g.a_z = h_z; g.a_m = 1; g.a_k = K;
    g.b = dz; g.b_z = (ll)M * N; g.b_k = N; g.b_n = 1;
    g.c = gW; g.c_z = (ll)K * N; g.c_m = N; g.c_n = 1;
    g.m = K; g.n = N; g.k = M;
    gemm(g, Z);
  }

  // out[z] (M, Kin) = (dz[z] (M, N) @ W[z]^T) * (mask[z] > 0), W[z] (Kin, N)
  // row-major with twin stride w_z; `out` has row stride out_m.
  void input_grad(int Z, const float* dz, const float* W, ll w_z, const float* mask,
                  float* out, ll out_m, int M, int Kin, int N) {
    Gemm g = {};
    g.a = dz; g.a_z = (ll)M * N; g.a_m = N; g.a_k = 1;
    g.b = W; g.b_z = w_z; g.b_k = 1; g.b_n = N;
    g.c = out; g.c_z = (ll)M * out_m; g.c_m = out_m; g.c_n = 1;
    g.mask = mask; g.mask_z = (ll)M * Kin; g.mask_m = Kin; g.mask_n = 1;
    g.m = M; g.n = Kin; g.k = N;
    gemm(g, Z);
  }

  void colsum(int Z, const float* x, int rows, int cols, float* out) {
    dim3 grid((cols + EW_THREADS - 1) / EW_THREADS, Z);
    colsum_kernel<<<grid, EW_THREADS, 0, stream>>>(x, (ll)rows * cols, rows, cols, out, cols);
    check();
  }

  void adam(AdamArgs args, const float* count, float lr, float wd, float polyak) {
    const ll n = args.end[args.n - 1];
    adam_kernel<<<(unsigned)((n + EW_THREADS - 1) / EW_THREADS), EW_THREADS, 0, stream>>>(
        args, count, lr, wd, polyak);
    check();
  }

  unsigned rows_grid(int B) const { return (unsigned)((B + EW_THREADS - 1) / EW_THREADS); }
};

struct Scratch {
  float* base;
  ll used = 0;
  float* take(ll n) {
    float* p = base ? base + used : nullptr;
    used += n;
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

Buffers carve(Scratch& sc, int B, int S, int A, int H) {
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

AdamArgs adam_args(float* const* p, float* const* g, float* const* m, float* const* v,
                   float* const* target, const ll* sizes) {
  AdamArgs a = {};
  a.n = 6;
  ll total = 0;
  for (int i = 0; i < 6; ++i) {
    a.p[i] = p[i]; a.g[i] = g[i]; a.m[i] = m[i]; a.v[i] = v[i];
    a.target[i] = target ? target[i] : nullptr;
    total += sizes[i];
    a.end[i] = total;
  }
  return a;
}

}  // namespace

extern "C" long long iltpu_sac_scratch_floats(int B, int S, int A, int H) {
  Scratch sc = {nullptr};
  carve(sc, B, S, A, H);
  return sc.used;
}

extern "C" int iltpu_sac_update(void* const* ptr, int B, int S, int A, int H, float lr,
                                float wd, float alpha_lr, float discount,
                                float entropy_target, float polyak, float min_alpha,
                                void* scratch, void* stream) {
  float* const* P = reinterpret_cast<float* const*>(ptr);
  float* const* aw = P;       // actor W1 b1 W2 b2 W3 b3
  float* const* am = P + 6;
  float* const* av = P + 12;
  float* const* cw = P + 18;  // critic, (2, ...)-stacked
  float* const* cm = P + 24;
  float* const* cv = P + 30;
  float* const* tw = P + 36;  // target critic
  float* la = P[42];
  float* lam = P[43];
  float* lav = P[44];
  float* ta = P[45];
  float* tc = P[46];
  float* tal = P[47];
  const float* s = P[48];
  const float* a = P[49];
  const float* r = P[50];
  const float* s2 = P[51];
  const float* term = P[52];
  const float* w = P[53];
  const float* ab = P[54];
  const float* eps2 = P[55];
  const float* eps_new = P[56];
  float* lp_out = P[57];
  float* minq_out = P[58];
  float* alpha_out = P[59];

  Scratch sc = {reinterpret_cast<float*>(scratch)};
  const Buffers f = carve(sc, B, S, A, H);
  const int X = S + A, O = 2 * A;
  const ll BH = (ll)B * H;
  Launcher L{reinterpret_cast<cudaStream_t>(stream)};
  const unsigned rg = L.rows_grid(B);

  // ---- TD target: actor on s', target twin on [s', a'] --------------------
  L.linear(1, s2, 0, aw[0], aw[1], f.ah1, B, S, H, true);
  L.linear(1, f.ah1, 0, aw[2], aw[3], f.ah2, B, H, H, true);
  L.linear(1, f.ah2, 0, aw[4], aw[5], f.ao, B, H, O, false);
  head_sample_kernel<<<rg, EW_THREADS, 0, L.stream>>>(f.ao, eps2, s2, ab, B, S, A, f.lp2, f.x2);
  L.check();
  L.linear(2, f.x2, 0, tw[0], tw[1], f.th1, B, X, H, true);
  L.linear(2, f.th1, BH, tw[2], tw[3], f.th2, B, H, H, true);
  L.linear(2, f.th2, BH, tw[4], tw[5], f.tq, B, H, 1, false);
  td_kernel<<<rg, EW_THREADS, 0, L.stream>>>(f.tq, r, term, ab, f.lp2, la, min_alpha, discount,
                                             s, a, B, S, A, f.td, f.x);
  L.check();

  // ---- critic forward, backward, AdamW + Polyak ------------------------
  L.linear(2, f.x, 0, cw[0], cw[1], f.ch1, B, X, H, true);
  L.linear(2, f.ch1, BH, cw[2], cw[3], f.ch2, B, H, H, true);
  L.linear(2, f.ch2, BH, cw[4], cw[5], f.cq, B, H, 1, false);
  critic_dq_kernel<<<rg, EW_THREADS, 0, L.stream>>>(f.cq, f.td, w, B, f.dq, minq_out);
  L.check();
  L.weight_grad(2, f.ch2, BH, f.dq, f.gc[4], B, H, 1);
  L.colsum(2, f.dq, B, 1, f.gc[5]);
  L.input_grad(2, f.dq, cw[4], H, f.ch2, f.dz2, H, B, H, 1);
  L.weight_grad(2, f.ch1, BH, f.dz2, f.gc[2], B, H, H);
  L.colsum(2, f.dz2, B, H, f.gc[3]);
  L.input_grad(2, f.dz2, cw[2], (ll)H * H, f.ch1, f.dz1, H, B, H, H);
  L.weight_grad(2, f.x, 0, f.dz1, f.gc[0], B, X, H);
  L.colsum(2, f.dz1, B, H, f.gc[1]);
  const ll csz[6] = {2LL * X * H, 2LL * H, 2LL * H * H, 2LL * H, 2LL * H, 2};
  L.adam(adam_args(cw, f.gc, cm, cv, tw, csz), tc, lr, wd, polyak);

  // ---- actor on s, the UPDATED critic's action gradient -----------------
  L.linear(1, s, 0, aw[0], aw[1], f.bh1, B, S, H, true);
  L.linear(1, f.bh1, 0, aw[2], aw[3], f.bh2, B, H, H, true);
  L.linear(1, f.bh2, 0, aw[4], aw[5], f.bo, B, H, O, false);
  head_sample_kernel<<<rg, EW_THREADS, 0, L.stream>>>(f.bo, eps_new, s, nullptr, B, S, A,
                                                      lp_out, f.xn);
  L.check();
  L.linear(2, f.xn, 0, cw[0], cw[1], f.th1, B, X, H, true);
  L.linear(2, f.th1, BH, cw[2], cw[3], f.th2, B, H, H, true);
  L.linear(2, f.th2, BH, cw[4], cw[5], f.tq, B, H, 1, false);
  select_dq_kernel<<<rg, EW_THREADS, 0, L.stream>>>(f.tq, B, f.dq);
  L.check();
  L.input_grad(2, f.dq, cw[4], H, f.th2, f.dz2, H, B, H, 1);
  L.input_grad(2, f.dz2, cw[2], (ll)H * H, f.th1, f.dz1, H, B, H, H);
  // only the action columns of dx: dz1 @ W1[S:, :]^T, no mask
  L.input_grad(2, f.dz1, cw[0] + (ll)S * H, (ll)X * H, nullptr, f.da, A, B, A, H);

  // ---- actor backward + AdamW ------------------------------------------
  head_backward_kernel<<<rg, EW_THREADS, 0, L.stream>>>(f.bo, eps_new, f.da, w, ab, la, min_alpha,
                                                        B, A, f.dout);
  L.check();
  L.weight_grad(1, f.bh2, 0, f.dout, f.ga[4], B, H, O);
  L.colsum(1, f.dout, B, O, f.ga[5]);
  L.input_grad(1, f.dout, aw[4], 0, f.bh2, f.adz2, H, B, H, O);
  L.weight_grad(1, f.bh1, 0, f.adz2, f.ga[2], B, H, H);
  L.colsum(1, f.adz2, B, H, f.ga[3]);
  L.input_grad(1, f.adz2, aw[2], 0, f.bh1, f.adz1, H, B, H, H);
  L.weight_grad(1, s, 0, f.adz1, f.ga[0], B, S, H);
  L.colsum(1, f.adz1, B, H, f.ga[1]);
  const ll asz[6] = {(ll)S * H, H, (ll)H * H, H, (ll)H * O, O};
  L.adam(adam_args(aw, f.ga, am, av, nullptr, asz), ta, lr, wd, 0.f);

  // ---- temperature, clocks, aux alpha ------------------------------------
  temperature_kernel<<<1, EW_THREADS, 0, L.stream>>>(lp_out, w, ab, B, entropy_target, alpha_lr,
                                                     min_alpha, la, lam, lav, ta, tc, tal,
                                                     alpha_out);
  L.check();
  return (int)L.err;
}
