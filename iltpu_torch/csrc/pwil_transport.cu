// PWIL's greedy transport for Hopper (sm_90a): the reward of each agent
// atom against a pool of expert atoms that it consumes.
//
// Replaces: the `lax.while_loop` of iltpu/rewards/pwil.py:107
// (PWILDiscriminator.compute_reward), vmapped over the envs by the
// trainer's PWIL step (iltpu/trainer.py:495-510), and the `lax.scan` of the
// expert relabelling (iltpu/trainer.py:512-533). It is no Pallas kernel:
// iltpu runs the loop as XLA's while loop.
//
// Inputs: the normalised expert atoms, feature-major (d, N); the pools
// (P, N), remaining mass per atom, updated in place; the normalised agent
// atoms (R, d); the segment offsets (P + 1): pool p takes rows off[p] ..
// off[p+1]-1 in order; a reset flag per row: after a flagged row its pool
// is refilled with the atom weight. Output: the rewards (R). The env step is
// P = R = the envs, one row each, reset = done; the relabelling is one
// segment per expert trajectory, so one launch gives what iltpu's
// sequential scan gives.
//
// For each row, as iltpu: while the agent's weight is > 0 and an atom has
// mass left, the nearest atom with mass left (ties to the lower index),
// consume = min(weight, mass), cost += consume * distance, mass -= consume,
// weight -= consume; reward = scale * exp(-bandwidth * cost).
//
// The fact the design rests on: while weight >= mass the atom is spent
// exactly (mass - mass == 0), and the only atom left partly consumed is
// the last, after which the weight is 0. So a row's rounds take, in order,
// the first k entries of the row's (distance, index) list over the atoms
// with mass left, sorted ascending. This kernel finds them in ONE pass over
// the atoms and walks them with iltpu's arithmetic: the same floating-point
// operations in the same order, so the pools stay bit-equal to the plain
// version and to iltpu. Each product that meets an add is rounded on its
// own (__fmul_rn, __fadd_rn), as the plain version's separate torch ops are.
//
// The design:
//  - key = (float bits of the distance << 32) | index, a uint64: distances
//    are >= 0, so one integer compare orders (distance, index) with ties to
//    the lower index;
//  - a selection pass: every lane computes its atoms' distances on the fly
//    (the atoms feature-major, so a warp's loads coalesce), masked by mass
//    > 0; keys under the warp's K-th smallest so far go to a per-warp
//    buffer in shared memory; each time 32 have gathered they are sorted
//    (bitonic, by shuffle) and merged into the warp's sorted list of K = 32
//    (one key a lane); then the warps' lists merge in a tree in shared
//    memory, each merge the K smallest of two sorted lists;
//  - before a warp's first merge, the largest of its 32 lanes' least keys
//    (32 distinct keys) bounds the K-th smallest, and the least of the
//    warps' bounds and K-th keys filters every warp's keys, so few merges
//    follow the first;
//  - one thread walks the K candidates; if the weight outlasts them (many
//    tiny partial masses) another pass selects the K smallest keys above
//    the last one taken, and so on: never capped, never approximate;
//  - fewer pools than SMs (the relabelling's 25 segments): a pool's atoms
//    are split across a thread-block cluster of C CTAs, the largest C (at
//    most 8 and SMs / P) for which the card holds all P clusters at once
//    (clusters stay within a GPC: 24 clusters of 5 fit an H100, 32 of 4,
//    so 25 segments take 4). Each CTA selects its slice's K smallest, the lists are read
//    by every CTA of the cluster through distributed shared memory (double
//    buffered by pass, so ONE cluster barrier, release/acquire, per pass)
//    and merged; every CTA then walks the same list (the same arithmetic on
//    the same data) and writes back only the masses of its own slice, so
//    no CTA reads another's pool entries and rows stay strictly sequential;
//    a reset row refills each CTA's own slice;
//  - no per-pool distance buffer: distances are computed, used and dropped.
//
// What bounds it on an H100: each row reads every atom once (N * d floats)
// and its pool (N floats), ~N * (3d + 1) operations; at PWIL@25's hopper
// size (25,000 atoms of d 15) the atoms are 1.5 MB, in L2 after the first
// touch. With one CTA a pool on every SM (512 envs) the passes read L2 at
// ~4.3 TB/s in all, and L2 bandwidth sets the time. The relabelling's
// clusters read ~24 GB/s a CTA: there a row is a chain of dependent steps
// (the pass's loads and arithmetic, the merges, the barriers, the cluster
// exchange, the walk), and latency sets its time (`python -m
// iltpu_torch.profile_phases pwil` times each phase). Rows of one pool are
// sequential by definition.
//
// The launch's configuration (the SM count, whether a cluster size can be
// scheduled) is queried once per process and cached, so a launch makes no
// call that a CUDA graph capture refuses; a cluster that cannot be
// scheduled is an error, never a quiet fallback.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

typedef long long ll;
typedef unsigned long long u64;

constexpr int MAX_D = 128;      // features an atom (ant's: 120); s_q holds a query row
constexpr int K = 32;           // candidates a selection pass yields: one a lane
constexpr int U = 4;            // atoms a lane takes per step of a pass
constexpr int MAX_CLUSTER = 8;  // the portable cluster size
constexpr int MIN_SLICE = 2048; // atoms a CTA of a cluster takes at least
constexpr u64 NONE = ~0ull;     // no candidate: above every key
constexpr unsigned FULL = 0xffffffffu;
constexpr int ERR_CLUSTER = -1000;  // no cluster can be scheduled (-e: CUDA error e)

struct PArgs {
  const float* atoms;          // (d, N), feature-major
  float* pools;                // (P, N)
  const float* queries;        // (R, d)
  const int* offsets;          // (P + 1)
  const unsigned char* reset;  // (R)
  float* rewards;              // (R)
  int P, N, d, R;
  int C;      // CTAs a pool (the cluster size)
  int slice;  // atoms a CTA of a cluster takes
  float atom_weight, agent_weight, neg_bandwidth, scale;
#ifdef PWIL_STAMPS
  long long* stamps;  // (grid, NSTAMP) SM cycles per phase, summed over rows
#endif
};

#ifdef PWIL_STAMPS
// Thread 0 adds the cycles since its last stamp to the phase's sum.
constexpr int NSTAMP = 8;  // phases 0-5, then passes and rows
#define STAMP(k)                                                   \
  if (tid == 0) {                                                  \
    const long long t_ = clock64();                                \
    a.stamps[(ll)blockIdx.x * NSTAMP + (k)] += t_ - stamp_at;      \
    stamp_at = t_;                                                 \
  }
#else
#define STAMP(k)
#endif

// Keep the smaller (keep_min) or the larger of this lane's key and its
// partner's, with the mass beside it.
__device__ __forceinline__ void cx(u64& k, float& m, int mask, bool keep_min) {
  const u64 pk = __shfl_xor_sync(FULL, k, mask);
  const float pm = __shfl_xor_sync(FULL, m, mask);
  if (keep_min ? pk < k : pk > k) {
    k = pk;
    m = pm;
  }
}

// Sort the warp's 32 keys ascending, lane i the i-th (bitonic).
__device__ __forceinline__ void sort32(u64& k, float& m, int lane) {
#pragma unroll
  for (int s = 2; s <= 32; s <<= 1) {
#pragma unroll
    for (int j = s >> 1; j > 0; j >>= 1) cx(k, m, j, ((lane & s) == 0) == ((lane & j) == 0));
  }
}

// The 32 smallest of two ascending lists, ascending: (k, m) is this lane's
// entry of one, (rk, rm) the other's entry at 31 - lane. The elementwise
// minimum is a bitonic sequence holding the 32 smallest; one bitonic merge
// sorts it.
__device__ __forceinline__ void merge_rev(u64& k, float& m, u64 rk, float rm, int lane) {
  if (rk < k) {
    k = rk;
    m = rm;
  }
#pragma unroll
  for (int j = 16; j > 0; j >>= 1) cx(k, m, j, (lane & j) == 0);
}

// Merge lists 0 .. n-1 (n a power of two) of s_key/s_mass into list 0, the
// K smallest ascending; a level a barrier.
__device__ __forceinline__ void tree_merge(u64 (*s_key)[2 * K], float (*s_mass)[2 * K], int n,
                                           int warp, int lane) {
  for (int h = n >> 1; h > 0; h >>= 1) {
    if (warp < h) {
      u64 k = s_key[warp][lane];
      float m = s_mass[warp][lane];
      merge_rev(k, m, s_key[warp + h][31 - lane], s_mass[warp + h][31 - lane], lane);
      s_key[warp][lane] = k;
      s_mass[warp][lane] = m;
    }
    __syncthreads();
  }
}

// T threads a CTA; FC features of each of a lane's U atoms loaded at once.
// The 128-thread variant (small pools, one CTA a pool) keeps to 128
// registers so that 4 CTAs share an SM and 512 pools fit in one wave.
template <int T, int FC>
__global__ void __launch_bounds__(T, T == 128 ? 4 : 1) pwil_kernel(const __grid_constant__ PArgs a) {
  constexpr int W = T / 32;
  static_assert(T >= MAX_D, "a thread a feature loads the query row");
  // per warp: its buffer of candidates (up to 63), whose first K slots hold
  // its sorted list for the merges
  __shared__ u64 s_key[W][2 * K];
  __shared__ float s_mass[W][2 * K];
  __shared__ u64 x_key[2][K];  // this CTA's list for the cluster, by pass parity
  __shared__ float x_mass[2][K];
  __shared__ float s_q[MAX_D];
  __shared__ u64 s_cut;  // the least of the warps' K-th keys: no key above it can win
  __shared__ float s_left[K];  // the walk's masses left, by list position
  __shared__ u64 s_lo;
  __shared__ int s_taken, s_more;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int C = a.C, N = a.N, d = a.d;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = C > 1 ? (int)cluster.block_rank() : 0;
  const int p = blockIdx.x / C;
  const int j0 = rank * a.slice, j1 = min(N, j0 + a.slice);
  float* pool = a.pools + (ll)p * N;
  const int r0 = max(a.offsets[p], 0), r1 = min(a.offsets[p + 1], a.R);
  u64* bk = s_key[warp];
  float* bm = s_mass[warp];
  const int Cp = C <= 1 ? 1 : (C <= 2 ? 2 : (C <= 4 ? 4 : 8));
  int pass = 0;
#ifdef PWIL_STAMPS
  long long stamp_at = clock64();
#endif

  for (int r = r0; r < r1; ++r) {
    if (tid < d) s_q[tid] = a.queries[(ll)r * d + tid];
    if (tid == 0) s_cut = NONE;
    __syncthreads();  // also: the last row's pool writes are seen
    STAMP(0);
    float weight = a.agent_weight, cost = 0.f;  // thread 0's
    bool above = false;  // a continuation pass: keys above lo only
    u64 lo = 0;
    bool more = true;
    while (more) {
      // 1. this warp's K smallest keys among its atoms with mass left
      u64 lk = NONE, thr = NONE;
      float lm = 0.f;
      int cnt = 0;
      int base = j0 + warp * 32 * U;
      float next[U];  // the masses of the warp's next step, loaded a step ahead
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = base + u * 32 + lane;
        next[u] = j < j1 ? pool[j] : 0.f;
      }
      for (; base < j1; base += T * U) {
        float acc[U], m[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int j = base + T * U + u * 32 + lane;
          m[u] = next[u];
          next[u] = j < j1 ? pool[j] : 0.f;
          acc[u] = 0.f;
        }
        // distances, FC features of U atoms in flight at once; the sum in
        // feature order
        for (int f0 = 0; f0 < d; f0 += FC) {
          float x[FC][U];
#pragma unroll
          for (int f = 0; f < FC; ++f) {
            const float* row = a.atoms + (ll)(f0 + f) * N + base + lane;
#pragma unroll
            for (int u = 0; u < U; ++u) x[f][u] = f0 + f < d && m[u] > 0.f ? __ldg(row + u * 32) : 0.f;
          }
#pragma unroll
          for (int f = 0; f < FC; ++f) {
            if (f0 + f < d) {
              const float q = s_q[f0 + f];
#pragma unroll
              for (int u = 0; u < U; ++u) {
                const float t = x[f][u] - q;
                acc[u] = __fadd_rn(acc[u], __fmul_rn(t, t));
              }
            }
          }
        }
        u64 keys[U], least = NONE;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          keys[u] = NONE;
          if (m[u] > 0.f) {
            keys[u] = ((u64)__float_as_uint(sqrtf(acc[u])) << 32) | (unsigned)(base + u * 32 + lane);
            if (above && keys[u] <= lo) keys[u] = NONE;
          }
          least = min(least, keys[u]);
        }
        if (thr == NONE) {
          // before the warp's first merge: the lanes' least keys are 32
          // distinct keys, so the largest of them bounds the K-th smallest
          u64 bound = least;
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) bound = max(bound, __shfl_xor_sync(FULL, bound, o));
          if (bound != NONE && lane == 0) atomicMin(&s_cut, bound + 1);  // keys <= bound pass
        }
        const u64 cut = min(thr, *(volatile u64*)&s_cut);
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const u64 key = keys[u];
          const bool take = key < cut;
          const unsigned b = __ballot_sync(FULL, take);
          if (take) {
            const int at = cnt + __popc(b & ((1u << lane) - 1u));
            bk[at] = key;
            bm[at] = m[u];
          }
          cnt += __popc(b);
          if (cnt >= K) {  // 32 gathered: sort them and merge into the list
            __syncwarp();
            u64 k = bk[lane];
            float km = bm[lane];
            const int rest = cnt - K;
            u64 k2 = NONE;
            float m2 = 0.f;
            if (lane < rest) {
              k2 = bk[K + lane];
              m2 = bm[K + lane];
            }
            __syncwarp();
            if (lane < rest) {
              bk[lane] = k2;
              bm[lane] = m2;
            }
            cnt = rest;
            sort32(k, km, lane);
            merge_rev(lk, lm, __shfl_sync(FULL, k, 31 - lane), __shfl_sync(FULL, km, 31 - lane),
                      lane);
            thr = __shfl_sync(FULL, lk, 31);
            if (lane == 0 && thr != NONE) atomicMin(&s_cut, thr);
            __syncwarp();
          }
        }
      }
      if (cnt > 0) {  // what is left in the buffer
        __syncwarp();
        u64 k = lane < cnt ? bk[lane] : NONE;
        float km = lane < cnt ? bm[lane] : 0.f;
        sort32(k, km, lane);
        merge_rev(lk, lm, __shfl_sync(FULL, k, 31 - lane), __shfl_sync(FULL, km, 31 - lane), lane);
      }
      __syncwarp();
      bk[lane] = lk;
      bm[lane] = lm;
      __syncthreads();
      STAMP(1);

      // 2. the CTA's K smallest: the warps' lists merged
      tree_merge(s_key, s_mass, W, warp, lane);
      STAMP(2);

      // 3. the cluster's: every CTA reads every CTA's list
      if (C > 1) {
        const int b = pass & 1;
        if (warp == 0) {
          x_key[b][lane] = s_key[0][lane];
          x_mass[b][lane] = s_mass[0][lane];
        }
        cluster.sync();  // release/acquire: the lists are written
        if (warp < Cp) {
          u64 k = NONE;
          float km = 0.f;
          if (warp < C) {
            k = cluster.map_shared_rank(&x_key[b][0], warp)[lane];
            km = cluster.map_shared_rank(&x_mass[b][0], warp)[lane];
          }
          s_key[warp][lane] = k;
          s_mass[warp][lane] = km;
        }
        __syncthreads();
        tree_merge(s_key, s_mass, Cp, warp, lane);
      }
      STAMP(3);

      // 4. the walk: iltpu's rounds over the candidates, in order, 8 at a
      // time from registers. Once the weight or the list is spent it stays
      // so, and `taken` counts a prefix.
      if (tid == 0) {
        int taken = 0;
        for (int i0 = 0; i0 < K && weight > 0.f; i0 += 8) {
          u64 kk[8];
          float ew[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            kk[i] = s_key[0][i0 + i];
            ew[i] = s_mass[0][i0 + i];
          }
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            if (weight > 0.f && kk[i] != NONE) {
              const float consume = fminf(weight, ew[i]);
              cost = __fadd_rn(cost, __fmul_rn(consume, __uint_as_float((unsigned)(kk[i] >> 32))));
              weight = weight - consume;
              s_left[i0 + i] = ew[i] - consume;
              taken = i0 + i + 1;
            }
          }
        }
        s_taken = taken;
        s_more = taken == K && weight > 0.f;  // the weight outlasts the K candidates
        s_lo = s_key[0][K - 1];
        s_cut = NONE;
      }
      __syncthreads();
      STAMP(4);
      more = s_more;
      lo = s_lo;
      above = true;
      ++pass;
      // the masses taken, back into this CTA's slice (a reset row refills it)
      if (warp == 0 && lane < s_taken && (more || !a.reset[r])) {
        const int j = (int)(unsigned)s_key[0][lane];
        if (j >= j0 && j < j1) pool[j] = s_left[lane];
      }
      __syncwarp();  // warp 0's next pass reuses the list's slots
#ifdef PWIL_STAMPS
      if (tid == 0) a.stamps[(ll)blockIdx.x * NSTAMP + 6] += 1;
#endif
    }
    if (tid == 0 && rank == 0) a.rewards[r] = __fmul_rn(a.scale, expf(__fmul_rn(a.neg_bandwidth, cost)));
    if (a.reset[r]) {
      for (int j = j0 + tid; j < j1; j += T) pool[j] = a.atom_weight;
    }
    STAMP(5);
#ifdef PWIL_STAMPS
    if (tid == 0) a.stamps[(ll)blockIdx.x * NSTAMP + 7] += 1;
#endif
  }
  if (C > 1) cluster.sync();  // no CTA leaves while another may read its lists
}

constexpr int BIG = 512, SMALL = 128;  // threads a CTA
typedef void (*Kernel)(PArgs);
Kernel kernel_for(int T) { return T == SMALL ? pwil_kernel<SMALL, 4> : pwil_kernel<BIG, 8>; }

cudaLaunchConfig_t config(int P, int C, int T, cudaLaunchAttribute* attr, cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(P * C));
  cfg.blockDim = dim3((unsigned)T);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = C > 1 ? 1 : 0;
  return cfg;
}

int sm_count() {
  static int n = -1;
  if (n < 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
      n = 0;
    }
  }
  return n;
}

// Clusters of C CTAs of the big kernel that the card runs at once (clusters
// stay within a GPC, so this is less than SMs / C), asked once a size; a
// CUDA error e as -e.
int active_clusters(int C) {
  static int n[MAX_CLUSTER + 1] = {};  // 0: not asked yet
  if (n[C] == 0) {
    cudaLaunchAttribute attr[1];
    cudaLaunchConfig_t cfg = config(C, C, BIG, attr, 0);
    int got = 0;
    const cudaError_t e = cudaOccupancyMaxActiveClusters(&got, kernel_for(BIG), &cfg);
    if (e != cudaSuccess) return -(int)e;
    n[C] = got > 0 ? got : -1;
  }
  return n[C] > 0 ? n[C] : 0;
}

// CTAs a pool: the largest cluster, at most the portable 8 and SMs / P,
// whose P clusters all run at once (a second wave would double the time),
// each CTA with at least MIN_SLICE atoms; 1 (no cluster) where pools are
// more than half the SMs or too many for clusters of 2 at once. Negative:
// an error (ERR_CLUSTER where the card can hold no cluster at all).
int cluster_for(int P, int N) {
  const int sms = sm_count();
  if (sms < 1) return -(int)cudaErrorInvalidDevice;
  int c = sms / P;
  c = c > MAX_CLUSTER ? MAX_CLUSTER : c;
  while (c > 1 && (ll)N < (ll)c * MIN_SLICE) --c;
  for (; c > 1; --c) {
    const int n = active_clusters(c);
    if (n < 0) return n;
    if (n == 0 && c == 2) return ERR_CLUSTER;
    if (n >= P) return c;
  }
  return 1;
}

int launch(const PArgs& a, int T, cudaStream_t s) {
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config(a.P, a.C, T, attr, s);
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel_for(T), a);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace

// Clusters of C CTAs (2..8) the card runs at once (negative: an error).
extern "C" int iltpu_pwil_active_clusters(int C) {
  return C < 2 || C > MAX_CLUSTER ? -(int)cudaErrorInvalidValue : active_clusters(C);
}

// CTAs a pool for P pools of N atoms (1: no cluster; negative: an error).
extern "C" int iltpu_pwil_cluster_size(int P, int N) { return cluster_for(P, N); }

extern "C" const char* iltpu_pwil_error(int e) {
  if (e == ERR_CLUSTER) return "the card cannot schedule a thread-block cluster of this kernel";
  return cudaGetErrorString((cudaError_t)(e < 0 ? -e : e));
}

extern "C" int iltpu_pwil_transport(const void* atoms_fm, void* pools, const void* queries,
                                    const void* offsets, const void* reset, void* rewards, int P,
                                    int N, int d, int R, float atom_weight, float agent_weight,
                                    float bandwidth, float scale, void* stream
#ifdef PWIL_STAMPS
                                    , long long* stamps
#endif
) {
  if (P < 1 || N < 1 || d < 1 || d > MAX_D || R < 0) return (int)cudaErrorInvalidValue;
  PArgs a;
  a.atoms = static_cast<const float*>(atoms_fm);
  a.pools = static_cast<float*>(pools);
  a.queries = static_cast<const float*>(queries);
  a.offsets = static_cast<const int*>(offsets);
  a.reset = static_cast<const unsigned char*>(reset);
  a.rewards = static_cast<float*>(rewards);
  a.P = P;
  a.N = N;
  a.d = d;
  a.R = R;
  a.C = cluster_for(P, N);
  if (a.C < 1) return a.C;
  a.slice = (int)((((ll)N + a.C - 1) / a.C + 31) / 32 * 32);
  a.atom_weight = atom_weight;
  a.agent_weight = agent_weight;
  a.neg_bandwidth = -bandwidth;
  a.scale = scale;
#ifdef PWIL_STAMPS
  a.stamps = stamps;
#endif
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  // a small pool on its own: 4 warps; else 16 (and always where a cluster
  // merges up to 8 lists, one a warp)
  return launch(a, a.C == 1 && N <= 4096 ? SMALL : BIG, s);
}
