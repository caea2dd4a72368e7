// K3, K4 and the double-single DP: squared Sakoe-Chiba banded DTW, radius r,
// of a batch of rows, each against its own query row.
//
// Row b compares a[b, :] (B, L) with qm[qids[b], :] (Q, L); r is clamped to
// L - 1 by the caller (a wider band changes nothing).  Band lane k = j - i + r
// in [0, 2r] holds cell (i, j).  Dead and out-of-band cells hold BIG = 1e30;
// d + BIG == BIG in f32, and every value is capped with min(D, BIG)
// (kvmatch_tpu/ops/dtw.py:60-61, ops/dtw_pallas.py:245-253).
//
// * dtw_diag  (K3) replaces kvmatch_tpu/ops/dtw_pallas.py:_dtw_diag_kernel.
//   It walks the 2L-1 anti-diagonals s = i + j with
//       D_s[k] = d(i, j) + min(D_{s-1}[k-1], D_{s-1}[k+1], D_{s-2}[k]).
//   Only lanes with s + r - k even hold a cell on diagonal s, and they read
//   only lanes of the same class.  One warp per row, the band in registers
//   (see the K3 section for its bound and design).
// * dtw_rows  (K4) replaces kvmatch_tpu/ops/dtw_pallas.py:_dtw_kernel: the
//   row prefix-scan form D[k] = C[k] + min_{j<=k}(M[j] - C[j-1]) with
//   M[k] = min(P[k], P[k+1]), C = cumsum(d), one block per row and two
//   hand-written block scans (warp shuffles + shared memory) per DP row.
// * dtw_ds replaces the XLA double-single DP of kvmatch_tpu/ops/dtw.py:
//   dtw_banded_batch_ds_multi with the K3 walk on (hi, lo) pairs (TwoSum
//   additions, lexicographic minima); returns hi and lo.  TwoSum is
//   error-free only without multiply-add contraction: the library is built
//   with --fmad=false and without fast math.  It is K3's kernel with the
//   band held as pairs (the DS template flag; see the K3 section).
//
// What bounds K4 on an H100: the serial chain of L rows per candidate row,
// each a few shared-memory loads, one f32 add and two block scans -- latency,
// not device memory (each row reads 2 L floats once).  The a and q rows are
// staged in shared memory (2 x 32 KB at L = 8192) when they fit the block's
// opt-in limit, else read from global memory.
// The TPU kernels' repeat-interleaved, 128-aligned inputs and their
// wrong-parity garbage lanes are Mosaic devices and are not carried over.

#include <cuda_runtime.h>
#include <math.h>

#define KVM_BIG 1e30f
#define KVM_DTW_THREADS 1024

// ------------------------------------------------------------ helpers
__device__ __forceinline__ void ds_two_sum(float ah, float al, float bh,
                                           float bl, float& h, float& l) {
  const float s = ah + bh;
  const float v = s - ah;
  const float e = (ah - (s - v)) + (bh - v);
  float lo = e + (al + bl);
  h = s + lo;
  l = lo - (h - s);
}

__device__ __forceinline__ void ds_min(float ah, float al, float bh,
                                       float bl, float& h, float& l) {
  const bool take_a = (ah < bh) || ((ah == bh) && (al <= bl));
  h = take_a ? ah : bh;
  l = take_a ? al : bl;
}

// Stage row b of a and its query row in shared memory when `stage`; returns
// the pointers the DP reads.
__device__ __forceinline__ void stage_rows(const float* a, const float* qm,
                                           int qid, int L, int stage,
                                           float* sh, const float*& arow,
                                           const float*& qrow) {
  arow = a + (long long)blockIdx.x * L;
  qrow = qm + (long long)qid * L;
  if (stage) {
    for (int t = threadIdx.x; t < L; t += blockDim.x) {
      sh[t] = arow[t];
      sh[L + t] = qrow[t];
    }
    arow = sh;
    qrow = sh + L;
  }
}

// ------------------------------------------------------------------- K3
// One warp walks the anti-diagonals of a row with the band in registers.
//
// What bounds it: f32 operations.  A row of the main path (L = 8192,
// r = 409) has L (2r + 1) - r (r + 1) = 6.54M band cells of 5 f32
// operations (sub, mul, add, two mins; the BIG cap not counted), so 1024
// rows are 3.35e10 operations: about 0.50 ms at 67 TFLOP/s.  The rows
// themselves are 33.5 MB, 0.01 ms of device memory.
//
// What the first design (one block per row, one thread per active lane,
// carries in shared memory) lost: each of the 16,383 anti-diagonal steps
// ended in a block-wide __syncthreads() after a chain of dependent
// shared-memory loads (about 600 cycles a step), and the 2 L floats of a
// staged row per block left room for 3 rows per SM.
//
// This design:
// * One warp per row (KVM_K3_WARPS rows per block), or, for bands wider
//   than a warp holds, G warps of one block per row; no barrier inside
//   the walk of a one-warp row.
// * The W = 2r + 1 band lanes are split into contiguous chunks of C lanes,
//   one per thread (C a template parameter, C = 2 mod 4, so every chunk
//   starts on an even lane and the stride C/2 between threads' reads is
//   odd: no shared-memory bank conflict).  A thread keeps both parity
//   classes of its chunk in D[C]: on diagonal s it rewrites its lanes of
//   parity (s + r) & 1, which hold D_{s-2}, from its other-parity lanes,
//   which hold D_{s-1}.  The one value across a chunk edge that a step
//   needs comes from one __shfl_up_sync or __shfl_down_sync (between
//   warps of a wide row: shared memory and one __syncthreads() a step).
// * The diagonals are walked in pairs (s, s + 1).  A lane's a-index and
//   q-index advance by one every pair, so a thread reads C/2 + 1 values of
//   a and of q per pair into registers and uses each twice.  They come
//   from a per-warp ring in shared memory (R floats each for a and q,
//   R = pow2 >= 16 C + 40, its first 16 entries mirrored past its end so a
//   pair's slots are read at immediate offsets from one base) that is
//   refilled with one coalesced load of 32 values every 32 pairs,
//   prefetched into registers 32 pairs ahead.
// * Cells outside the matrix read +inf sentinels from the ring (indices
//   outside [0, L)), so d = inf or NaN and min(d + m, BIG) = BIG without a
//   branch.  Lanes past the band's end (k >= W, in the last chunk) read
//   +inf from a masked a or q slot and stay BIG.
// The f32 operations of each cell are those of the first design and of
// dtw_diag_plain, so the outputs are equal bit for bit.
//
// DS (the DS template flag) is this kernel on (hi, lo) pairs: each lane
// holds a pair in D/Dl, a step shuffles both halves of the edge pair, and
// the cell is d = df * df, two ds_min, ds_two_sum with (d, 0) and the cap
// to (BIG, 0) when !(hi < BIG) -- the operations of dtw_ds_diag_plain, so
// the two are equal bit for bit.  Cells outside the matrix see d = inf or
// NaN from the sentinels; the sum is then NaN or inf and the cap gives
// (BIG, 0), as the plain version's explicit value.  What bounds it: f32
// operations, about 20 a cell against K3's 5 (with the selects of the
// pair minima and the cap, about 28 against 6: it runs at 4.5x K3's
// time).  The first DS design (one
// block per row, carries in shared memory, a barrier per anti-diagonal)
// was K3's first design and lost what that design lost.
#define KVM_K3_WARPS 4
#define KVM_K3_MAX_WARPS_PER_ROW 32

template <int C>
struct K3Ring {
  static constexpr int need = 16 * C + 40;
  static constexpr int R = need <= 128 ? 128 : need <= 256 ? 256
                         : need <= 512 ? 512 : 1024;
  // Entries [0, 16) are mirrored at [R, R + 16), so a thread's (at most 16)
  // slots of a pair are contiguous from one base: reads take immediate
  // offsets, with no wrap-around mask per slot.
  static constexpr int STRIDE = R + 16;
};

__device__ __forceinline__ void k3_put(float* ring, int idx, int mask,
                                       int r_len, float v) {
  const int k = idx & mask;
  ring[k] = v;
  if (k < 16) ring[k + r_len] = v;
}

__device__ __forceinline__ float k3_load(const float* row, int idx, int L) {
  return (idx >= 0 && idx < L) ? __ldg(row + idx) : INFINITY;
}

// C lanes per thread, E = r & 1 (the parity of every chunk's first active
// lane on even diagonals).  WIDE == false: one warp per row, KVM_K3_WARPS
// rows per block (G == 1); WIDE: one row per block of G warps.  DS: the
// double-single DP, out = hi and out_lo = lo; otherwise out_lo is unused.
template <int C, int E, bool WIDE, bool DS>
__global__ void __launch_bounds__(WIDE ? KVM_K3_MAX_WARPS_PER_ROW * 32
                                       : KVM_K3_WARPS * 32)
dtw_diag_kernel(const float* __restrict__ a, const float* __restrict__ qm,
                const int* __restrict__ qids, int B, int L, int Q, int r,
                int G, float* __restrict__ out, float* __restrict__ out_lo) {
  constexpr int R = K3Ring<C>::R;
  constexpr int M = R - 1;
  constexpr int RS = K3Ring<C>::STRIDE;
  constexpr int H = C / 2;
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = WIDE ? blockIdx.x : blockIdx.x * KVM_K3_WARPS + warp;
  const int g = WIDE ? warp : 0;  // the warp's place in its row
  float* ringA = smem + warp * 2 * RS;
  float* ringQ = ringA + RS;
  // WIDE only: [2 diagonals][last lanes, first lanes][G], then (DS) the
  // same for the lo halves.
  float* edge = smem + (WIDE ? G : KVM_K3_WARPS) * 2 * RS;
  if (row >= B) return;  // not WIDE only: a WIDE grid has no spare block
  const int qid = qids[row];
  if (qid < 0 || qid >= Q) {
    if (lane == 0 && g == 0) {
      out[row] = NAN;
      if (DS) out_lo[row] = NAN;
    }
    return;  // uniform over the row's warps
  }
  const float* arow = a + (long long)row * L;
  const float* qrow = qm + (long long)qid * L;
  const int W = 2 * r + 1;
  const int k0 = (g * 32 + lane) * C;  // first lane of this thread's chunk
  const int kw = g * 32 * C;           // first lane of this warp
  // Masked slot bound: lanes k0 + u >= W must read +inf (see the note).
  const int wl = (W - k0 + 1) >> 1;
  // Ring windows on pair 0; on pair p each is shifted by p.
  //   a: [lo_a, hi_a], thread's a-index base T = p + (r - E) / 2 - k0 / 2
  //   q: [lo_q, hi_q], thread's q-index base J = 2 p - T
  const int hi_a = (r + E) / 2 - kw / 2;
  const int lo_a = (r - E) / 2 - (kw + 32 * C) / 2 + 1;
  const int lo_q = (E - r) / 2 + kw / 2;
  const int hi_q = lo_q + 16 * C;
  for (int i = lo_a + lane; i <= hi_a + 32; i += 32)
    k3_put(ringA, i, M, R, k3_load(arow, i, L));
  for (int j = lo_q + lane; j <= hi_q + 32; j += 32)
    k3_put(ringQ, j, M, R, k3_load(qrow, j, L));
  int fa = hi_a + 33, fq = hi_q + 33;  // next ring index to fill
  float pa = k3_load(arow, fa + lane, L);
  float pq = k3_load(qrow, fq + lane, L);
  __syncwarp();

  float D[C];
  float Dl[DS ? C : 1];  // DS: the lo halves
#pragma unroll
  for (int u = 0; u < C; ++u) D[u] = (k0 + u == r) ? 0.0f : KVM_BIG;
  if constexpr (DS) {
#pragma unroll
    for (int u = 0; u < C; ++u) Dl[u] = 0.0f;
  }
  const int T0 = (r - E) / 2 - k0 / 2;
  for (int p = 0; p < L; ++p) {
    if (p > 0 && (p & 31) == 0) {
      __syncwarp();
      k3_put(ringA, fa + lane, M, R, pa);
      k3_put(ringQ, fq + lane, M, R, pq);
      __syncwarp();
      fa += 32;
      fq += 32;
      pa = k3_load(arow, fa + lane, L);
      pq = k3_load(qrow, fq + lane, L);
    }
    const int T = p + T0;
    const int J = 2 * p - T;
    // a-slot v holds a[T + E - v], q-slot w holds q[J + w].
    const float* a_base = ringA + ((T - H + 1) & M);
    const float* q_base = ringQ + (J & M);
    float av[H + E], qv[H + 1 - E];
#pragma unroll
    for (int v = 0; v < H + E; ++v) {
      const float x = a_base[H + E - 1 - v];
      av[v] = (E == 1 && v >= wl) ? INFINITY : x;
    }
#pragma unroll
    for (int w = 0; w < H + 1 - E; ++w) {
      const float x = q_base[w];
      qv[w] = (E == 0 && w >= wl) ? INFINITY : x;
    }
    // Two diagonals: the first rewrites lanes u = E + 2m, the second
    // lanes u = 1 - E + 2m.  A first-lane update (u = 0) needs the left
    // chunk's last lane, a last-lane update (u = C - 1) the right chunk's
    // first lane.
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int par = E ^ half;  // lanes of this diagonal: u = par + 2m
      const float mine = par == 0 ? D[C - 1] : D[0];
      float nb = par == 0 ? __shfl_up_sync(0xffffffffu, mine, 1)
                          : __shfl_down_sync(0xffffffffu, mine, 1);
      float nbl = 0.0f;
      if constexpr (DS) {
        const float minel = par == 0 ? Dl[C - 1] : Dl[0];
        nbl = par == 0 ? __shfl_up_sync(0xffffffffu, minel, 1)
                       : __shfl_down_sync(0xffffffffu, minel, 1);
      }
      if (WIDE) {
        // Chunk edges between warps go through shared memory.
        float* eb = edge + half * 2 * G;  // [0]: warps' last lanes, [1]: first
        float* ebl = eb + 4 * G;          // DS: the lo halves
        if (lane == 31) eb[g] = D[C - 1];
        if (lane == 0) eb[G + g] = D[0];
        if constexpr (DS) {
          if (lane == 31) ebl[g] = Dl[C - 1];
          if (lane == 0) ebl[G + g] = Dl[0];
        }
        __syncthreads();
        if (par == 0 && lane == 0) {
          nb = g > 0 ? eb[g - 1] : KVM_BIG;
          if constexpr (DS) nbl = g > 0 ? ebl[g - 1] : 0.0f;
        }
        if (par == 1 && lane == 31) {
          nb = g + 1 < G ? eb[G + g + 1] : KVM_BIG;
          if constexpr (DS) nbl = g + 1 < G ? ebl[G + g + 1] : 0.0f;
        }
      } else {
        if (par == 0 && lane == 0) nb = KVM_BIG;
        if (par == 1 && lane == 31) nb = KVM_BIG;
        if constexpr (DS) {
          if ((par == 0 && lane == 0) || (par == 1 && lane == 31)) nbl = 0.0f;
        }
      }
#pragma unroll
      for (int m = 0; m < H; ++m) {
        const int u = par + 2 * m;
        const float lft = u == 0 ? nb : D[u > 0 ? u - 1 : 0];
        const float rgt = u == C - 1 ? nb : D[u < C - 1 ? u + 1 : 0];
        // first diagonal: a-slot m + E, q-slot m; second: a-slot m,
        // q-slot m + 1 - E
        const float df = half == 0 ? av[m + E] - qv[m]
                                   : av[m] - qv[m + 1 - E];
        if constexpr (DS) {
          const float lftl = u == 0 ? nbl : Dl[u > 0 ? u - 1 : 0];
          const float rgtl = u == C - 1 ? nbl : Dl[u < C - 1 ? u + 1 : 0];
          float mh, ml, vh, vl;
          ds_min(lft, lftl, rgt, rgtl, mh, ml);
          ds_min(mh, ml, D[u], Dl[u], mh, ml);
          ds_two_sum(mh, ml, df * df, 0.0f, vh, vl);
          const bool ok = vh < KVM_BIG;
          D[u] = ok ? vh : KVM_BIG;
          Dl[u] = ok ? vl : 0.0f;
        } else {
          const float mn = fminf(fminf(lft, rgt), D[u]);
          D[u] = fminf(df * df + mn, KVM_BIG);
        }
      }
    }
  }
  const int kk = r - k0;
  if (kk >= 0 && kk < C) {
    float res = KVM_BIG, res_l = 0.0f;
#pragma unroll
    for (int u = 0; u < C; ++u)
      if (u == kk) {
        res = D[u];
        if constexpr (DS) res_l = Dl[u];
      }
    out[row] = res;
    if (DS) out_lo[row] = res_l;
  }
}

// ------------------------------------------------------------------- K4
// Exclusive block scan of one value per thread (sum or min); `wt` holds 32
// floats of shared memory.  blockDim.x is a multiple of 32.
template <bool kMin>
__device__ __forceinline__ float block_excl_scan(float v, float* wt) {
  const float ident = kMin ? INFINITY : 0.0f;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  float x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const float n = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x = kMin ? fminf(n, x) : n + x;
  }
  if (lane == 31) wt[warp] = x;
  __syncthreads();
  if (warp == 0) {
    float t = lane < nw ? wt[lane] : ident;
    for (int o = 1; o < 32; o <<= 1) {
      const float n = __shfl_up_sync(0xffffffffu, t, o);
      if (lane >= o) t = kMin ? fminf(n, t) : n + t;
    }
    wt[lane] = t;
  }
  __syncthreads();
  float e = __shfl_up_sync(0xffffffffu, x, 1);
  if (lane == 0) e = ident;
  if (warp > 0) e = kMin ? fminf(wt[warp - 1], e) : wt[warp - 1] + e;
  __syncthreads();  // wt is rewritten by the next scan
  return e;
}

__global__ void __launch_bounds__(KVM_DTW_THREADS)
dtw_rows_kernel(const float* __restrict__ a, const float* __restrict__ qm,
                const int* __restrict__ qids, int L, int Q, int r, int stage,
                float* __restrict__ out) {
  extern __shared__ float smem[];
  const int W = 2 * r + 1;
  const int qid = qids[blockIdx.x];
  if (qid < 0 || qid >= Q) {
    if (threadIdx.x == 0) out[blockIdx.x] = NAN;
    return;
  }
  float* sP = smem;              // previous row, W lanes + a BIG sentinel
  float* sC = sP + (W + 1);      // cumsum of d
  float* sM = sC + W;            // M, then the running min of M - C_prev
  float* wt = sM + W;            // 32 warp totals
  const float* arow;
  const float* qrow;
  stage_rows(a, qm, qid, L, stage, wt + 32, arow, qrow);
  // Each thread owns the contiguous lanes [k0, k1).
  const int per = (W + blockDim.x - 1) / blockDim.x;
  const int k0 = min(W, (int)threadIdx.x * per);
  const int k1 = min(W, k0 + per);
  for (int t = threadIdx.x; t < W + 1; t += blockDim.x) sP[t] = KVM_BIG;
  __syncthreads();
  for (int i = 0; i < L; ++i) {
    const float ai = arow[i];
    float run = 0.0f;
    for (int k = k0; k < k1; ++k) {
      const int j = i - r + k;
      float d = 0.0f;
      if (j >= 0 && j < L) {
        const float df = ai - qrow[j];
        d = df * df;
      }
      run = run + d;
      sC[k] = run;
      sM[k] = i == 0 ? (k == r ? 0.0f : KVM_BIG) : fminf(sP[k], sP[k + 1]);
    }
    const float off = block_excl_scan<false>(run, wt);
    for (int k = k0; k < k1; ++k) sC[k] = off + sC[k];
    __syncthreads();
    float g = INFINITY;
    for (int k = k0; k < k1; ++k) {
      g = fminf(g, sM[k] - (k > 0 ? sC[k - 1] : 0.0f));
      sM[k] = g;
    }
    const float pre = block_excl_scan<true>(g, wt);
    for (int k = k0; k < k1; ++k) {
      const int j = i - r + k;
      sP[k] = (j >= 0 && j < L) ? fminf(sC[k] + fminf(pre, sM[k]), KVM_BIG)
                                : KVM_BIG;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = sP[r];
}

// ------------------------------------------------------------ launchers
// Dynamic shared memory: `base` floats of carries plus 2 L floats of staged
// rows when they fit the device's opt-in limit.
template <typename K>
static int configure(K kernel, long long base, int L, int* stage,
                     size_t* bytes) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return (int)err;
  const long long with_rows = (base + 2LL * L) * (long long)sizeof(float);
  *stage = with_rows <= optin;
  const long long b = *stage ? with_rows : base * (long long)sizeof(float);
  if (b > optin) return (int)cudaErrorInvalidValue;
  *bytes = (size_t)b;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)b);
}

static int threads_for(int lanes) {
  const int t = ((lanes + 31) / 32) * 32;
  return t < KVM_DTW_THREADS ? t : KVM_DTW_THREADS;
}

static bool bad_args(int B, int L, int Q, int r) {
  return B <= 0 || L <= 0 || Q <= 0 || r < 0 || r >= L;
}

// K3's shape for a band of W lanes: C lanes per thread (C = 2 mod 4) and
// G warps per row.  A warp holds up to 32 x 30 lanes; a wider band takes
// G = ceil(W / (32 x 26)) warps of 26 lanes a thread (rings of 512
// floats), up to KVM_K3_MAX_WARPS_PER_ROW: r <= 13311 (ops/dtw.py:K3_MAX_R).
static int k3_shape(int r, int* C, int* G) {
  const int W = 2 * r + 1;
  *G = W <= 32 * 30 ? 1 : (W + 32 * 26 - 1) / (32 * 26);
  if (*G > KVM_K3_MAX_WARPS_PER_ROW) return (int)cudaErrorInvalidValue;
  if (*G > 1) {
    *C = 26;
    return 0;
  }
  *C = 2;
  while (32 * *C < W) *C += 4;
  return 0;
}

template <int C, int E, bool WIDE, bool DS>
static int launch_diag(const float* a, const float* qm, const int* qids,
                       int B, int L, int Q, int r, int G, float* out,
                       float* out_lo, cudaStream_t stream) {
  auto kernel = dtw_diag_kernel<C, E, WIDE, DS>;
  const int warps = WIDE ? G : KVM_K3_WARPS;
  const size_t bytes = sizeof(float) *
      ((size_t)warps * 2 * K3Ring<C>::STRIDE
       + (WIDE ? (DS ? 8 : 4) * (size_t)G : 0));
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = WIDE ? B : (B + KVM_K3_WARPS - 1) / KVM_K3_WARPS;
  kernel<<<blocks, warps * 32, bytes, stream>>>(a, qm, qids, B, L, Q, r, G,
                                                out, out_lo);
  return (int)cudaGetLastError();
}

template <int E, bool DS>
static int dispatch_diag(int C, int G, const float* a, const float* qm,
                         const int* qids, int B, int L, int Q, int r,
                         float* o, float* ol, cudaStream_t s) {
  if (G > 1)
    return launch_diag<26, E, true, DS>(a, qm, qids, B, L, Q, r, G, o, ol, s);
  switch (C) {
#define KVM_K3_CASE(c) \
    case c: return launch_diag<c, E, false, DS>(a, qm, qids, B, L, Q, r, 1, \
                                               o, ol, s);
    KVM_K3_CASE(2) KVM_K3_CASE(6) KVM_K3_CASE(10) KVM_K3_CASE(14)
    KVM_K3_CASE(18) KVM_K3_CASE(22) KVM_K3_CASE(26) KVM_K3_CASE(30)
#undef KVM_K3_CASE
  }
  return (int)cudaErrorInvalidValue;
}

// K3 (out_lo == nullptr) or DS (hi to out, lo to out_lo).
template <bool DS>
static int run_diag(const void* a, const void* qm, const void* qids, int B,
                    int L, int Q, int r, void* out, void* out_lo,
                    void* stream) {
  if (bad_args(B, L, Q, r)) return (int)cudaErrorInvalidValue;
  int C = 0, G = 0;
  const int err = k3_shape(r, &C, &G);
  if (err) return err;
  const float* fa = (const float*)a;
  const float* fq = (const float*)qm;
  const int* fi = (const int*)qids;
  float* o = (float*)out;
  float* ol = (float*)out_lo;
  cudaStream_t s = (cudaStream_t)stream;
  return (r & 1) ? dispatch_diag<1, DS>(C, G, fa, fq, fi, B, L, Q, r, o, ol, s)
                 : dispatch_diag<0, DS>(C, G, fa, fq, fi, B, L, Q, r, o, ol, s);
}

extern "C" int kvm_dtw_diag(const void* a, const void* qm, const void* qids,
                            int B, int L, int Q, int r, void* out,
                            void* stream) {
  return run_diag<false>(a, qm, qids, B, L, Q, r, out, nullptr, stream);
}

extern "C" int kvm_dtw_ds(const void* a, const void* qm, const void* qids,
                          int B, int L, int Q, int r, void* out_hi,
                          void* out_lo, void* stream) {
  return run_diag<true>(a, qm, qids, B, L, Q, r, out_hi, out_lo, stream);
}

extern "C" int kvm_dtw_rows(const void* a, const void* qm, const void* qids,
                            int B, int L, int Q, int r, void* out,
                            void* stream) {
  if (bad_args(B, L, Q, r)) return (int)cudaErrorInvalidValue;
  const int W = 2 * r + 1;
  int stage = 0;
  size_t bytes = 0;
  const int err = configure(dtw_rows_kernel, 3LL * W + 1 + 32, L, &stage,
                            &bytes);
  if (err) return err;
  dtw_rows_kernel<<<B, threads_for(W), bytes, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)qm, (const int*)qids, L, Q, r, stage,
      (float*)out);
  return (int)cudaGetLastError();
}
