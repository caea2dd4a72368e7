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
//   (see the K3 section for its bound and design); a band wider than one
//   block holds spans the blocks of a thread-block cluster, and a band wider
//   than a cluster holds takes the global form (carries in device memory).
// * dtw_rows  (K4) replaces kvmatch_tpu/ops/dtw_pallas.py:_dtw_kernel: the
//   row prefix-scan form D[k] = C[k] + min_{j<=k}(M[j] - C[j-1]) with
//   M[k] = min(P[k], P[k+1]), C = cumsum(d).  One warp per row with the
//   band in registers and two warp scans per DP row when a warp holds the
//   band (2r + 1 <= 960), else one block per row with two block scans (see
//   the K4 section).
// * dtw_ds replaces the XLA double-single DP of kvmatch_tpu/ops/dtw.py:
//   dtw_banded_batch_ds_multi with the K3 walk on (hi, lo) pairs (TwoSum
//   additions, lexicographic minima); returns hi and lo.  TwoSum is
//   error-free only without multiply-add contraction: the library is built
//   with --fmad=false and without fast math.  It is K3's kernel with the
//   band held as pairs (the DS template flag; see the K3 section).
//
// The TPU kernels' repeat-interleaved, 128-aligned inputs and their
// wrong-parity garbage lanes are Mosaic devices and are not carried over.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

#define KVM_BIG 1e30f
#define KVM_DTW_THREADS 1024
#define KVM_FULL 0xffffffffu

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
// A band wider than one block's 32 warps (r > 13,311) takes the CLUSTER
// form: the G warps of a row are spread over the blocks of a thread-block
// cluster (at most 8, the portable size; r <= 106,495), g numbers them
// across the cluster, and each keeps its own ring.  The chunk edges between
// warps go through the same double-buffered edge slots; a warp at a block's
// edge reads its neighbour block's slot through distributed shared memory,
// and cluster.sync() takes the place of __syncthreads().  Rows one block
// holds keep the instantiations above (CLUSTER == false compiles to the
// same code as before the cluster form).
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
// rows per block (G == 1); WIDE: one row per block of G warps; WIDE and
// CLUSTER: one row per cluster of G / Gb blocks of Gb warps (G warps in
// all).  DS: the double-single DP, out = hi and out_lo = lo; otherwise
// out_lo is unused.
template <int C, int E, bool WIDE, bool DS, bool CLUSTER = false>
__global__ void __launch_bounds__(WIDE ? KVM_K3_MAX_WARPS_PER_ROW * 32
                                       : KVM_K3_WARPS * 32)
dtw_diag_kernel(const float* __restrict__ a, const float* __restrict__ qm,
                const int* __restrict__ qids, int B, int L, int Q, int r,
                int G, float* __restrict__ out, float* __restrict__ out_lo) {
  static_assert(WIDE || !CLUSTER, "the cluster form is a wide form");
  constexpr int R = K3Ring<C>::R;
  constexpr int M = R - 1;
  constexpr int RS = K3Ring<C>::STRIDE;
  constexpr int H = C / 2;
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int row, g;  // g: the warp's place in its row
  int Gb = G, rank = 0;  // CLUSTER: warps per block, the block's rank
  if constexpr (CLUSTER) {
    Gb = blockDim.x >> 5;
    rank = (int)cg::this_cluster().block_rank();
    row = blockIdx.x / (G / Gb);
    g = rank * Gb + warp;
  } else {
    row = WIDE ? blockIdx.x : blockIdx.x * KVM_K3_WARPS + warp;
    g = WIDE ? warp : 0;
  }
  float* ringA = smem + warp * 2 * RS;
  float* ringQ = ringA + RS;
  // WIDE only: [2 diagonals][last lanes, first lanes][Gb], then (DS) the
  // same for the lo halves.
  float* edge = smem + (WIDE ? Gb : KVM_K3_WARPS) * 2 * RS;
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
      if constexpr (CLUSTER) {
        // As below, with the slots of warps g -/+ 1 in the block of rank
        // (g -/+ 1) / Gb, read through distributed shared memory.
        cg::cluster_group cluster = cg::this_cluster();
        float* eb = edge + half * 2 * Gb;
        float* ebl = eb + 4 * Gb;
        if (lane == 31) eb[warp] = D[C - 1];
        if (lane == 0) eb[Gb + warp] = D[0];
        if constexpr (DS) {
          if (lane == 31) ebl[warp] = Dl[C - 1];
          if (lane == 0) ebl[Gb + warp] = Dl[0];
        }
        cluster.sync();
        const int nw = par == 0 ? g - 1 : g + 1;  // the neighbour warp
        if ((par == 0 && lane == 0) || (par == 1 && lane == 31)) {
          const bool in = nw >= 0 && nw < G;
          const int slot = (nw % Gb) + (par == 0 ? 0 : Gb);
          nb = in ? cluster.map_shared_rank(eb, nw / Gb)[slot] : KVM_BIG;
          if constexpr (DS)
            nbl = in ? cluster.map_shared_rank(ebl, nw / Gb)[slot] : 0.0f;
        }
      } else if (WIDE) {
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
  // No block may leave while a neighbour can still read its edge slots.
  if constexpr (CLUSTER) cg::this_cluster().sync();
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

// The GLOBAL form, for bands wider than a cluster of 8 blocks holds
// (r > 106,495, ops/dtw.py:K3_MAX_R): one block of KVM_DTW_THREADS threads a
// row, its two anti-diagonal carries in a global workspace (the blocks
// resident at once stride over the rows).  Only the lanes of one parity live
// in a carry: carry c, rewritten on the diagonals s with s & 1 == c, holds
// the lanes k = P + 2x, P = (c + r) & 1, at slot x + 1, with a BIG slot on
// each side (S = r + 3 slots; DS adds two carries of lo halves).  On
// diagonal s the block's threads stride over the lanes that hold a cell of
// the matrix, and each cell does dtw_diag_plain's (dtw_ds_diag_plain's)
// operations in place: D_{s-1}[k - 1] and D_{s-1}[k + 1] are slots x + P' and
// x + P' + 1 of the other carry (P' its parity), D_{s-2}[k] is this slot.
// A cell rewrites only its own slot and reads the other carry, which this
// diagonal never writes, so one __syncthreads() a diagonal orders them.
// Lanes outside the matrix keep what they held: a lane leaves the matrix
// only for good, the lanes that would read its stale value on the next
// diagonals lie outside the matrix too, and a lane not yet inside it still
// holds its first value, BIG.  So the form is bit-equal to the plain
// versions.  Not a fast form: every carry read and write goes through the
// L2 cache, and a row runs on one SM.
template <bool DS>
__global__ void __launch_bounds__(KVM_DTW_THREADS)
dtw_diag_global_kernel(const float* __restrict__ a,
                       const float* __restrict__ qm,
                       const int* __restrict__ qids, int B, int L, int Q,
                       int r, float* ws, float* __restrict__ out,
                       float* __restrict__ out_lo) {
  const int S = r + 3;
  const int W = 2 * r + 1;
  float* base = ws + (long long)blockIdx.x * (DS ? 4 : 2) * S;
  const int seed = (r >> 1) + 1;  // lane r of carry 0
  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    const int qid = qids[b];
    if (qid < 0 || qid >= Q) {
      if (threadIdx.x == 0) {
        out[b] = NAN;
        if (DS) out_lo[b] = NAN;
      }
      continue;  // uniform over the block
    }
    const float* arow = a + (long long)b * L;
    const float* qrow = qm + (long long)qid * L;
    for (int x = threadIdx.x; x < 2 * S; x += blockDim.x) {
      base[x] = x == seed ? 0.0f : KVM_BIG;  // D_{-2}[r] = 0 seeds (0, 0)
      if (DS) base[2 * S + x] = 0.0f;
    }
    __syncthreads();
    for (int s = 0; s < 2 * L - 1; ++s) {
      const int c = s & 1;
      const int p = (s + r) & 1;
      float* cur = base + c * S;
      const float* prev = base + (1 - c) * S + p;
      // The lanes k = p + 2x of this diagonal that hold a cell (i, j):
      // i = (s + r - k) / 2 and j = s - i in [0, L).
      const int k_lo = max(max(0, r - s), s + r - 2 * (L - 1));
      const int k_hi = min(min(W - 1, s + r), 2 * (L - 1) + r - s);
      const int x_lo = (k_lo - p + 1) >> 1;
      const int x_hi = (k_hi - p) >> 1;
      const int i0 = (s + r - p) >> 1;  // i of slot x is i0 - x
      for (int x = x_lo + (int)threadIdx.x; x <= x_hi; x += blockDim.x) {
        const int i = i0 - x;
        const float df = arow[i] - qrow[s - i];
        if constexpr (DS) {
          float* curl = base + (2 + c) * S;
          const float* prevl = base + (3 - c) * S + p;
          float mh, ml, vh, vl;
          ds_min(prev[x], prevl[x], prev[x + 1], prevl[x + 1], mh, ml);
          ds_min(mh, ml, cur[x + 1], curl[x + 1], mh, ml);
          ds_two_sum(mh, ml, df * df, 0.0f, vh, vl);
          const bool ok = vh < KVM_BIG;
          cur[x + 1] = ok ? vh : KVM_BIG;
          curl[x + 1] = ok ? vl : 0.0f;
        } else {
          const float mn = fminf(fminf(prev[x], prev[x + 1]), cur[x + 1]);
          cur[x + 1] = fminf(df * df + mn, KVM_BIG);
        }
      }
      __syncthreads();
    }
    if (threadIdx.x == 0) {  // cell (L - 1, L - 1): lane r of carry 0
      out[b] = base[seed];
      if (DS) out_lo[b] = base[2 * S + seed];
    }
    __syncthreads();  // the carries are rewritten for the next row
  }
}

// ------------------------------------------------------------------- K4
// The row prefix-scan form.  Each DP row i, per band lane k (j = i - r + k):
//   d = (a_i - q_j)^2, 0 outside the matrix;  C = cumsum(d);
//   M = min(P[k], P[k + 1]) (row 0: 0 at k = r, BIG elsewhere);
//   G = M - C[k - 1];  D = min(C + cummin(G), BIG), BIG outside the matrix.
//
// What bounds it: the same work as K3 (5 f32 operations a band cell, about
// 0.50 ms for 1024 rows at L = 8192, r = 409), but each row is a chain:
// two scans across the band before the next row can start.
//
// What the first design (one block per row, one thread per band lane,
// carries in shared memory, two block scans a row) lost: 8 block barriers
// a row, each behind dependent shared-memory loads, for about 7 f32
// operations a lane (62 ms at that shape, 0.8% of the bound).
//
// This design, for bands one warp holds (W = 2r + 1 <= 960):
// * One warp per row, KVM_K3_WARPS rows per block, no barrier.
// * The band in registers: thread t holds the C lanes [tC, tC + C) of P
//   (C as K3 picks it: 2, 6, ..., 30, the least with 32 C >= W); lanes
//   k >= W are padding, d = 0 and D = BIG there.
// * The running sum and the running min inside a chunk are sequential;
//   across chunks, an inclusive Hillis-Steele warp scan of the 32 chunk
//   totals (5 __shfl_up_sync steps, n + x), shifted by one lane for the
//   exclusive value (0, or +inf for the min, at lane 0).  P[k + 1] and
//   C[k - 1] across a chunk edge are one shuffle each.
// * q stays in registers: qv[u] = q[i - r + tC + u] shifts by one lane a
//   row, the new last value is the right thread's qv[0] (the last thread's
//   from a 32-value buffer loaded every 32 rows, as is a_i).
// dtw_rows_plain repeats these f32 operations in this order, so the two
// are equal bit for bit.  Wider bands take the block form below: one block
// a row as in the first design, with one block scan a row of another form,
// and its three carries (about 3W floats) in a global workspace when they
// pass the shared-memory opt-in limit.
__device__ __forceinline__ float k4_load(const float* row, int idx, int L) {
  return (idx >= 0 && idx < L) ? __ldg(row + idx) : 0.0f;
}

template <int C>
__global__ void __launch_bounds__(KVM_K3_WARPS * 32)
dtw_rows_warp_kernel(const float* __restrict__ a,
                     const float* __restrict__ qm,
                     const int* __restrict__ qids, int B, int L, int Q, int r,
                     float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * KVM_K3_WARPS + (threadIdx.x >> 5);
  if (row >= B) return;
  const int qid = qids[row];
  if (qid < 0 || qid >= Q) {
    if (lane == 0) out[row] = NAN;
    return;
  }
  const float* arow = a + (long long)row * L;
  const float* qrow = qm + (long long)qid * L;
  const int k0 = lane * C;               // first lane of this thread's chunk
  const int nw = 2 * r + 1 - k0;         // lanes u < nw lie inside the band
  const int jr = 32 * C - r;             // q index of row i's new last value
  float qv[C], P[C], c[C];
#pragma unroll
  for (int u = 0; u < C; ++u) {
    qv[u] = k4_load(qrow, k0 + u - r, L);
    P[u] = KVM_BIG;
  }
  float ab = k4_load(arow, lane, L), ab_next = k4_load(arow, 32 + lane, L);
  float qe = k4_load(qrow, jr + lane, L);
  float qe_next = k4_load(qrow, jr + 32 + lane, L);
  for (int i = 0; i < L; ++i) {
    if (i > 0 && (i & 31) == 0) {
      ab = ab_next;
      qe = qe_next;
      ab_next = k4_load(arow, i + 32 + lane, L);
      qe_next = k4_load(qrow, jr + i + 32 + lane, L);
    }
    const float ai = __shfl_sync(KVM_FULL, ab, i & 31);
    // Lanes u in [ulo, uhi] hold cells of the matrix (0 <= j < L, k < W).
    const int jb = i - r + k0;
    const int ulo = -jb;
    const int uhi = min(nw, L - jb) - 1;
    const bool full = ulo <= 0 && uhi >= C - 1;
    float run = 0.0f;
    if (full) {
#pragma unroll
      for (int u = 0; u < C; ++u) {
        const float df = ai - qv[u];
        run = run + df * df;
        c[u] = run;
      }
    } else {
#pragma unroll
      for (int u = 0; u < C; ++u) {
        const float df = ai - qv[u];
        run = run + ((u >= ulo && u <= uhi) ? df * df : 0.0f);
        c[u] = run;
      }
    }
    float x = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float n = __shfl_up_sync(KVM_FULL, x, o);
      if (lane >= o) x = n + x;
    }
    const float off_n = __shfl_up_sync(KVM_FULL, x, 1);
    const float off = lane == 0 ? 0.0f : off_n;
#pragma unroll
    for (int u = 0; u < C; ++u) c[u] = off + c[u];
    const float cl_n = __shfl_up_sync(KVM_FULL, c[C - 1], 1);
    const float cl = lane == 0 ? 0.0f : cl_n;  // C[k0 - 1]
    // G = M - C[k - 1] and its running min, written over P (P[u] is dead
    // once M[u] is taken; P[u + 1] is read before it is overwritten).
    float gm = INFINITY;
    if (i == 0) {
#pragma unroll
      for (int u = 0; u < C; ++u) {
        const float m = (k0 + u == r) ? 0.0f : KVM_BIG;
        gm = fminf(gm, m - (u == 0 ? cl : c[u > 0 ? u - 1 : 0]));
        P[u] = gm;
      }
    } else {
      const float pr_n = __shfl_down_sync(KVM_FULL, P[0], 1);
      const float pr = lane == 31 ? KVM_BIG : pr_n;  // P[k0 + C]
#pragma unroll
      for (int u = 0; u < C; ++u) {
        const float m = fminf(P[u], u + 1 < C ? P[u + 1 < C ? u + 1 : 0] : pr);
        gm = fminf(gm, m - (u == 0 ? cl : c[u > 0 ? u - 1 : 0]));
        P[u] = gm;
      }
    }
    float y = gm;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float n = __shfl_up_sync(KVM_FULL, y, o);
      if (lane >= o) y = fminf(n, y);
    }
    const float pre_n = __shfl_up_sync(KVM_FULL, y, 1);
    const float pre = lane == 0 ? INFINITY : pre_n;
    if (full) {
#pragma unroll
      for (int u = 0; u < C; ++u)
        P[u] = fminf(c[u] + fminf(pre, P[u]), KVM_BIG);
    } else {
#pragma unroll
      for (int u = 0; u < C; ++u)
        P[u] = (u >= ulo && u <= uhi)
                   ? fminf(c[u] + fminf(pre, P[u]), KVM_BIG) : KVM_BIG;
    }
    // Row i + 1's q window: one lane to the left.
    const float qn = __shfl_down_sync(KVM_FULL, qv[0], 1);
    const float qr = __shfl_sync(KVM_FULL, qe, i & 31);
#pragma unroll
    for (int u = 0; u + 1 < C; ++u) qv[u] = qv[u + 1];
    qv[C - 1] = lane == 31 ? qr : qn;
  }
  const int kk = r - k0;
  if (kk >= 0 && kk < C) {
    float res = KVM_BIG;
#pragma unroll
    for (int u = 0; u < C; ++u)
      if (u == kk) res = P[u];
    out[row] = res;
  }
}

// The block form, for bands wider than a warp holds: one block per row, a
// thread per run of `per` contiguous lanes.  Its arithmetic is the row
// recurrence D[k] = d[k] + min(D[k - 1], M[k]) itself, scanned as a
// composition of the lanes' maps x -> min(x, M[k]) + d[k]: a run of lanes
// composes to x -> min(x + A, G), A the run's sum of d and G the least
// path cost that enters the run from above, and two runs compose as
//   (A1, G1) then (A2, G2) = (A1 + A2, min(G1 + A2, G2)).
// Every sum is a sum of path costs (no f32 cancellation), so its error is
// relative, as K3's.  (The prefix form above, C[k] + min(M[j] - C[j - 1]),
// subtracts prefix sums of the whole band: on wide bands they reach 1e5 and
// more, and the minimum over j picks the most negative rounding, row after
// row: -3.79 against 0.0039 at L = 32,768, r = 20,000 in its first block
// form.)  One exclusive block scan of (A, G) pairs a DP row; `wt` holds 64
// floats of shared memory, blockDim.x is a multiple of 32.  Returns G of
// the lanes before this thread's run: the carry into it (+inf for the
// first run).
__device__ __forceinline__ float block_excl_minplus(float A, float G,
                                                    float* wt) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  float a = A, g = G;
  for (int o = 1; o < 32; o <<= 1) {
    const float na = __shfl_up_sync(KVM_FULL, a, o);
    const float ng = __shfl_up_sync(KVM_FULL, g, o);
    if (lane >= o) {
      g = fminf(ng + a, g);
      a = na + a;
    }
  }
  if (lane == 31) {
    wt[warp] = a;
    wt[32 + warp] = g;
  }
  __syncthreads();
  if (warp == 0) {
    float ta = lane < nw ? wt[lane] : 0.0f;
    float tg = lane < nw ? wt[32 + lane] : INFINITY;
    for (int o = 1; o < 32; o <<= 1) {
      const float na = __shfl_up_sync(KVM_FULL, ta, o);
      const float ng = __shfl_up_sync(KVM_FULL, tg, o);
      if (lane >= o) {
        tg = fminf(ng + ta, tg);
        ta = na + ta;
      }
    }
    wt[lane] = ta;
    wt[32 + lane] = tg;
  }
  __syncthreads();
  const float ea_n = __shfl_up_sync(KVM_FULL, a, 1);
  const float eg_n = __shfl_up_sync(KVM_FULL, g, 1);
  const float ea = lane == 0 ? 0.0f : ea_n;
  float eg = lane == 0 ? INFINITY : eg_n;
  if (warp > 0) eg = fminf(wt[32 + warp - 1] + ea, eg);
  __syncthreads();  // wt is rewritten by the next row's scan
  return eg;
}

// Each carry holds per x T slots: lane k = t per + u of thread t (its
// contiguous run) lives at slot u T + t, so the threads of a warp touch
// consecutive slots (coalesced in the global workspace, no bank conflict in
// shared memory).  GLOBAL: the three carries in the block's slice of `ws`
// (a workspace for the blocks of the grid, which stride over the rows),
// otherwise in shared memory.  The a and q rows are staged in shared
// memory when `stage` (they fit the opt-in limit), else read from global
// memory.
template <bool GLOBAL>
__global__ void __launch_bounds__(KVM_DTW_THREADS)
dtw_rows_kernel(const float* __restrict__ a, const float* __restrict__ qm,
                const int* __restrict__ qids, int B, int L, int Q, int r,
                int stage, float* ws, float* __restrict__ out) {
  extern __shared__ float smem[];
  const int W = 2 * r + 1;
  const int T = blockDim.x;
  const int t = threadIdx.x;
  const int per = (W + T - 1) / T;
  const int S = per * T;         // slots of each carry
  float* wt = smem;              // 64 floats: the warps' (A, G) totals
  float* sP = GLOBAL ? ws + (long long)blockIdx.x * 3 * S
                     : smem + 64;  // the previous row's D
  float* sD = sP + S;            // d of this row
  float* sM = sD + S;            // M of this row
  float* rows = GLOBAL ? smem + 64 : sM + S;  // staged a and q rows
  const int k0 = t * per;        // this thread's lanes [k0, k0 + nk)
  const int nk = max(0, min(per, W - k0));
  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    const int qid = qids[b];
    if (qid < 0 || qid >= Q) {
      if (t == 0) out[b] = NAN;
      continue;  // uniform over the block
    }
    const float* arow = a + (long long)b * L;
    const float* qrow = qm + (long long)qid * L;
    if (stage) {
      for (int x = t; x < L; x += T) {
        rows[x] = arow[x];
        rows[L + x] = qrow[x];
      }
      arow = rows;
      qrow = rows + L;
    }
    for (int x = t; x < S; x += T) sP[x] = KVM_BIG;
    __syncthreads();
    for (int i = 0; i < L; ++i) {
      const float ai = arow[i];
      float A = 0.0f, G = INFINITY;
      for (int u = 0; u < nk; ++u) {
        const int k = k0 + u;
        const int j = i - r + k;
        float d = 0.0f;
        if (j >= 0 && j < L) {
          const float df = ai - qrow[j];
          d = df * df;
        }
        // P[k + 1]: the next slot of this run, or the next thread's first;
        // BIG past the band.
        const float pn = k + 1 >= W ? KVM_BIG
                         : sP[u + 1 < per ? (u + 1) * T + t : t + 1];
        const float m = i == 0 ? (k == r ? 0.0f : KVM_BIG)
                               : fminf(sP[u * T + t], pn);
        sD[u * T + t] = d;
        sM[u * T + t] = m;
        G = fminf(G, m) + d;
        A = A + d;
      }
      // Every read of sP above precedes the scan's barriers.
      float h = block_excl_minplus(A, G, wt);
      for (int u = 0; u < nk; ++u) {
        h = fminf(h, sM[u * T + t]) + sD[u * T + t];
        const int j = i - r + k0 + u;
        sP[u * T + t] = (j >= 0 && j < L) ? fminf(h, KVM_BIG) : KVM_BIG;
      }
      __syncthreads();
    }
    if (t == 0) out[b] = sP[(r % per) * T + r / per];
    __syncthreads();  // sP and the staged rows are rewritten next
  }
}

// ------------------------------------------------------------ launchers
// The shared-memory opt-in limit of a block and the SM count of the device.
static int device_limits(int* optin, int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

// Dynamic shared memory: `base` floats plus 2 L floats of staged rows when
// they fit the device's opt-in limit.
template <typename K>
static int configure(K kernel, long long base, int L, int optin, int* stage,
                     size_t* bytes) {
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

// C lanes per thread (C = 2 mod 4) for a band one warp holds (W <= 960).
static int warp_chunk(int W) {
  int C = 2;
  while (32 * C < W) C += 4;
  return C;
}

// K3's shape for a band of W lanes: C lanes per thread, G warps per row,
// NB blocks per row.  A warp holds up to 32 x 30 lanes; a wider band takes
// G = ceil(W / (32 x 26)) warps of 26 lanes a thread (rings of 512
// floats).  Up to KVM_K3_MAX_WARPS_PER_ROW warps are one block (NB = 1);
// more take NB = ceil(G / 32) blocks of a cluster, at most
// KVM_K3_MAX_CLUSTER (the portable cluster size), with G rounded up to a
// multiple of NB (the extra warps hold lanes past the band, which stay
// BIG): r <= 106,495 (ops/dtw.py:K3_MAX_R).  A wider band (NB > 8) takes
// the global form.
#define KVM_K3_MAX_CLUSTER 8
static void k3_shape(int r, int* C, int* G, int* NB) {
  const int W = 2 * r + 1;
  *NB = 1;
  *G = W <= 32 * 30 ? 1 : (W + 32 * 26 - 1) / (32 * 26);
  if (*G > KVM_K3_MAX_WARPS_PER_ROW) {
    *NB = (*G + KVM_K3_MAX_WARPS_PER_ROW - 1) / KVM_K3_MAX_WARPS_PER_ROW;
    *G = (*G + *NB - 1) / *NB * *NB;
  }
  *C = *G > 1 ? 26 : warp_chunk(W);
}

// The global form's grid (the blocks resident at once, at most B) and the
// floats of its workspace; 0 floats when the band takes another form.
template <bool DS>
static int diag_global_plan(int B, int r, int* grid, long long* floats) {
  int C = 0, G = 0, NB = 0;
  k3_shape(r, &C, &G, &NB);
  *grid = 0;
  *floats = 0;
  if (NB <= KVM_K3_MAX_CLUSTER) return 0;
  int optin = 0, sms = 0, per_sm = 0;
  int err = device_limits(&optin, &sms);
  if (err) return err;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, dtw_diag_global_kernel<DS>, KVM_DTW_THREADS, 0);
  if (err) return err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  *grid = (int)(B < (long long)per_sm * sms ? B : (long long)per_sm * sms);
  *floats = (long long)*grid * (DS ? 4 : 2) * (r + 3);
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

// The cluster form: one row per cluster of NB blocks of G / NB warps.
// Returns an error, and launches nothing, when no such cluster fits the
// device (cudaOccupancyMaxActiveClusters is 0).
template <int E, bool DS>
static int launch_cluster(const float* a, const float* qm, const int* qids,
                          int B, int L, int Q, int r, int G, int NB,
                          float* out, float* out_lo, cudaStream_t stream) {
  auto kernel = dtw_diag_kernel<26, E, true, DS, true>;
  const int Gb = G / NB;
  const size_t bytes = sizeof(float) *
      ((size_t)Gb * 2 * K3Ring<26>::STRIDE + (DS ? 8 : 4) * (size_t)Gb);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = NB;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)B * (unsigned)NB);
  cfg.blockDim = dim3(Gb * 32);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, (const void*)kernel, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
  err = cudaLaunchKernelEx(&cfg, kernel, a, qm, qids, B, L, Q, r, G, out,
                           out_lo);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int E, bool DS>
static int dispatch_diag(int C, int G, int NB, const float* a,
                         const float* qm, const int* qids, int B, int L,
                         int Q, int r, float* o, float* ol, cudaStream_t s) {
  if (NB > 1)
    return launch_cluster<E, DS>(a, qm, qids, B, L, Q, r, G, NB, o, ol, s);
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

// K3 (out_lo == nullptr) or DS (hi to out, lo to out_lo).  The global form
// needs a workspace of the floats kvm_dtw_diag_workspace / _ds_workspace
// report.
template <bool DS>
static int run_diag(const void* a, const void* qm, const void* qids, int B,
                    int L, int Q, int r, void* out, void* out_lo, void* ws,
                    long long ws_floats, void* stream) {
  if (bad_args(B, L, Q, r)) return (int)cudaErrorInvalidValue;
  int C = 0, G = 0, NB = 0;
  k3_shape(r, &C, &G, &NB);
  const float* fa = (const float*)a;
  const float* fq = (const float*)qm;
  const int* fi = (const int*)qids;
  float* o = (float*)out;
  float* ol = (float*)out_lo;
  cudaStream_t s = (cudaStream_t)stream;
  if (NB > KVM_K3_MAX_CLUSTER) {
    int grid = 0;
    long long need = 0;
    const int err = diag_global_plan<DS>(B, r, &grid, &need);
    if (err) return err;
    if (ws == nullptr || ws_floats < need) return (int)cudaErrorInvalidValue;
    dtw_diag_global_kernel<DS><<<grid, KVM_DTW_THREADS, 0, s>>>(
        fa, fq, fi, B, L, Q, r, (float*)ws, o, ol);
    return (int)cudaGetLastError();
  }
  return (r & 1)
      ? dispatch_diag<1, DS>(C, G, NB, fa, fq, fi, B, L, Q, r, o, ol, s)
      : dispatch_diag<0, DS>(C, G, NB, fa, fq, fi, B, L, Q, r, o, ol, s);
}

template <bool DS>
static int diag_workspace(int B, int L, int Q, int r, long long* floats) {
  if (bad_args(B, L, Q, r)) return (int)cudaErrorInvalidValue;
  int grid = 0;
  return diag_global_plan<DS>(B, r, &grid, floats);
}

// Floats of workspace kvm_dtw_diag / kvm_dtw_ds need (0: none).
extern "C" int kvm_dtw_diag_workspace(int B, int L, int Q, int r,
                                      long long* floats) {
  return diag_workspace<false>(B, L, Q, r, floats);
}

extern "C" int kvm_dtw_ds_workspace(int B, int L, int Q, int r,
                                    long long* floats) {
  return diag_workspace<true>(B, L, Q, r, floats);
}

extern "C" int kvm_dtw_diag(const void* a, const void* qm, const void* qids,
                            int B, int L, int Q, int r, void* out, void* ws,
                            long long ws_floats, void* stream) {
  return run_diag<false>(a, qm, qids, B, L, Q, r, out, nullptr, ws, ws_floats,
                         stream);
}

extern "C" int kvm_dtw_ds(const void* a, const void* qm, const void* qids,
                          int B, int L, int Q, int r, void* out_hi,
                          void* out_lo, void* ws, long long ws_floats,
                          void* stream) {
  return run_diag<true>(a, qm, qids, B, L, Q, r, out_hi, out_lo, ws,
                        ws_floats, stream);
}

// K4's launch: the one-warp form (C > 0) when a warp holds the band, else
// the block form with its carries in shared memory (ws_floats == 0) or,
// past the opt-in limit, in a workspace of ws_floats floats: the carries of
// `grid` blocks, the blocks resident at once (at most B), which stride over
// the rows.
struct RowsPlan {
  int C, threads, stage, grid;
  size_t bytes;
  long long ws_floats;
};

static int rows_plan(int B, int L, int r, RowsPlan* p) {
  const int W = 2 * r + 1;
  *p = RowsPlan{};
  if (W <= 32 * 30) {
    p->C = warp_chunk(W);
    p->grid = (B + KVM_K3_WARPS - 1) / KVM_K3_WARPS;
    return 0;
  }
  int optin = 0, sms = 0;
  int err = device_limits(&optin, &sms);
  if (err) return err;
  p->threads = threads_for(W);
  // Three carries of per x threads slots each (dtw_rows_kernel).
  const long long carries = 3LL * ((W + p->threads - 1) / p->threads)
                            * p->threads;
  if ((64 + carries) * (long long)sizeof(float) <= optin) {
    p->grid = B;
    return configure(dtw_rows_kernel<false>, 64 + carries, L, optin,
                     &p->stage, &p->bytes);
  }
  err = configure(dtw_rows_kernel<true>, 64, L, optin, &p->stage, &p->bytes);
  if (err) return err;
  int per_sm = 0;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, dtw_rows_kernel<true>, p->threads, p->bytes);
  if (err) return err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  p->grid = (int)(B < (long long)per_sm * sms ? B : (long long)per_sm * sms);
  p->ws_floats = p->grid * carries;
  return 0;
}

// Floats of workspace kvm_dtw_rows needs for these arguments (0: none).
extern "C" int kvm_dtw_rows_workspace(int B, int L, int Q, int r,
                                      long long* floats) {
  if (bad_args(B, L, Q, r)) return (int)cudaErrorInvalidValue;
  RowsPlan p;
  const int err = rows_plan(B, L, r, &p);
  if (err) return err;
  *floats = p.ws_floats;
  return 0;
}

template <int C>
static int launch_rows_warp(const float* a, const float* qm, const int* qids,
                            int B, int L, int Q, int r, int grid, float* out,
                            cudaStream_t s) {
  dtw_rows_warp_kernel<C><<<grid, KVM_K3_WARPS * 32, 0, s>>>(
      a, qm, qids, B, L, Q, r, out);
  return (int)cudaGetLastError();
}

extern "C" int kvm_dtw_rows(const void* a, const void* qm, const void* qids,
                            int B, int L, int Q, int r, void* out, void* ws,
                            long long ws_floats, void* stream) {
  if (bad_args(B, L, Q, r)) return (int)cudaErrorInvalidValue;
  RowsPlan p;
  const int err = rows_plan(B, L, r, &p);
  if (err) return err;
  const float* fa = (const float*)a;
  const float* fq = (const float*)qm;
  const int* fi = (const int*)qids;
  float* o = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  switch (p.C) {
#define KVM_K4_CASE(c) \
    case c: return launch_rows_warp<c>(fa, fq, fi, B, L, Q, r, p.grid, o, s);
    KVM_K4_CASE(2) KVM_K4_CASE(6) KVM_K4_CASE(10) KVM_K4_CASE(14)
    KVM_K4_CASE(18) KVM_K4_CASE(22) KVM_K4_CASE(26) KVM_K4_CASE(30)
#undef KVM_K4_CASE
    case 0: break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (p.ws_floats > 0) {
    if (ws == nullptr || ws_floats < p.ws_floats)
      return (int)cudaErrorInvalidValue;
    dtw_rows_kernel<true><<<p.grid, p.threads, p.bytes, s>>>(
        fa, fq, fi, B, L, Q, r, p.stage, (float*)ws, o);
  } else {
    dtw_rows_kernel<false><<<p.grid, p.threads, p.bytes, s>>>(
        fa, fq, fi, B, L, Q, r, p.stage, nullptr, o);
  }
  return (int)cudaGetLastError();
}
