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
//   only lanes of the same class, so a thread per active lane suffices
//   (r + 1 threads; lanes loop per thread above 1024).  The two carries
//   ping-pong in shared memory: step s reads D_{s-1} and overwrites D_{s-2}
//   lane by lane, each thread only its own lanes, so one __syncthreads() per
//   step is the whole synchronisation.  Lanes of the other class are never
//   written and keep BIG.
// * dtw_rows  (K4) replaces kvmatch_tpu/ops/dtw_pallas.py:_dtw_kernel: the
//   row prefix-scan form D[k] = C[k] + min_{j<=k}(M[j] - C[j-1]) with
//   M[k] = min(P[k], P[k+1]), C = cumsum(d), one block per row and two
//   hand-written block scans (warp shuffles + shared memory) per DP row.
// * dtw_ds replaces the XLA double-single DP of kvmatch_tpu/ops/dtw.py:
//   dtw_banded_batch_ds_multi with the K3 walk on (hi, lo) pairs (TwoSum
//   additions, lexicographic minima); returns hi and lo.  TwoSum is
//   error-free only without multiply-add contraction: the library is built
//   with --fmad=false and without fast math.
//
// What bounds them on an H100: the serial chain of 2L-1 steps (K3, DS) or
// L rows (K4) per candidate row, each a few shared-memory loads, one f32 add
// and a barrier -- latency, not device memory (each row reads 2 L floats
// once).  The a and q rows are staged in shared memory (2 x 32 KB at
// L = 8192) when they fit the block's opt-in limit, else read from global
// memory; enough blocks stay resident per SM to hide the barrier latency.
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
__global__ void __launch_bounds__(KVM_DTW_THREADS)
dtw_diag_kernel(const float* __restrict__ a, const float* __restrict__ qm,
                const int* __restrict__ qids, int L, int Q, int r, int stage,
                float* __restrict__ out) {
  extern __shared__ float smem[];
  const int W = 2 * r + 1;
  const int qid = qids[blockIdx.x];
  if (qid < 0 || qid >= Q) {
    if (threadIdx.x == 0) out[blockIdx.x] = NAN;
    return;
  }
  // Carries with a BIG sentinel lane on each side: buf[k + 1] is lane k.
  float* buf0 = smem;
  float* buf1 = smem + (W + 2);
  const float* arow;
  const float* qrow;
  stage_rows(a, qm, qid, L, stage, smem + 2 * (W + 2), arow, qrow);
  for (int t = threadIdx.x; t < W + 2; t += blockDim.x) {
    buf0[t] = (t == r + 1) ? 0.0f : KVM_BIG;  // D_{-2}: only (0, 0)'s seed
    buf1[t] = KVM_BIG;                         // D_{-1}
  }
  __syncthreads();
  const int S = 2 * L - 1;
  for (int s = 0; s < S; ++s) {
    float* cur = (s & 1) ? buf1 : buf0;         // D_{s-2}, becomes D_s
    const float* prev = (s & 1) ? buf0 : buf1;  // D_{s-1}
    const int p = (s + r) & 1;
    for (int k = 2 * threadIdx.x + p; k < W; k += 2 * blockDim.x) {
      const int i = (s + r - k) >> 1;
      const int j = s - i;
      float v = KVM_BIG;
      if (i >= 0 && i < L && j >= 0 && j < L) {
        const float df = arow[i] - qrow[j];
        const float m = fminf(fminf(prev[k], prev[k + 2]), cur[k + 1]);
        v = fminf(df * df + m, KVM_BIG);
      }
      cur[k + 1] = v;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = (((S - 1) & 1) ? buf1 : buf0)[r + 1];
}

// ------------------------------------------------------------------- DS
__global__ void __launch_bounds__(KVM_DTW_THREADS)
dtw_ds_kernel(const float* __restrict__ a, const float* __restrict__ qm,
              const int* __restrict__ qids, int L, int Q, int r, int stage,
              float* __restrict__ out_hi, float* __restrict__ out_lo) {
  extern __shared__ float smem[];
  const int W = 2 * r + 1;
  const int qid = qids[blockIdx.x];
  if (qid < 0 || qid >= Q) {
    if (threadIdx.x == 0) {
      out_hi[blockIdx.x] = NAN;
      out_lo[blockIdx.x] = NAN;
    }
    return;
  }
  float* h0 = smem;
  float* l0 = smem + (W + 2);
  float* h1 = smem + 2 * (W + 2);
  float* l1 = smem + 3 * (W + 2);
  const float* arow;
  const float* qrow;
  stage_rows(a, qm, qid, L, stage, smem + 4 * (W + 2), arow, qrow);
  for (int t = threadIdx.x; t < W + 2; t += blockDim.x) {
    h0[t] = (t == r + 1) ? 0.0f : KVM_BIG;
    l0[t] = 0.0f;
    h1[t] = KVM_BIG;
    l1[t] = 0.0f;
  }
  __syncthreads();
  const int S = 2 * L - 1;
  for (int s = 0; s < S; ++s) {
    float* ch = (s & 1) ? h1 : h0;
    float* cl = (s & 1) ? l1 : l0;
    const float* ph = (s & 1) ? h0 : h1;
    const float* pl = (s & 1) ? l0 : l1;
    const int p = (s + r) & 1;
    for (int k = 2 * threadIdx.x + p; k < W; k += 2 * blockDim.x) {
      const int i = (s + r - k) >> 1;
      const int j = s - i;
      float vh = KVM_BIG, vl = 0.0f;
      if (i >= 0 && i < L && j >= 0 && j < L) {
        const float df = arow[i] - qrow[j];
        const float d = df * df;
        float mh, ml;
        ds_min(ph[k], pl[k], ph[k + 2], pl[k + 2], mh, ml);
        ds_min(mh, ml, ch[k + 1], cl[k + 1], mh, ml);
        ds_two_sum(mh, ml, d, 0.0f, vh, vl);
        if (!(vh < KVM_BIG)) {
          vh = KVM_BIG;
          vl = 0.0f;
        }
      }
      ch[k + 1] = vh;
      cl[k + 1] = vl;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const int last = (S - 1) & 1;
    out_hi[blockIdx.x] = (last ? h1 : h0)[r + 1];
    out_lo[blockIdx.x] = (last ? l1 : l0)[r + 1];
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

extern "C" int kvm_dtw_diag(const void* a, const void* qm, const void* qids,
                            int B, int L, int Q, int r, void* out,
                            void* stream) {
  if (bad_args(B, L, Q, r)) return (int)cudaErrorInvalidValue;
  int stage = 0;
  size_t bytes = 0;
  const int err = configure(dtw_diag_kernel, 2LL * (2 * r + 3), L, &stage,
                            &bytes);
  if (err) return err;
  dtw_diag_kernel<<<B, threads_for(r + 1), bytes, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)qm, (const int*)qids, L, Q, r, stage,
      (float*)out);
  return (int)cudaGetLastError();
}

extern "C" int kvm_dtw_ds(const void* a, const void* qm, const void* qids,
                          int B, int L, int Q, int r, void* out_hi,
                          void* out_lo, void* stream) {
  if (bad_args(B, L, Q, r)) return (int)cudaErrorInvalidValue;
  int stage = 0;
  size_t bytes = 0;
  const int err = configure(dtw_ds_kernel, 4LL * (2 * r + 3), L, &stage,
                            &bytes);
  if (err) return err;
  dtw_ds_kernel<<<B, threads_for(r + 1), bytes, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)qm, (const int*)qids, L, Q, r, stage,
      (float*)out_hi, (float*)out_lo);
  return (int)cudaGetLastError();
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
