// K2: phase-2 window distances for a batch of candidate offsets.
//
// Replaces the Pallas TPU kernel kvmatch_tpu/ops/pallas_ed.py:_ed_kernel
// (entry window_distances_pallas), made multi-query like
// kvmatch_tpu/ops/ed.py:ed_distances_multi / znorm_ed_distances_multi: row b
// compares the window data[off_b : off_b + L] (off_b int64) with
// queries[qid_b].
//   raw:     d2 = sum (x - q)^2
//   z-norm:  mean = sum(x)/L, var = sum((x - mean)^2)/L, std = sqrt(var),
//            d2 = sum(((x - mean)/std - q_hat)^2), inf where std == 0
// Offsets are clamped to [0, n - L] as jax.lax.dynamic_slice clamps them in
// the JAX package's direct-gather route (ops/ed.py:81-83); padding rows
// (verify.pad_batches repeats the first offset) are computed and trimmed by
// the caller.
//
// What bounds it on an H100: device-memory reads, 4*L bytes of window per
// row (the query rows stay in L1/L2 across the rows of one query, which the
// engines send together), against 3 (raw) or 9 (z-norm) f32 operations a
// window element -- far below the compute roofline.  The design, chosen on
// the card's timings (PERF.md):
//
// * A row is WPR warps: one up to L = 1024, two up to 2048, four up to 4096,
//   eight above; a block is 8 warps, so 8 / WPR rows.  Lanes read
//   consecutive floats (each warp load is one coalesced 128-byte line), 16
//   loads a thread in flight before their first use.
// * Sums are warp shuffles (every lane gets the total); a row of several
//   warps adds the warps' sums through one shared-memory stage -- at most
//   two barriers a reduction, against the nine of a 256-thread tree.
// * z-norm keeps the two-pass centred algebra of the plain version (mean,
//   then the centred square sum, then the distance, which multiplies by
//   1/std where the plain version divides).  Pass one reads the window from
//   device memory; passes two and three re-read it through L1.  Past
//   L = 4096 a block's window (32 KB at L = 8192) times the blocks an SM
//   holds outgrows L1, so pass two walks the window backwards: it starts on
//   the lines pass one touched last, and pass three on those pass two
//   touched last.
// * Staging each window in shared memory by 16-byte cp.async copies (the
//   Pallas kernel's VMEM copy) was slower on the card at every shape on
//   record: a block holds its copy through three passes, so fewer windows
//   are in flight.
//
// The f64 form (kvm_window_ed_f64, z-norm only) is phase 2's exact confirm
// of cNSM-ED's near windows on the card: the same rows over the same
// resident f32 series, each point promoted to f64 on load, with f64 query
// rows, sums, reductions and outputs, and the mean and variance divided by
// L (a flat window's mean is then exact, so its std is exactly 0).  The
// engine sends it only a series whose f64 host values the f32 copy holds
// exactly, so it reads the numbers the host confirm reads.  It replaces no
// TPU kernel (the JAX package confirms on the host).  Bound: the same 4*L
// bytes a row; its 9 f64 operations a point stay far below the card's f64
// rate, and at the cells' few hundred rows a launch its time is the
// launch.  The f32 instantiations compile to the arithmetic above.

#include <cuda_runtime.h>
#include <math.h>

#define KVM_ED_WARPS 8
#define KVM_ED_THREADS (32 * KVM_ED_WARPS)

// Arithmetic of one type: f32 for K2, f64 for its exact form.
__device__ __forceinline__ float kvm_fma(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double kvm_fma(double a, double b, double c) {
  return fma(a, b, c);
}
__device__ __forceinline__ float kvm_sqrt(float v) { return sqrtf(v); }
__device__ __forceinline__ double kvm_sqrt(double v) { return sqrt(v); }
// A row's sum over L: times the f32-rounded 1/L in f32 (K2's arithmetic),
// divided by L in f64.
__device__ __forceinline__ float kvm_over_l(float s, float inv_l, int) {
  return s * inv_l;
}
__device__ __forceinline__ double kvm_over_l(double s, double, int L) {
  return s / (double)L;
}

// The sum of v over a row's WPR warps, returned to every thread of the row.
// Every thread of the block calls it the same number of times (rows past B
// repeat the last row), so its barriers are uniform.
template <typename T, int WPR>
__device__ __forceinline__ T row_sum(T v, T* red, int warp, int lane) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (WPR == 1) return v;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  const int first = (warp / WPR) * WPR;
  T t = T(0);
#pragma unroll
  for (int w = 0; w < WPR; ++w) t += red[first + w];
  __syncthreads();
  return t;
}

template <typename T, int WPR, bool ZNORM>
__global__ void __launch_bounds__(KVM_ED_THREADS)
window_ed_kernel(const float* __restrict__ data, long long n,
                 const T* __restrict__ queries, int L, T inv_l,
                 const long long* __restrict__ offsets,
                 const int* __restrict__ qids, int B,
                 T* __restrict__ d2, T* __restrict__ mean,
                 T* __restrict__ stdv) {
  constexpr int ROWS = KVM_ED_WARPS / WPR;
  constexpr int T_ROW = 32 * WPR;  // threads of a row
  __shared__ T red[KVM_ED_WARPS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slot = warp / WPR;
  const int t = threadIdx.x - slot * T_ROW;
  const long long row = (long long)blockIdx.x * ROWS + slot;
  const bool live = row < B;
  const long long b = live ? row : (long long)B - 1;
  long long off = offsets[b];
  if (off > n - L) off = n - L;
  if (off < 0) off = 0;
  const float* __restrict__ x = data + off;
  const T* __restrict__ q = queries + (long long)qids[b] * L;

  if constexpr (!ZNORM) {
    T s = T(0);
#pragma unroll 16
    for (int j = t; j < L; j += T_ROW) {
      const T df = (T)__ldg(x + j) - __ldg(q + j);
      s = kvm_fma(df, df, s);
    }
    const T tot = row_sum<T, WPR>(s, red, warp, lane);
    if (live && t == 0) d2[b] = tot;
  } else {
    T s1 = T(0);
#pragma unroll 16
    for (int j = t; j < L; j += T_ROW) s1 += (T)__ldg(x + j);
    const T mu = kvm_over_l(row_sum<T, WPR>(s1, red, warp, lane), inv_l, L);
    T s2 = T(0);
    if constexpr (WPR == 8) {
      const int last =
          t < L ? t + ((L - 1 - t) / T_ROW) * T_ROW : t - T_ROW;
#pragma unroll 16
      for (int j = last; j >= t; j -= T_ROW) {
        const T c = (T)__ldg(x + j) - mu;
        s2 = kvm_fma(c, c, s2);
      }
    } else {
#pragma unroll 16
      for (int j = t; j < L; j += T_ROW) {
        const T c = (T)__ldg(x + j) - mu;
        s2 = kvm_fma(c, c, s2);
      }
    }
    const T var = kvm_over_l(row_sum<T, WPR>(s2, red, warp, lane), inv_l, L);
    const T sd = kvm_sqrt(var);
    const T inv = T(1) / (sd > T(0) ? sd : T(1));
    T s3 = T(0);
#pragma unroll 16
    for (int j = t; j < L; j += T_ROW) {
      const T z = ((T)__ldg(x + j) - mu) * inv - __ldg(q + j);
      s3 = kvm_fma(z, z, s3);
    }
    const T tot = row_sum<T, WPR>(s3, red, warp, lane);
    if (live && t == 0) {
      d2[b] = sd > T(0) ? tot : (T)INFINITY;
      mean[b] = mu;
      stdv[b] = sd;
    }
  }
}

template <int WPR>
static int launch(int znorm, const float* data, long long n,
                  const float* queries, int L, float inv_l,
                  const long long* offsets, const int* qids, int B, float* d2,
                  float* mean, float* stdv, cudaStream_t stream) {
  constexpr int ROWS = KVM_ED_WARPS / WPR;
  const unsigned grid = (unsigned)((B + ROWS - 1) / ROWS);
  if (znorm)
    window_ed_kernel<float, WPR, true><<<grid, KVM_ED_THREADS, 0, stream>>>(
        data, n, queries, L, inv_l, offsets, qids, B, d2, mean, stdv);
  else
    window_ed_kernel<float, WPR, false><<<grid, KVM_ED_THREADS, 0, stream>>>(
        data, n, queries, L, inv_l, offsets, qids, B, d2, mean, stdv);
  return (int)cudaGetLastError();
}

extern "C" int kvm_window_ed(const void* data, long long n,
                             const void* queries, int L, float inv_l,
                             const void* offsets, const void* qids, int B,
                             int znorm, void* d2, void* mean, void* stdv,
                             void* stream) {
  if (B <= 0 || L <= 0 || (long long)L > n) return (int)cudaErrorInvalidValue;
  const float* x = (const float*)data;
  const float* qs = (const float*)queries;
  const long long* off = (const long long*)offsets;
  const int* qi = (const int*)qids;
  float *o1 = (float*)d2, *o2 = (float*)mean, *o3 = (float*)stdv;
  cudaStream_t st = (cudaStream_t)stream;
  if (L <= 1024)
    return launch<1>(znorm, x, n, qs, L, inv_l, off, qi, B, o1, o2, o3, st);
  if (L <= 2048)
    return launch<2>(znorm, x, n, qs, L, inv_l, off, qi, B, o1, o2, o3, st);
  if (L <= 4096)
    return launch<4>(znorm, x, n, qs, L, inv_l, off, qi, B, o1, o2, o3, st);
  return launch<8>(znorm, x, n, qs, L, inv_l, off, qi, B, o1, o2, o3, st);
}

template <int WPR>
static int launch_f64(const float* data, long long n, const double* queries,
                      int L, const long long* offsets, const int* qids,
                      int B, double* d2, double* mean, double* stdv,
                      cudaStream_t stream) {
  constexpr int ROWS = KVM_ED_WARPS / WPR;
  const unsigned grid = (unsigned)((B + ROWS - 1) / ROWS);
  window_ed_kernel<double, WPR, true><<<grid, KVM_ED_THREADS, 0, stream>>>(
      data, n, queries, L, 0.0, offsets, qids, B, d2, mean, stdv);
  return (int)cudaGetLastError();
}

// (d2, mean, std) in f64, z-norm, of the f32 series' windows against f64
// z-normalised query rows; the rows as K2 takes them.
extern "C" int kvm_window_ed_f64(const void* data, long long n,
                                 const void* queries, int L,
                                 const void* offsets, const void* qids, int B,
                                 void* d2, void* mean, void* stdv,
                                 void* stream) {
  if (B <= 0 || L <= 0 || (long long)L > n) return (int)cudaErrorInvalidValue;
  const float* x = (const float*)data;
  const double* qs = (const double*)queries;
  const long long* off = (const long long*)offsets;
  const int* qi = (const int*)qids;
  double *o1 = (double*)d2, *o2 = (double*)mean, *o3 = (double*)stdv;
  cudaStream_t st = (cudaStream_t)stream;
  if (L <= 1024) return launch_f64<1>(x, n, qs, L, off, qi, B, o1, o2, o3, st);
  if (L <= 2048) return launch_f64<2>(x, n, qs, L, off, qi, B, o1, o2, o3, st);
  if (L <= 4096) return launch_f64<4>(x, n, qs, L, off, qi, B, o1, o2, o3, st);
  return launch_f64<8>(x, n, qs, L, off, qi, B, o1, o2, o3, st);
}
