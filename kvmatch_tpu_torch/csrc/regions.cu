// NEAR: the region route's z-normalised near-set (phase 2 of cNSM-ED), as
// three passes around the two cuFFT transforms that
// kvmatch_tpu_torch/ops/regions.py:region_znorm_near_multi runs with
// torch.fft:
//
//   kvm_region_rows   stage each region row x' = x - x[0] (f64, rounded to
//                     f32) into a zero-padded (B, N) buffer, N = next_pow2(R);
//   (torch.fft.rfft of the rows; of the Q flipped queries once a call)
//   kvm_spectrum_mul  X[b] *= Qf[qid[b]] in place, reading qid in the kernel;
//   (torch.fft.irfft: the correlation)
//   kvm_region_near   one block a row: the width-L window sums of x' and x'^2
//                     in f64, mean, std, d2, its error bound, the guarded
//                     alpha/beta constraint, the [vfrom, vto) window and the
//                     threshold test, and the compaction of the (row, column)
//                     pairs that pass.
//
// Replaces no TPU kernel: the JAX package computes the near-set in XLA
// (kvmatch_tpu/ops/regions.py:242, region_znorm_near_multi).  It replaces the
// port's torch chain (ops/regions.py:region_znorm_near_plain, kept as the
// plain version), about 70 launches a chunk over (B, R) and (B, M) f64 and
// f32 temporaries: an int64 gather index, an f64 copy of each row, one query
// spectrum per row, two f64 cumsums, two pads and differences, some 30
// elementwise ops and a nonzero with its read-back.
//
// What bounds it on an H100: device-memory bytes.  A row needs its R points
// read to stage it (4R) and written as N f32 (4N), the two transforms' reads
// and writes (about 4N each way, each), and the near pass's read of the row
// and of the M correlations (4R + 4M; the row's second read, by the walk,
// mostly hits L2).  The near pass's own work is f64: four block scans a
// window (one thread a window), two f64 divisions and a square root; on the
// card it ran at 14% of its bytes' time at M = 4096 (PERF.md), most likely
// held by the scans' f64 shuffles and adds (not profiled); scanning several
// windows a thread is the next step.
//
// Arithmetic.  The staged values, the window statistics and every f32 step
// after them are the plain version's operations in its order (built with
// --fmad=false, so nothing is contracted); the constant factors come from the
// wrapper rounded to f32, as torch rounds a Python scalar.  Two things differ:
// * the f64 window sums are taken in another order than torch.cumsum (below),
//   so a window's f64 mean and variance may differ in their last bits, and its
//   f32 mean or std by an ulp;
// * the complex product may round differently than torch's (whose build may
//   contract it into multiply-adds).  Both move d2 by a few f32 ulps, inside
//   FFT_ERR_C and ERR_C; a window within a few ulps of a limit can fall on the
//   other side of it.  The transforms, the rounding of x' to f32 and the
//   query spectra are the plain version's (the irfft's 1/N is moved onto the
//   query spectra, which scales both exactly by a power of two).
//
// The window sums and the error bound err.  Window i of a row sums points
// [i, i + L); with P(k) = sum_{j<k} t_j (t = x' or x'^2), s(i) = P(i + L) -
// P(i).  The block walks the row in tiles of T = RN_THREADS windows with two
// cursors L apart: the trail cursor reads points [t0, t0 + T), the lead
// cursor [L + t0, L + t0 + T), each by a block scan (a warp shuffle scan,
// then the preceding warps' totals added one by one) on top of a carried
// prefix (the trail's from 0, the lead's from the first L points' sum, a
// block reduction).  No tile is held beyond its step, so any L and M work in
// a few hundred bytes of shared memory.
// Each term reaches P(k) through at most d roundings: the lead's
//   d_lead  <= ceil(L/T) + 12            (the reduction of the first L)
//            + ceil(M/T) + 14            (the tiles' carries and a tile scan)
// and the trail's d_trail <= ceil(M/T) + 14.  So, to first order in
// u = 2^-53, |s - s_exact| <= D u sum_j |t_j| over the row, D = d_lead +
// d_trail + 1, whatever the order; sum t_j^2 = P_row (the row's P) and, by
// Cauchy-Schwarz, sum |x'_j| <= sqrt(R P_row).  With the mean m = s1/L,
// |m| <= sqrt(P_row / L), and var = s2/L - m^2:
//   L |var - var_exact| <= D u P_row (1 + 2 sqrt(R / L)) + 8 u P_row,
// the 8 u P_row the divisions, the square and the subtraction.  The bound
// err of ops/regions.py:region_znorm_distances_multi takes
// 2 L |var - var_exact| / sigma^2 <= SUM_ERR_C R P_row / sigma^2 with
// SUM_ERR_C = 4 u, which holds here when
//   D (1 + 2 sqrt(R / L)) + 8 <= 2 R,
// a condition on (L, M) alone that the wrapper checks before each launch
// (ops/regions.py:near_sums_within_err, which counts 2 roundings more a
// cursor): it holds for every L >= 25 with M = 512 or M = next_pow2(L),
// every region the engines plan.  err itself, and the guarded threshold,
// are the plain version's, unchanged.
//
// Compaction: each warp ballots its hits, one lane adds their number to the
// count with one atomicAdd, and each hit writes (row, column) to its slot if
// the slot is under near_k.  The count keeps counting past near_k, so the
// caller sees an overflow; the pairs come in no particular order.

#include <cuda_runtime.h>
#include <math.h>

#define RR_THREADS 256
#define RR_PER 4    // elements a thread of the staging pass
#define SM_THREADS 256
#define SM_PER 4    // spectrum bins a thread of the product
#define RN_THREADS 256
#define RN_WARPS (RN_THREADS / 32)

// The first point of region row b: its start clamped to [0, max(n - R, 0)],
// as ops/ed.py:_gather clamps it; point k of the row is data[min(off + k,
// n - 1)] (a row longer than the series repeats the last point).
__device__ __forceinline__ long long row_origin(long long start, long long n,
                                                long long R) {
  const long long hi = n - R > 0 ? n - R : 0;
  return start < 0 ? 0 : (start > hi ? hi : start);
}

// Rows with vto <= vfrom (the padding rows of a chunk) hold no window.
__device__ __forceinline__ bool padding_row(const long long* vfrom,
                                            const long long* vto, int b) {
  return vto[b] <= vfrom[b];
}

__global__ void __launch_bounds__(RR_THREADS)
region_rows_kernel(const float* __restrict__ data, long long n,
                   const long long* __restrict__ starts,
                   const long long* __restrict__ vfrom,
                   const long long* __restrict__ vto, int R, int N,
                   float* __restrict__ out, int* __restrict__ count) {
  const int b = blockIdx.x;
  if (b == 0 && blockIdx.y == 0 && threadIdx.x == 0) *count = 0;
  float* row = out + (long long)b * N;
  const int k0 = blockIdx.y * (RR_THREADS * RR_PER) + threadIdx.x;
  if (padding_row(vfrom, vto, b)) {
#pragma unroll
    for (int e = 0; e < RR_PER; ++e) {
      const int k = k0 + e * RR_THREADS;
      if (k < N) row[k] = 0.0f;
    }
    return;
  }
  const long long off = row_origin(starts[b], n, R);
  const double c = (double)data[off];
#pragma unroll
  for (int e = 0; e < RR_PER; ++e) {
    const int k = k0 + e * RR_THREADS;
    if (k >= N) break;
    float v = 0.0f;
    if (k < R) {
      const long long i = off + k < n ? off + k : n - 1;
      v = (float)((double)data[i] - c);  // x.double() - c, then .float()
    }
    row[k] = v;
  }
}

__global__ void __launch_bounds__(SM_THREADS)
spectrum_mul_kernel(float2* __restrict__ X, const float2* __restrict__ Qf,
                    const int* __restrict__ qids,
                    const long long* __restrict__ vfrom,
                    const long long* __restrict__ vto, int H) {
  const int b = blockIdx.x;
  if (padding_row(vfrom, vto, b)) return;
  float2* x = X + (long long)b * H;
  const float2* q = Qf + (long long)qids[b] * H;
  const int j0 = blockIdx.y * (SM_THREADS * SM_PER) + threadIdx.x;
#pragma unroll
  for (int e = 0; e < SM_PER; ++e) {
    const int j = j0 + e * SM_THREADS;
    if (j >= H) break;
    const float2 a = x[j];
    const float2 w = q[j];
    x[j] = make_float2(a.x * w.x - a.y * w.y, a.x * w.y + a.y * w.x);
  }
}

// Sum of v over the block, in every thread: a warp's shuffle tree, then the
// warps' sums added one by one.  ``sh`` holds RN_WARPS doubles.
__device__ __forceinline__ double block_sum(double v, double* sh) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  double s = sh[0];
#pragma unroll
  for (int w = 1; w < RN_WARPS; ++w) s += sh[w];
  __syncthreads();
  return s;
}

// Exclusive block scans of four values a thread: ``ex[k]`` is the sum of
// ``v[k]`` over the threads before this one, ``tot[k]`` over the block.
// ``sh`` holds 4 x RN_WARPS doubles.
__device__ __forceinline__ void block_scan4(const double v[4], double ex[4],
                                            double tot[4],
                                            double (*sh)[RN_WARPS]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  double inc[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) inc[k] = v[k];
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const double y = __shfl_up_sync(0xffffffffu, inc[k], o);
      if (lane >= o) inc[k] += y;
    }
  }
  if (lane == 31) {
#pragma unroll
    for (int k = 0; k < 4; ++k) sh[k][warp] = inc[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const double prev = __shfl_up_sync(0xffffffffu, inc[k], 1);
    double before = 0.0;
    for (int w = 0; w < warp; ++w) before += sh[k][w];
    ex[k] = lane ? before + prev : before;
    double t = sh[k][0];
#pragma unroll
    for (int w = 1; w < RN_WARPS; ++w) t += sh[k][w];
    tot[k] = t;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(RN_THREADS)
region_near_kernel(const float* __restrict__ data, long long n,
                   const long long* __restrict__ starts,
                   const int* __restrict__ qids,
                   const long long* __restrict__ vfrom,
                   const long long* __restrict__ vto,
                   const float* __restrict__ corr, int N,
                   const float* __restrict__ thresh,
                   const float* __restrict__ cons, int L, int M, float two_l,
                   float k_fft, float k_sum, float k_err, int near_k,
                   int* __restrict__ out) {
  __shared__ double sh_scan[4][RN_WARPS];
  __shared__ double sh_sum[RN_WARPS];
  const int b = blockIdx.x;
  if (padding_row(vfrom, vto, b)) return;
  const long long vf = vfrom[b];
  const long long vt = vto[b] < M ? vto[b] : M;
  const int R = M + L - 1;
  const long long off = row_origin(starts[b], n, R);
  const float* x = data + off;
  const long long last = n - 1 - off;
  const double c = (double)x[0];
  double a1 = 0.0, a2 = 0.0, p = 0.0;
  for (int k = threadIdx.x; k < R; k += RN_THREADS) {
    const double v = (double)x[k < last ? k : last] - c;
    const double v2 = v * v;
    if (k < L) {
      a1 += v;
      a2 += v2;
    }
    p += v2;
  }
  double cl1 = block_sum(a1, sh_sum);
  double cl2 = block_sum(a2, sh_sum);
  const double prow = block_sum(p, sh_sum);
  const int q = qids[b];
  const float alpha = cons[5 * q + 0];
  const float beta = cons[5 * q + 1];
  const float mu_q = cons[5 * q + 2];
  const float sd_q = cons[5 * q + 3];
  const float cg = cons[5 * q + 4];
  const float mean_hi = beta + cg;
  const float ratio_hi = alpha + cg;
  const float ratio_lo = 1.0f / alpha - cg;
  const float th = thresh[q];
  const float row_sq = (float)prow;
  const float t_fft = k_fft * sqrtf(row_sq);
  const float t_sum = k_sum * row_sq;
  const double dl = (double)L;
  const float* crow = corr + (long long)b * N + (L - 1);
  const int lane = threadIdx.x & 31;
  double ct1 = 0.0, ct2 = 0.0;
  for (int t0 = 0; t0 < vt; t0 += RN_THREADS) {
    const int i = t0 + threadIdx.x;
    double v[4] = {0.0, 0.0, 0.0, 0.0};
    if (i < M) {
      const double tv = (double)x[i < last ? i : last] - c;
      v[0] = tv;
      v[1] = tv * tv;
      if (L + i < R) {
        const long long k = L + i;
        const double lv = (double)x[k < last ? k : last] - c;
        v[2] = lv;
        v[3] = lv * lv;
      }
    }
    double ex[4], tot[4];
    block_scan4(v, ex, tot, sh_scan);
    bool hit = false;
    if (i >= vf && i < vt) {
      const double s1 = (cl1 + ex[2]) - (ct1 + ex[0]);
      const double s2 = (cl2 + ex[3]) - (ct2 + ex[1]);
      const double mean = s1 / dl;
      double var = s2 / dl - mean * mean;
      var = var < 0.0 ? 0.0 : var;  // clamp_min(var, 0); NaN stays
      const float sd = (float)sqrt(var);
      const float mu = (float)(mean + c);
      const float safe = sd > 0.0f ? sd : 1.0f;
      float d2 = two_l - (2.0f * crow[i]) / safe;
      d2 = d2 < 0.0f ? 0.0f : d2;
      if (!(sd > 0.0f)) d2 = INFINITY;
      const float err = (t_fft + t_sum / safe) / safe + k_err;
      const float ratio = sd / sd_q;
      hit = fabsf(mu - mu_q) <= mean_hi && ratio <= ratio_hi &&
            ratio >= ratio_lo && sd > 0.0f && d2 <= th + err;
    }
    const unsigned m = __ballot_sync(0xffffffffu, hit);
    if (m) {
      int base = 0;
      if (lane == 0) base = atomicAdd(out, __popc(m));
      base = __shfl_sync(0xffffffffu, base, 0);
      if (hit) {
        const int slot = base + __popc(m & ((1u << lane) - 1u));
        if (slot < near_k) {
          out[1 + slot] = b;
          out[1 + near_k + slot] = i;
        }
      }
    }
    ct1 += tot[0];
    ct2 += tot[1];
    cl1 += tot[2];
    cl2 += tot[3];
  }
}

extern "C" int kvm_region_rows(const void* data, long long n,
                               const void* starts, const void* vfrom,
                               const void* vto, int B, int R, int N,
                               void* rows, void* count, void* stream) {
  if (B < 1 || R < 1 || N < R || n < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid(B, (N + RR_THREADS * RR_PER - 1) / (RR_THREADS * RR_PER));
  region_rows_kernel<<<grid, RR_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)data, n, (const long long*)starts,
      (const long long*)vfrom, (const long long*)vto, R, N, (float*)rows,
      (int*)count);
  return (int)cudaGetLastError();
}

extern "C" int kvm_spectrum_mul(void* spec, const void* qspec,
                                const void* qids, const void* vfrom,
                                const void* vto, int B, int H, void* stream) {
  if (B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid(B, (H + SM_THREADS * SM_PER - 1) / (SM_THREADS * SM_PER));
  spectrum_mul_kernel<<<grid, SM_THREADS, 0, (cudaStream_t)stream>>>(
      (float2*)spec, (const float2*)qspec, (const int*)qids,
      (const long long*)vfrom, (const long long*)vto, H);
  return (int)cudaGetLastError();
}

extern "C" int kvm_region_near(const void* data, long long n,
                               const void* starts, const void* qids,
                               const void* vfrom, const void* vto,
                               const void* corr, int B, int N,
                               const void* thresh, const void* cons, int L,
                               int M, float two_l, float k_fft, float k_sum,
                               float k_err, int near_k, void* out,
                               void* stream) {
  if (B < 1 || L < 1 || M < 1 || N < M + L - 1 || near_k < 1 || n < 1) {
    return (int)cudaErrorInvalidValue;
  }
  region_near_kernel<<<B, RN_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)data, n, (const long long*)starts, (const int*)qids,
      (const long long*)vfrom, (const long long*)vto, (const float*)corr, N,
      (const float*)thresh, (const float*)cons, L, M, two_l, k_fft, k_sum,
      k_err, near_k, (int*)out);
  return (int)cudaGetLastError();
}
