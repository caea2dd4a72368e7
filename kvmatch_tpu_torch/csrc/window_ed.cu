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
// row (the query row stays in L1/L2 across rows of the same query) against
// 3 f32 ops per element -- far below the compute roofline.  Design: one
// 256-thread block per row, threads stride the window so a warp reads
// consecutive addresses, a shared-memory tree reduces the f32 partial sums.
// The z-norm variant is two-pass (mean, then centred sums) as in
// ops/ed.py:201-211; its second and third passes re-read the 32 KB window
// from L1/L2.  The TPU kernel's 1024-element DMA alignment and barrel realign
// (Mosaic constraints) are not carried over.

#include <cuda_runtime.h>
#include <math.h>

#define KVM_ED_THREADS 256

__device__ __forceinline__ float block_sum(float v, float* sh) {
  const int tid = threadIdx.x;
  sh[tid] = v;
  __syncthreads();
  for (int s = KVM_ED_THREADS / 2; s > 0; s >>= 1) {
    if (tid < s) sh[tid] = sh[tid] + sh[tid + s];
    __syncthreads();
  }
  const float r = sh[0];
  __syncthreads();
  return r;
}

__global__ void __launch_bounds__(KVM_ED_THREADS)
window_ed_kernel(const float* __restrict__ data, long long n,
                 const float* __restrict__ queries, int L, float inv_l,
                 const long long* __restrict__ offsets,
                 const int* __restrict__ qids, int znorm,
                 float* __restrict__ d2, float* __restrict__ mean,
                 float* __restrict__ stdv) {
  __shared__ float sh[KVM_ED_THREADS];
  const long long b = blockIdx.x;
  const int tid = threadIdx.x;
  long long off = offsets[b];
  if (off > n - L) off = n - L;
  if (off < 0) off = 0;
  const float* x = data + off;
  const float* q = queries + (long long)qids[b] * L;

  if (!znorm) {
    float s = 0.0f;
    for (int j = tid; j < L; j += KVM_ED_THREADS) {
      const float df = x[j] - q[j];
      s = s + df * df;
    }
    const float tot = block_sum(s, sh);
    if (tid == 0) d2[b] = tot;
    return;
  }

  float s1 = 0.0f;
  for (int j = tid; j < L; j += KVM_ED_THREADS) s1 = s1 + x[j];
  const float mu = block_sum(s1, sh) * inv_l;
  float s2 = 0.0f;
  for (int j = tid; j < L; j += KVM_ED_THREADS) {
    const float c = x[j] - mu;
    s2 = s2 + c * c;
  }
  const float var = block_sum(s2, sh) * inv_l;
  const float sd = sqrtf(var);
  const float safe = sd > 0.0f ? sd : 1.0f;
  float s3 = 0.0f;
  for (int j = tid; j < L; j += KVM_ED_THREADS) {
    const float z = (x[j] - mu) / safe - q[j];
    s3 = s3 + z * z;
  }
  const float tot = block_sum(s3, sh);
  if (tid == 0) {
    d2[b] = sd > 0.0f ? tot : INFINITY;
    mean[b] = mu;
    stdv[b] = sd;
  }
}

extern "C" int kvm_window_ed(const void* data, long long n,
                             const void* queries, int L, float inv_l,
                             const void* offsets, const void* qids, int B,
                             int znorm, void* d2, void* mean, void* stdv,
                             void* stream) {
  if (B <= 0 || L <= 0 || (long long)L > n) return (int)cudaErrorInvalidValue;
  window_ed_kernel<<<B, KVM_ED_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)data, n, (const float*)queries, L, inv_l,
      (const long long*)offsets, (const int*)qids, znorm, (float*)d2,
      (float*)mean, (float*)stdv);
  return (int)cudaGetLastError();
}
