// K1: dense phase-1 probe over the cached per-scale bucket stack.
//
// Replaces the Pallas TPU kernel kvmatch_tpu/ops/probe_pallas.py:_probe_kernel
// (entry probe_flags_tiles, driven by parallel/query.py:
// make_dense_probe_step_flags_pallas).  For every position p and query q it
// sums, over the query's plan segments, the lower bound
//     width * max(key_lo - mean_hi, mean_lo - key_hi, 0)^2      (RSM-ED)
// with key_lo = b*d - slack, key_hi = key_lo + d + 2*slack and b the bucket id
// of the segment's window, read at bstack[sidx, p + (order-1)*unit]; the cNSM
// variant takes the bound in z-space under alpha/beta and carries the Ex/Ex2
// std-filter tracks, setting the bound to +inf when the filter rejects.  Out:
// one flag per 128 positions (acc <= eps^2 and p < m) and exact per-query
// counts.
//
// Arithmetic is f32, op for op as the plain versions
// kvmatch_tpu_torch/parallel/query.py:_dense_probe/_dense_probe_norm (which
// mirror the JAX package's), built with --fmad=false so no multiply-add is
// contracted: flags and counts equal the plain version bit for bit, and the
// probe_guard slack that makes phase 1 sound is unchanged.
//
// What bounds it on an H100: the bucket reads.  Each (query, segment) reads
// one int32 per position from a 4*S*n-byte stack (2 GB at n=1e8), i.e.
// Q*S_SEG*4 bytes per position (8*30*4 = 960 B at the bench shape) against
// ~20 f32 ops per read; most of the stack re-reads hit L2 for neighbouring
// segments of one scale.  Design: one thread per position and 128 threads per
// block (a block is one flag for every query), so neighbouring threads read
// neighbouring addresses; the segment tables, eps^2 and the constraint rows
// sit in shared memory; flags and counts come from __syncthreads_or /
// __syncthreads_count and one int32 atomicAdd per block and query, which is
// exact and independent of block order.  The TPU kernel's VMEM staging and
// lane rotates (Mosaic constraints) have no counterpart here.

#include <cuda_runtime.h>
#include <math.h>

#define KVM_FLAG 128
#define KVM_MAX_Q 32
#define KVM_MAX_SEG 30

__global__ void __launch_bounds__(KVM_FLAG)
probe_flags_kernel(const int* __restrict__ bstack, long long stride,
                   long long col0,
                   const int* __restrict__ sidx, const int* __restrict__ order,
                   const int* __restrict__ valid,
                   const float* __restrict__ mlo, const float* __restrict__ mhi,
                   const float* __restrict__ width,
                   const float* __restrict__ eps2, const float* __restrict__ cons,
                   int Q, int S_SEG, long long p0, long long m, int unit,
                   float d, float slack, int qlen, int norm,
                   unsigned char* __restrict__ flags, long long fstride,
                   int* __restrict__ counts) {
  __shared__ long long s_off[KVM_MAX_Q * KVM_MAX_SEG];
  __shared__ int s_valid[KVM_MAX_Q * KVM_MAX_SEG];
  __shared__ float s_mlo[KVM_MAX_Q * KVM_MAX_SEG];
  __shared__ float s_mhi[KVM_MAX_Q * KVM_MAX_SEG];
  __shared__ float s_w[KVM_MAX_Q * KVM_MAX_SEG];
  __shared__ float s_eps2[KVM_MAX_Q];
  __shared__ float s_cons[KVM_MAX_Q * 4];

  const int tid = threadIdx.x;
  for (int i = tid; i < Q * S_SEG; i += KVM_FLAG) {
    s_off[i] = (long long)sidx[i] * stride + (long long)(order[i] - 1) * unit
               - col0;
    s_valid[i] = valid[i];
    s_mlo[i] = mlo[i];
    s_mhi[i] = mhi[i];
    s_w[i] = width[i];
  }
  for (int i = tid; i < Q; i += KVM_FLAG) s_eps2[i] = eps2[i];
  for (int i = tid; i < Q * 4; i += KVM_FLAG) s_cons[i] = cons[i];
  __syncthreads();

  const long long p = p0 + (long long)blockIdx.x * KVM_FLAG + tid;
  const bool live = p < m;
  const float slack2 = 2.0f * slack;
  const float unitf = (float)unit;
  const float qlenf = (float)qlen;
  const long long fcol = p0 / KVM_FLAG + blockIdx.x;

  for (int q = 0; q < Q; ++q) {
    float acc = 0.0f;
    if (live) {
      const int base = q * S_SEG;
      if (!norm) {
        for (int s = 0; s < S_SEG; ++s) {
          if (!s_valid[base + s]) continue;
          const float b = (float)bstack[p + s_off[base + s]];
          const float key_lo = b * d - slack;
          const float key_hi = key_lo + d + slack2;
          const float delta = fmaxf(fmaxf(key_lo - s_mhi[base + s],
                                          s_mlo[base + s] - key_hi), 0.0f);
          acc = acc + s_w[base + s] * delta * delta;
        }
      } else {
        const float alpha = s_cons[4 * q + 0];
        const float beta = s_cons[4 * q + 1];
        const float mu_q = s_cons[4 * q + 2];
        const float sd_q = s_cons[4 * q + 3];
        const float s_small = sd_q / alpha;
        const float s_big = alpha * sd_q;
        const float inv_big = 1.0f / s_big;
        const float inv_small = 1.0f / s_small;
        const float inv_sd = 1.0f / sd_q;
        const float mub = mu_q + beta;
        const float mmb = mu_q - beta;
        float exlo = 0.0f, exup = 0.0f, ex2lo = 0.0f, punits = 0.0f;
        for (int s = 0; s < S_SEG; ++s) {
          if (!s_valid[base + s]) continue;
          const float w = s_w[base + s];
          const float b = (float)bstack[p + s_off[base + s]];
          const float key_lo = b * d - slack;
          const float key_hi = key_lo + d + slack2;
          const float n_lo = key_lo - mub;
          const float n_hi = key_hi - mmb;
          const float z_lo = n_lo >= 0.0f ? n_lo * inv_big : n_lo * inv_small;
          const float z_hi = n_hi >= 0.0f ? n_hi * inv_small : n_hi * inv_big;
          const float zq_lo = (s_mlo[base + s] - mu_q) * inv_sd;
          const float zq_hi = (s_mhi[base + s] - mu_q) * inv_sd;
          const float delta = fmaxf(fmaxf(z_lo - zq_hi, zq_lo - z_hi), 0.0f);
          const float k_units = w / unitf;
          acc = acc + w * delta * delta;
          exlo = exlo + key_lo * k_units;
          exup = exup + key_hi * k_units;
          const float sq = key_lo > 0.0f ? key_lo * key_lo
                           : (key_hi < 0.0f ? key_hi * key_hi : 0.0f);
          ex2lo = ex2lo + sq * k_units;
          punits = punits + k_units;
        }
        // Derived-sigma filter (engine/norm_ed.py _std_filter), as the plain
        // version's epilogue.
        punits = fmaxf(punits, 1.0f);
        const float rest = qlenf - punits * unitf;
        const float as = alpha * sd_q;
        const float limit = as * as + 1e-6f;
        const float mean_lo = exlo / punits;
        const float mean_up = exup / punits;
        const bool over = mean_lo > mub;
        const bool under = mean_up < mmb;
        const float rest_s = fmaxf(rest, 1.0f);
        const float nv_o = mub - (mean_lo - mub) * punits * unitf / rest_s;
        const float var_o = (ex2lo * unitf + rest * nv_o * nv_o) / qlenf
                            - mub * mub;
        const float nv_u = mmb + (mmb - mean_up) * punits * unitf / rest_s;
        const float var_u = (ex2lo * unitf + rest * nv_u * nv_u) / qlenf
                            - mmb * mmb;
        bool bad;
        if (rest > 0.0f) {
          bad = (over && var_o > limit) || (under && var_u > limit);
        } else if (over) {
          const float t = mean_lo - mub;
          bad = t * t > limit;
        } else if (under) {
          const float t = mmb - mean_up;
          bad = t * t > limit;
        } else {
          bad = false;
        }
        if (bad) acc = INFINITY;
      }
    }
    const int mask = (live && acc <= s_eps2[q]) ? 1 : 0;
    const int any = __syncthreads_or(mask);
    const int cnt = __syncthreads_count(mask);
    if (tid == 0) {
      flags[q * fstride + fcol] = any ? 1 : 0;
      if (cnt) atomicAdd(counts + q, cnt);
    }
  }
}

extern "C" int kvm_probe_flags(const void* bstack, long long stride,
                               long long col0, const void* sidx,
                               const void* order, const void* valid,
                               const void* mlo, const void* mhi,
                               const void* width, const void* eps2,
                               const void* cons, int Q, int S_SEG,
                               long long p0, long long npos, long long m,
                               int unit, float d, float slack, int qlen,
                               int norm, void* flags, long long fstride,
                               void* counts, void* stream) {
  if (Q < 1 || Q > KVM_MAX_Q || S_SEG < 1 || S_SEG > KVM_MAX_SEG ||
      npos <= 0 || npos % KVM_FLAG || p0 % KVM_FLAG) {
    return (int)cudaErrorInvalidValue;
  }
  const long long blocks = npos / KVM_FLAG;
  probe_flags_kernel<<<(unsigned int)blocks, KVM_FLAG, 0,
                       (cudaStream_t)stream>>>(
      (const int*)bstack, stride, col0, (const int*)sidx, (const int*)order,
      (const int*)valid, (const float*)mlo, (const float*)mhi,
      (const float*)width, (const float*)eps2, (const float*)cons, Q, S_SEG,
      p0, m, unit, d, slack, qlen, norm, (unsigned char*)flags, fstride,
      (int*)counts);
  return (int)cudaGetLastError();
}
