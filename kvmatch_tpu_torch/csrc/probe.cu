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
// What bounds it on an H100: instruction throughput.  A (position, query,
// segment) term is one int32 read and about 20 (cNSM) or 12 (RSM) f32
// operations; the reads mostly hit L2 (the segment shifts, up to L
// positions, fall inside the window of blocks in flight), and the 2 GB
// stack at n = 1e8 is 0.6 ms of device memory.  The first design (one
// position per thread, 128-thread blocks, per-term recomputation of the
// segment's constants, two block barriers per query) spent about 52
// instructions a term.  This design:
// * Each block first compacts every query's valid segments (they keep
//   their order) and hoists the per-(query, segment) constants into shared
//   memory: the 64-bit stack offset, zq_lo, zq_hi, the width and
//   k_units = w / unit, each the plain version's f32 operation, and the
//   per-query constants of the bound and of the sigma filter.  The term
//   loop runs to the query's k segments with no validity branch.
// * A thread holds K1_P = 8 positions (register blocking): one warp covers
//   256 consecutive positions, two flags, with each read of a table entry
//   serving 8 positions and each bucket load coalesced (32 lanes, 128 B).
//   A block walks K1_TILES tiles of 2048 positions, so the table prologue
//   and its barrier are paid once per 8192 positions.
// * Early exit: every term is >= 0, so a position whose running bound
//   exceeds eps^2 is settled (f32 rounding is monotone); a warp leaves the
//   segment loop as soon as none of its positions is still <= eps^2.  The
//   work then follows the data: what a run needs is the number of
//   (position, segment) terms still open when each is reached
//   (ops/probe.py:probe_work).
// * cNSM: the Ex/Ex2 tracks feed only the sigma filter of positions whose
//   bound stays <= eps^2, so the bound runs first and the tracks are
//   summed in a second pass over the segments (the same f32 operations in
//   the same order) only by warps that hold such a position.
// * Flags and counts per warp: __any_sync / __reduce_add_sync, one flag
//   byte per (query, 128 positions) by lane 0, a shared-memory count per
//   query and one int32 atomicAdd per block and query at the end -- exact
//   and independent of block order.
// What is left (PERF.md): about 24 instructions a cNSM term in the segment
// loop, and a warp runs on while any of its 256 positions is open.

#include <cuda_runtime.h>
#include <math.h>

#define KVM_FLAG 128
#define KVM_MAX_Q 32
#define KVM_MAX_SEG 30
#define K1_THREADS 256
#define K1_P 8                         // positions per thread
#define K1_TILE (K1_THREADS * K1_P)    // positions per block step
#define K1_TILES 4                     // block steps per block

// Per-query constants, f32 as in the plain version.
struct K1Query {
  float eps2, mub, mmb, inv_big, inv_small;  // bound (cNSM: z-space)
  float punits, rest, rest_s, limit;         // derived-sigma filter
  int k;                                     // valid segments
  int inf_ok;                                // +inf <= eps2
};

// The std-filter verdict of one position (engine/norm_ed.py _std_filter),
// as the plain version's epilogue.
__device__ __forceinline__ bool k1_bad(const K1Query& c, float exlo,
                                       float exup, float ex2lo, float unitf,
                                       float qlenf) {
  const float mean_lo = exlo / c.punits;
  const float mean_up = exup / c.punits;
  const bool over = mean_lo > c.mub;
  const bool under = mean_up < c.mmb;
  if (c.rest > 0.0f) {
    if (over) {
      const float nv = c.mub - (mean_lo - c.mub) * c.punits * unitf / c.rest_s;
      const float var = (ex2lo * unitf + c.rest * nv * nv) / qlenf
                        - c.mub * c.mub;
      if (var > c.limit) return true;
    }
    if (under) {
      const float nv = c.mmb + (c.mmb - mean_up) * c.punits * unitf / c.rest_s;
      const float var = (ex2lo * unitf + c.rest * nv * nv) / qlenf
                        - c.mmb * c.mmb;
      if (var > c.limit) return true;
    }
    return false;
  }
  if (over) {
    const float t = mean_lo - c.mub;
    return t * t > c.limit;
  }
  if (under) {
    const float t = c.mmb - mean_up;
    return t * t > c.limit;
  }
  return false;
}

// One query over a warp's 8 x 32 positions: returns the mask bits (bit j:
// position tb + 32 j of this lane).  FULL: every position is live, so the
// loads need no predicate.
template <bool NORM, bool FULL>
__device__ __forceinline__ unsigned k1_query(
    const int* __restrict__ tb, unsigned live, const long long* off,
    const float4* tab, const K1Query& c, float d, float slack, float slack2,
    float unitf, float qlenf) {
  float acc[K1_P];
#pragma unroll
  for (int j = 0; j < K1_P; ++j)
    acc[j] = (FULL || (live >> j & 1u)) ? 0.0f : INFINITY;
  for (int t = 0; t < c.k; ++t) {
    float lo = acc[0];
#pragma unroll
    for (int j = 1; j < K1_P; ++j) lo = fminf(lo, acc[j]);
    if (!__any_sync(0xffffffffu, lo <= c.eps2)) break;  // all settled
    const int* row = tb + off[t];
    const float4 e = tab[t];  // raw: mlo, mhi, w; cNSM: zq_lo, zq_hi, w, ku
#pragma unroll
    for (int j = 0; j < K1_P; ++j) {
      const int bi = (FULL || (live >> j & 1u)) ? row[32 * j] : 0;
      const float b = (float)bi;
      const float key_lo = b * d - slack;
      const float key_hi = key_lo + d + slack2;
      float delta;
      if (NORM) {
        const float n_lo = key_lo - c.mub;
        const float n_hi = key_hi - c.mmb;
        // where(n >= 0, n * inv_a, n * inv_b): one product of the picked
        // factor, the same bits.
        const float z_lo = n_lo * (n_lo >= 0.0f ? c.inv_big : c.inv_small);
        const float z_hi = n_hi * (n_hi >= 0.0f ? c.inv_small : c.inv_big);
        delta = fmaxf(fmaxf(z_lo - e.y, e.x - z_hi), 0.0f);
      } else {
        delta = fmaxf(fmaxf(key_lo - e.y, e.x - key_hi), 0.0f);
      }
      acc[j] = acc[j] + e.z * delta * delta;
    }
  }
  unsigned bits = 0;
  if (!NORM) {
#pragma unroll
    for (int j = 0; j < K1_P; ++j)
      if ((live >> j & 1u) && acc[j] <= c.eps2) bits |= 1u << j;
    return bits;
  }
  // cNSM: the sigma filter for positions still in, over a second pass.
  unsigned open = 0;
#pragma unroll
  for (int j = 0; j < K1_P; ++j)
    if ((live >> j & 1u) && (acc[j] <= c.eps2 || c.inf_ok)) open |= 1u << j;
  if (!__any_sync(0xffffffffu, open != 0)) return 0;
  float exlo[K1_P], exup[K1_P], ex2lo[K1_P];
#pragma unroll
  for (int j = 0; j < K1_P; ++j) exlo[j] = exup[j] = ex2lo[j] = 0.0f;
  for (int t = 0; t < c.k; ++t) {
    const int* row = tb + off[t];
    const float ku = tab[t].w;
#pragma unroll
    for (int j = 0; j < K1_P; ++j) {
      const int bi = (FULL || (live >> j & 1u)) ? row[32 * j] : 0;
      const float b = (float)bi;
      const float key_lo = b * d - slack;
      const float key_hi = key_lo + d + slack2;
      exlo[j] = exlo[j] + key_lo * ku;
      exup[j] = exup[j] + key_hi * ku;
      // where(key_lo > 0, key_lo^2, where(key_hi < 0, key_hi^2, 0))
      const float sk = key_lo > 0.0f ? key_lo
                       : (key_hi < 0.0f ? key_hi : 0.0f);
      ex2lo[j] = ex2lo[j] + sk * sk * ku;
    }
  }
#pragma unroll
  for (int j = 0; j < K1_P; ++j) {
    if (!(open >> j & 1u)) continue;
    const bool bad = k1_bad(c, exlo[j], exup[j], ex2lo[j], unitf, qlenf);
    if (bad ? c.inf_ok : acc[j] <= c.eps2) bits |= 1u << j;
  }
  return bits;
}

template <bool NORM>
__global__ void __launch_bounds__(K1_THREADS)
probe_flags_kernel(const int* __restrict__ bstack, long long stride,
                   long long col0,
                   const int* __restrict__ sidx, const int* __restrict__ order,
                   const int* __restrict__ valid,
                   const float* __restrict__ mlo, const float* __restrict__ mhi,
                   const float* __restrict__ width,
                   const float* __restrict__ eps2, const float* __restrict__ cons,
                   int Q, int S_SEG, long long p0, long long end, long long m,
                   int unit, float d, float slack, int qlen,
                   unsigned char* __restrict__ flags, long long fstride,
                   int* __restrict__ counts) {
  __shared__ long long s_off[KVM_MAX_Q * KVM_MAX_SEG];
  __shared__ float4 s_tab[KVM_MAX_Q * KVM_MAX_SEG];
  __shared__ K1Query s_q[KVM_MAX_Q];
  __shared__ int s_cnt[KVM_MAX_Q];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float unitf = (float)unit;
  const float qlenf = (float)qlen;
  const float slack2 = 2.0f * slack;

  // Prologue: one warp per query, one lane per segment.  A valid segment
  // goes to slot (number of valid segments before it): the first k slots
  // hold the query's valid segments in their order.
  for (int q = warp; q < Q; q += K1_THREADS / 32) {
    const int i = q * S_SEG + lane;
    const bool v = lane < S_SEG && valid[i] != 0;
    const unsigned vb = __ballot_sync(0xffffffffu, v);
    float mu_q = 0.0f, inv_sd = 0.0f;
    K1Query c;
    c.eps2 = eps2[q];
    c.inf_ok = INFINITY <= c.eps2;
    c.k = __popc(vb);
    if (NORM) {
      const float alpha = cons[4 * q + 0];
      const float beta = cons[4 * q + 1];
      const float sd_q = cons[4 * q + 3];
      mu_q = cons[4 * q + 2];
      const float s_small = sd_q / alpha;
      const float s_big = alpha * sd_q;
      c.inv_big = 1.0f / s_big;
      c.inv_small = 1.0f / s_small;
      inv_sd = 1.0f / sd_q;
      c.mub = mu_q + beta;
      c.mmb = mu_q - beta;
      const float as = alpha * sd_q;
      c.limit = as * as + 1e-6f;
    } else {
      c.mub = c.mmb = c.inv_big = c.inv_small = c.limit = 0.0f;
    }
    const int slot = q * KVM_MAX_SEG + __popc(vb & ((1u << lane) - 1u));
    if (v) {
      // Offset of the segment's entry from column p - col0 of row 0.
      s_off[slot] = (long long)sidx[i] * stride
                    + (long long)(order[i] - 1) * unit;
      const float w = width[i];
      const float ku = w / unitf;
      s_tab[slot] = NORM ? make_float4((mlo[i] - mu_q) * inv_sd,
                                       (mhi[i] - mu_q) * inv_sd, w, ku)
                         : make_float4(mlo[i], mhi[i], w, ku);
    }
    __syncwarp();
    if (lane == 0) {
      // punits: sum of k_units over the valid segments in order, then the
      // filter's per-query terms (parallel/query.py:_dense_probe_norm).
      float pu = 0.0f;
      for (int t = 0; t < c.k; ++t) pu = pu + s_tab[q * KVM_MAX_SEG + t].w;
      c.punits = fmaxf(pu, 1.0f);
      c.rest = qlenf - c.punits * unitf;
      c.rest_s = fmaxf(c.rest, 1.0f);
      s_q[q] = c;
      s_cnt[q] = 0;
    }
  }
  __syncthreads();

  const long long lim = m < end ? m : end;  // live positions: p < lim
  const long long blk0 = p0 + (long long)blockIdx.x * (K1_TILE * K1_TILES);
  for (int tile = 0; tile < K1_TILES; ++tile) {
    const long long wp0 = blk0 + (long long)tile * K1_TILE
                          + (long long)warp * (32 * K1_P);
    if (wp0 >= end) break;  // warp-uniform; end is a multiple of 128
    const long long p = wp0 + lane;
    unsigned live = 0;
#pragma unroll
    for (int j = 0; j < K1_P; ++j)
      if (p + 32 * j < lim) live |= 1u << j;
    const bool full = wp0 + 32 * K1_P <= lim;
    const int* tb = bstack + (p - col0);  // position p is column p - col0
    for (int q = 0; q < Q; ++q) {
      const K1Query c = s_q[q];
      const long long* off = s_off + q * KVM_MAX_SEG;
      const float4* tab = s_tab + q * KVM_MAX_SEG;
      const unsigned bits =
          full ? k1_query<NORM, true>(tb, live, off, tab, c, d, slack, slack2,
                                      unitf, qlenf)
               : k1_query<NORM, false>(tb, live, off, tab, c, d, slack,
                                       slack2, unitf, qlenf);
      // Flag f of this warp covers positions [wp0 + 128 f, +128): bits
      // j = 4 f .. 4 f + 3 of every lane.
      const unsigned c0 = __popc(bits & 0x0fu);
      const unsigned c1 = __popc(bits >> 4);
      const bool any0 = __any_sync(0xffffffffu, c0 != 0);
      const bool any1 = __any_sync(0xffffffffu, c1 != 0);
      const unsigned cnt = __reduce_add_sync(0xffffffffu, c0 + c1);
      if (lane == 0) {
        unsigned char* fr = flags + q * fstride + wp0 / KVM_FLAG;
        fr[0] = any0 ? 1 : 0;
        if (wp0 + KVM_FLAG < end) fr[1] = any1 ? 1 : 0;
        if (cnt) atomicAdd(s_cnt + q, (int)cnt);
      }
    }
  }
  __syncthreads();
  for (int q = threadIdx.x; q < Q; q += K1_THREADS)
    if (s_cnt[q]) atomicAdd(counts + q, s_cnt[q]);
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
  const long long per_block = (long long)K1_TILE * K1_TILES;
  const unsigned int blocks = (unsigned int)((npos + per_block - 1) / per_block);
  auto kernel = norm ? probe_flags_kernel<true> : probe_flags_kernel<false>;
  kernel<<<blocks, K1_THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)bstack, stride, col0, (const int*)sidx, (const int*)order,
      (const int*)valid, (const float*)mlo, (const float*)mhi,
      (const float*)width, (const float*)eps2, (const float*)cons, Q, S_SEG,
      p0, p0 + npos, m, unit, d, slack, qlen, (unsigned char*)flags, fstride,
      (int*)counts);
  return (int)cudaGetLastError();
}
