/* Single-thread scalar twin of the reference's phase-2 query loops.
 *
 * A copy of kvmatch_tpu/native/baseline_scalar.c for the PyTorch port.
 * Purpose: a MEASURED baseline standing in for the Java reference, which
 * needs a JVM (BASELINE.md asks for a measured, not modeled, comparison).  Each scan reproduces the per-offset early-abandon
 * algorithms of the reference at equal-or-better engineering quality, so
 * speedups reported against it are conservative:
 *
 *   base_ed_scan   — QueryEngine.java:343-363   (early-abandon ED per offset)
 *   base_nsm_scan  — NormQueryEngine.java:454-527 (rolling Ex/Ex2, constraint
 *                    check, sorted-order early-abandon z-ED)
 *   base_dtw_scan  — QueryEngineDtw.java:385-452 + DtwUtils.java (lbKim ->
 *                    lbKeogh(query env) -> lbKeogh(data env) -> merged cb ->
 *                    early-abandon banded DTW)
 *
 * All loops are written from the algorithm descriptions, not transliterated;
 * they use C arrays and monotonic deques instead of Java boxed lists, which
 * only makes the baseline FASTER than the Java it stands in for.
 */

#include <math.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

/* ------------------------------------------------------------------ ED --- */

long base_ed_scan(const double *data, long n,
                  const int64_t *left, const int64_t *right, long k_iv,
                  const double *q, long L, double eps2,
                  int64_t *out_offs, double *out_d2)
{
    long cnt = 0;
    for (long v = 0; v < k_iv; v++) {
        int64_t lo = left[v], hi = right[v];
        if (lo < 0) lo = 0;
        if (hi > n - L) hi = n - L;
        for (int64_t i = lo; i <= hi; i++) {
            const double *w = data + i;
            double d = 0.0;
            for (long j = 0; j < L; j++) {
                double diff = w[j] - q[j];
                d += diff * diff;
                if (d > eps2) break;
            }
            if (d <= eps2) {
                out_offs[cnt] = i;
                out_d2[cnt] = d;
                cnt++;
            }
        }
    }
    return cnt;
}

/* ----------------------------------------------------------------- cNSM --- */

/* zq_sorted: query z-values ordered by descending |z| (the reference's
 * reordered early abandoning); order: original position of each sorted entry. */
long base_nsm_scan(const double *data, long n,
                   const int64_t *left, const int64_t *right, long k_iv,
                   const double *zq_sorted, const int64_t *order, long L,
                   double eps2, double alpha, double beta,
                   double mean_q, double std_q,
                   int64_t *out_offs, double *out_d2)
{
    long cnt = 0;
    for (long v = 0; v < k_iv; v++) {
        int64_t lo = left[v], hi = right[v];
        if (lo < 0) lo = 0;
        if (hi > n - L) hi = n - L;
        if (lo > hi) continue;
        /* rolling window sums across the interval, as the reference's
         * chunk scan keeps ex/ex2 incrementally */
        double ex = 0.0, ex2 = 0.0;
        for (int64_t j = lo; j < lo + L; j++) {
            ex += data[j];
            ex2 += data[j] * data[j];
        }
        for (int64_t i = lo; i <= hi; i++) {
            double mean = ex / L;
            double var = ex2 / L - mean * mean;
            double std = var > 0 ? sqrt(var) : 0.0;
            double ratio = std / std_q;
            if (std > 0 && fabs(mean - mean_q) <= beta &&
                ratio <= alpha && ratio >= 1.0 / alpha) {
                const double *w = data + i;
                double d = 0.0;
                for (long k = 0; k < L; k++) {
                    double x = (w[order[k]] - mean) / std;
                    double diff = x - zq_sorted[k];
                    d += diff * diff;
                    if (d > eps2) break;
                }
                if (d <= eps2) {
                    out_offs[cnt] = i;
                    out_d2[cnt] = d;
                    cnt++;
                }
            }
            if (i < hi) {           /* roll the window one step right */
                double out_v = data[i], in_v = data[i + L];
                ex += in_v - out_v;
                ex2 += in_v * in_v - out_v * out_v;
            }
        }
    }
    return cnt;
}

/* ------------------------------------------------------------------ DTW --- */

/* Sliding min/max (Lemire) with edge clamping over [0, m): env of radius r. */
static void lemire_envelope(const double *x, long m, long r,
                            double *lo, double *hi)
{
    /* [b, e) windows into linear arrays: e only grows, so size by the full
     * iteration count, not the deque's bounded occupancy */
    long cap = m + r + 1;
    long *dq_min = (long *)malloc(sizeof(long) * cap);
    long *dq_max = (long *)malloc(sizeof(long) * cap);
    long bmin = 0, emin = 0, bmax = 0, emax = 0;
    for (long i = 0; i < m + r; i++) {
        if (i < m) {
            while (emin > bmin && x[dq_min[emin - 1]] >= x[i]) emin--;
            dq_min[emin++] = i;
            while (emax > bmax && x[dq_max[emax - 1]] <= x[i]) emax--;
            dq_max[emax++] = i;
        }
        long c = i - r;             /* center whose window just completed */
        if (c >= 0 && c < m) {
            while (emin > bmin && dq_min[bmin] < c - r) bmin++;
            while (emax > bmax && dq_max[bmax] < c - r) bmax++;
            lo[c] = x[dq_min[bmin]];
            hi[c] = x[dq_max[bmax]];
        }
    }
    free(dq_min);
    free(dq_max);
}

/* LB_Kim first/last-3 hierarchy with the reference's early exits. */
static double lb_kim(const double *w, const double *q, long L, double eps2)
{
    double d, lb;
    double x0 = w[0], y0 = w[L - 1], q0 = q[0], p0 = q[L - 1];
    lb = (x0 - q0) * (x0 - q0) + (y0 - p0) * (y0 - p0);
    if (lb >= eps2) return lb;
    double x1 = w[1], q1 = q[1];
    d = fmin((x1 - q0) * (x1 - q0), (x0 - q1) * (x0 - q1));
    d = fmin(d, (x1 - q1) * (x1 - q1));
    lb += d;
    if (lb >= eps2) return lb;
    double y1 = w[L - 2], p1 = q[L - 2];
    d = fmin((y1 - p0) * (y1 - p0), (y0 - p1) * (y0 - p1));
    d = fmin(d, (y1 - p1) * (y1 - p1));
    lb += d;
    if (lb >= eps2) return lb;
    double x2 = w[2], q2 = q[2];
    d = fmin((x0 - q2) * (x0 - q2), (x1 - q2) * (x1 - q2));
    d = fmin(d, (x2 - q2) * (x2 - q2));
    d = fmin(d, (x2 - q1) * (x2 - q1));
    d = fmin(d, (x2 - q0) * (x2 - q0));
    lb += d;
    if (lb >= eps2) return lb;
    double y2 = w[L - 3], p2 = q[L - 3];
    d = fmin((y0 - p2) * (y0 - p2), (y1 - p2) * (y1 - p2));
    d = fmin(d, (y2 - p2) * (y2 - p2));
    d = fmin(d, (y2 - p1) * (y2 - p1));
    d = fmin(d, (y2 - p0) * (y2 - p0));
    return lb + d;
}

/* Query-envelope Keogh in sorted order with per-position cb and early abandon. */
static double lb_keogh_q(const int64_t *order, const double *w,
                         const double *q_hi_sorted, const double *q_lo_sorted,
                         double *cb, long L, double eps2)
{
    double lb = 0.0;
    for (long k = 0; k < L && lb < eps2; k++) {
        double x = w[order[k]];
        double d = 0.0;
        if (x > q_hi_sorted[k]) {
            d = x - q_hi_sorted[k];
        } else if (x < q_lo_sorted[k]) {
            d = q_lo_sorted[k] - x;
        }
        d = d * d;
        lb += d;
        cb[order[k]] = d;
    }
    return lb;
}

/* Data-envelope Keogh: sorted query values vs the chunk envelope at the
 * window's absolute start ``base``. */
static double lb_keogh_d(const int64_t *order, const double *q_sorted,
                         const double *env_lo, const double *env_hi, long base,
                         double *cb, long L, double eps2)
{
    double lb = 0.0;
    for (long k = 0; k < L && lb < eps2; k++) {
        double qv = q_sorted[k];
        double d = 0.0;
        double u = env_hi[base + order[k]];
        double l = env_lo[base + order[k]];
        if (qv > u) {
            d = qv - u;
        } else if (qv < l) {
            d = l - qv;
        }
        d = d * d;
        lb += d;
        cb[order[k]] = d;
    }
    return lb;
}

/* Early-abandon banded DTW with the cumulative-bound prune (UCR dtw()). */
static double dtw_ea(const double *w, const double *q, const double *cb,
                     long L, long r, double eps2, double *cost, double *prev)
{
    long W = 2 * r + 1;
    const double INF = 1e308;
    for (long k = 0; k < W; k++) prev[k] = INF;
    for (long i = 0; i < L; i++) {
        double row_min = INF;
        for (long s = 0; s < W; s++) {
            long j = i - r + s;
            if (j < 0 || j >= L) {
                cost[s] = INF;
                continue;
            }
            double best;
            if (i == 0 && j == 0) {
                best = 0.0;
            } else {
                /* band slot s at row i-1 holds j' = i-1-r+s, so (i-1, j-1)
                 * lives at slot s, and (i-1, j) at slot s+1 */
                double diag = prev[s];
                double up = (s + 1 < W) ? prev[s + 1] : INF;
                double left = (s > 0) ? cost[s - 1] : INF;      /* (i, j-1)   */
                best = fmin(diag, fmin(up, left));
                if (best >= INF) best = INF;
            }
            double diff = w[i] - q[j];
            double c = (best >= INF && !(i == 0 && j == 0))
                           ? INF : best + diff * diff;
            cost[s] = c;
            if (c < row_min) row_min = c;
        }
        /* early abandon: row min + remaining lower bound exceeds budget */
        long nxt = i + r + 1;
        if (nxt < L && row_min + cb[nxt] >= eps2) return row_min + cb[nxt];
        double *tmp = prev; prev = cost; cost = tmp;
    }
    return prev[r];
}

/* Full per-interval DTW scan.  q: raw query; q_lo/q_hi: its envelope;
 * order: positions by descending |q - mean(q)| (reordered early abandon);
 * cb buffers provided by caller (3 * L doubles) plus 2 * (2r+1) DP rows. */
long base_dtw_scan(const double *data, long n,
                   const int64_t *left, const int64_t *right, long k_iv,
                   const double *q, const double *q_lo, const double *q_hi,
                   const int64_t *order, long L, long rho, double eps2,
                   int64_t *out_offs, double *out_d2)
{
    long cnt = 0;
    double *q_sorted = (double *)malloc(sizeof(double) * L);
    double *q_lo_sorted = (double *)malloc(sizeof(double) * L);
    double *q_hi_sorted = (double *)malloc(sizeof(double) * L);
    double *cb1 = (double *)malloc(sizeof(double) * L);
    double *cb2 = (double *)malloc(sizeof(double) * L);
    double *cb = (double *)malloc(sizeof(double) * (L + 1));
    long W = 2 * rho + 1;
    double *row_a = (double *)malloc(sizeof(double) * W);
    double *row_b = (double *)malloc(sizeof(double) * W);
    for (long k = 0; k < L; k++) {
        q_sorted[k] = q[order[k]];
        q_lo_sorted[k] = q_lo[order[k]];
        q_hi_sorted[k] = q_hi[order[k]];
    }
    for (long v = 0; v < k_iv; v++) {
        int64_t lo = left[v], hi = right[v];
        if (lo < 0) lo = 0;
        if (hi > n - L) hi = n - L;
        if (lo > hi) continue;
        /* chunk envelope over the scanned region, as the reference computes
         * lowerUpperLemire per read chunk */
        long m = (hi - lo) + L;
        double *env_lo = (double *)malloc(sizeof(double) * m);
        double *env_hi = (double *)malloc(sizeof(double) * m);
        lemire_envelope(data + lo, m, rho, env_lo, env_hi);
        for (int64_t i = lo; i <= hi; i++) {
            const double *w = data + i;
            double kim = lb_kim(w, q, L, eps2);
            if (kim > eps2) continue;
            double k1 = lb_keogh_q(order, w, q_hi_sorted, q_lo_sorted, cb1, L, eps2);
            if (k1 > eps2) continue;
            double k2 = lb_keogh_d(order, q_sorted, env_lo, env_hi, i - lo,
                                   cb2, L, eps2);
            if (k2 > eps2) continue;
            const double *c = (k1 > k2) ? cb1 : cb2;
            cb[L - 1] = c[L - 1];
            for (long k = L - 2; k >= 0; k--) cb[k] = cb[k + 1] + c[k];
            double d = dtw_ea(w, q, cb, L, rho, eps2, row_a, row_b);
            if (d <= eps2) {
                out_offs[cnt] = i;
                out_d2[cnt] = d;
                cnt++;
            }
        }
        free(env_lo);
        free(env_hi);
    }
    free(q_sorted); free(q_lo_sorted); free(q_hi_sorted);
    free(cb1); free(cb2); free(cb); free(row_a); free(row_b);
    return cnt;
}

/* cNSM-DTW: z-normalized windows through the same cascade.
 * zq/zq_lo/zq_hi: z-normalized query and its envelope. */
long base_nsm_dtw_scan(const double *data, long n,
                       const int64_t *left, const int64_t *right, long k_iv,
                       const double *zq, const double *zq_lo, const double *zq_hi,
                       const int64_t *order, long L, long rho, double eps2,
                       double alpha, double beta, double mean_q, double std_q,
                       int64_t *out_offs, double *out_d2)
{
    long cnt = 0;
    double *zw = (double *)malloc(sizeof(double) * L);
    double *zq_sorted = (double *)malloc(sizeof(double) * L);
    double *zq_lo_sorted = (double *)malloc(sizeof(double) * L);
    double *zq_hi_sorted = (double *)malloc(sizeof(double) * L);
    double *cb1 = (double *)malloc(sizeof(double) * L);
    double *cb2 = (double *)malloc(sizeof(double) * L);
    double *cb = (double *)malloc(sizeof(double) * (L + 1));
    long W = 2 * rho + 1;
    double *row_a = (double *)malloc(sizeof(double) * W);
    double *row_b = (double *)malloc(sizeof(double) * W);
    for (long k = 0; k < L; k++) {
        zq_sorted[k] = zq[order[k]];
        zq_lo_sorted[k] = zq_lo[order[k]];
        zq_hi_sorted[k] = zq_hi[order[k]];
    }
    for (long v = 0; v < k_iv; v++) {
        int64_t lo = left[v], hi = right[v];
        if (lo < 0) lo = 0;
        if (hi > n - L) hi = n - L;
        if (lo > hi) continue;
        double ex = 0.0, ex2 = 0.0;
        for (int64_t j = lo; j < lo + L; j++) {
            ex += data[j];
            ex2 += data[j] * data[j];
        }
        long m = (hi - lo) + L;
        /* z-normalize per window, then envelope per window is needed; the
         * reference normalizes on the fly and envelopes the raw chunk — the
         * raw envelope mapped by the window's affine transform encloses the
         * z-window envelope, matching engine semantics */
        double *env_lo = (double *)malloc(sizeof(double) * m);
        double *env_hi = (double *)malloc(sizeof(double) * m);
        lemire_envelope(data + lo, m, rho, env_lo, env_hi);
        for (int64_t i = lo; i <= hi; i++) {
            double mean = ex / L;
            double var = ex2 / L - mean * mean;
            double std = var > 0 ? sqrt(var) : 0.0;
            double ratio = std / std_q;
            if (std > 0 && fabs(mean - mean_q) <= beta &&
                ratio <= alpha && ratio >= 1.0 / alpha) {
                const double *w = data + i;
                for (long k = 0; k < L; k++) zw[k] = (w[k] - mean) / std;
                double kim = lb_kim(zw, zq, L, eps2);
                if (kim <= eps2) {
                    double k1 = lb_keogh_q(order, zw, zq_hi_sorted,
                                           zq_lo_sorted, cb1, L, eps2);
                    if (k1 <= eps2) {
                        /* affine-map the raw chunk envelope into z-space */
                        double k2 = 0.0;
                        long base = i - lo;
                        for (long k = 0; k < L && k2 < eps2; k++) {
                            double u = (env_hi[base + order[k]] - mean) / std;
                            double l = (env_lo[base + order[k]] - mean) / std;
                            double qv = zq_sorted[k];
                            double d = 0.0;
                            if (qv > u) d = qv - u;
                            else if (qv < l) d = l - qv;
                            d = d * d;
                            k2 += d;
                            cb2[order[k]] = d;
                        }
                        if (k2 <= eps2) {
                            const double *c = (k1 > k2) ? cb1 : cb2;
                            cb[L - 1] = c[L - 1];
                            for (long k = L - 2; k >= 0; k--)
                                cb[k] = cb[k + 1] + c[k];
                            double d = dtw_ea(zw, zq, cb, L, rho, eps2,
                                              row_a, row_b);
                            if (d <= eps2) {
                                out_offs[cnt] = i;
                                out_d2[cnt] = d;
                                cnt++;
                            }
                        }
                    }
                }
            }
            if (i < hi) {
                double out_v = data[i], in_v = data[i + L];
                ex += in_v - out_v;
                ex2 += in_v * in_v - out_v * out_v;
            }
        }
        free(env_lo);
        free(env_hi);
    }
    free(zw); free(zq_sorted); free(zq_lo_sorted); free(zq_hi_sorted);
    free(cb1); free(cb2); free(cb); free(row_a); free(row_b);
    return cnt;
}
