/* Native BN254 G1 group kernels for the host runtime.
 *
 * The reference's math core is Rust with inline x86-64 asm
 * (arithmetic/curves/src/{derive/field.rs, bn256/assembly.rs}); this is the
 * framework's native counterpart for the host-side work that doesn't belong
 * on the accelerator: SRS generation, Feist-Khovratovich table preprocessing chains,
 * small commitment MSMs, and verifier-side folds.  4x64-bit Montgomery
 * arithmetic over Fq with __int128 products; Jacobian point ops; Pippenger
 * MSM.  Exposed through a tiny C ABI consumed via ctypes
 * (sha2cq_tpu/native_loader.py).
 *
 * Data layout at the ABI: field elements are canonical (non-Montgomery)
 * little-endian u64[4]; points are u64[12] (X, Y, Z Jacobian, Z=0 identity);
 * scalars are canonical u64[4].
 */
#include <stdint.h>
#include <string.h>
#ifdef _OPENMP
#include <omp.h>
#endif

typedef unsigned __int128 u128;
typedef uint64_t u64;

static const u64 Q[4] = {0x3c208c16d87cfd47ULL, 0x97816a916871ca8dULL,
                         0xb85045b68181585dULL, 0x30644e72e131a029ULL};
static const u64 R2[4] = {0xf32cfc5b538afa89ULL, 0xb5e71911d44501fbULL,
                          0x47ab1eff0a417ff6ULL, 0x06d89f71cab8351fULL};
static const u64 RMODQ[4] = {0xd35d438dc58f0d9dULL, 0x0a78eb28f5c70b3dULL,
                             0x666ea36f7879462cULL, 0x0e0a77c19a07df2fULL};
static const u64 NINV = 0x87d20782e4866389ULL;

typedef struct { u64 v[4]; } fq;

static inline int fq_is_zero(const fq *a) {
    return (a->v[0] | a->v[1] | a->v[2] | a->v[3]) == 0;
}

static inline int geq(const u64 a[4], const u64 b[4]) {
    for (int i = 3; i >= 0; i--) {
        if (a[i] > b[i]) return 1;
        if (a[i] < b[i]) return 0;
    }
    return 1;
}

static inline void sub_q(u64 a[4]) {
    u128 borrow = 0;
    for (int i = 0; i < 4; i++) {
        u128 d = (u128)a[i] - Q[i] - borrow;
        a[i] = (u64)d;
        borrow = (d >> 64) & 1;
    }
}

static void fq_add(fq *r, const fq *a, const fq *b) {
    u128 carry = 0;
    for (int i = 0; i < 4; i++) {
        u128 s = (u128)a->v[i] + b->v[i] + carry;
        r->v[i] = (u64)s;
        carry = s >> 64;
    }
    if (carry || geq(r->v, Q)) sub_q(r->v);
}

static void fq_sub(fq *r, const fq *a, const fq *b) {
    u128 borrow = 0;
    u64 t[4];
    for (int i = 0; i < 4; i++) {
        u128 d = (u128)a->v[i] - b->v[i] - borrow;
        t[i] = (u64)d;
        borrow = (d >> 64) & 1;
    }
    if (borrow) {
        u128 carry = 0;
        for (int i = 0; i < 4; i++) {
            u128 s = (u128)t[i] + Q[i] + carry;
            t[i] = (u64)s;
            carry = s >> 64;
        }
    }
    memcpy(r->v, t, sizeof t);
}

/* CIOS Montgomery multiplication */
static void fq_mul(fq *r, const fq *a, const fq *b) {
    u64 t[6] = {0, 0, 0, 0, 0, 0};
    for (int i = 0; i < 4; i++) {
        u128 carry = 0;
        for (int j = 0; j < 4; j++) {
            u128 cur = (u128)t[j] + (u128)a->v[i] * b->v[j] + carry;
            t[j] = (u64)cur;
            carry = cur >> 64;
        }
        u128 cur = (u128)t[4] + carry;
        t[4] = (u64)cur;
        t[5] = (u64)(cur >> 64);

        u64 m = t[0] * NINV;
        carry = ((u128)t[0] + (u128)m * Q[0]) >> 64;
        for (int j = 1; j < 4; j++) {
            u128 c2 = (u128)t[j] + (u128)m * Q[j] + carry;
            t[j - 1] = (u64)c2;
            carry = c2 >> 64;
        }
        cur = (u128)t[4] + carry;
        t[3] = (u64)cur;
        t[4] = t[5] + (u64)(cur >> 64);
        t[5] = 0;
    }
    if (t[4] || geq(t, Q)) sub_q(t);
    memcpy(r->v, t, 4 * sizeof(u64));
}

static void fq_to_mont(fq *r, const fq *a) {
    fq r2;
    memcpy(r2.v, R2, sizeof R2);
    fq_mul(r, a, &r2);
}

static void fq_from_mont(fq *r, const fq *a) {
    fq one = {{1, 0, 0, 0}};
    fq_mul(r, a, &one);
}

static void fq_dbl(fq *r, const fq *a) { fq_add(r, a, a); }

/* Fermat inversion a^(q-2) (Montgomery form in/out).  Used once per
 * batched-inversion round in the affine MSM — amortized to ~0 per add. */
static void fq_inv(fq *r, const fq *a) {
    static const u64 QM2[4] = {0x3c208c16d87cfd45ULL, 0x97816a916871ca8dULL,
                               0xb85045b68181585dULL, 0x30644e72e131a029ULL};
    fq acc, base = *a;
    memset(&acc, 0, sizeof acc);
    memcpy(acc.v, RMODQ, sizeof RMODQ);
    for (int limb = 0; limb < 4; limb++)
        for (int bit = 0; bit < 64; bit++) {
            if ((QM2[limb] >> bit) & 1) fq_mul(&acc, &acc, &base);
            fq_mul(&base, &base, &base);
        }
    *r = acc;
}

/* Jacobian point, Montgomery-form coordinates */
typedef struct { fq x, y, z; } pt;

static void pt_set_identity(pt *p) {
    memset(p, 0, sizeof *p);
    memcpy(p->x.v, RMODQ, sizeof RMODQ); /* (1, 1, 0) in Montgomery form */
    memcpy(p->y.v, RMODQ, sizeof RMODQ);
}

static int pt_is_identity(const pt *p) { return fq_is_zero(&p->z); }

static void pt_double(pt *r, const pt *p) {
    if (pt_is_identity(p)) { *r = *p; return; }
    fq A, B, C, D, E, F, t, t2;
    fq_mul(&A, &p->x, &p->x);
    fq_mul(&B, &p->y, &p->y);
    fq_mul(&C, &B, &B);
    fq_add(&t, &p->x, &B);
    fq_mul(&t, &t, &t);
    fq_sub(&t, &t, &A);
    fq_sub(&t, &t, &C);
    fq_dbl(&D, &t);
    fq_dbl(&E, &A);
    fq_add(&E, &E, &A);
    fq_mul(&F, &E, &E);
    pt out;
    fq_dbl(&t, &D);
    fq_sub(&out.x, &F, &t);
    fq_sub(&t, &D, &out.x);
    fq_mul(&t, &E, &t);
    fq_dbl(&t2, &C); fq_dbl(&t2, &t2); fq_dbl(&t2, &t2); /* 8C */
    fq_sub(&out.y, &t, &t2);
    fq_mul(&t, &p->y, &p->z);
    fq_dbl(&out.z, &t);
    *r = out;
}

static void pt_add(pt *r, const pt *p, const pt *q) {
    if (pt_is_identity(p)) { *r = *q; return; }
    if (pt_is_identity(q)) { *r = *p; return; }
    fq z1z1, z2z2, u1, u2, s1, s2, t;
    fq_mul(&z1z1, &p->z, &p->z);
    fq_mul(&z2z2, &q->z, &q->z);
    fq_mul(&u1, &p->x, &z2z2);
    fq_mul(&u2, &q->x, &z1z1);
    fq_mul(&t, &q->z, &z2z2);
    fq_mul(&s1, &p->y, &t);
    fq_mul(&t, &p->z, &z1z1);
    fq_mul(&s2, &q->y, &t);
    fq h, rr;
    fq_sub(&h, &u2, &u1);
    fq_sub(&rr, &s2, &s1);
    if (fq_is_zero(&h)) {
        if (fq_is_zero(&rr)) { pt_double(r, p); return; }
        pt_set_identity(r);
        return;
    }
    fq hh, hhh, v;
    fq_mul(&hh, &h, &h);
    fq_mul(&hhh, &h, &hh);
    fq_mul(&v, &u1, &hh);
    pt out;
    fq_mul(&t, &rr, &rr);
    fq_sub(&t, &t, &hhh);
    fq tv;
    fq_dbl(&tv, &v);
    fq_sub(&out.x, &t, &tv);
    fq_sub(&t, &v, &out.x);
    fq_mul(&t, &rr, &t);
    fq tu;
    fq_mul(&tu, &s1, &hhh);
    fq_sub(&out.y, &t, &tu);
    fq_mul(&t, &p->z, &q->z);
    fq_mul(&out.z, &t, &h);
    *r = out;
}

/* mixed add: q affine in Montgomery form (implicit z = 1), madd-2007-bl
 * 7M+4S vs the 12M+4S generic Jacobian add — bucket accumulation feeds
 * every point in with z = 1, so this is the Pippenger hot path. */
static void pt_add_mixed(pt *r, const pt *p, const fq *qx, const fq *qy) {
    if (pt_is_identity(p)) {
        r->x = *qx;
        r->y = *qy;
        memset(&r->z, 0, sizeof(fq));
        memcpy(r->z.v, RMODQ, sizeof RMODQ);
        return;
    }
    fq z1z1, u2, s2, t;
    fq_mul(&z1z1, &p->z, &p->z);
    fq_mul(&u2, qx, &z1z1);
    fq_mul(&t, &p->z, &z1z1);
    fq_mul(&s2, qy, &t);
    fq h, rr;
    fq_sub(&h, &u2, &p->x);
    fq_sub(&rr, &s2, &p->y);
    fq_dbl(&rr, &rr); /* r = 2*(S2 - Y1) */
    if (fq_is_zero(&h)) {
        if (fq_is_zero(&rr)) { pt_double(r, p); return; }
        pt_set_identity(r);
        return;
    }
    fq hh, ii, j, v;
    fq_mul(&hh, &h, &h);
    fq_dbl(&ii, &hh);
    fq_dbl(&ii, &ii); /* I = 4*HH */
    fq_mul(&j, &h, &ii);
    fq_mul(&v, &p->x, &ii);
    pt out;
    fq_mul(&t, &rr, &rr);
    fq_sub(&t, &t, &j);
    fq tv;
    fq_dbl(&tv, &v);
    fq_sub(&out.x, &t, &tv);
    fq_sub(&t, &v, &out.x);
    fq_mul(&t, &rr, &t);
    fq t2;
    fq_mul(&t2, &p->y, &j);
    fq_dbl(&t2, &t2);
    fq_sub(&out.y, &t, &t2);
    fq_add(&t, &p->z, &h);
    fq_mul(&t, &t, &t);
    fq_sub(&t, &t, &z1z1);
    fq_sub(&out.z, &t, &hh);
    *r = out;
}

/* ---------------- exported ABI (canonical u64[4] coordinates) ------------- */

static void load_pt(pt *p, const u64 *in) {
    fq x = {{in[0], in[1], in[2], in[3]}};
    fq y = {{in[4], in[5], in[6], in[7]}};
    fq z = {{in[8], in[9], in[10], in[11]}};
    fq_to_mont(&p->x, &x);
    fq_to_mont(&p->y, &y);
    fq_to_mont(&p->z, &z);
}

static void store_pt(u64 *out, const pt *p) {
    fq x, y, z;
    fq_from_mont(&x, &p->x);
    fq_from_mont(&y, &p->y);
    fq_from_mont(&z, &p->z);
    memcpy(out, x.v, 32);
    memcpy(out + 4, y.v, 32);
    memcpy(out + 8, z.v, 32);
}

void g1_add_jac(const u64 *a, const u64 *b, u64 *out) {
    pt p, q, r;
    load_pt(&p, a);
    load_pt(&q, b);
    pt_add(&r, &p, &q);
    store_pt(out, &r);
}

void g1_scalar_mul(const u64 *point, const u64 *scalar, u64 *out) {
    pt base, acc;
    load_pt(&base, point);
    pt_set_identity(&acc);
    int top = 3;
    while (top >= 0 && scalar[top] == 0) top--;
    if (top >= 0) {
        for (int i = top; i >= 0; i--) {
            u64 w = scalar[i];
            int start = (i == top) ? 63 - __builtin_clzll(w) : 63;
            for (int bit = start; bit >= 0; bit--) {
                pt_double(&acc, &acc);
                if ((w >> bit) & 1) pt_add(&acc, &acc, &base);
            }
        }
    }
    store_pt(out, &acc);
}

/* Pippenger MSM, window c = 8.  points: n * u64[12] (Jacobian canonical),
 * scalars: n * u64[4] canonical.  out: u64[12].  Window sums run in
 * parallel (OpenMP when available), then fold with a doubling chain. */
/* generic Pippenger window pass (unsigned digits, full Jacobian adds) —
 * fallback for inputs with projective (z != 1) points */
static void msm_window_generic(const pt *pts, const u64 *scalars, long n,
                               int w, pt *acc_out) {
    enum { C = 8, NBUCKET = 1 << C };
    pt *buckets = (pt *)__builtin_malloc(sizeof(pt) * NBUCKET);
    for (int b = 0; b < NBUCKET; b++) pt_set_identity(&buckets[b]);
    for (long i = 0; i < n; i++) {
        int limb = (w * C) / 64;
        int shift = (w * C) % 64;
        u64 d = (scalars[4 * i + limb] >> shift);
        if (shift > 64 - C && limb < 3)
            d |= scalars[4 * i + limb + 1] << (64 - shift);
        d &= (NBUCKET - 1);
        if (d) pt_add(&buckets[d], &buckets[d], &pts[i]);
    }
    pt run, acc;
    pt_set_identity(&run);
    pt_set_identity(&acc);
    for (int b = NBUCKET - 1; b >= 1; b--) {
        pt_add(&run, &run, &buckets[b]);
        pt_add(&acc, &acc, &run);
    }
    *acc_out = acc;
    __builtin_free(buckets);
}

/* Batch-affine bucket accumulation for one window: all points landing in
 * each bucket are tree-reduced with AFFINE additions whose divisions share
 * one batched inversion per round (Montgomery trick), ~5M+1S per add vs
 * ~7M+4S for the Jacobian mixed add.  (The reference carries the same idea
 * as an unused `batch_add!` macro, derive/curve.rs:2-143; here it is the
 * production path.)  px/py are scratch of size >= n; pairbuf of >= n/2+1. */
static void msm_window_affine(const pt *pts, const fq *nys, const short *digs,
                              long n, int nw, int w, int hb,
                              fq *px, fq *py, fq *pairbuf, pt *acc_out) {
    long *cnt = (long *)__builtin_malloc(sizeof(long) * (size_t)(hb + 1) * 2);
    long *off = cnt + hb + 1;
    memset(cnt, 0, sizeof(long) * (size_t)(hb + 1));
    for (long i = 0; i < n; i++) {
        int v = digs[i * nw + w];
        if (v) cnt[v > 0 ? v : -v]++;
    }
    long tot = 0;
    for (int b = 1; b <= hb; b++) { off[b] = tot; tot += cnt[b]; }
    long *fill = (long *)__builtin_malloc(sizeof(long) * (size_t)(hb + 1));
    memcpy(fill, off, sizeof(long) * (size_t)(hb + 1));
    for (long i = 0; i < n; i++) {
        int v = digs[i * nw + w];
        if (!v) continue;
        int b = v > 0 ? v : -v;
        long at = fill[b]++;
        px[at] = pts[i].x;
        py[at] = v > 0 ? pts[i].y : nys[i];
    }
    __builtin_free(fill);

    /* tree rounds: halve every bucket's list with one shared inversion */
    fq *dinv = pairbuf;
    long maxc = 0;
    for (int b = 1; b <= hb; b++) if (cnt[b] > maxc) maxc = cnt[b];
    while (maxc > 1) {
        /* collect denominators (dead pairs contribute a 1 so indices align) */
        long m = 0;
        for (int b = 1; b <= hb; b++) {
            long base = off[b];
            for (long k = 0; 2 * k + 1 < cnt[b]; k++) {
                const fq *xa = &px[base + 2 * k], *xb = &px[base + 2 * k + 1];
                fq d;
                fq_sub(&d, xb, xa);
                if (fq_is_zero(&d)) {
                    if (memcmp(py[base + 2 * k].v, py[base + 2 * k + 1].v,
                               sizeof(fq)) == 0)
                        fq_dbl(&d, &py[base + 2 * k]);     /* doubling: 2y */
                    else
                        memcpy(d.v, RMODQ, sizeof RMODQ);  /* cancel: dead */
                }
                dinv[m++] = d;
            }
        }
        /* batched inversion in place */
        if (m) {
            fq accp, run;
            memcpy(accp.v, RMODQ, sizeof RMODQ);
            fq *pref = pairbuf + m;    /* prefix products after dinv slots */
            for (long j = 0; j < m; j++) {
                pref[j] = accp;
                fq_mul(&accp, &accp, &dinv[j]);
            }
            fq_inv(&run, &accp);
            for (long j = m - 1; j >= 0; j--) {
                fq d = dinv[j];
                fq_mul(&dinv[j], &run, &pref[j]);
                fq_mul(&run, &run, &d);
            }
        }
        /* complete the additions, compacting each bucket in place */
        long mi = 0;
        for (int b = 1; b <= hb; b++) {
            long base = off[b], wr = 0;
            long pairs = cnt[b] / 2;
            for (long k = 0; k < pairs; k++) {
                fq xa = px[base + 2 * k], ya = py[base + 2 * k];
                fq xb = px[base + 2 * k + 1], yb = py[base + 2 * k + 1];
                fq d = dinv[mi++];
                fq dx, lam, num;
                fq_sub(&dx, &xb, &xa);
                if (fq_is_zero(&dx)) {
                    if (memcmp(ya.v, yb.v, sizeof(fq)) != 0)
                        continue;                   /* P + (-P): drop */
                    fq xx;                          /* doubling: 3x^2 / 2y */
                    fq_mul(&xx, &xa, &xa);
                    fq_dbl(&num, &xx);
                    fq_add(&num, &num, &xx);
                } else {
                    fq_sub(&num, &yb, &ya);
                }
                fq_mul(&lam, &num, &d);
                fq x3, y3, t;
                fq_mul(&x3, &lam, &lam);
                fq_sub(&x3, &x3, &xa);
                fq_sub(&x3, &x3, &xb);
                fq_sub(&t, &xa, &x3);
                fq_mul(&y3, &lam, &t);
                fq_sub(&y3, &y3, &ya);
                px[base + wr] = x3;
                py[base + wr] = y3;
                wr++;
            }
            if (cnt[b] & 1) {
                px[base + wr] = px[base + cnt[b] - 1];
                py[base + wr] = py[base + cnt[b] - 1];
                wr++;
            }
            cnt[b] = wr;
        }
        maxc = 0;
        for (int b = 1; b <= hb; b++) if (cnt[b] > maxc) maxc = cnt[b];
    }

    /* bucket fold: sum_b b * bucket[b] via running sums */
    pt run, acc;
    pt_set_identity(&run);
    pt_set_identity(&acc);
    for (int b = hb; b >= 1; b--) {
        if (cnt[b])
            pt_add_mixed(&run, &run, &px[off[b]], &py[off[b]]);
        pt_add(&acc, &acc, &run);
    }
    *acc_out = acc;
    __builtin_free(cnt);
}

/* Lockstep batch-affine core for SMALL n: all windows' tree rounds run in
 * step with ONE shared batched inversion per round.  Per-window inversions
 * (one ~12.5 us Fermat per tree round per window) dominate tiny MSMs —
 * the CQ phase issues ~200 sub-100-point jobs per SHA-256 proof (a/qa/a0
 * per lookup argument) and measured ~1 ms/job, ~2.4 ms of it inversions.
 * Requires affine inputs (z == 1); caller guarantees. */
#define MSM_SMALL_N 512
static int g1_msm_core_small(pt *pts, const u64 *scalars, long n, u64 *out) {
    enum { C = 8, HB = 1 << (C - 1), NW = 32 };
    /* signed digit decomposition (same as the big path at c=8) */
    short *digs = (short *)__builtin_malloc(sizeof(short) * (size_t)n * NW);
    fq *nys = (fq *)__builtin_malloc(sizeof(fq) * (size_t)n);
    /* per-window bucketed point lists + shared inversion scratch */
    fq *PX = (fq *)__builtin_malloc(sizeof(fq) * (size_t)n * NW * 3);
    long *meta = (long *)__builtin_malloc(
        sizeof(long) * (size_t)NW * (2 * (HB + 1) + 1));
    if (!digs || !nys || !PX || !meta) {
        __builtin_free(digs); __builtin_free(nys);
        __builtin_free(PX); __builtin_free(meta);
        return -1;
    }
    fq zero;
    memset(&zero, 0, sizeof zero);
    for (long i = 0; i < n; i++) {
        int carry = 0;
        for (int w = 0; w < NW; w++) {
            int limb = (w * C) / 64;
            int shift = (w * C) % 64;
            u64 d = (scalars[4 * i + limb] >> shift);
            if (shift > 64 - C && limb < 3)
                d |= scalars[4 * i + limb + 1] << (64 - shift);
            int v = (int)(d & ((u64)(1 << C) - 1)) + carry;
            if (v > HB) { v -= (1 << C); carry = 1; } else carry = 0;
            digs[i * NW + w] = (short)v;
        }
        fq_sub(&nys[i], &zero, &pts[i].y);
    }
    /* counting sort into per-window bucket lists */
    long maxc = 0;
    for (int w = 0; w < NW; w++) {
        long *cnt = meta + (size_t)w * (2 * (HB + 1) + 1);
        long *off = cnt + HB + 1;
        memset(cnt, 0, sizeof(long) * (HB + 1));
        for (long i = 0; i < n; i++) {
            int v = digs[i * NW + w];
            if (v) cnt[v > 0 ? v : -v]++;
        }
        long tot = 0;
        for (int b = 1; b <= HB; b++) { off[b] = tot; tot += cnt[b]; }
        fq *px = PX + (size_t)w * n * 2;
        fq *py = px + n;
        long fill[HB + 1];
        memcpy(fill, off, sizeof fill);
        for (long i = 0; i < n; i++) {
            int v = digs[i * NW + w];
            if (!v) continue;
            int b = v > 0 ? v : -v;
            long at = fill[b]++;
            px[at] = pts[i].x;
            py[at] = v > 0 ? pts[i].y : nys[i];
        }
        for (int b = 1; b <= HB; b++) if (cnt[b] > maxc) maxc = cnt[b];
    }
    /* lockstep tree rounds: one shared inversion across ALL windows */
    fq *dinv = PX + (size_t)NW * n * 2;          /* n*NW scratch */
    while (maxc > 1) {
        long m = 0;
        for (int w = 0; w < NW; w++) {
            long *cnt = meta + (size_t)w * (2 * (HB + 1) + 1);
            long *off = cnt + HB + 1;
            fq *px = PX + (size_t)w * n * 2;
            fq *py = px + n;
            for (int b = 1; b <= HB; b++) {
                long base = off[b];
                for (long k2 = 0; 2 * k2 + 1 < cnt[b]; k2++) {
                    const fq *xa = &px[base + 2 * k2];
                    const fq *xb = &px[base + 2 * k2 + 1];
                    fq d;
                    fq_sub(&d, xb, xa);
                    if (fq_is_zero(&d)) {
                        if (memcmp(py[base + 2 * k2].v,
                                   py[base + 2 * k2 + 1].v, sizeof(fq)) == 0)
                            fq_dbl(&d, &py[base + 2 * k2]);
                        else
                            memcpy(d.v, RMODQ, sizeof RMODQ);
                    }
                    dinv[m++] = d;
                }
            }
        }
        if (m) {   /* batched inversion in place (prefix trick) */
            fq *pref = (fq *)__builtin_malloc(sizeof(fq) * (size_t)m);
            if (!pref) {
                __builtin_free(digs); __builtin_free(nys);
                __builtin_free(PX); __builtin_free(meta);
                return -1;
            }
            fq accp, run;
            memcpy(accp.v, RMODQ, sizeof RMODQ);
            for (long j = 0; j < m; j++) {
                pref[j] = accp;
                fq_mul(&accp, &accp, &dinv[j]);
            }
            fq_inv(&run, &accp);
            for (long j = m - 1; j >= 0; j--) {
                fq d = dinv[j];
                fq_mul(&dinv[j], &run, &pref[j]);
                fq_mul(&run, &run, &d);
            }
            __builtin_free(pref);
        }
        long mi = 0;
        maxc = 0;
        for (int w = 0; w < NW; w++) {
            long *cnt = meta + (size_t)w * (2 * (HB + 1) + 1);
            long *off = cnt + HB + 1;
            fq *px = PX + (size_t)w * n * 2;
            fq *py = px + n;
            for (int b = 1; b <= HB; b++) {
                long base = off[b], wr = 0;
                long pairs = cnt[b] / 2;
                for (long k2 = 0; k2 < pairs; k2++) {
                    fq xa = px[base + 2 * k2], ya = py[base + 2 * k2];
                    fq xb = px[base + 2 * k2 + 1], yb = py[base + 2 * k2 + 1];
                    fq d = dinv[mi++];
                    fq dx, lam, num;
                    fq_sub(&dx, &xb, &xa);
                    if (fq_is_zero(&dx)) {
                        if (memcmp(ya.v, yb.v, sizeof(fq)) != 0)
                            continue;               /* P + (-P): drop */
                        fq xx;
                        fq_mul(&xx, &xa, &xa);
                        fq_dbl(&num, &xx);
                        fq_add(&num, &num, &xx);
                    } else {
                        fq_sub(&num, &yb, &ya);
                    }
                    fq_mul(&lam, &num, &d);
                    fq x3, y3, t;
                    fq_mul(&x3, &lam, &lam);
                    fq_sub(&x3, &x3, &xa);
                    fq_sub(&x3, &x3, &xb);
                    fq_sub(&t, &xa, &x3);
                    fq_mul(&y3, &lam, &t);
                    fq_sub(&y3, &y3, &ya);
                    px[base + wr] = x3;
                    py[base + wr] = y3;
                    wr++;
                }
                if (cnt[b] & 1) {
                    px[base + wr] = px[base + cnt[b] - 1];
                    py[base + wr] = py[base + cnt[b] - 1];
                    wr++;
                }
                cnt[b] = wr;
                if (wr > maxc) maxc = wr;
            }
        }
    }
    /* per-window bucket fold + 2^C-weighted window fold */
    pt total;
    pt_set_identity(&total);
    for (int w = NW - 1; w >= 0; w--) {
        if (!pt_is_identity(&total))
            for (int d = 0; d < C; d++) pt_double(&total, &total);
        long *cnt = meta + (size_t)w * (2 * (HB + 1) + 1);
        long *off = cnt + HB + 1;
        fq *px = PX + (size_t)w * n * 2;
        fq *py = px + n;
        pt run, acc;
        pt_set_identity(&run);
        pt_set_identity(&acc);
        for (int b = HB; b >= 1; b--) {
            if (cnt[b])
                pt_add_mixed(&run, &run, &px[off[b]], &py[off[b]]);
            pt_add(&acc, &acc, &run);
        }
        pt_add(&total, &total, &acc);
    }
    store_pt(out, &total);
    __builtin_free(digs);
    __builtin_free(nys);
    __builtin_free(PX);
    __builtin_free(meta);
    return 0;
}

static int g1_msm_core(pt *pts, const u64 *scalars, long n, u64 *out) {
    /* the commitment bases are affine (z == 1): batch-affine tree path
     * with signed c-bit digits (half the buckets) */
    int affine = 1;
    for (long i = 0; i < n && affine; i++)
        affine = memcmp(pts[i].z.v, RMODQ, sizeof RMODQ) == 0;
    if (affine && n <= MSM_SMALL_N)
        return g1_msm_core_small(pts, scalars, n, out);

    /* window size: larger MSMs amortize the 2^(c-1)-bucket fold; the
     * generic (projective-input) fallback is fixed at c = 8 */
    int c = 8;
    if (affine) {
        int lg = 0;
        while ((1L << lg) < n) lg++;
        c = lg - 5;
        {   /* window override for tuning (SHA2CQ_MSM_C=<bits>) */
            extern char *getenv(const char *);
            extern int atoi(const char *);
            const char *e = getenv("SHA2CQ_MSM_C");
            if (e && *e) { int v = atoi(e); if (v) c = v; }
        }
        if (c < 8) c = 8;
        if (c > 14) c = 14;
    }
    const int hb = 1 << (c - 1);
    const int nw = (256 + c - 1) / c;
    pt wsum[32];

    if (affine) {
        short *digs = (short *)__builtin_malloc(sizeof(short) * (size_t)n * nw);
        fq *nys = (fq *)__builtin_malloc(sizeof(fq) * (size_t)n);
        if (!digs || !nys) {
            __builtin_free(digs);
            __builtin_free(nys);
            return -1;
        }
        fq zero;
        memset(&zero, 0, sizeof zero);
        #ifdef _OPENMP
        #pragma omp parallel for schedule(static)
        #endif
        for (long i = 0; i < n; i++) {
            int carry = 0;
            for (int w = 0; w < nw; w++) {
                int limb = (w * c) / 64;
                int shift = (w * c) % 64;
                u64 d = (scalars[4 * i + limb] >> shift);
                if (shift > 64 - c && limb < 3)
                    d |= scalars[4 * i + limb + 1] << (64 - shift);
                int v = (int)(d & ((u64)(1 << c) - 1)) + carry;
                if (v > hb) { v -= (1 << c); carry = 1; } else carry = 0;
                digs[i * nw + w] = (short)v;
            }
            /* carry out of the top window is impossible: scalars < 2^254 */
            fq_sub(&nys[i], &zero, &pts[i].y);
        }
        int oom = 0;
        #ifdef _OPENMP
        #pragma omp parallel for schedule(dynamic, 1)
        #endif
        for (int w = 0; w < nw; w++) {
            fq *px = (fq *)__builtin_malloc(sizeof(fq) * (size_t)(3 * n + 2));
            if (!px) {
                oom = 1;
                pt_set_identity(&wsum[w]);
                continue;
            }
            fq *py = px + n;
            fq *pairbuf = py + n;   /* n/2 dinv + n/2 prefix + slack */
            msm_window_affine(pts, nys, digs, n, nw, w, hb,
                              px, py, pairbuf, &wsum[w]);
            __builtin_free(px);
        }
        __builtin_free(digs);
        __builtin_free(nys);
        if (oom) return -1;
    } else {
        #ifdef _OPENMP
        #pragma omp parallel for schedule(dynamic, 1)
        #endif
        for (int w = 0; w < nw; w++)
            msm_window_generic(pts, scalars, n, w, &wsum[w]);
    }

    pt total;
    pt_set_identity(&total);
    for (int w = nw - 1; w >= 0; w--) {
        if (!pt_is_identity(&total))
            for (int d = 0; d < c; d++) pt_double(&total, &total);
        pt_add(&total, &total, &wsum[w]);
    }
    store_pt(out, &total);
    return 0;
}

void g1_msm(const u64 *points, const u64 *scalars, long n, u64 *out) {
    pt *pts = (pt *)__builtin_malloc(sizeof(pt) * (size_t)n);
    #ifdef _OPENMP
    #pragma omp parallel for schedule(static)
    #endif
    for (long i = 0; i < n; i++) load_pt(&pts[i], points + 12 * i);
    g1_msm_core(pts, scalars, n, out);
    __builtin_free(pts);
}

static long pt_batch_to_affine_compact(pt *p, const u64 *sc_in, u64 *sc_out,
                                       long n);

/* One indexed/plain MSM job: out = sum_i scalars[i] * base[idx ? idx[i] : i].
 * Returns 0, or -1 on allocation failure (out untouched). */
static int msm_job_plain(const u64 *base, const long *idx,
                         const u64 *scalars, long n, u64 *out) {
    if (n <= 0) {
        pt id;
        pt_set_identity(&id);
        store_pt(out, &id);
        return 0;
    }
    pt *pts = (pt *)__builtin_malloc(sizeof(pt) * (size_t)n);
    if (!pts) return -1;
    for (long i = 0; i < n; i++)
        load_pt(&pts[i], base + 12 * (idx ? idx[i] : i));
    int rc = g1_msm_core(pts, scalars, n, out);
    __builtin_free(pts);
    return rc;
}

/* One grouped sparse MSM job (see g1_msm_grouped_multi for semantics).
 * Returns 0, or -1 on allocation failure (out untouched). */
static int msm_job_grouped(const u64 *base, const long *rows,
                           const long *starts, long ng,
                           const u64 *scalars, u64 *out) {
    if (ng <= 0) {
        pt id;
        pt_set_identity(&id);
        store_pt(out, &id);
        return 0;
    }
    pt *grp = (pt *)__builtin_malloc(sizeof(pt) * (size_t)ng);
    u64 *sc = (u64 *)__builtin_malloc(sizeof(u64) * 4 * (size_t)ng);
    if (!grp || !sc) {
        __builtin_free(grp);
        __builtin_free(sc);
        return -1;
    }
    for (long g = 0; g < ng; g++) {
        pt acc;
        pt_set_identity(&acc);
        for (long i = starts[g]; i < starts[g + 1]; i++) {
            const u64 *q = base + 12 * rows[i];
            fq x = {{q[0], q[1], q[2], q[3]}};
            fq y = {{q[4], q[5], q[6], q[7]}};
            fq mx, my;
            fq_to_mont(&mx, &x);
            fq_to_mont(&my, &y);
            pt_add_mixed(&acc, &acc, &mx, &my);
        }
        grp[g] = acc;
    }
    long m = pt_batch_to_affine_compact(grp, scalars, sc, ng);
    int rc = 0;
    if (m == 0) {
        pt id;
        pt_set_identity(&id);
        store_pt(out, &id);
    } else {
        rc = g1_msm_core(grp, sc, m, out);
    }
    __builtin_free(sc);
    __builtin_free(grp);
    return rc;
}

/* Plain/indexed AND grouped MSM jobs co-scheduled in ONE OpenMP region:
 * the CQ phase previously ran g1_msm_multi then g1_msm_grouped_multi
 * back-to-back, so the tail of the first batch idled cores before the
 * second started.  modes[j]: 0 = plain/indexed (idx_or_rows = optional
 * index list, sizes = n), 1 = grouped (idx_or_rows = CSR rows, starts =
 * CSR offsets, sizes = ngroups).  status[j] gets 0 on success, 1 on
 * allocation failure (out slot set to identity); returns the failure
 * count so callers can re-route failed jobs to a fallback path. */
long g1_msm_unified(const long *modes, const u64 **bases,
                    const long **idx_or_rows, const long **starts,
                    const long *sizes, const u64 **scalars, long k,
                    u64 *out, long *status) {
    long failed = 0;
    #ifdef _OPENMP
    #pragma omp parallel for schedule(dynamic, 1) reduction(+:failed)
    #endif
    for (long j = 0; j < k; j++) {
        int rc;
        if (modes[j] == 1)
            rc = msm_job_grouped(bases[j], idx_or_rows[j], starts[j],
                                 sizes[j], scalars[j], out + 12 * j);
        else
            rc = msm_job_plain(bases[j], idx_or_rows ? idx_or_rows[j] : 0,
                               scalars[j], sizes[j], out + 12 * j);
        if (rc != 0) {
            pt id;
            pt_set_identity(&id);
            store_pt(out + 12 * j, &id);
            status[j] = 1;
            failed += 1;
        } else {
            status[j] = 0;
        }
    }
    return failed;
}

/* MSM over a subset of a fixed basis: out = sum_i scalars[i] *
 * basis[indices[i]] — the CQ prover's sparse a/qa/a0 commitments gather a
 * few thousand rows of a preprocessed table basis per lookup argument
 * (static_lookup/prover.rs:220-257); indexing native-side skips the
 * per-call Python gather + marshalling of ~100-byte points. */
void g1_msm_indexed(const u64 *points, const long *indices,
                    const u64 *scalars, long n, u64 *out) {
    pt *pts = (pt *)__builtin_malloc(sizeof(pt) * (size_t)n);
    #ifdef _OPENMP
    #pragma omp parallel for schedule(static)
    #endif
    for (long i = 0; i < n; i++) load_pt(&pts[i], points + 12 * indices[i]);
    g1_msm_core(pts, scalars, n, out);
    __builtin_free(pts);
}

/* K independent G1 MSMs in one call, OpenMP-parallel ACROSS jobs (the
 * per-window pragmas inside g1_msm_core serialize under the outer region).
 * The prover issues hundreds of small commitment MSMs per proof — advice
 * columns (prover.rs:299-391) and the per-lookup CQ a/qa/a0/b0/p commits
 * (static_lookup/prover.rs:187-343); batching them into one call keeps all
 * cores busy across the whole set instead of ramping a parallel region per
 * commitment.  Per job j: packed affine basis bases[j], optional index list
 * indices[j] (NULL = identity), scalars[j], sizes[j]; out + 12*j gets the
 * Jacobian result. */
void g1_msm_multi(const u64 **bases, const long **indices,
                  const u64 **scalars, const long *sizes, long k, u64 *out) {
    #ifdef _OPENMP
    #pragma omp parallel for schedule(dynamic, 1)
    #endif
    for (long j = 0; j < k; j++) {
        if (msm_job_plain(bases[j], indices ? indices[j] : 0,
                          scalars[j], sizes[j], out + 12 * j) != 0) {
            pt id;    /* alloc failure: identity (legacy ABI has no status
                       * channel; use g1_msm_unified for checked results) */
            pt_set_identity(&id);
            store_pt(out + 12 * j, &id);
        }
    }
}

/* Batch-normalize Jacobian points to z = 1 (Montgomery trick), compacting
 * out identity sums together with their scalars.  Returns the compacted
 * count; scalars are copied into sc_out so the caller's buffer stays
 * const.  One fq_inv for the whole batch + ~6 muls/point. */
static long pt_batch_to_affine_compact(pt *p, const u64 *sc_in, u64 *sc_out,
                                       long n) {
    long m = 0;
    for (long i = 0; i < n; i++) {
        if (pt_is_identity(&p[i]))
            continue;
        if (m != i) p[m] = p[i];
        memcpy(sc_out + 4 * m, sc_in + 4 * i, 4 * sizeof(u64));
        m++;
    }
    if (m == 0)
        return 0;
    fq *pref = (fq *)__builtin_malloc(sizeof(fq) * (size_t)m);
    fq run;
    memcpy(run.v, RMODQ, sizeof RMODQ); /* 1 in Montgomery form */
    for (long i = 0; i < m; i++) {
        pref[i] = run;
        fq_mul(&run, &run, &p[i].z);
    }
    fq inv;
    fq_inv(&inv, &run);
    for (long i = m - 1; i >= 0; i--) {
        fq zi, zi2, zi3;
        fq_mul(&zi, &inv, &pref[i]);       /* 1/z_i */
        fq_mul(&inv, &inv, &p[i].z);       /* 1/prod_{j<i} z_j */
        fq_mul(&zi2, &zi, &zi);
        fq_mul(&zi3, &zi2, &zi);
        fq_mul(&p[i].x, &p[i].x, &zi2);
        fq_mul(&p[i].y, &p[i].y, &zi3);
        memcpy(p[i].z.v, RMODQ, sizeof RMODQ);
    }
    __builtin_free(pref);
    return m;
}

/* Grouped sparse MSM, K jobs in one call:
 *   out_j = sum_g scalars[j][g] * (sum_{i in [starts[j][g], starts[j][g+1])}
 *                                   bases[j][rows[j][i]])
 * The CQ b0/p commitments' scalars depend only on the table row each
 * support row looks up (equal witness value => equal 1/(f+beta)), so
 * grouping the opening-basis points by table row first (one mixed add per
 * row) shrinks the Pippenger size from |support| to |distinct values|.
 * The reference commits the dense coefficient form instead
 * (static_lookup/prover.rs:259-343); sparse+grouped is this repo's
 * redesign of the same commitments. */
void g1_msm_grouped_multi(const u64 **bases, const long **rows,
                          const long **starts, const long *ngroups,
                          const u64 **scalars, long k, u64 *out) {
    #ifdef _OPENMP
    #pragma omp parallel for schedule(dynamic, 1)
    #endif
    for (long j = 0; j < k; j++) {
        if (msm_job_grouped(bases[j], rows[j], starts[j], ngroups[j],
                            scalars[j], out + 12 * j) != 0) {
            pt id;    /* alloc failure: identity (legacy ABI; see above) */
            pt_set_identity(&id);
            store_pt(out + 12 * j, &id);
        }
    }
}

/* 4-bit fixed-window scalar mul on Montgomery-form points (internal). */
static void pt_scalar_mul_glv(pt *out, const pt *base, const u64 *scalar);

static void pt_scalar_mul_w4(pt *out, const pt *base, const u64 *scalar) {
    pt table[16];
    pt_set_identity(&table[0]);
    table[1] = *base;
    for (int i = 2; i < 16; i++) pt_add(&table[i], &table[i - 1], base);
    pt acc;
    pt_set_identity(&acc);
    int top = 3;
    while (top >= 0 && scalar[top] == 0) top--;
    if (top < 0) { *out = acc; return; }
    int started = 0;
    for (int i = top; i >= 0; i--) {
        for (int nib = 15; nib >= 0; nib--) {
            unsigned d = (unsigned)((scalar[i] >> (4 * nib)) & 0xF);
            if (started) {
                pt_double(&acc, &acc);
                pt_double(&acc, &acc);
                pt_double(&acc, &acc);
                pt_double(&acc, &acc);
            }
            if (d) { pt_add(&acc, &acc, &table[d]); started = 1; }
            else if (!started) continue;
        }
    }
    *out = acc;
}

/* batch scalar-mul: out[i] = scalar[i] * point[i] (for SRS power chains,
 * FK pointwise products, Lagrange basis construction); OpenMP-parallel
 * with windowed muls. */
void g1_batch_scalar_mul(const u64 *points, const u64 *scalars, long n, u64 *out) {
    #ifdef _OPENMP
    #pragma omp parallel for schedule(dynamic, 16)
    #endif
    for (long i = 0; i < n; i++) {
        pt p, r;
        load_pt(&p, points + 12 * i);
        pt_scalar_mul_glv(&r, &p, scalars + 4 * i);
        store_pt(out + 12 * i, &r);
    }
}

/* ------------------------------- G2 (Fq2) ---------------------------------
 * Fq2 = Fq[u]/(u^2+1); G2 Jacobian points over Fq2.  Needed natively because
 * the CQ TableSRS carries an N-long G2 power list and each table's
 * [T(x)]_2 commitment is a size-N G2 MSM (poly/kzg/commitment.rs:42-47,
 * static_lookup.rs:128-157) — Python G2 muls are ~10 ms each, minutes per
 * 2^16 table. */
typedef struct { fq c0, c1; } fq2;

static void fq2_add(fq2 *r, const fq2 *a, const fq2 *b) {
    fq_add(&r->c0, &a->c0, &b->c0);
    fq_add(&r->c1, &a->c1, &b->c1);
}

static void fq2_sub(fq2 *r, const fq2 *a, const fq2 *b) {
    fq_sub(&r->c0, &a->c0, &b->c0);
    fq_sub(&r->c1, &a->c1, &b->c1);
}

static void fq2_dbl(fq2 *r, const fq2 *a) { fq2_add(r, a, a); }

static void fq2_mul(fq2 *r, const fq2 *a, const fq2 *b) {
    /* Karatsuba: (a0+a1 u)(b0+b1 u) = a0b0 - a1b1 + ((a0+a1)(b0+b1)-a0b0-a1b1) u */
    fq t0, t1, t2, t3;
    fq_mul(&t0, &a->c0, &b->c0);
    fq_mul(&t1, &a->c1, &b->c1);
    fq_add(&t2, &a->c0, &a->c1);
    fq_add(&t3, &b->c0, &b->c1);
    fq_mul(&t2, &t2, &t3);
    fq2 out;
    fq_sub(&out.c0, &t0, &t1);
    fq_sub(&t2, &t2, &t0);
    fq_sub(&out.c1, &t2, &t1);
    *r = out;
}

static int fq2_is_zero(const fq2 *a) {
    return fq_is_zero(&a->c0) && fq_is_zero(&a->c1);
}

typedef struct { fq2 x, y, z; } pt2;

static void pt2_set_identity(pt2 *p) {
    memset(p, 0, sizeof *p);
    memcpy(p->x.c0.v, RMODQ, sizeof RMODQ);
    memcpy(p->y.c0.v, RMODQ, sizeof RMODQ);
}

static int pt2_is_identity(const pt2 *p) { return fq2_is_zero(&p->z); }

static void pt2_double(pt2 *r, const pt2 *p) {
    if (pt2_is_identity(p)) { *r = *p; return; }
    fq2 A, B, C, D, E, F, t, t2;
    fq2_mul(&A, &p->x, &p->x);
    fq2_mul(&B, &p->y, &p->y);
    fq2_mul(&C, &B, &B);
    fq2_add(&t, &p->x, &B);
    fq2_mul(&t, &t, &t);
    fq2_sub(&t, &t, &A);
    fq2_sub(&t, &t, &C);
    fq2_dbl(&D, &t);
    fq2_dbl(&E, &A);
    fq2_add(&E, &E, &A);
    fq2_mul(&F, &E, &E);
    pt2 out;
    fq2_dbl(&t, &D);
    fq2_sub(&out.x, &F, &t);
    fq2_sub(&t, &D, &out.x);
    fq2_mul(&t, &E, &t);
    fq2_dbl(&t2, &C); fq2_dbl(&t2, &t2); fq2_dbl(&t2, &t2);
    fq2_sub(&out.y, &t, &t2);
    fq2_mul(&t, &p->y, &p->z);
    fq2_dbl(&out.z, &t);
    *r = out;
}

static void pt2_add(pt2 *r, const pt2 *p, const pt2 *q) {
    if (pt2_is_identity(p)) { *r = *q; return; }
    if (pt2_is_identity(q)) { *r = *p; return; }
    fq2 z1z1, z2z2, u1, u2, s1, s2, t;
    fq2_mul(&z1z1, &p->z, &p->z);
    fq2_mul(&z2z2, &q->z, &q->z);
    fq2_mul(&u1, &p->x, &z2z2);
    fq2_mul(&u2, &q->x, &z1z1);
    fq2_mul(&t, &q->z, &z2z2);
    fq2_mul(&s1, &p->y, &t);
    fq2_mul(&t, &p->z, &z1z1);
    fq2_mul(&s2, &q->y, &t);
    fq2 h, rr;
    fq2_sub(&h, &u2, &u1);
    fq2_sub(&rr, &s2, &s1);
    if (fq2_is_zero(&h)) {
        if (fq2_is_zero(&rr)) { pt2_double(r, p); return; }
        pt2_set_identity(r);
        return;
    }
    fq2 hh, hhh, v;
    fq2_mul(&hh, &h, &h);
    fq2_mul(&hhh, &h, &hh);
    fq2_mul(&v, &u1, &hh);
    pt2 out;
    fq2_mul(&t, &rr, &rr);
    fq2_sub(&t, &t, &hhh);
    fq2 tv;
    fq2_dbl(&tv, &v);
    fq2_sub(&out.x, &t, &tv);
    fq2_sub(&t, &v, &out.x);
    fq2_mul(&t, &rr, &t);
    fq2 tu;
    fq2_mul(&tu, &s1, &hhh);
    fq2_sub(&out.y, &t, &tu);
    fq2_mul(&t, &p->z, &q->z);
    fq2_mul(&out.z, &t, &h);
    *r = out;
}

static void pt2_scalar_mul_w4(pt2 *out, const pt2 *base, const u64 *scalar) {
    pt2 table[16];
    pt2_set_identity(&table[0]);
    table[1] = *base;
    for (int i = 2; i < 16; i++) pt2_add(&table[i], &table[i - 1], base);
    pt2 acc;
    pt2_set_identity(&acc);
    int top = 3;
    while (top >= 0 && scalar[top] == 0) top--;
    if (top < 0) { *out = acc; return; }
    int started = 0;
    for (int i = top; i >= 0; i--) {
        for (int nib = 15; nib >= 0; nib--) {
            unsigned d = (unsigned)((scalar[i] >> (4 * nib)) & 0xF);
            if (started) {
                pt2_double(&acc, &acc);
                pt2_double(&acc, &acc);
                pt2_double(&acc, &acc);
                pt2_double(&acc, &acc);
            }
            if (d) { pt2_add(&acc, &acc, &table[d]); started = 1; }
        }
    }
    *out = acc;
}

/* ABI: G2 Jacobian canonical = u64[24]: x.c0, x.c1, y.c0, y.c1, z.c0, z.c1 */
static void load_pt2(pt2 *p, const u64 *in) {
    fq t;
    const u64 *src = in;
    fq *dst[6] = {&p->x.c0, &p->x.c1, &p->y.c0, &p->y.c1, &p->z.c0, &p->z.c1};
    for (int i = 0; i < 6; i++) {
        memcpy(t.v, src + 4 * i, 32);
        fq_to_mont(dst[i], &t);
    }
}

static void store_pt2(u64 *out, const pt2 *p) {
    const fq *src[6] = {&p->x.c0, &p->x.c1, &p->y.c0, &p->y.c1, &p->z.c0, &p->z.c1};
    for (int i = 0; i < 6; i++) {
        fq t;
        fq_from_mont(&t, src[i]);
        memcpy(out + 4 * i, t.v, 32);
    }
}

void g2_batch_scalar_mul(const u64 *points, const u64 *scalars, long n, u64 *out) {
    #ifdef _OPENMP
    #pragma omp parallel for schedule(dynamic, 8)
    #endif
    for (long i = 0; i < n; i++) {
        pt2 p, r;
        load_pt2(&p, points + 24 * i);
        pt2_scalar_mul_w4(&r, &p, scalars + 4 * i);
        store_pt2(out + 24 * i, &r);
    }
}

/* G2 Pippenger MSM (window c = 8), same structure as g1_msm. */
void g2_msm(const u64 *points, const u64 *scalars, long n, u64 *out) {
    enum { C = 8, NBUCKET = 1 << C, NW = (256 + C - 1) / C };
    pt2 wsum[NW];
    pt2 *pts = (pt2 *)__builtin_malloc(sizeof(pt2) * (size_t)n);
    #ifdef _OPENMP
    #pragma omp parallel for schedule(static)
    #endif
    for (long i = 0; i < n; i++) load_pt2(&pts[i], points + 24 * i);

    #ifdef _OPENMP
    #pragma omp parallel for schedule(dynamic, 1)
    #endif
    for (int w = 0; w < NW; w++) {
        pt2 *buckets = (pt2 *)__builtin_malloc(sizeof(pt2) * NBUCKET);
        for (int b = 0; b < NBUCKET; b++) pt2_set_identity(&buckets[b]);
        for (long i = 0; i < n; i++) {
            int limb = (w * C) / 64;
            int shift = (w * C) % 64;
            u64 d = (scalars[4 * i + limb] >> shift);
            if (shift > 64 - C && limb < 3)
                d |= scalars[4 * i + limb + 1] << (64 - shift);
            d &= (NBUCKET - 1);
            if (d) pt2_add(&buckets[d], &buckets[d], &pts[i]);
        }
        pt2 run, acc;
        pt2_set_identity(&run);
        pt2_set_identity(&acc);
        for (int b = NBUCKET - 1; b >= 1; b--) {
            pt2_add(&run, &run, &buckets[b]);
            pt2_add(&acc, &acc, &run);
        }
        wsum[w] = acc;
        __builtin_free(buckets);
    }

    pt2 total;
    pt2_set_identity(&total);
    for (int w = NW - 1; w >= 0; w--) {
        if (!pt2_is_identity(&total))
            for (int d = 0; d < C; d++) pt2_double(&total, &total);
        pt2_add(&total, &total, &wsum[w]);
    }
    __builtin_free(pts);
    store_pt2(out, &total);
}

/* ---------------- group NTT (the Feist-Khovratovich workhorse) ------------
 *
 * In-place radix-2 DIT NTT over G1 points: bit-reversal permutation then
 * log2(n) butterfly stages; matches ops/ntt.ntt_host semantics (same
 * ordering as the reference's generic best_fft, which IS instantiated over
 * groups in halo2 — arithmetic.rs:171 `best_fft<G: Group>`).
 *
 * points: n * u64[12] canonical Jacobian, in/out.
 * twiddles: (n/2) * u64[4] canonical Fr scalars [w^0, w^1, ... w^{n/2-1}].
 *
 * Cost model: each butterfly pays one ~254-bit windowed scalar mul
 * (~250 doubles + ~60 adds); OpenMP over the butterflies of each stage.
 * A 2^17 NTT is ~1.1M butterflies => minutes single-core, ~tens of
 * seconds on a few cores — vs hours in Python (round-1 437 s for 2^12).
 */
static void pt_neg_inplace(pt *p) {
    fq zero;
    memset(&zero, 0, sizeof zero);
    fq_sub(&p->y, &zero, &p->y);
}

void g1_group_ntt(u64 *points, const u64 *twiddles, long n, int k) {
    /* load to Montgomery form */
    pt *pts = (pt *)__builtin_malloc(sizeof(pt) * (size_t)n);
    #ifdef _OPENMP
    #pragma omp parallel for schedule(static)
    #endif
    for (long i = 0; i < n; i++) load_pt(&pts[i], points + 12 * i);

    /* bit-reversal permutation */
    for (long i = 0; i < n; i++) {
        long r = 0;
        long x = i;
        for (int b = 0; b < k; b++) { r = (r << 1) | (x & 1); x >>= 1; }
        if (r > i) { pt tmp = pts[i]; pts[i] = pts[r]; pts[r] = tmp; }
    }

    for (int s = 0; s < k; s++) {
        long half = 1L << s;
        long stride = 1L << (k - 1 - s);
        long nbf = n >> 1;
        #ifdef _OPENMP
        #pragma omp parallel for schedule(dynamic, 64)
        #endif
        for (long bf = 0; bf < nbf; bf++) {
            long blk = bf >> s;
            long j = bf & (half - 1);
            long top = (blk << (s + 1)) | j;
            long bot = top | half;
            pt t;
            if (j == 0) {
                t = pts[bot];
            } else {
                pt_scalar_mul_glv(&t, &pts[bot], twiddles + 4 * (j * stride));
            }
            pt nt = t;
            pt_neg_inplace(&nt);
            pt e = pts[top];
            pt_add(&pts[top], &e, &t);
            pt_add(&pts[bot], &e, &nt);
        }
    }

    #ifdef _OPENMP
    #pragma omp parallel for schedule(static)
    #endif
    for (long i = 0; i < n; i++) store_pt(points + 12 * i, &pts[i]);
    __builtin_free(pts);
}

/* ------------------------- Fr scalar-field kernels ------------------------
 *
 * Host-side Fr (BN254 scalar field) bulk kernels: the prover's CQ
 * log-derivative iNTTs, multiopen polynomial folds, Horner evaluations and
 * kate division are O(n)/O(n log n) bigint loops that were pure Python.
 * Montgomery 4x64 CIOS identical in shape to the fq_* ops above; constants
 * pinned to reference bn256/fr.rs:28-60.
 *
 * ABI: values are canonical little-endian u64[4].  Internally we exploit
 * the identity mont_mul(a_canonical, b*R) = a*b (canonical), so vector
 * kernels convert only the scalar operand to Montgomery form.
 */
static const u64 FRQ[4] = {0x43e1f593f0000001ULL, 0x2833e84879b97091ULL,
                           0xb85045b68181585dULL, 0x30644e72e131a029ULL};
static const u64 FR_R2[4] = {0x1bb8e645ae216da7ULL, 0x53fe3ab1e35c59e3ULL,
                             0x8c49833d53bb8085ULL, 0x0216d0b17f4e44a5ULL};
static const u64 FR_NINV = 0xc2e1f593efffffffULL;

typedef struct { u64 v[4]; } fr;

static inline int fr_geq(const u64 a[4], const u64 b[4]) {
    for (int i = 3; i >= 0; i--) {
        if (a[i] > b[i]) return 1;
        if (a[i] < b[i]) return 0;
    }
    return 1;
}

static inline void sub_fr(u64 a[4]) {
    u128 borrow = 0;
    for (int i = 0; i < 4; i++) {
        u128 d = (u128)a[i] - FRQ[i] - borrow;
        a[i] = (u64)d;
        borrow = (d >> 64) & 1;
    }
}

static void fr_add(fr *r, const fr *a, const fr *b) {
    u128 carry = 0;
    for (int i = 0; i < 4; i++) {
        u128 s = (u128)a->v[i] + b->v[i] + carry;
        r->v[i] = (u64)s;
        carry = s >> 64;
    }
    if (carry || fr_geq(r->v, FRQ)) sub_fr(r->v);
}

static void fr_sub(fr *r, const fr *a, const fr *b) {
    u128 borrow = 0;
    u64 t[4];
    for (int i = 0; i < 4; i++) {
        u128 d = (u128)a->v[i] - b->v[i] - borrow;
        t[i] = (u64)d;
        borrow = (d >> 64) & 1;
    }
    if (borrow) {
        u128 carry = 0;
        for (int i = 0; i < 4; i++) {
            u128 s = (u128)t[i] + FRQ[i] + carry;
            t[i] = (u64)s;
            carry = s >> 64;
        }
    }
    memcpy(r->v, t, sizeof t);
}

static void fr_mul(fr *r, const fr *a, const fr *b) {
    u64 t[6] = {0, 0, 0, 0, 0, 0};
    for (int i = 0; i < 4; i++) {
        u128 carry = 0;
        for (int j = 0; j < 4; j++) {
            u128 cur = (u128)t[j] + (u128)a->v[i] * b->v[j] + carry;
            t[j] = (u64)cur;
            carry = cur >> 64;
        }
        u128 cur = (u128)t[4] + carry;
        t[4] = (u64)cur;
        t[5] = (u64)(cur >> 64);

        u64 m = t[0] * FR_NINV;
        carry = ((u128)t[0] + (u128)m * FRQ[0]) >> 64;
        for (int j = 1; j < 4; j++) {
            u128 c2 = (u128)t[j] + (u128)m * FRQ[j] + carry;
            t[j - 1] = (u64)c2;
            carry = c2 >> 64;
        }
        cur = (u128)t[4] + carry;
        t[3] = (u64)cur;
        t[4] = t[5] + (u64)(cur >> 64);
        t[5] = 0;
    }
    if (t[4] || fr_geq(t, FRQ)) sub_fr(t);
    memcpy(r->v, t, 4 * sizeof(u64));
}

static void fr_to_mont(fr *r, const fr *a) {
    fr r2;
    memcpy(r2.v, FR_R2, sizeof FR_R2);
    fr_mul(r, a, &r2);
}

/* In-place radix-2 DIT NTT over Fr, same semantics as ops/ntt.ntt_host
 * (bit-reverse then breadth-first butterflies; natural order in and out).
 * twiddles: (n/2) canonical scalars [w^0 .. w^{n/2-1}]. */
void fr_ntt(u64 *vals, const u64 *twiddles, long n, int k) {
    fr *a = (fr *)__builtin_malloc(sizeof(fr) * (size_t)n);
    fr *tw = (fr *)__builtin_malloc(sizeof(fr) * (size_t)(n / 2));
    #ifdef _OPENMP
    #pragma omp parallel for schedule(static) if(n >= 65536)
    #endif
    for (long i = 0; i < n; i++) fr_to_mont(&a[i], (const fr *)(vals + 4 * i));
    #ifdef _OPENMP
    #pragma omp parallel for schedule(static) if(n >= 131072)
    #endif
    for (long i = 0; i < n / 2; i++)
        fr_to_mont(&tw[i], (const fr *)(twiddles + 4 * i));

    for (long i = 0; i < n; i++) {
        long r = 0, x = i;
        for (int b = 0; b < k; b++) { r = (r << 1) | (x & 1); x >>= 1; }
        if (r > i) { fr tmp = a[i]; a[i] = a[r]; a[r] = tmp; }
    }

    for (int s = 0; s < k; s++) {
        long half = 1L << s;
        long stride = 1L << (k - 1 - s);
        long nbf = n >> 1;
        #ifdef _OPENMP
        #pragma omp parallel for schedule(static) if(nbf >= 65536)
        #endif
        for (long bf = 0; bf < nbf; bf++) {
            long blk = bf >> s;
            long j = bf & (half - 1);
            long top = (blk << (s + 1)) | j;
            long bot = top | half;
            fr t;
            if (j == 0) t = a[bot];
            else fr_mul(&t, &a[bot], &tw[j * stride]);
            fr e = a[top];
            fr_add(&a[top], &e, &t);
            fr_sub(&a[bot], &e, &t);
        }
    }

    fr one = {{1, 0, 0, 0}};
    #ifdef _OPENMP
    #pragma omp parallel for schedule(static) if(n >= 65536)
    #endif
    for (long i = 0; i < n; i++)
        fr_mul((fr *)(vals + 4 * i), &a[i], &one);  /* from Montgomery */
    __builtin_free(a);
    __builtin_free(tw);
}

/* K independent same-size NTTs, OpenMP ACROSS transforms (fr_ntt's inner
 * pragmas are size-gated off at per-proof polynomial sizes).  With ninv
 * non-NULL each result is scaled by it — i.e. pass the inverse twiddle
 * table plus 1/n for a batched iNTT (the CQ prover's ~2-per-lookup
 * lagrange_to_coeff conversions, static_lookup/prover.rs:259-276). */
void fr_ntt_multi(u64 **vals, const u64 *twiddles, long n, int k,
                  long count, const u64 *ninv) {
    #ifdef _OPENMP
    #pragma omp parallel for schedule(dynamic, 1)
    #endif
    for (long j = 0; j < count; j++) {
        fr_ntt(vals[j], twiddles, n, k);
        if (ninv) fr_vec_scale(vals[j], ninv, n);
    }
}

/* acc[i] = acc[i] * v + add[i] (all canonical); add may be NULL or shorter
 * than n (addn entries, rest treated as 0) — the gwc/shplonk poly fold. */
void fr_fold(u64 *acc, const u64 *add, long addn, const u64 *v, long n) {
    fr vm;
    fr_to_mont(&vm, (const fr *)v);
    #ifdef _OPENMP
    #pragma omp parallel for schedule(static) if(n >= 131072)
    #endif
    for (long i = 0; i < n; i++) {
        fr t;
        fr_mul(&t, (const fr *)(acc + 4 * i), &vm);
        if (add && i < addn) fr_add(&t, &t, (const fr *)(add + 4 * i));
        memcpy(acc + 4 * i, &t, sizeof t);
    }
}

/* vals[i] *= b[i] (canonical in/out, elementwise) — the CQ prover's
 * counts*inverse and support-correction products stay (n,4) limb buffers
 * instead of round-tripping ~5M Python bigints per large-k proof. */
void fr_vec_mul(u64 *vals, const u64 *b, long n) {
    #ifdef _OPENMP
    #pragma omp parallel for schedule(static) if(n >= 65536)
    #endif
    for (long i = 0; i < n; i++) {
        fr bm, t;
        fr_to_mont(&bm, (const fr *)(b + 4 * i));
        fr_mul(&t, (const fr *)(vals + 4 * i), &bm);
        memcpy(vals + 4 * i, &t, sizeof t);
    }
}

/* vals[i] *= c (canonical) */
void fr_vec_scale(u64 *vals, const u64 *c, long n) {
    fr cm;
    fr_to_mont(&cm, (const fr *)c);
    #ifdef _OPENMP
    #pragma omp parallel for schedule(static) if(n >= 131072)
    #endif
    for (long i = 0; i < n; i++) {
        fr t;
        fr_mul(&t, (const fr *)(vals + 4 * i), &cm);
        memcpy(vals + 4 * i, &t, sizeof t);
    }
}

/* Horner evaluation out = poly(x); poly canonical, length n. */
void fr_eval_poly(const u64 *poly, long n, const u64 *x, u64 *out) {
    fr xm, acc;
    fr_to_mont(&xm, (const fr *)x);
    memset(&acc, 0, sizeof acc);
    for (long i = n - 1; i >= 0; i--) {
        fr t;
        fr_mul(&t, &acc, &xm);
        fr_add(&acc, &t, (const fr *)(poly + 4 * i));
    }
    memcpy(out, &acc, sizeof acc);
}

/* kate division: q(X) = (p(X) - p(b)) / (X - b), deg q = n-2.
 * out must hold n-1 elements (reference arithmetic.rs:351-387 semantics:
 * quotient only, caller already knows p(b)). */
void fr_kate_div(const u64 *poly, long n, const u64 *b, u64 *out) {
    fr bm, acc;
    fr_to_mont(&bm, (const fr *)b);
    memset(&acc, 0, sizeof acc);
    for (long i = n - 2; i >= 0; i--) {
        fr t;
        fr_mul(&t, &acc, &bm);
        fr_add(&acc, &t, (const fr *)(poly + 4 * (i + 1)));
        memcpy(out + 4 * i, &acc, sizeof acc);
    }
}

/* Permutation grand-product passes (reference permutation/prover.rs:47-201)
 * — the per-row Python loops were ~0.5 s of every SHA-256 prove.
 * All buffers canonical u64[4] limbs. */

/* acc[i] *= (beta*sigma[i] + gamma + vals[i]) */
void fr_perm_mul_acc(u64 *acc, const u64 *sigma, const u64 *vals,
                     const u64 *beta, const u64 *gamma, long n) {
    fr bm, gm;
    fr_to_mont(&bm, (const fr *)beta);
    fr_to_mont(&gm, (const fr *)gamma);
    #ifdef _OPENMP
    #pragma omp parallel for schedule(static)
    #endif
    for (long i = 0; i < n; i++) {
        fr s, v, a, t;
        fr_to_mont(&s, (const fr *)(sigma + 4 * i));
        fr_to_mont(&v, (const fr *)(vals + 4 * i));
        fr_to_mont(&a, (const fr *)(acc + 4 * i));
        fr_mul(&t, &s, &bm);
        fr_add(&t, &t, &gm);
        fr_add(&t, &t, &v);
        fr_mul(&a, &a, &t);
        fr one = {{1, 0, 0, 0}};
        fr_mul((fr *)(acc + 4 * i), &a, &one);  /* from Montgomery */
    }
}

/* acc[i] *= (dbase*omega^i*beta + gamma + vals[i]) — the numerator pass
 * with its geometric delta*omega^i coefficient */
void fr_perm_mul_acc_geo(u64 *acc, const u64 *vals, const u64 *beta,
                         const u64 *gamma, const u64 *dbase,
                         const u64 *omega, long n) {
    fr bm, gm, dm, om;
    fr_to_mont(&bm, (const fr *)beta);
    fr_to_mont(&gm, (const fr *)gamma);
    fr_to_mont(&dm, (const fr *)dbase);
    fr_to_mont(&om, (const fr *)omega);
    #ifdef _OPENMP
    #pragma omp parallel
    #endif
    {
        long lo = 0, hi = n;
        #ifdef _OPENMP
        int nt = omp_get_num_threads(), id = omp_get_thread_num();
        lo = n * id / nt;
        hi = n * (id + 1) / nt;
        #endif
        /* d at this thread's start row: dbase * omega^lo (square&multiply) */
        fr d = dm, opow = om;
        long e = lo;
        fr acc_p;
        fr one = {{1, 0, 0, 0}};
        fr one_m;
        fr_to_mont(&one_m, &one);
        acc_p = one_m;
        while (e) {
            if (e & 1) fr_mul(&acc_p, &acc_p, &opow);
            fr_mul(&opow, &opow, &opow);
            e >>= 1;
        }
        fr_mul(&d, &dm, &acc_p);
        for (long i = lo; i < hi; i++) {
            fr v, a, t;
            fr_to_mont(&v, (const fr *)(vals + 4 * i));
            fr_to_mont(&a, (const fr *)(acc + 4 * i));
            fr_mul(&t, &d, &bm);
            fr_add(&t, &t, &gm);
            fr_add(&t, &t, &v);
            fr_mul(&a, &a, &t);
            fr_mul((fr *)(acc + 4 * i), &a, &one);
            fr_mul(&d, &d, &om);
        }
    }
}

/* z[0] = z0; z[i] = z[i-1] * m[i-1]  (the grand-product prefix) */
void fr_prefix_prod(const u64 *m, const u64 *z0, u64 *z, long n) {
    fr acc, one = {{1, 0, 0, 0}};
    fr_to_mont(&acc, (const fr *)z0);
    for (long i = 0; i < n; i++) {
        fr out;
        fr_mul(&out, &acc, &one);
        memcpy(z + 4 * i, &out, sizeof out);
        if (i + 1 < n) {
            fr mi;
            fr_to_mont(&mi, (const fr *)(m + 4 * i));
            fr_mul(&acc, &acc, &mi);
        }
    }
}

/* Batch modular inverse via Montgomery's trick; vals in/out canonical.
 * Zero entries are left as zero (matching fields/host.batch_inv). */
void fr_batch_inv(u64 *vals, long n) {
    fr *pref = (fr *)__builtin_malloc(sizeof(fr) * (size_t)(n + 1));
    fr *vm = (fr *)__builtin_malloc(sizeof(fr) * (size_t)n);
    fr one_m;
    fr one = {{1, 0, 0, 0}};
    fr_to_mont(&one_m, &one);
    pref[0] = one_m;
    for (long i = 0; i < n; i++) {
        fr_to_mont(&vm[i], (const fr *)(vals + 4 * i));
        int z = !(vm[i].v[0] | vm[i].v[1] | vm[i].v[2] | vm[i].v[3]);
        if (z) pref[i + 1] = pref[i];
        else fr_mul(&pref[i + 1], &pref[i], &vm[i]);
    }
    /* invert pref[n] by exponentiation: inv = x^(r-2) */
    fr base = pref[n], accv = one_m;
    u64 e[4];
    memcpy(e, FRQ, sizeof e);
    /* r - 2 */
    e[0] -= 2;  /* FRQ[0] >= 2, no borrow */
    for (int w = 0; w < 4; w++) {
        for (int bit = 0; bit < 64; bit++) {
            if ((e[w] >> bit) & 1) fr_mul(&accv, &accv, &base);
            fr_mul(&base, &base, &base);
        }
    }
    fr inv = accv;
    for (long i = n - 1; i >= 0; i--) {
        int z = !(vm[i].v[0] | vm[i].v[1] | vm[i].v[2] | vm[i].v[3]);
        if (z) continue;
        fr t;
        fr_mul(&t, &pref[i], &inv);       /* inverse of vals[i], mont */
        fr_mul(&inv, &inv, &vm[i]);
        fr_mul((fr *)(vals + 4 * i), &t, &one);  /* from mont -> canonical */
    }
    __builtin_free(pref);
    __builtin_free(vm);
}

/* =================== optimal-ate pairing (BN254, verifier) ===================
   Tower: fq2 = fq[u]/(u^2+1); fq6 = fq2[v]/(v^3 - xi), xi = 9+u;
   fq12 = fq6[w]/(w^2 - v).  Mirrors curves/host.py miller_loop (Fq2
   Jacobian dbl/add steps with sparse {w^0,w^1,w^3} line coefficients) and
   final_exponentiation (BN addition chain, 3x exp-by-x); randomized
   equality vs the Python oracle is pinned in tests/test_native_pairing.py.
   All constants below are Montgomery-form; generated from the Python
   tower (fq2_pow(XI, (p-1)/3) etc.) and cross-checked there. */

static void fq_neg(fq *r, const fq *a) {
    if (fq_is_zero(a)) { *r = *a; return; }
    u64 br = 0;
    for (int i = 0; i < 4; i++) {
        u128 d = (u128)Q[i] - a->v[i] - br;
        r->v[i] = (u64)d;
        br = (d >> 64) ? 1 : 0;
    }
}

static void fq2_neg(fq2 *r, const fq2 *a) { fq_neg(&r->c0, &a->c0); fq_neg(&r->c1, &a->c1); }
static void fq2_conj(fq2 *r, const fq2 *a) { r->c0 = a->c0; fq_neg(&r->c1, &a->c1); }

static void fq2_mul_fq(fq2 *r, const fq2 *a, const fq *b) {
    fq_mul(&r->c0, &a->c0, b);
    fq_mul(&r->c1, &a->c1, b);
}

static void fq2_mul_xi(fq2 *r, const fq2 *a) {
    /* (9 a0 - a1) + (a0 + 9 a1) u */
    fq t0, t1, n0;
    fq_dbl(&t0, &a->c0); fq_dbl(&t0, &t0); fq_dbl(&t0, &t0); fq_add(&t0, &t0, &a->c0); /* 9 a0 */
    fq_dbl(&t1, &a->c1); fq_dbl(&t1, &t1); fq_dbl(&t1, &t1); fq_add(&t1, &t1, &a->c1); /* 9 a1 */
    n0 = a->c0;
    fq_sub(&t0, &t0, &a->c1);
    fq_add(&t1, &t1, &n0);
    r->c0 = t0; r->c1 = t1;
}

static void fq2_sq2(fq2 *r, const fq2 *a) { fq2_mul(r, a, a); }

static void fq2_inv(fq2 *r, const fq2 *a) {
    fq d, t0, t1;
    fq_mul(&t0, &a->c0, &a->c0);
    fq_mul(&t1, &a->c1, &a->c1);
    fq_add(&d, &t0, &t1);
    fq_inv(&d, &d);
    fq_mul(&r->c0, &a->c0, &d);
    fq_mul(&t0, &a->c1, &d);
    fq_neg(&r->c1, &t0);
}

typedef struct { fq2 c0, c1, c2; } fq6;

static void fq6_add(fq6 *r, const fq6 *a, const fq6 *b) {
    fq2_add(&r->c0, &a->c0, &b->c0);
    fq2_add(&r->c1, &a->c1, &b->c1);
    fq2_add(&r->c2, &a->c2, &b->c2);
}

static void fq6_sub(fq6 *r, const fq6 *a, const fq6 *b) {
    fq2_sub(&r->c0, &a->c0, &b->c0);
    fq2_sub(&r->c1, &a->c1, &b->c1);
    fq2_sub(&r->c2, &a->c2, &b->c2);
}

static void fq6_neg(fq6 *r, const fq6 *a) {
    fq2_neg(&r->c0, &a->c0); fq2_neg(&r->c1, &a->c1); fq2_neg(&r->c2, &a->c2);
}

static void fq6_mul(fq6 *r, const fq6 *a, const fq6 *b) {
    fq2 t0, t1, t2, s0, s1, x;
    fq6 out;
    fq2_mul(&t0, &a->c0, &b->c0);
    fq2_mul(&t1, &a->c1, &b->c1);
    fq2_mul(&t2, &a->c2, &b->c2);
    /* c0 = t0 + xi((a1+a2)(b1+b2) - t1 - t2) */
    fq2_add(&s0, &a->c1, &a->c2);
    fq2_add(&s1, &b->c1, &b->c2);
    fq2_mul(&x, &s0, &s1);
    fq2_sub(&x, &x, &t1);
    fq2_sub(&x, &x, &t2);
    fq2_mul_xi(&x, &x);
    fq2_add(&out.c0, &t0, &x);
    /* c1 = (a0+a1)(b0+b1) - t0 - t1 + xi t2 */
    fq2_add(&s0, &a->c0, &a->c1);
    fq2_add(&s1, &b->c0, &b->c1);
    fq2_mul(&x, &s0, &s1);
    fq2_sub(&x, &x, &t0);
    fq2_sub(&x, &x, &t1);
    fq2 xt2;
    fq2_mul_xi(&xt2, &t2);
    fq2_add(&out.c1, &x, &xt2);
    /* c2 = (a0+a2)(b0+b2) - t0 - t2 + t1 */
    fq2_add(&s0, &a->c0, &a->c2);
    fq2_add(&s1, &b->c0, &b->c2);
    fq2_mul(&x, &s0, &s1);
    fq2_sub(&x, &x, &t0);
    fq2_sub(&x, &x, &t2);
    fq2_add(&out.c2, &x, &t1);
    *r = out;
}

static void fq6_mul_by_v(fq6 *r, const fq6 *a) {
    /* v (a0 + a1 v + a2 v^2) = xi a2 + a0 v + a1 v^2 */
    fq6 out;
    fq2_mul_xi(&out.c0, &a->c2);
    out.c1 = a->c0;
    out.c2 = a->c1;
    *r = out;
}

static void fq6_inv(fq6 *r, const fq6 *a) {
    fq2 C0, C1, C2, t, x, T;
    /* C0 = a0^2 - xi a1 a2; C1 = xi a2^2 - a0 a1; C2 = a1^2 - a0 a2 */
    fq2_sq2(&C0, &a->c0);
    fq2_mul(&t, &a->c1, &a->c2);
    fq2_mul_xi(&t, &t);
    fq2_sub(&C0, &C0, &t);
    fq2_sq2(&C1, &a->c2);
    fq2_mul_xi(&C1, &C1);
    fq2_mul(&t, &a->c0, &a->c1);
    fq2_sub(&C1, &C1, &t);
    fq2_sq2(&C2, &a->c1);
    fq2_mul(&t, &a->c0, &a->c2);
    fq2_sub(&C2, &C2, &t);
    /* T = a0 C0 + xi(a2 C1 + a1 C2) */
    fq2_mul(&x, &a->c2, &C1);
    fq2_mul(&t, &a->c1, &C2);
    fq2_add(&x, &x, &t);
    fq2_mul_xi(&x, &x);
    fq2_mul(&T, &a->c0, &C0);
    fq2_add(&T, &T, &x);
    fq2_inv(&T, &T);
    fq2_mul(&r->c0, &C0, &T);
    fq2_mul(&r->c1, &C1, &T);
    fq2_mul(&r->c2, &C2, &T);
}

typedef struct { fq6 c0, c1; } fq12;

static void fq12_mul(fq12 *r, const fq12 *a, const fq12 *b) {
    fq6 t0, t1, s0, s1, x;
    fq12 out;
    fq6_mul(&t0, &a->c0, &b->c0);
    fq6_mul(&t1, &a->c1, &b->c1);
    /* c0 = t0 + v t1 ; c1 = (a0+a1)(b0+b1) - t0 - t1 */
    fq6_mul_by_v(&x, &t1);
    fq6_add(&out.c0, &t0, &x);
    fq6_add(&s0, &a->c0, &a->c1);
    fq6_add(&s1, &b->c0, &b->c1);
    fq6_mul(&x, &s0, &s1);
    fq6_sub(&x, &x, &t0);
    fq6_sub(&out.c1, &x, &t1);
    *r = out;
}

static void fq12_sq(fq12 *r, const fq12 *a) { fq12_mul(r, a, a); }

static void fq12_conj(fq12 *r, const fq12 *a) {
    r->c0 = a->c0;
    fq6_neg(&r->c1, &a->c1);
}

static void fq12_inv(fq12 *r, const fq12 *a) {
    fq6 t0, t1, x;
    fq6_mul(&t0, &a->c0, &a->c0);
    fq6_mul(&t1, &a->c1, &a->c1);
    fq6_mul_by_v(&x, &t1);
    fq6_sub(&t0, &t0, &x);
    fq6_inv(&t0, &t0);
    fq6_mul(&r->c0, &a->c0, &t0);
    fq6_mul(&x, &a->c1, &t0);
    fq6_neg(&r->c1, &x);
}

/* Frobenius^1 coefficients (Montgomery form): FROB6_C1 = xi^((p-1)/3),
   FROB6_C2 = xi^(2(p-1)/3), FROB12_C1 = xi^((p-1)/6); PSI_X/PSI_Y are the
   untwist-Frobenius-twist constants for the G2 endomorphism. */
static const fq2 FROB6_C1 = {{{0xb5773b104563ab30ULL, 0x347f91c8a9aa6454ULL, 0x7a007127242e0991ULL, 0x1956bcd8118214ecULL}}, {{0x6e849f1ea0aa4757ULL, 0xaa1c7b6d89f89141ULL, 0xb6e713cdfae0ca3aULL, 0x26694fbb4e82ebc3ULL}}};
static const fq2 FROB6_C2 = {{{0x7361d77f843abe92ULL, 0xa5bb2bd3273411fbULL, 0x9c941f314b3e2399ULL, 0x15df9cddbb9fd3ecULL}}, {{0x5dddfd154bd8c949ULL, 0x62cb29a5a4445b60ULL, 0x37bc870a0c7dd2b9ULL, 0x24830a9d3171f0fdULL}}};
static const fq2 FROB12_C1 = {{{0xaf9ba69633144907ULL, 0xca6b1d7387afb78aULL, 0x11bded5ef08a2087ULL, 0x02f34d751a1f3a7cULL}}, {{0xa222ae234c492d72ULL, 0xd00f02a4565de15bULL, 0xdc2ff3a253dfc926ULL, 0x10a75716b3899551ULL}}};
static const fq2 PSI_X = {{{0xb5773b104563ab30ULL, 0x347f91c8a9aa6454ULL, 0x7a007127242e0991ULL, 0x1956bcd8118214ecULL}}, {{0x6e849f1ea0aa4757ULL, 0xaa1c7b6d89f89141ULL, 0xb6e713cdfae0ca3aULL, 0x26694fbb4e82ebc3ULL}}};
static const fq2 PSI_Y = {{{0xe4bbdd0c2936b629ULL, 0xbb30f162e133bacbULL, 0x31a9d1b6f9645366ULL, 0x253570bea500f8ddULL}}, {{0xa1d77ce45ffe77c7ULL, 0x07affd117826d1dbULL, 0x6d16bd27bb7edc6bULL, 0x2c87200285defeccULL}}};

static void fq12_frob1(fq12 *r, const fq12 *a) {
    fq12 out;
    fq2_conj(&out.c0.c0, &a->c0.c0);
    fq2_conj(&out.c0.c1, &a->c0.c1); fq2_mul(&out.c0.c1, &out.c0.c1, &FROB6_C1);
    fq2_conj(&out.c0.c2, &a->c0.c2); fq2_mul(&out.c0.c2, &out.c0.c2, &FROB6_C2);
    fq2_conj(&out.c1.c0, &a->c1.c0); fq2_mul(&out.c1.c0, &out.c1.c0, &FROB12_C1);
    fq2_conj(&out.c1.c1, &a->c1.c1); fq2_mul(&out.c1.c1, &out.c1.c1, &FROB6_C1);
    fq2_mul(&out.c1.c1, &out.c1.c1, &FROB12_C1);
    fq2_conj(&out.c1.c2, &a->c1.c2); fq2_mul(&out.c1.c2, &out.c1.c2, &FROB6_C2);
    fq2_mul(&out.c1.c2, &out.c1.c2, &FROB12_C1);
    *r = out;
}

static void fq12_set_one(fq12 *r) {
    memset(r, 0, sizeof(*r));
    memcpy(r->c0.c0.c0.v, RMODQ, sizeof(RMODQ));
}

static int fq12_is_one(const fq12 *a) {
    fq12 one;
    fq12_set_one(&one);
    return memcmp(a, &one, sizeof(one)) == 0;
}

/* ------------------------------ Miller loop ------------------------------ */

typedef struct { fq2 X, Y, Z; } g2j;

static void line_dbl(g2j *t, const fq *xp3, const fq *ypn2,
                     fq2 *c0, fq2 *c1, fq2 *c3) {
    /* curves/host.py _dbl_step: line scaled by 2 Yt Zt^6 */
    fq2 XX, YY, YYYY, ZZ, S, M, X3, Y3, Z3, Zt3, tt;
    fq2_sq2(&XX, &t->X);
    fq2_sq2(&YY, &t->Y);
    fq2_sq2(&YYYY, &YY);
    fq2_sq2(&ZZ, &t->Z);
    fq2_add(&tt, &t->X, &YY);
    fq2_sq2(&tt, &tt);
    fq2_sub(&tt, &tt, &XX);
    fq2_sub(&tt, &tt, &YYYY);
    fq2_dbl(&S, &tt);
    fq2_dbl(&M, &XX);
    fq2_add(&M, &M, &XX);
    fq2_sq2(&X3, &M);
    fq2_dbl(&tt, &S);
    fq2_sub(&X3, &X3, &tt);
    fq2_add(&Z3, &t->Y, &t->Z);
    fq2_sq2(&Z3, &Z3);
    fq2_sub(&Z3, &Z3, &YY);
    fq2_sub(&Z3, &Z3, &ZZ);
    fq2_sub(&tt, &S, &X3);
    fq2_mul(&Y3, &M, &tt);
    fq2_dbl(&tt, &YYYY); fq2_dbl(&tt, &tt); fq2_dbl(&tt, &tt);
    fq2_sub(&Y3, &Y3, &tt);
    fq2_mul(&Zt3, &ZZ, &t->Z);
    /* c0 = (Y Zt3) * (-2 yp); c1 = (XX ZZ) * (3 xp); c3 = 2 YY - 3 XX X */
    fq2_mul(c0, &t->Y, &Zt3);
    fq2_mul_fq(c0, c0, ypn2);
    fq2_mul(c1, &XX, &ZZ);
    fq2_mul_fq(c1, c1, xp3);
    fq2_mul(&tt, &XX, &t->X);
    fq2 tt3;
    fq2_dbl(&tt3, &tt); fq2_add(&tt3, &tt3, &tt);
    fq2_dbl(c3, &YY);
    fq2_sub(c3, c3, &tt3);
    t->X = X3; t->Y = Y3; t->Z = Z3;
}

static void line_add(g2j *t, const fq2 *xq, const fq2 *yq,
                      const fq *xp, const fq *ypn,
                      fq2 *c0, fq2 *c1, fq2 *c3) {
    /* curves/host.py _add_step: line scaled by H Zt = Z3 */
    fq2 ZZ, U2, S2, H, R, HH, HHH, V, X3, Y3, Z3, tt;
    fq2_sq2(&ZZ, &t->Z);
    fq2_mul(&U2, xq, &ZZ);
    fq2_mul(&S2, yq, &ZZ);
    fq2_mul(&S2, &S2, &t->Z);
    fq2_sub(&H, &U2, &t->X);
    fq2_sub(&R, &S2, &t->Y);
    fq2_sq2(&HH, &H);
    fq2_mul(&HHH, &H, &HH);
    fq2_mul(&V, &t->X, &HH);
    fq2_sq2(&X3, &R);
    fq2_sub(&X3, &X3, &HHH);
    fq2_dbl(&tt, &V);
    fq2_sub(&X3, &X3, &tt);
    fq2_sub(&tt, &V, &X3);
    fq2_mul(&Y3, &R, &tt);
    fq2_mul(&tt, &t->Y, &HHH);
    fq2_sub(&Y3, &Y3, &tt);
    fq2_mul(&Z3, &t->Z, &H);
    fq2_mul_fq(c0, &Z3, ypn);
    fq2_mul_fq(c1, &R, xp);
    fq2_mul(c3, yq, &Z3);
    fq2_mul(&tt, &R, xq);
    fq2_sub(c3, c3, &tt);
    t->X = X3; t->Y = Y3; t->Z = Z3;
}

static void fq12_mul_sparse013(fq12 *f, const fq2 *c0, const fq2 *c1, const fq2 *c3) {
    /* multiply by g with g0.a0 = c0, g1.a0 = c1, g1.a1 = c3, rest zero */
    fq12 g;
    memset(&g, 0, sizeof(g));
    g.c0.c0 = *c0;
    g.c1.c0 = *c1;
    g.c1.c1 = *c3;
    fq12_mul(f, f, &g);
}

/* ATE_LOOP_COUNT = 6x+2 = 29793968203157093288 (65 bits) */
static const u64 ATE_LO = 0x9d797039be763ba8ULL;  /* low 64 bits */
/* bit 64 is set; loop runs i = 63..0 like the Python bit_length-2 start */

static void miller_loop_c(const fq *xp, const fq *yp,
                          const fq2 *xq, const fq2 *yq, fq12 *f) {
    fq xp3, ypn, ypn2, t0;
    fq_dbl(&t0, xp);
    fq_add(&xp3, &t0, xp);          /* 3 xp */
    fq_neg(&ypn, yp);               /* -yp */
    fq_dbl(&ypn2, &ypn);            /* -2 yp */
    g2j t;
    t.X = *xq; t.Y = *yq;
    memset(&t.Z, 0, sizeof(t.Z));
    memcpy(t.Z.c0.v, RMODQ, sizeof(RMODQ));
    fq12_set_one(f);
    fq2 c0, c1, c3;
    for (int i = 63; i >= 0; i--) {
        fq12_sq(f, f);
        line_dbl(&t, &xp3, &ypn2, &c0, &c1, &c3);
        fq12_mul_sparse013(f, &c0, &c1, &c3);
        if ((ATE_LO >> i) & 1) {
            line_add(&t, xq, yq, xp, &ypn, &c0, &c1, &c3);
            fq12_mul_sparse013(f, &c0, &c1, &c3);
        }
    }
    /* q1 = psi(q); q2 = psi(q1); add q1 then -q2 */
    fq2 x1, y1, x2, y2, ny2;
    fq2_conj(&x1, xq); fq2_mul(&x1, &x1, &PSI_X);
    fq2_conj(&y1, yq); fq2_mul(&y1, &y1, &PSI_Y);
    fq2_conj(&x2, &x1); fq2_mul(&x2, &x2, &PSI_X);
    fq2_conj(&y2, &y1); fq2_mul(&y2, &y2, &PSI_Y);
    fq2_neg(&ny2, &y2);
    line_add(&t, &x1, &y1, xp, &ypn, &c0, &c1, &c3);
    fq12_mul_sparse013(f, &c0, &c1, &c3);
    line_add(&t, &x2, &ny2, xp, &ypn, &c0, &c1, &c3);
    fq12_mul_sparse013(f, &c0, &c1, &c3);
}

/* BN parameter x = 4965661367192848881 (63 bits) */
static const u64 BN_X_C = 0x44e992b44a6909f1ULL;

static void fq12_exp_x(fq12 *r, const fq12 *a) {
    fq12 acc, base;
    fq12_set_one(&acc);
    base = *a;
    for (int i = 0; i < 63; i++) {
        if ((BN_X_C >> i) & 1) fq12_mul(&acc, &acc, &base);
        fq12_sq(&base, &base);
    }
    *r = acc;
}

static void final_exp_c(fq12 *r, const fq12 *f) {
    /* easy: f^(p^6-1) then ^(p^2+1); hard: BN addition chain
       (curves/host.py final_exponentiation) */
    fq12 f1, fi, rr, fp1, fp2, fp3, fu, fu2, fu3, fu2p, fu3p;
    fq12 y0, y1, y2, y3, y4, y5, y6, t0, t1, x;
    fq12_conj(&f1, f);
    fq12_inv(&fi, f);
    fq12_mul(&f1, &f1, &fi);
    fq12_frob1(&rr, &f1); fq12_frob1(&rr, &rr);
    fq12_mul(&rr, &rr, &f1);
    fq12_frob1(&fp1, &rr);
    fq12_frob1(&fp2, &fp1);
    fq12_frob1(&fp3, &fp2);
    fq12_exp_x(&fu, &rr);
    fq12_exp_x(&fu2, &fu);
    fq12_exp_x(&fu3, &fu2);
    fq12_frob1(&fu2p, &fu2);
    fq12_frob1(&fu3p, &fu3);
    fq12_mul(&y0, &fp1, &fp2);
    fq12_mul(&y0, &y0, &fp3);
    fq12_conj(&y1, &rr);
    fq12_frob1(&y2, &fu2); fq12_frob1(&y2, &y2);
    fq12_frob1(&y3, &fu); fq12_conj(&y3, &y3);
    fq12_mul(&y4, &fu, &fu2p); fq12_conj(&y4, &y4);
    fq12_conj(&y5, &fu2);
    fq12_mul(&y6, &fu3, &fu3p); fq12_conj(&y6, &y6);
    fq12_sq(&t0, &y6);
    fq12_mul(&t0, &t0, &y4);
    fq12_mul(&t0, &t0, &y5);
    fq12_mul(&t1, &y3, &y5);
    fq12_mul(&t1, &t1, &t0);
    fq12_mul(&t0, &t0, &y2);
    fq12_sq(&x, &t1);
    fq12_mul(&x, &x, &t0);
    fq12_sq(&t1, &x);
    fq12_mul(&t0, &t1, &y1);
    fq12_mul(&t1, &t1, &y0);
    fq12_sq(&t0, &t0);
    fq12_mul(r, &t1, &t0);
}

/* pairs: g1s n*(2*4) u64 affine x,y; g2s n*(4*4) u64 affine x(c0,c1),y(c0,c1);
   all canonical (non-Montgomery); caller filters identity points.
   out (optional, may be NULL): 48 u64 canonical fq12 of the final result.
   Returns 1 iff prod e(Pi, Qi) == 1. */
int bn_pairing_check(const u64 *g1s, const u64 *g2s, long n, u64 *out) {
    fq12 acc, f;
    fq12_set_one(&acc);
    for (long i = 0; i < n; i++) {
        fq xp, yp;
        fq2 xq, yq;
        memcpy(xp.v, g1s + 8 * i, 32);
        memcpy(yp.v, g1s + 8 * i + 4, 32);
        memcpy(xq.c0.v, g2s + 16 * i, 32);
        memcpy(xq.c1.v, g2s + 16 * i + 4, 32);
        memcpy(yq.c0.v, g2s + 16 * i + 8, 32);
        memcpy(yq.c1.v, g2s + 16 * i + 12, 32);
        fq_to_mont(&xp, &xp); fq_to_mont(&yp, &yp);
        fq_to_mont(&xq.c0, &xq.c0); fq_to_mont(&xq.c1, &xq.c1);
        fq_to_mont(&yq.c0, &yq.c0); fq_to_mont(&yq.c1, &yq.c1);
        miller_loop_c(&xp, &yp, &xq, &yq, &f);
        fq12_mul(&acc, &acc, &f);
    }
    final_exp_c(&acc, &acc);
    if (out) {
        fq *cs = (fq *)&acc;
        for (int i = 0; i < 12; i++) {
            fq t;
            fq_from_mont(&t, &cs[i]);
            memcpy(out + 4 * i, t.v, 32);
        }
    }
    return fq12_is_one(&acc);
}

/* ---- verifier helpers: sqrt (p = 3 mod 4) and Jacobian->affine ---------- */

/* (p+1)/4, little-endian u64 words */
static const u64 QP1_4[4] = {0x4f082305b61f3f52ULL, 0x65e05aa45a1c72a3ULL,
                             0x6e14116da0605617ULL, 0x0c19139cb84c680aULL};

static void fq_pow_words(fq *r, const fq *a, const u64 *e) {
    fq acc, base = *a;
    memcpy(acc.v, RMODQ, sizeof(RMODQ));
    for (int w = 0; w < 4; w++)
        for (int bit = 0; bit < 64; bit++) {
            if ((e[w] >> bit) & 1) fq_mul(&acc, &acc, &base);
            fq_mul(&base, &base, &base);
        }
    *r = acc;
}

/* ys[i] = sqrt(xs[i]) if square else 0; canonical in/out.
   Returns nothing; caller validates y^2 == x (it must anyway, since a
   non-residue input yields sqrt of a wrong value). */
void fq_sqrt_batch(const u64 *xs, long n, u64 *ys) {
    for (long i = 0; i < n; i++) {
        fq x, y;
        memcpy(x.v, xs + 4 * i, 32);
        fq_to_mont(&x, &x);
        fq_pow_words(&y, &x, QP1_4);
        fq_from_mont(&y, &y);
        memcpy(ys + 4 * i, y.v, 32);
    }
}

/* Jacobian (X, Y, Z) canonical -> affine (x, y) canonical; identity -> 0,0 */
void g1_jac_to_affine_batch(const u64 *jac, long n, u64 *out) {
    for (long i = 0; i < n; i++) {
        pt p;
        load_pt(&p, jac + 12 * i);
        if (pt_is_identity(&p)) {
            memset(out + 8 * i, 0, 64);
            continue;
        }
        fq zi, zi2, zi3, x, y;
        fq_inv(&zi, &p.z);
        fq_mul(&zi2, &zi, &zi);
        fq_mul(&zi3, &zi2, &zi);
        fq_mul(&x, &p.x, &zi2);
        fq_mul(&y, &p.y, &zi3);
        fq_from_mont(&x, &x);
        fq_from_mont(&y, &y);
        memcpy(out + 8 * i, x.v, 32);
        memcpy(out + 8 * i + 4, y.v, 32);
    }
}

/* ================== GLV scalar multiplication (BN254 G1) ==================
   phi(x,y) = (beta x, y) acts as multiplication by lambda (cube root of
   unity in Fr); k decomposes as k1 + lambda k2 with |k_i| < 2^127 via the
   rounded-lattice method.  Joint 4-bit windows over the two 128-bit halves
   cut the doubling chain from 254 to 128 (~35% fewer point ops per mul) —
   the FK table preprocessing (g1_group_ntt butterflies, batch scalar muls)
   is made of exactly these muls.  Constants derived + cross-checked in
   Python (tests/test_native_fr.py pins GLV == double-and-add). */

static const fq BETA_MONT = {{0x3350c88e13e80b9cULL, 0x7dce557cdb5e56b9ULL,
                              0x6001b4b8b615564aULL, 0x2682e617020217e0ULL}};
/* N1 = round(2^320 |b2| / r); N2 = round(2^320 |b1| / r) */
static const u64 GLV_N1[4] = {0x149d540fd5e495ccULL, 0x5398fd0300ff6565ULL,
                              0x4ccef014a773d2d2ULL, 0x0000000000000002ULL};
static const u64 GLV_N2[4] = {0x6eb9c714773a6ef3ULL, 0xd91d232ec7e0b3d7ULL,
                              0x0000000000000002ULL, 0x0000000000000000ULL};
static const u64 GLV_A1[2] = {0x8211bbeb7d4f1128ULL, 0x6f4d8248eeb859fcULL};
static const u64 GLV_G2C[2] = {0x89d3256894d213e3ULL, 0x0000000000000000ULL};
static const u64 GLV_G1C[2] = {0x0be4e1541221250bULL, 0x6f4d8248eeb859fdULL};

static void glv_round_hi320(const u64 *k, const u64 *nc, u64 out[2]) {
    /* out = (k * nc + 2^319) >> 320; product < 2^448 so word 7 stays 0 */
    u64 prod[8] = {0};
    for (int i = 0; i < 4; i++) {
        u128 carry = 0;
        for (int j = 0; j < 4; j++) {
            u128 cur = (u128)k[i] * nc[j] + prod[i + j] + carry;
            prod[i + j] = (u64)cur;
            carry = cur >> 64;
        }
        int idx = i + 4;
        while (carry) {
            u128 cur = (u128)prod[idx] + (u64)carry;
            prod[idx] = (u64)cur;
            carry = (carry >> 64) + (cur >> 64);
            idx++;
        }
    }
    u128 cur = (u128)prod[4] + 0x8000000000000000ULL;
    prod[4] = (u64)cur;
    int idx = 5;
    u64 c = (u64)(cur >> 64);
    while (c) {
        u128 t = (u128)prod[idx] + c;
        prod[idx] = (u64)t;
        c = (u64)(t >> 64);
        idx++;
    }
    out[0] = prod[5];
    out[1] = prod[6];
}

static void glv_submul(u64 acc[4], const u64 c[2], const u64 m[2], int add) {
    /* acc +-= c*m over 256-bit two's complement (c, m < 2^128) */
    u64 prod[4] = {0};
    for (int i = 0; i < 2; i++) {
        u128 carry = 0;
        for (int j = 0; j < 2; j++) {
            u128 cur = (u128)c[i] * m[j] + prod[i + j] + carry;
            prod[i + j] = (u64)cur;
            carry = cur >> 64;
        }
        prod[i + 2] += (u64)carry;  /* no overflow: product < 2^256 */
    }
    if (add) {
        u128 carry = 0;
        for (int i = 0; i < 4; i++) {
            u128 cur = (u128)acc[i] + prod[i] + carry;
            acc[i] = (u64)cur;
            carry = cur >> 64;
        }
    } else {
        u128 borrow = 0;
        for (int i = 0; i < 4; i++) {
            u128 cur = (u128)acc[i] - prod[i] - borrow;
            acc[i] = (u64)cur;
            borrow = (cur >> 64) ? 1 : 0;
        }
    }
}

static int glv_abs128(u64 v[4], u64 out[2]) {
    /* two's-complement 256-bit -> (sign, |v|) with |v| < 2^128 */
    int neg = (v[3] >> 63) != 0;
    if (neg) {
        u128 carry = 1;
        for (int i = 0; i < 4; i++) {
            u128 cur = (u128)(~v[i]) + carry;
            v[i] = (u64)cur;
            carry = cur >> 64;
        }
    }
    out[0] = v[0];
    out[1] = v[1];
    return neg;
}

static void pt_neg(pt *r, const pt *p) {
    r->x = p->x;
    fq_neg(&r->y, &p->y);
    r->z = p->z;
}

static void pt_scalar_mul_glv(pt *out, const pt *base, const u64 *scalar) {
    u64 c1[2], c2m[2];
    glv_round_hi320(scalar, GLV_N1, c1);
    glv_round_hi320(scalar, GLV_N2, c2m);
    /* k1 = k - c1 a1 - c2m |b1|;  k2 = c1 |b1| - c2m |b2| */
    u64 k1[4] = {scalar[0], scalar[1], scalar[2], scalar[3]};
    glv_submul(k1, c1, GLV_A1, 0);
    glv_submul(k1, c2m, GLV_G2C, 0);
    u64 k2[4] = {0, 0, 0, 0};
    glv_submul(k2, c1, GLV_G2C, 1);
    glv_submul(k2, c2m, GLV_G1C, 0);
    u64 s1[2], s2[2];
    int n1 = glv_abs128(k1, s1);
    int n2 = glv_abs128(k2, s2);

    pt b1 = *base, b2;
    b2 = *base;
    fq_mul(&b2.x, &b2.x, &BETA_MONT);
    if (n1) pt_neg(&b1, &b1);
    if (n2) pt_neg(&b2, &b2);

    pt t1[16], t2[16];
    pt_set_identity(&t1[0]);
    pt_set_identity(&t2[0]);
    t1[1] = b1; t2[1] = b2;
    for (int i = 2; i < 16; i++) {
        pt_add(&t1[i], &t1[i - 1], &b1);
        pt_add(&t2[i], &t2[i - 1], &b2);
    }
    pt acc;
    pt_set_identity(&acc);
    int started = 0;
    for (int nib = 31; nib >= 0; nib--) {
        if (started) {
            pt_double(&acc, &acc);
            pt_double(&acc, &acc);
            pt_double(&acc, &acc);
            pt_double(&acc, &acc);
        }
        unsigned d1 = (unsigned)((s1[nib >> 4] >> ((nib & 15) * 4)) & 0xF);
        unsigned d2 = (unsigned)((s2[nib >> 4] >> ((nib & 15) * 4)) & 0xF);
        if (d1) { pt_add(&acc, &acc, &t1[d1]); started = 1; }
        if (d2) { pt_add(&acc, &acc, &t2[d2]); started = 1; }
    }
    *out = acc;
}

/* exported for the GLV == double-and-add pinning test */
void g1_scalar_mul_glv(const u64 *point, const u64 *scalar, u64 *out) {
    pt base, r;
    load_pt(&base, point);
    pt_scalar_mul_glv(&r, &base, scalar);
    store_pt(out, &r);
}
