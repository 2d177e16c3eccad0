// Complete projective point addition on the Pasta curves (y^2 = x^3 + 5),
// Renes-Costello-Batina 2016 Algorithm 7 (a = 0): branch-free, correct for
// the identity (0:1:0), doubling and P + (-P).  Device counterpart of the
// JAX package's ec/pallas_ec.py padd_tiles and padd_affine_tiles.
//
// Points cross device memory as structure-of-arrays int32 tensors of
// three field rows (X, Y, Z; see load_fe in field.cuh).
#pragma once

#include "field.cuh"

struct point {
    fe x, y, z;
};

__device__ __forceinline__ point load_point(const u32* base, size_t row,
                                            size_t i) {
    return {load_fe(base, row, 0, i), load_fe(base, row, 1, i),
            load_fe(base, row, 2, i)};
}

__device__ __forceinline__ void store_point(u32* base, size_t row, size_t i,
                                            const point& p) {
    store_fe(base, row, 0, i, p.x);
    store_fe(base, row, 1, i, p.y);
    store_fe(base, row, 2, i, p.z);
}

// 14 Montgomery products, the formula of the plain version (ec/msm.py)
template <int F>
__device__ __forceinline__ point padd(const point& P, const point& Q) {
    const fe b3 = fe_const<F>(FIELD_B3);
    fe t0 = fe_mul<F>(P.x, Q.x);
    fe t1 = fe_mul<F>(P.y, Q.y);
    fe t2 = fe_mul<F>(P.z, Q.z);
    fe t3 = fe_mul<F>(fe_add<F>(P.x, P.y), fe_add<F>(Q.x, Q.y));
    t3 = fe_sub<F>(t3, fe_add<F>(t0, t1));
    fe t4 = fe_mul<F>(fe_add<F>(P.y, P.z), fe_add<F>(Q.y, Q.z));
    t4 = fe_sub<F>(t4, fe_add<F>(t1, t2));
    fe x3 = fe_mul<F>(fe_add<F>(P.x, P.z), fe_add<F>(Q.x, Q.z));
    fe y3 = fe_sub<F>(x3, fe_add<F>(t0, t2));
    x3 = fe_add<F>(t0, t0);
    t0 = fe_add<F>(x3, t0);
    t2 = fe_mul<F>(b3, t2);
    fe z3 = fe_add<F>(t1, t2);
    t1 = fe_sub<F>(t1, t2);
    y3 = fe_mul<F>(b3, y3);
    x3 = fe_mul<F>(t4, y3);
    x3 = fe_sub<F>(fe_mul<F>(t3, t1), x3);
    y3 = fe_mul<F>(y3, t0);
    y3 = fe_add<F>(fe_mul<F>(t1, z3), y3);
    t0 = fe_mul<F>(t0, t3);
    z3 = fe_add<F>(fe_mul<F>(z3, t4), t0);
    return {x3, y3, z3};
}

// The same addition for Z1 = Z2 = 1: t2 = 1 and 3b*t2 = 3b are constants
// and two cross products collapse to additions — 10 products
template <int F>
__device__ __forceinline__ point padd_affine(const fe& x1, const fe& y1,
                                             const fe& x2, const fe& y2) {
    const fe b3 = fe_const<F>(FIELD_B3);
    fe t0 = fe_mul<F>(x1, x2);
    fe t1 = fe_mul<F>(y1, y2);
    const fe t4 = fe_add<F>(y1, y2);
    const fe t5 = fe_add<F>(x1, x2);
    const fe t3 = fe_sub<F>(fe_mul<F>(fe_add<F>(x1, y1), fe_add<F>(x2, y2)),
                            fe_add<F>(t0, t1));
    const fe y3 = fe_mul<F>(b3, t5);
    t0 = fe_add<F>(fe_add<F>(t0, t0), t0);
    const fe z3 = fe_add<F>(t1, b3);
    t1 = fe_sub<F>(t1, b3);
    return {fe_sub<F>(fe_mul<F>(t3, t1), fe_mul<F>(t4, y3)),
            fe_add<F>(fe_mul<F>(t1, z3), fe_mul<F>(y3, t0)),
            fe_add<F>(fe_mul<F>(z3, t4), fe_mul<F>(t0, t3))};
}

// The same addition spread over a group of SPREAD threads (K1's SPREAD
// launch, csrc/padd.cu, and the IPA rounds' window combine, csrc/ipa.cu):
// a chain of 3 products in place of 14.
constexpr int SPREAD = 6;           // threads a SPREAD add

__device__ __forceinline__ fe fe_sel(bool c, const fe& a, const fe& b) {
    fe r;
#pragma unroll
    for (int l = 0; l < 8; ++l) r.v[l] = c ? a.v[l] : b.v[l];
    return r;
}

__device__ __forceinline__ fe fe_ld(const fe* s) {
    fe r;
#pragma unroll
    for (int l = 0; l < 8; ++l) r.v[l] = s->v[l];
    return r;
}

__device__ __forceinline__ void fe_st(fe* s, const fe& a) {
#pragma unroll
    for (int l = 0; l < 8; ++l) s->v[l] = a.v[l];
}

// O[oi] = P[pi] + Q[qi] (rows prow, qrow, orow: global or shared memory)
// by the SPREAD threads of a group; r < SPREAD is the thread's rank in it
// and `sh` the group's 12 field elements of shared scratch.  Holds two
// __syncthreads: every thread of the block calls it alike, and a thread
// with `active` false (a lane past the end, a thread outside every group)
// only takes part in the barriers.  A call reads sh[0..5] only between
// its two barriers and sh[6..11] only after them, so calls may follow one
// another with no barrier between.  The stages (ec.cuh's padd):
//   1. rank r: t0 = X1 X2, t1 = Y1 Y2, t2 = Z1 Z2, (X1+Y1)(X2+Y2),
//      (Y1+Z1)(Y2+Z2), (X1+Z1)(X2+Z2);
//   2. the sums of t3, t4, y3 and 3 t0, and the one of 3b*t2 (ranks 1, 3,
//      5) or 3b*y3 (ranks 0, 2) that rank r needs;
//   3. rank r: t4 y3, t3 t1, y3 t0, t1 z3, t0 t3, z3 t4 (y3 = 3b*y3,
//      t1 = t1 - 3b*t2, z3 = t1 + 3b*t2, t0 = 3 t0);
//   then ranks 0, 1, 2 write X3, Y3, Z3.
template <int F>
__device__ __forceinline__ void padd_spread(
    const u32* P, size_t prow, size_t pi, const u32* Q, size_t qrow,
    size_t qi, u32* O, size_t orow, size_t oi, int r, fe* sh, bool active) {
    if (active) {
        // stage 1: (P[c1] (+ P[c2])) (Q[c1] (+ Q[c2]))
        const int c1 = r < 3 ? r : (r == 4 ? 1 : 0);
        const int c2 = r == 3 ? 1 : 2;
        fe a = load_fe(P, prow, c1, pi), b = load_fe(Q, qrow, c1, qi);
        const fe a2 = fe_add<F>(a, load_fe(P, prow, c2, pi));
        const fe b2 = fe_add<F>(b, load_fe(Q, qrow, c2, qi));
        a = fe_sel(r >= 3, a2, a);
        b = fe_sel(r >= 3, b2, b);
        fe_st(&sh[r], fe_mul<F>(a, b));
    }
    __syncthreads();
    if (active) {
        const fe t0 = fe_ld(&sh[0]), t1 = fe_ld(&sh[1]), t2 = fe_ld(&sh[2]);
        const fe t3 = fe_sub<F>(fe_ld(&sh[3]), fe_add<F>(t0, t1));
        const fe t4 = fe_sub<F>(fe_ld(&sh[4]), fe_add<F>(t1, t2));
        const fe y3 = fe_sub<F>(fe_ld(&sh[5]), fe_add<F>(t0, t2));
        const fe t03 = fe_add<F>(fe_add<F>(t0, t0), t0);
        // stage 2: ranks 0 and 2 need 3b*y3, the others 3b*t2
        const bool wy = r == 0 || r == 2;
        const fe w = fe_mul<F>(fe_const<F>(FIELD_B3), fe_sel(wy, y3, t2));
        const fe z3 = fe_add<F>(t1, w);      // t1 + 3b t2 (ranks 1, 3, 5)
        const fe t1m = fe_sub<F>(t1, w);     // t1 - 3b t2 (ranks 1, 3, 5)
        // stage 3: u v for rank r
        fe u = fe_sel(r == 0, t4, fe_sel(r == 1, t3, fe_sel(r == 2, w,
               fe_sel(r == 3, t1m, fe_sel(r == 4, t03, z3)))));
        fe v = fe_sel(r == 0, w, fe_sel(r == 1, t1m, fe_sel(r == 2, t03,
               fe_sel(r == 3, z3, fe_sel(r == 4, t3, t4)))));
        u = fe_mul<F>(u, v);
        fe_st(&sh[SPREAD + r], u);
    }
    __syncthreads();
    if (active && r < 3) {
        // X3 = t3 t1 - t4 y3, Y3 = t1 z3 + y3 t0, Z3 = z3 t4 + t0 t3
        const fe lo = fe_ld(&sh[SPREAD + 2 * r]);
        const fe hi = fe_ld(&sh[SPREAD + 2 * r + 1]);
        store_fe(O, orow, r, oi,
                 r == 0 ? fe_sub<F>(hi, lo) : fe_add<F>(hi, lo));
    }
}
