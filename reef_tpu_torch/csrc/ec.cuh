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
