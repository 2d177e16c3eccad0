// Pasta base-field arithmetic for Hopper: 255-bit elements as eight
// little-endian 32-bit limbs, Montgomery form with R = 2^256.
//
// Replaces the tile helpers of the JAX package's ops/pallas_field.py
// (mul_tile, _cond_sub_tile, add_tile, sub_tile), which hold sixteen 16-bit
// limbs in uint32 lanes because the TPU's vector unit has no 32x32->64
// multiply.  Here each limb product is one 32-bit mad.lo / mad.hi pair and
// every carry rides the condition-code flag of a PTX carry chain
// (mad.lo.cc / madc.hi.cc / addc.cc), so a Montgomery product is 8 CIOS
// rounds of two 8-limb multiply-accumulate chains (~270 integer
// multiply-adds) instead of 256 16-bit partial products and 16 REDC
// rounds.  R is the same 2^256, so a Montgomery integer is the same number
// as in the reference; only n0 = -p^-1 mod 2^32 differs from the 16-bit
// one.  Results are canonical (< p), as in the reference.
//
// Bound on this card: the multiply-adds.  Each product, sum and compare
// runs in registers; the kernels that include this header load each
// operand once and store each result once, so the bytes are small beside
// the integer work.
//
// Each carry chain is ONE asm statement: the carry flag is not preserved
// between separate asm statements, so a chain split across statements
// could see a flag the compiler clobbered in between.
#pragma once

#include <cstdint>

typedef uint32_t u32;

// Field ids: 0 = F_P (the Pallas base field), 1 = F_Q (the Vesta base field).
static __constant__ u32 FIELD_P[2][8] = {
    {0x00000001u, 0x992d30edu, 0x094cf91bu, 0x224698fcu,
     0x00000000u, 0x00000000u, 0x00000000u, 0x40000000u},
    {0x00000001u, 0x8c46eb21u, 0x0994a8ddu, 0x224698fcu,
     0x00000000u, 0x00000000u, 0x00000000u, 0x40000000u}};
// -p^-1 mod 2^32 (both moduli are 1 mod 2^32)
static __constant__ u32 FIELD_N0[2] = {0xffffffffu, 0xffffffffu};
// 3b = 15 in Montgomery form (y^2 = x^3 + 5 on both curves)
static __constant__ u32 FIELD_B3[2][8] = {
    {0xffffffc5u, 0xb295b960u, 0xdb4296a3u, 0x19babde9u,
     0xfffffff8u, 0xffffffffu, 0xffffffffu, 0x3fffffffu},
    {0xffffffc5u, 0xaba7cf64u, 0xcabd14f0u, 0x19babde9u,
     0xfffffff8u, 0xffffffffu, 0xffffffffu, 0x3fffffffu}};
// 1 in Montgomery form (R mod p)
static __constant__ u32 FIELD_ONE[2][8] = {
    {0xfffffffdu, 0x34786d38u, 0xe41914adu, 0x992c350bu,
     0xffffffffu, 0xffffffffu, 0xffffffffu, 0x3fffffffu},
    {0xfffffffdu, 0x5b2b3e9cu, 0xe3420567u, 0x992c350bu,
     0xffffffffu, 0xffffffffu, 0xffffffffu, 0x3fffffffu}};

struct fe {
    u32 v[8];
};

template <int F>
__device__ __forceinline__ fe fe_const(const u32 (&c)[2][8]) {
    fe r;
#pragma unroll
    for (int i = 0; i < 8; ++i) r.v[i] = c[F][i];
    return r;
}

// t[0..9] += x[0..7] * y: the low halves of the eight products in one
// carry chain, the high halves (one word up) in a second.
__device__ __forceinline__ void mac_row(u32 (&t)[10], const u32 (&x)[8],
                                        u32 y) {
    asm("mad.lo.cc.u32  %0, %10, %18, %0;\n\t"
        "madc.lo.cc.u32 %1, %11, %18, %1;\n\t"
        "madc.lo.cc.u32 %2, %12, %18, %2;\n\t"
        "madc.lo.cc.u32 %3, %13, %18, %3;\n\t"
        "madc.lo.cc.u32 %4, %14, %18, %4;\n\t"
        "madc.lo.cc.u32 %5, %15, %18, %5;\n\t"
        "madc.lo.cc.u32 %6, %16, %18, %6;\n\t"
        "madc.lo.cc.u32 %7, %17, %18, %7;\n\t"
        "addc.cc.u32    %8, %8, 0;\n\t"
        "addc.u32       %9, %9, 0;\n\t"
        "mad.hi.cc.u32  %1, %10, %18, %1;\n\t"
        "madc.hi.cc.u32 %2, %11, %18, %2;\n\t"
        "madc.hi.cc.u32 %3, %12, %18, %3;\n\t"
        "madc.hi.cc.u32 %4, %13, %18, %4;\n\t"
        "madc.hi.cc.u32 %5, %14, %18, %5;\n\t"
        "madc.hi.cc.u32 %6, %15, %18, %6;\n\t"
        "madc.hi.cc.u32 %7, %16, %18, %7;\n\t"
        "madc.hi.cc.u32 %8, %17, %18, %8;\n\t"
        "addc.u32       %9, %9, 0;"
        : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]),
          "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8]), "+r"(t[9])
        : "r"(x[0]), "r"(x[1]), "r"(x[2]), "r"(x[3]), "r"(x[4]),
          "r"(x[5]), "r"(x[6]), "r"(x[7]), "r"(y));
}

// s = r - p over 8 limbs; returns 0xffffffff when it borrowed (r < p).
__device__ __forceinline__ u32 sub8(u32 (&s)[8], const u32 (&r)[8],
                                    const u32 (&p)[8]) {
    u32 bw;
    const u32 zero = 0;
    asm("sub.cc.u32  %0, %9, %17;\n\t"
        "subc.cc.u32 %1, %10, %18;\n\t"
        "subc.cc.u32 %2, %11, %19;\n\t"
        "subc.cc.u32 %3, %12, %20;\n\t"
        "subc.cc.u32 %4, %13, %21;\n\t"
        "subc.cc.u32 %5, %14, %22;\n\t"
        "subc.cc.u32 %6, %15, %23;\n\t"
        "subc.cc.u32 %7, %16, %24;\n\t"
        "subc.u32    %8, %25, %25;"
        : "=r"(s[0]), "=r"(s[1]), "=r"(s[2]), "=r"(s[3]), "=r"(s[4]),
          "=r"(s[5]), "=r"(s[6]), "=r"(s[7]), "=r"(bw)
        : "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3]), "r"(r[4]),
          "r"(r[5]), "r"(r[6]), "r"(r[7]),
          "r"(p[0]), "r"(p[1]), "r"(p[2]), "r"(p[3]), "r"(p[4]),
          "r"(p[5]), "r"(p[6]), "r"(p[7]), "r"(zero));
    return bw;
}

// s = a + b over 8 limbs, carry out dropped.
__device__ __forceinline__ void add8(u32 (&s)[8], const u32 (&a)[8],
                                     const u32 (&b)[8]) {
    asm("add.cc.u32  %0, %8, %16;\n\t"
        "addc.cc.u32 %1, %9, %17;\n\t"
        "addc.cc.u32 %2, %10, %18;\n\t"
        "addc.cc.u32 %3, %11, %19;\n\t"
        "addc.cc.u32 %4, %12, %20;\n\t"
        "addc.cc.u32 %5, %13, %21;\n\t"
        "addc.cc.u32 %6, %14, %22;\n\t"
        "addc.u32    %7, %15, %23;"
        : "=r"(s[0]), "=r"(s[1]), "=r"(s[2]), "=r"(s[3]), "=r"(s[4]),
          "=r"(s[5]), "=r"(s[6]), "=r"(s[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]),
          "r"(a[5]), "r"(a[6]), "r"(a[7]),
          "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]),
          "r"(b[5]), "r"(b[6]), "r"(b[7]));
}

// r < 2p -> r mod p
template <int F>
__device__ __forceinline__ fe fe_reduce_once(const fe& r) {
    const fe p = fe_const<F>(FIELD_P);
    fe s;
    const u32 bw = sub8(s.v, r.v, p.v);
#pragma unroll
    for (int i = 0; i < 8; ++i) s.v[i] = (r.v[i] & bw) | (s.v[i] & ~bw);
    return s;
}

template <int F>
__device__ __forceinline__ fe fe_add(const fe& a, const fe& b) {
    fe s;
    add8(s.v, a.v, b.v);       // a + b < 2p < 2^256: no carry out
    return fe_reduce_once<F>(s);
}

template <int F>
__device__ __forceinline__ fe fe_sub(const fe& a, const fe& b) {
    fe d, q;
    const fe p = fe_const<F>(FIELD_P);
    const u32 bw = sub8(d.v, a.v, b.v);
#pragma unroll
    for (int i = 0; i < 8; ++i) q.v[i] = p.v[i] & bw;
    fe r;
    add8(r.v, d.v, q.v);       // + p when a < b (wraps mod 2^256)
    return r;
}

// Montgomery product a*b*2^-256 mod p (CIOS).  With a, b < p the running
// value stays below 2p between rounds, so it fits t[0..8] and one
// conditional subtract leaves it canonical.
template <int F>
__device__ __forceinline__ fe fe_mul(const fe& a, const fe& b) {
    const fe p = fe_const<F>(FIELD_P);
    const u32 n0 = FIELD_N0[F];
    u32 t[10] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        mac_row(t, a.v, b.v[i]);
        const u32 m = t[0] * n0;
        mac_row(t, p.v, m);    // t[0] becomes 0
#pragma unroll
        for (int j = 0; j < 9; ++j) t[j] = t[j + 1];
        t[9] = 0;
    }
    fe r;
#pragma unroll
    for (int i = 0; i < 8; ++i) r.v[i] = t[i];
    return fe_reduce_once<F>(r);
}
