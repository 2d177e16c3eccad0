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

// ---------------------------------------------------------------------------
// Pasta-shaped products: full 512-bit products, summed unreduced, then one
// REDC shaped for the two moduli.
//
// Both moduli are p = 1 + q 2^32 + 2^254 with q < 2^96 (limb 0 is 1,
// limbs 1-3 hold q, limbs 4-6 are 0, limb 7 is 2^30), and n0 = -1.  So a
// REDC round's m is -w_i, and m p is m at word i (w_i + m carries iff
// w_i != 0), m q at words i+1 .. i+4 and m 2^254 at words i+7 and i+8:
// three limb products where fe_mul's REDC half takes eight.  A row of an
// MDS mix, sum_j M_ij s_j, sums its t products as they come (`wide_mul`,
// `wide_mac`) and reduces once (`pasta_redc`), where fe_mul and fe_add
// would reduce t times and add t - 1 times.  A wide value is 17 words:
// nine products below p^2 < 2^510 fit.  fe_mul stays as it is for the
// kernels that include this header.

template <int F>
struct pasta_q;     // limbs 1-3 of p
template <>
struct pasta_q<0> {
    static constexpr u32 q1 = 0x992d30edu, q2 = 0x094cf91bu,
                         q3 = 0x224698fcu;
};
template <>
struct pasta_q<1> {
    static constexpr u32 q1 = 0x8c46eb21u, q2 = 0x0994a8ddu,
                         q3 = 0x224698fcu;
};

// w[I .. I+8] += a * y for a schoolbook product's row I >= 1: w[I+8] is
// written, not read (the rows below reach word I+7 at most).
template <int I>
__device__ __forceinline__ void wide_row(u32 (&w)[17], const u32 (&a)[8],
                                         u32 y) {
    const u32 zero = 0;
    asm("mad.lo.cc.u32  %0, %9, %17, %0;\n\t"
        "madc.lo.cc.u32 %1, %10, %17, %1;\n\t"
        "madc.lo.cc.u32 %2, %11, %17, %2;\n\t"
        "madc.lo.cc.u32 %3, %12, %17, %3;\n\t"
        "madc.lo.cc.u32 %4, %13, %17, %4;\n\t"
        "madc.lo.cc.u32 %5, %14, %17, %5;\n\t"
        "madc.lo.cc.u32 %6, %15, %17, %6;\n\t"
        "madc.lo.cc.u32 %7, %16, %17, %7;\n\t"
        "addc.u32       %8, %18, 0;\n\t"
        "mad.hi.cc.u32  %1, %9, %17, %1;\n\t"
        "madc.hi.cc.u32 %2, %10, %17, %2;\n\t"
        "madc.hi.cc.u32 %3, %11, %17, %3;\n\t"
        "madc.hi.cc.u32 %4, %12, %17, %4;\n\t"
        "madc.hi.cc.u32 %5, %13, %17, %5;\n\t"
        "madc.hi.cc.u32 %6, %14, %17, %6;\n\t"
        "madc.hi.cc.u32 %7, %15, %17, %7;\n\t"
        "madc.hi.u32    %8, %16, %17, %8;"
        : "+r"(w[I]), "+r"(w[I + 1]), "+r"(w[I + 2]), "+r"(w[I + 3]),
          "+r"(w[I + 4]), "+r"(w[I + 5]), "+r"(w[I + 6]), "+r"(w[I + 7]),
          "=&r"(w[I + 8])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]),
          "r"(a[5]), "r"(a[6]), "r"(a[7]), "r"(y), "r"(zero));
}

template <int I>
__device__ __forceinline__ void wide_rows(u32 (&w)[17], const u32 (&a)[8],
                                          const u32 (&b)[8]) {
    if constexpr (I < 8) {
        wide_row<I>(w, a, b[I]);
        wide_rows<I + 1>(w, a, b);
    }
}

// w = a * b: words 0..15, w[16] = 0.  Row 0 (the low halves, then the
// high halves one word up), then rows 1..7.
__device__ __forceinline__ void wide_mul(u32 (&w)[17], const u32 (&a)[8],
                                         const u32 (&b)[8]) {
    const u32 zero = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) w[j] = a[j] * b[0];
    asm("mad.hi.cc.u32  %0, %8, %16, %0;\n\t"
        "madc.hi.cc.u32 %1, %9, %16, %1;\n\t"
        "madc.hi.cc.u32 %2, %10, %16, %2;\n\t"
        "madc.hi.cc.u32 %3, %11, %16, %3;\n\t"
        "madc.hi.cc.u32 %4, %12, %16, %4;\n\t"
        "madc.hi.cc.u32 %5, %13, %16, %5;\n\t"
        "madc.hi.cc.u32 %6, %14, %16, %6;\n\t"
        "madc.hi.u32    %7, %15, %16, %17;"
        : "+r"(w[1]), "+r"(w[2]), "+r"(w[3]), "+r"(w[4]), "+r"(w[5]),
          "+r"(w[6]), "+r"(w[7]), "=r"(w[8])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]),
          "r"(a[5]), "r"(a[6]), "r"(a[7]), "r"(b[0]), "r"(zero));
    wide_rows<1>(w, a, b);
    w[16] = 0;
}

// w += x (a product: x[16] = 0).  Words 0..7 with the carry out kept in
// c, then c brought back into the flag (c + 0xffffffff carries iff c = 1)
// for words 8..16: one chain of 17 words would take 33 asm operands.
__device__ __forceinline__ void wide_add(u32 (&w)[17], const u32 (&x)[17]) {
    u32 c;
    const u32 zero = 0;
    asm("add.cc.u32  %0, %0, %9;\n\t"
        "addc.cc.u32 %1, %1, %10;\n\t"
        "addc.cc.u32 %2, %2, %11;\n\t"
        "addc.cc.u32 %3, %3, %12;\n\t"
        "addc.cc.u32 %4, %4, %13;\n\t"
        "addc.cc.u32 %5, %5, %14;\n\t"
        "addc.cc.u32 %6, %6, %15;\n\t"
        "addc.cc.u32 %7, %7, %16;\n\t"
        "addc.u32    %8, %17, 0;"
        : "+r"(w[0]), "+r"(w[1]), "+r"(w[2]), "+r"(w[3]), "+r"(w[4]),
          "+r"(w[5]), "+r"(w[6]), "+r"(w[7]), "=r"(c)
        : "r"(x[0]), "r"(x[1]), "r"(x[2]), "r"(x[3]), "r"(x[4]),
          "r"(x[5]), "r"(x[6]), "r"(x[7]), "r"(zero));
    asm("add.cc.u32  %9, %9, 0xffffffff;\n\t"
        "addc.cc.u32 %0, %0, %10;\n\t"
        "addc.cc.u32 %1, %1, %11;\n\t"
        "addc.cc.u32 %2, %2, %12;\n\t"
        "addc.cc.u32 %3, %3, %13;\n\t"
        "addc.cc.u32 %4, %4, %14;\n\t"
        "addc.cc.u32 %5, %5, %15;\n\t"
        "addc.cc.u32 %6, %6, %16;\n\t"
        "addc.cc.u32 %7, %7, %17;\n\t"
        "addc.u32    %8, %8, 0;"
        : "+r"(w[8]), "+r"(w[9]), "+r"(w[10]), "+r"(w[11]), "+r"(w[12]),
          "+r"(w[13]), "+r"(w[14]), "+r"(w[15]), "+r"(w[16]), "+r"(c)
        : "r"(x[8]), "r"(x[9]), "r"(x[10]), "r"(x[11]), "r"(x[12]),
          "r"(x[13]), "r"(x[14]), "r"(x[15]));
}

// w += a * b
__device__ __forceinline__ void wide_mac(u32 (&w)[17], const u32 (&a)[8],
                                         const u32 (&b)[8]) {
    u32 x[17];
    wide_mul(x, a, b);
    wide_add(w, x);
}

// w += x 2^256 (x in words 8..15, the carry into word 16)
__device__ __forceinline__ void wide_add_hi(u32 (&w)[17],
                                            const u32 (&x)[8]) {
    asm("add.cc.u32  %0, %0, %9;\n\t"
        "addc.cc.u32 %1, %1, %10;\n\t"
        "addc.cc.u32 %2, %2, %11;\n\t"
        "addc.cc.u32 %3, %3, %12;\n\t"
        "addc.cc.u32 %4, %4, %13;\n\t"
        "addc.cc.u32 %5, %5, %14;\n\t"
        "addc.cc.u32 %6, %6, %15;\n\t"
        "addc.cc.u32 %7, %7, %16;\n\t"
        "addc.u32    %8, %8, 0;"
        : "+r"(w[8]), "+r"(w[9]), "+r"(w[10]), "+r"(w[11]), "+r"(w[12]),
          "+r"(w[13]), "+r"(w[14]), "+r"(w[15]), "+r"(w[16])
        : "r"(x[0]), "r"(x[1]), "r"(x[2]), "r"(x[3]), "r"(x[4]),
          "r"(x[5]), "r"(x[6]), "r"(x[7]));
}

// One REDC round on words i .. i+4 (w0 .. w4): + m at word i, + m q at
// words i+1 .. i+4, and the carries that the round before left at word
// i+4 (pend, 0..2); the carries out of word i+4 go back into pend.
template <int F>
__device__ __forceinline__ void redc_round(u32& w0, u32& w1, u32& w2,
                                           u32& w3, u32& w4, u32& pend,
                                           u32 m) {
    const u32 zero = 0;
    asm("add.cc.u32     %0, %0, %6;\n\t"
        "madc.lo.cc.u32 %1, %6, %7, %1;\n\t"
        "madc.lo.cc.u32 %2, %6, %8, %2;\n\t"
        "madc.lo.cc.u32 %3, %6, %9, %3;\n\t"
        "addc.cc.u32    %4, %4, %5;\n\t"
        "addc.u32       %5, %10, 0;\n\t"
        "mad.hi.cc.u32  %2, %6, %7, %2;\n\t"
        "madc.hi.cc.u32 %3, %6, %8, %3;\n\t"
        "madc.hi.cc.u32 %4, %6, %9, %4;\n\t"
        "addc.u32       %5, %5, 0;"
        : "+r"(w0), "+r"(w1), "+r"(w2), "+r"(w3), "+r"(w4), "+r"(pend)
        : "r"(m), "r"(pasta_q<F>::q1), "r"(pasta_q<F>::q2),
          "r"(pasta_q<F>::q3), "r"(zero));
}

// w 2^-256 mod p, canonical, for a wide w below S p 2^256: the REDC
// leaves w / 2^256 + p at most, then S conditional subtracts.  (A sum of
// n products of values below p is below n p^2 < (n / 4 + 2^-120) p 2^256,
// as p < 2^254 (1 + 2^-125), so S = n / 4 + 1 in integers; a product
// plus a value below p times 2^256 takes S = 2.)  Eight rounds of
// m = -w_i; the m 2^254 terms wait for one chain after the rounds:
// of them only m_0 2^254 reaches a word a round reads (word 7), and
// m_7 takes it into account, so word 7 ends at 0 with them.
template <int F, int S>
__device__ __forceinline__ fe pasta_redc(u32 (&w)[17]) {
    u32 m[8], pend = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        m[i] = 0u - (i < 7 ? w[i] : w[7] + (m[0] << 30));
        redc_round<F>(w[i], w[i + 1], w[i + 2], w[i + 3], w[i + 4], pend,
                      m[i]);
    }
    // (m_0 .. m_7) 2^254 at words 7..15, and pend at word 12
    u32 h[9];
    h[0] = m[0] << 30;
#pragma unroll
    for (int k = 0; k < 7; ++k) h[k + 1] = __funnelshift_r(m[k], m[k + 1], 2);
    h[8] = m[7] >> 2;
    asm("add.cc.u32  %0, %0, %10;\n\t"
        "addc.cc.u32 %1, %1, %11;\n\t"
        "addc.cc.u32 %2, %2, %12;\n\t"
        "addc.cc.u32 %3, %3, %13;\n\t"
        "addc.cc.u32 %4, %4, %14;\n\t"
        "addc.cc.u32 %5, %5, %15;\n\t"
        "addc.cc.u32 %6, %6, %16;\n\t"
        "addc.cc.u32 %7, %7, %17;\n\t"
        "addc.cc.u32 %8, %8, %18;\n\t"
        "addc.u32    %9, %9, 0;"
        : "+r"(w[7]), "+r"(w[8]), "+r"(w[9]), "+r"(w[10]), "+r"(w[11]),
          "+r"(w[12]), "+r"(w[13]), "+r"(w[14]), "+r"(w[15]), "+r"(w[16])
        : "r"(h[0]), "r"(h[1]), "r"(h[2]), "r"(h[3]), "r"(h[4]),
          "r"(h[5]), "r"(h[6]), "r"(h[7]), "r"(h[8]));
    asm("add.cc.u32  %0, %0, %5;\n\t"
        "addc.cc.u32 %1, %1, 0;\n\t"
        "addc.cc.u32 %2, %2, 0;\n\t"
        "addc.cc.u32 %3, %3, 0;\n\t"
        "addc.u32    %4, %4, 0;"
        : "+r"(w[12]), "+r"(w[13]), "+r"(w[14]), "+r"(w[15]), "+r"(w[16])
        : "r"(pend));
    fe r;
#pragma unroll
    for (int k = 0; k < 8; ++k) r.v[k] = w[8 + k];   // w[16] is 0
#pragma unroll
    for (int k = 0; k < S; ++k) r = fe_reduce_once<F>(r);
    return r;
}

// fe_mul's value by a wide product and the Pasta-shaped REDC
template <int F>
__device__ __forceinline__ fe fe_mul_pasta(const fe& a, const fe& b) {
    u32 w[17];
    wide_mul(w, a.v, b.v);
    return pasta_redc<F, 1>(w);
}

// Field elements cross device memory as structure-of-arrays int32 tensors
// whose element (c, l, i) — field row c (a point coordinate, a Poseidon
// lane), 32-bit limb l, lane i — sits at (c * 8 + l) * row + i for a row
// stride `row`: lane-adjacent threads read adjacent words.
__device__ __forceinline__ fe load_fe(const u32* base, size_t row, int c,
                                      size_t i) {
    fe r;
#pragma unroll
    for (int l = 0; l < 8; ++l) r.v[l] = base[(size_t)(c * 8 + l) * row + i];
    return r;
}

__device__ __forceinline__ void store_fe(u32* base, size_t row, int c,
                                         size_t i, const fe& a) {
#pragma unroll
    for (int l = 0; l < 8; ++l) base[(size_t)(c * 8 + l) * row + i] = a.v[l];
}

extern "C" const char* reef_cuda_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
