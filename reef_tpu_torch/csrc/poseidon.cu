// K5: the batched Poseidon permutation, one full permutation per state, on
// (t, 8, B) int32 state arrays (lane l of state i is field row l; see
// load_fe in field.cuh), t = 5 or 9, over F_P or F_Q.
//
// Replaces the JAX package's ops/poseidon_pallas.py _perm_call /
// _perm_body (with _sbox, _add_rc and _mds).  The TPU kernel keeps 1024
// states of a grid block in VMEM across all rounds and does the MDS mix on
// the MXU: a byte-convolution matmul split into nibbles (Mosaic's int8 dot
// is signed) followed by a 32-column REDC.  None of that carries over.  Here
// one thread owns one state and keeps it in registers for all R_F + R_P
// rounds (8 + 56 at t = 5, 8 + 57 at t = 9): add the round constants, the
// x^5 S-box as three field.cuh products (every lane in the four first and
// four last rounds, lane 0 in the partial rounds between), and the MDS mix
// as t^2 Montgomery products summed by modular adds.  The round constants
// and the Montgomery MDS sit in __constant__ memory (the host fills them
// once per field and width): every thread of a warp reads the same word
// at the same time, which the constant cache serves as a broadcast.
//
// Bound on this card: integer multiply-adds.  A state costs
// 8 (3t + t^2) + R_P (3 + t^2) products of ~264 multiply-adds (1,888
// products at t = 5, 5,652 at t = 9) against 2 t 32 bytes moved.  At
// t = 9 the state alone is 72 registers and the MDS sums need more, so
// the MDS rows go through local memory; at B = 1 (the sponge of a sumcheck
// round) one thread does all the work and the launch is bound by the
// latency of its dependent products, not by any rate.
#include "field.cuh"

constexpr int R_F = 8;

// rounds of the width-T permutation: R_F full, R_P partial
template <int T>
struct width;
template <>
struct width<5> {
    static constexpr int R = R_F + 56;
};
template <>
struct width<9> {
    static constexpr int R = R_F + 57;
};

// [field][round][lane][limb] and [field][row][column][limb], Montgomery
static __constant__ u32 RC5[2][width<5>::R * 5 * 8];
static __constant__ u32 MDS5[2][5 * 5 * 8];
static __constant__ u32 RC9[2][width<9>::R * 9 * 8];
static __constant__ u32 MDS9[2][9 * 9 * 8];

template <int F, int T>
__device__ __forceinline__ fe rc_fe(int r, int l) {
    fe x;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        if constexpr (T == 5)
            x.v[k] = RC5[F][(r * T + l) * 8 + k];
        else
            x.v[k] = RC9[F][(r * T + l) * 8 + k];
    }
    return x;
}

template <int F, int T>
__device__ __forceinline__ fe mds_fe(int i, int j) {
    fe x;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        if constexpr (T == 5)
            x.v[k] = MDS5[F][(i * T + j) * 8 + k];
        else
            x.v[k] = MDS9[F][(i * T + j) * 8 + k];
    }
    return x;
}

template <int F>
__device__ __forceinline__ fe pow5(const fe& x) {
    const fe x2 = fe_mul<F>(x, x);
    const fe x4 = fe_mul<F>(x2, x2);
    return fe_mul<F>(x4, x);
}

// s <- M s.  The row loop stays rolled (one copy of t products in the
// code, not t^2), so the new state is gathered in `o` in local memory.
template <int F, int T>
__device__ __forceinline__ void mds_mix(fe (&s)[T]) {
    fe o[T];
#pragma unroll 1
    for (int i = 0; i < T; ++i) {
        fe acc = fe_mul<F>(s[0], mds_fe<F, T>(i, 0));
#pragma unroll
        for (int j = 1; j < T; ++j)
            acc = fe_add<F>(acc, fe_mul<F>(s[j], mds_fe<F, T>(i, j)));
        o[i] = acc;
    }
#pragma unroll
    for (int i = 0; i < T; ++i) s[i] = o[i];
}

template <int F, int T>
__global__ void __launch_bounds__(128)
perm_kernel(const u32* __restrict__ in, u32* __restrict__ out, int B) {
    const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= (size_t)B) return;
    fe s[T];
#pragma unroll
    for (int l = 0; l < T; ++l) s[l] = load_fe(in, B, l, i);
    constexpr int R = width<T>::R;
#pragma unroll 1
    for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int l = 0; l < T; ++l) s[l] = fe_add<F>(s[l], rc_fe<F, T>(r, l));
        s[0] = pow5<F>(s[0]);
        if (r < R_F / 2 || r >= R - R_F / 2) {   // a full round
#pragma unroll
            for (int l = 1; l < T; ++l) s[l] = pow5<F>(s[l]);
        }
        mds_mix<F, T>(s);
    }
#pragma unroll
    for (int l = 0; l < T; ++l) store_fe(out, B, l, i, s[l]);
}

// Copies one field's round constants ((R_F + R_P) * t * 8 words) and MDS
// (t * t * 8 words), Montgomery, from host memory into the constant banks.
extern "C" int reef_poseidon_set_consts(int field, int t, const void* rc,
                                        const void* mds) {
    if (field < 0 || field > 1) return (int)cudaErrorInvalidValue;
    cudaError_t err;
    if (t == 5) {
        err = cudaMemcpyToSymbol(RC5, rc, sizeof(RC5[0]),
                                 field * sizeof(RC5[0]));
        if (err == cudaSuccess)
            err = cudaMemcpyToSymbol(MDS5, mds, sizeof(MDS5[0]),
                                     field * sizeof(MDS5[0]));
    } else if (t == 9) {
        err = cudaMemcpyToSymbol(RC9, rc, sizeof(RC9[0]),
                                 field * sizeof(RC9[0]));
        if (err == cudaSuccess)
            err = cudaMemcpyToSymbol(MDS9, mds, sizeof(MDS9[0]),
                                     field * sizeof(MDS9[0]));
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)err;
}

template <int F, int T>
static void launch(const u32* in, u32* out, int B, cudaStream_t s) {
    perm_kernel<F, T><<<(B + 127) / 128, 128, 0, s>>>(in, out, B);
}

extern "C" int reef_poseidon(const void* in, void* out, int B, int t,
                             int field, void* stream) {
    if (B < 1 || (t != 5 && t != 9) || field < 0 || field > 1)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const u32* i = (const u32*)in;
    u32* o = (u32*)out;
    if (field == 0) {
        if (t == 5) launch<0, 5>(i, o, B, s);
        else launch<0, 9>(i, o, B, s);
    } else {
        if (t == 5) launch<1, 5>(i, o, B, s);
        else launch<1, 9>(i, o, B, s);
    }
    return (int)cudaGetLastError();
}
