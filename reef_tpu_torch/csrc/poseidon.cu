// K5: the batched Poseidon permutation on (t, 8, B) int32 state arrays
// (lane l of state i is field row l; see load_fe in field.cuh), t = 5 or 9,
// over F_P or F_Q, in two launches: one thread per state for large
// batches, one block per state for small ones.
//
// Replaces the JAX package's ops/poseidon_pallas.py _perm_call /
// _perm_body (with _sbox, _add_rc and _mds).  The TPU kernel keeps 1024
// states of a grid block in VMEM across all rounds and does the MDS mix on
// the MXU: a byte-convolution matmul split into nibbles (Mosaic's int8 dot
// is signed) followed by a 32-column REDC.  None of that carries over.
//
// perm_kernel, for large B: one thread owns one state and keeps it in
// registers for all R_F + R_P rounds (8 + 56 at t = 5, 8 + 57 at t = 9):
// add the round constants, the x^5 S-box as three field.cuh products
// (every lane in the four first and four last rounds, lane 0 in the
// partial rounds between), and the MDS mix as t^2 Montgomery products
// summed by modular adds.  The round constants and the Montgomery MDS sit
// in __constant__ memory (the host fills them once per field and width):
// every thread of a warp reads the same word at the same time, which the
// constant cache serves as a broadcast.  Bound: integer multiply-adds.  A
// state costs 8 (3t + t^2) + R_P (3 + t^2) products of ~264 multiply-adds
// (1,888 products at t = 5, 5,652 at t = 9) against 2 t 32 bytes moved.
// At t = 9 the state alone is 72 registers and the MDS sums need more, so
// the MDS rows go through local memory.
//
// perm_spread_kernel, for small B (a sumcheck round's single sponge state,
// the top levels of a Merkle tree): there perm_kernel is bound by the
// latency of one thread's 5,652 dependent products.  Here a block owns
// one state: thread (i, j), in row group i of G lanes (G = 8 at t = 5,
// 16 at t = 9; lanes j >= t add zero), holds M[i][j] in registers for all
// rounds and forms M[i][j] x_j^5 as (M[i][j] x_j) x_j^4, so that M x_j
// depends on x_j alone; row i's t products are summed by a butterfly of
// warp shuffles (log2 G modular adds), which leaves s_i in every lane of
// the group; lane (i, 0) writes it to shared memory, and one barrier a
// round (double-buffered) hands the state to the next round.  So a round's
// dependency chain is three products deep, 195 at t = 9 (65 rounds)
// instead of 5,652, or four where the thread runs its products one after
// another, plus log2 G shuffled adds and a barrier.  The
// threads of a warp read different round constants, which the constant
// cache would serialise, so this kernel copies its field's and width's
// constants from a global copy into shared memory once per block.  It
// does t G / t^2 times the work of perm_kernel (redundant S-boxes, idle
// lanes), so it wins only while the card is mostly idle: the wrapper
// routes by B (ops/poseidon_kernel.py).
#include "field.cuh"

constexpr int R_F = 8;

// rounds of the width-T permutation: R_F full, R_P partial; G lanes per
// row group in perm_spread_kernel
template <int T>
struct width;
template <>
struct width<5> {
    static constexpr int R = R_F + 56;
    static constexpr int G = 8;
};
template <>
struct width<9> {
    static constexpr int R = R_F + 57;
    static constexpr int G = 16;
};

// [field][round][lane][limb] and [field][row][column][limb], Montgomery:
// the constant banks perm_kernel reads, and a global copy of the same
// tables for perm_spread_kernel
static __constant__ u32 RC5[2][width<5>::R * 5 * 8];
static __constant__ u32 MDS5[2][5 * 5 * 8];
static __constant__ u32 RC9[2][width<9>::R * 9 * 8];
static __constant__ u32 MDS9[2][9 * 9 * 8];
static __device__ u32 RC5G[2][width<5>::R * 5 * 8];
static __device__ u32 MDS5G[2][5 * 5 * 8];
static __device__ u32 RC9G[2][width<9>::R * 9 * 8];
static __device__ u32 MDS9G[2][9 * 9 * 8];

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

// the sum of p over the G lanes of this thread's row group (G a power of
// two dividing 32), in every lane of the group: log2 G butterfly steps of
// eight shuffles and a modular add.  Modular sums are canonical, so every
// lane ends with the same value whatever order it added in.
template <int F, int G>
__device__ __forceinline__ fe group_sum(fe p) {
    const unsigned lane = threadIdx.x & 31;
    const unsigned mask = (G == 32) ? 0xffffffffu
                                    : ((1u << G) - 1) << (lane & ~(G - 1));
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1) {
        fe q;
#pragma unroll
        for (int k = 0; k < 8; ++k)
            q.v[k] = __shfl_xor_sync(mask, p.v[k], off, G);
        p = fe_add<F>(p, q);
    }
    return p;
}

template <int F, int T>
__global__ void __launch_bounds__(T * width<T>::G)
perm_spread_kernel(const u32* __restrict__ in, u32* __restrict__ out,
                   int B) {
    constexpr int R = width<T>::R, G = width<T>::G, NT = T * G;
    __shared__ u32 rc_sh[R * T * 8];
    __shared__ fe xs[2][T];
    const u32* rc_g;
    const u32* mds_g;
    if constexpr (T == 5) {
        rc_g = RC5G[F];
        mds_g = MDS5G[F];
    } else {
        rc_g = RC9G[F];
        mds_g = MDS9G[F];
    }
    const int i = threadIdx.x / G, j = threadIdx.x % G;
    const size_t b = blockIdx.x;

    for (int k = threadIdx.x; k < R * T * 8; k += NT) rc_sh[k] = rc_g[k];
    fe m = {};
    if (j < T) {
#pragma unroll
        for (int k = 0; k < 8; ++k) m.v[k] = mds_g[(i * T + j) * 8 + k];
    }
    if (j == 0) xs[0][i] = load_fe(in, B, i, b);
    __syncthreads();

    fe s = {};
#pragma unroll 1
    for (int r = 0; r < R; ++r) {
        fe p = {};
        if (j < T) {
            fe c;
#pragma unroll
            for (int k = 0; k < 8; ++k) c.v[k] = rc_sh[(r * T + j) * 8 + k];
            const fe x = fe_add<F>(xs[r & 1][j], c);
            p = fe_mul<F>(m, x);
            if (j == 0 || r < R_F / 2 || r >= R - R_F / 2) {   // S-box lane
                const fe x2 = fe_mul<F>(x, x);
                p = fe_mul<F>(p, fe_mul<F>(x2, x2));      // M x^5
            }
        }
        s = group_sum<F, G>(p);
        if (j == 0) xs[(r + 1) & 1][i] = s;
        __syncthreads();
    }
    if (j == 0) store_fe(out, B, i, b, s);
}

// one field's row of a [2][N] table, host to device
template <class S>
static cudaError_t copy_row(S& sym, const void* src, int field) {
    return cudaMemcpyToSymbol(sym, src, sizeof(sym[0]), field * sizeof(sym[0]));
}

// Copies one field's round constants ((R_F + R_P) * t * 8 words) and MDS
// (t * t * 8 words), Montgomery, from host memory into the constant banks
// and their global copies.
extern "C" int reef_poseidon_set_consts(int field, int t, const void* rc,
                                        const void* mds) {
    if (field < 0 || field > 1 || (t != 5 && t != 9))
        return (int)cudaErrorInvalidValue;
    cudaError_t err[4];
    if (t == 5) {
        err[0] = copy_row(RC5, rc, field);
        err[1] = copy_row(MDS5, mds, field);
        err[2] = copy_row(RC5G, rc, field);
        err[3] = copy_row(MDS5G, mds, field);
    } else {
        err[0] = copy_row(RC9, rc, field);
        err[1] = copy_row(MDS9, mds, field);
        err[2] = copy_row(RC9G, rc, field);
        err[3] = copy_row(MDS9G, mds, field);
    }
    for (cudaError_t e : err)
        if (e != cudaSuccess) return (int)e;
    return (int)cudaSuccess;
}

template <int F, int T>
static void launch(const u32* in, u32* out, int B, int spread,
                   cudaStream_t s) {
    if (spread)
        perm_spread_kernel<F, T><<<B, T * width<T>::G, 0, s>>>(in, out, B);
    else
        perm_kernel<F, T><<<(B + 127) / 128, 128, 0, s>>>(in, out, B);
}

// spread = 0: perm_kernel (a thread per state); 1: perm_spread_kernel (a
// block per state).  Either computes every state of the batch.
extern "C" int reef_poseidon(const void* in, void* out, int B, int t,
                             int field, int spread, void* stream) {
    if (B < 1 || (t != 5 && t != 9) || field < 0 || field > 1 ||
        spread < 0 || spread > 1)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const u32* i = (const u32*)in;
    u32* o = (u32*)out;
    if (field == 0) {
        if (t == 5) launch<0, 5>(i, o, B, spread, s);
        else launch<0, 9>(i, o, B, spread, s);
    } else {
        if (t == 5) launch<1, 5>(i, o, B, spread, s);
        else launch<1, 9>(i, o, B, spread, s);
    }
    return (int)cudaGetLastError();
}
