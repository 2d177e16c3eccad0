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
// registers for all rounds, on the sparse tables of
// ops/poseidon_constants.py sparse_params (the Poseidon paper's
// appendix B): the partial rounds' constants on lanes 1.. are moved
// forward through M, so a partial round adds one scalar to lane 0, and
// each partial round's matrix is factored as S_k diag(1, D_k), the diag
// moved into the round before, so a partial round's mix is a row for
// lane 0 (t products) and s_i + c_i x0 on the other lanes (one product
// each, in place).  Full rounds keep the dense matrix (the first half's
// last one is diag(1, D_0) M).  Every row's products are summed
// unreduced and take one REDC (field.cuh pasta_redc, shaped for the two
// Pasta primes), then the conditional subtracts its bound needs (two at
// t = 5, three at t = 9); the S-box's products are field.cuh's
// fe_mul_pasta.  A state costs 8 (3t + t^2) + R_P (3 + 2t - 1) products:
// 992 at t = 5, 2,004 at t = 9, against the dense order's 1,888 and
// 5,652.  Bound: integer multiply-adds, against 2 t 32 bytes moved.  The
// tables sit in shared memory (below).  The full rounds' new state is gathered in
// local memory (their row loop stays rolled); the partial rounds need
// no second copy of the state.
//
// perm_spread_kernel, for small B (a sumcheck round's single sponge state,
// the top levels of a Merkle tree): there perm_kernel is bound by the
// latency of one thread's 2,004 dependent products.  Here a block owns
// one state: thread (i, j), in row group i of G lanes (G = 8 at t = 5,
// 16 at t = 9; lanes j >= t add zero), holds M[i][j] in registers for all
// rounds and forms M[i][j] x_j^5 as (M[i][j] x_j) x_j^4, so that M x_j
// depends on x_j alone; row i's t products are summed by a butterfly of
// warp shuffles (log2 G modular adds), which leaves s_i in every lane of
// the group; lane (i, 0) writes it to shared memory, and one barrier a
// round (double-buffered) hands the state to the next round.  So a round's
// dependency chain is three products deep, 195 at t = 9 (65 rounds),
// or four where the thread runs its products one after
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
    static constexpr int R_P = 56, R = R_F + R_P;
    static constexpr int G = 8;
};
template <>
struct width<9> {
    static constexpr int R_P = 57, R = R_F + R_P;
    static constexpr int G = 16;
};

// perm_spread_kernel's tables, [field][round][lane][limb] and
// [field][row][column][limb], Montgomery, in global memory
static __device__ u32 RC5G[2][width<5>::R * 5 * 8];
static __device__ u32 MDS5G[2][5 * 5 * 8];
static __device__ u32 RC9G[2][width<9>::R * 9 * 8];
static __device__ u32 MDS9G[2][9 * 9 * 8];

// perm_kernel's tables (ops/poseidon_constants.py sparse_params), elements
// of 8 words, Montgomery: the full rounds' constants; the matrix of the
// first half's last full round, diag(1, D_0) M; M; and for each partial
// round its lane-0 constant, its lane-0 row (t) and its column (t - 1).
// 650 elements (20,800 bytes) at t = 5, 1,260 (40,320 bytes) at t = 9.
template <int T>
struct alignas(16) sparse_tables {
    static constexpr int FULL_RC = 0, PRE = R_F * T, MDS = PRE + T * T,
                         PART = MDS + T * T, N = PART + width<T>::R_P * 2 * T;
    u32 w[N * 8];
};

// perm_kernel stages its field's tables in shared memory once a block
// (20,800 bytes at t = 5, 40,320 at t = 9), from where all the threads
// of a warp that read one word get it in one broadcast: the tables of
// both fields and widths (122 KB) do not fit the 64 KB constant bank.
// The global copies, one per field and width:
static __device__ sparse_tables<5> SP5G[2];
static __device__ sparse_tables<9> SP9G[2];

template <int T>
__device__ __forceinline__ const sparse_tables<T>& global_tables(int f) {
    if constexpr (T == 5)
        return SP5G[f];
    else
        return SP9G[f];
}

// element e of a table in shared memory; warp-uniform, so one word
// serves the warp
__device__ __forceinline__ fe tab_fe(const u32* tb, int e) {
    fe x;
#pragma unroll
    for (int k = 0; k < 8; ++k) x.v[k] = tb[e * 8 + k];
    return x;
}

template <int F>
__device__ __forceinline__ fe pow5(const fe& x) {
    const fe x2 = fe_mul_pasta<F>(x, x);
    const fe x4 = fe_mul_pasta<F>(x2, x2);
    return fe_mul_pasta<F>(x4, x);
}

// s <- A s for a dense matrix A (element e0 on): each row's t products
// summed unreduced, one REDC a row.  The row loop stays rolled (one copy
// of t products in the code, not t^2), so the new state is gathered in
// `o` in local memory.
template <int F, int T>
__device__ __forceinline__ void dense_mix(fe (&s)[T], const u32* tb,
                                          int e0) {
    fe o[T];
#pragma unroll 1
    for (int i = 0; i < T; ++i) {
        u32 w[17];
        wide_mul(w, s[0].v, tab_fe(tb, e0 + i * T).v);
#pragma unroll
        for (int j = 1; j < T; ++j)
            wide_mac(w, s[j].v, tab_fe(tb, e0 + i * T + j).v);
        o[i] = pasta_redc<F, T / 4 + 1>(w);
    }
#pragma unroll
    for (int i = 0; i < T; ++i) s[i] = o[i];
}

// The partial rounds, sparse: x0 = (s_0 + c)^5; s_0 <- row . (x0, s_1..);
// s_i <- s_i + col_i x0 for i >= 1, in place (s_i 2^256 joins the product
// before its REDC).
template <int F, int T>
__device__ __forceinline__ void partial_rounds(fe (&s)[T], const u32* tb) {
    using tabs = sparse_tables<T>;
#pragma unroll 1
    for (int k = 0; k < width<T>::R_P; ++k) {
        const int e = tabs::PART + k * 2 * T;
        s[0] = pow5<F>(fe_add<F>(s[0], tab_fe(tb, e)));
        u32 w[17];
        wide_mul(w, s[0].v, tab_fe(tb, e + 1).v);
#pragma unroll
        for (int j = 1; j < T; ++j)
            wide_mac(w, s[j].v, tab_fe(tb, e + 1 + j).v);
        const fe s0 = pasta_redc<F, T / 4 + 1>(w);
#pragma unroll
        for (int i = 1; i < T; ++i) {
            wide_mul(w, s[0].v, tab_fe(tb, e + T + i).v);
            wide_add_hi(w, s[i].v);
            s[i] = pasta_redc<F, 2>(w);
        }
        s[0] = s0;
    }
}

// 128 threads a block and at least one block resident an SM: with that
// minimum ptxas gives each instance more registers than without it, and
// none spills (chip_smoke.py's build phase prints its report); asking
// for more resident blocks spilled and ran slower on an NVIDIA H100 80GB
// HBM3 at 700 W (PERF.md): each thread's dependent carry chains, not the
// number of resident warps, set the pace.
template <int F, int T>
__global__ void __launch_bounds__(128, 1)
perm_kernel(const u32* __restrict__ in, u32* __restrict__ out, int B) {
    using tabs = sparse_tables<T>;
    __shared__ tabs sh;
    const uint4* g = reinterpret_cast<const uint4*>(global_tables<T>(F).w);
    uint4* d = reinterpret_cast<uint4*>(sh.w);
    for (int k = threadIdx.x; k < tabs::N * 2; k += blockDim.x) d[k] = g[k];
    __syncthreads();
    const u32* tb = sh.w;
    const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= (size_t)B) return;
    fe s[T];
#pragma unroll
    for (int l = 0; l < T; ++l) s[l] = load_fe(in, B, l, i);
#pragma unroll 1
    for (int r = 0; r < R_F; ++r) {
        if (r == R_F / 2) partial_rounds<F, T>(s, tb);
#pragma unroll
        for (int l = 0; l < T; ++l)
            s[l] = pow5<F>(
                fe_add<F>(s[l], tab_fe(tb, tabs::FULL_RC + r * T + l)));
        dense_mix<F, T>(s, tb, r == R_F / 2 - 1 ? tabs::PRE : tabs::MDS);
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

// Copies one field's tables, Montgomery, from host memory: for
// perm_spread_kernel the round constants ((R_F + R_P) * t * 8 words) and
// the MDS (t * t * 8 words), for perm_kernel the sparse tables
// (sparse_tables<t>, in its order: ops/poseidon_device.py sparse_table).
extern "C" int reef_poseidon_set_consts(int field, int t, const void* rc,
                                        const void* mds,
                                        const void* sparse) {
    if (field < 0 || field > 1 || (t != 5 && t != 9))
        return (int)cudaErrorInvalidValue;
    cudaError_t err[3] = {cudaSuccess, cudaSuccess, cudaSuccess};
    if (t == 5) {
        err[0] = copy_row(RC5G, rc, field);
        err[1] = copy_row(MDS5G, mds, field);
        err[2] = copy_row(SP5G, sparse, field);
    } else {
        err[0] = copy_row(RC9G, rc, field);
        err[1] = copy_row(MDS9G, mds, field);
        err[2] = copy_row(SP9G, sparse, field);
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
