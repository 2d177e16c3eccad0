// K6: the nlookup sumcheck round on the card, three launchers over (8, n)
// int32 field tables (one field row; see load_fe in field.cuh).
//
// Not a TPU kernel: the JAX package's ops/sumcheck_device.py computes the
// round (_one_round_kernel) and the eq build (_build_eq_kernel) in XLA,
// outside any pallas_call.  This port's plain limb arithmetic costs some
// 200 torch launches per Montgomery product, so a round in plain torch on
// the card would be thousands of launches; these kernels keep the loop at
// three launches a round, with nothing copied to the host between rounds.
//
//   reef_sc_coeffs   the round's three coefficients over the pairs
//                    (t0, t1, e0, e1) of the tables' halves, in one
//                    launch: xsq = sum ts*es, con = sum t0*e0 and
//                    x = sum t1*e1 - xsq - con (ts = t1 - t0,
//                    es = e1 - e0; t1 e1 = (t0 + ts)(e0 + es), so x is the
//                    reference's sum (es*t0 + ts*e0) with three products
//                    a pair in place of four).  Each block sums its pairs
//                    by warp shuffles; the last block to finish (a ticket
//                    taken by atomicAdd after a __threadfence) sums the
//                    blocks' partials and writes (xsq, x, con) and, given
//                    a sponge state, that state with con, x, xsq added
//                    into lanes 1, 2, 3 (the absorb of the Fiat-Shamir
//                    sponge).  Modular sums are canonical, so any order
//                    gives the reference's halving-tree sums;
//   reef_sc_fold     both tables folded by the challenge r, read from device
//                    memory (the sponge lane the Poseidon kernel wrote):
//                    t0 + r*ts and e0 + r*es, tables of half the length;
//   reef_sc_eq_step  one doubling step of the eq table's running-claim
//                    term: out[2k] = term[k]*(1 - q), out[2k+1] =
//                    term[k]*q, plus the scattered claim table `eq` in the
//                    last step.
//
// Bound on this card.  A coefficient pass reads 128 bytes a pair and does
// 3 products (~800 multiply-adds): integer work at the large rounds, where
// the grid fills every SM.  From half ~2^13 down a round is latency: one
// pair a thread, and the reduce across the block and then the grid.  It
// replaced two launches (a pass over the pairs, then one over the
// partials, the second gone below 257 pairs) and a block sum through eight
// levels of shared memory and barriers; here the partials are summed by
// the last block of the same launch, and a block sums by five shuffle
// levels a warp and one across its warps.  A fold reads 128 and writes 64
// bytes for 2 products, an eq step reads 32 (64 with `eq`) and writes 64
// for 2 products: near the line between memory and integer work.
//
// The ticket is one word of device memory that the wrapper allocates once
// per device: a launch's last block resets it to 0.  Two coefficient
// launches in flight at once would share it, so the launches of a device
// must go to one stream (they do: the sumcheck's round loop runs on the
// current stream, each round waiting on the last).
#include "field.cuh"

constexpr int SC_THREADS = 256;
constexpr int SC_WARPS = SC_THREADS / 32;

template <int F>
__device__ __forceinline__ fe fe_shfl_down(const fe& a, int off) {
    fe r;
#pragma unroll
    for (int l = 0; l < 8; ++l) r.v[l] = __shfl_down_sync(0xffffffffu, a.v[l],
                                                           off);
    return r;
}

// Sums a[c] (c < 3) over the block into thread 0's a: five shuffle levels
// in each warp, then the warps' sums in warp 0 (blockDim.x a multiple of
// 32, at most SC_THREADS).  `sh` holds 3 * SC_WARPS field elements.
template <int F>
__device__ __forceinline__ void block_sum3(fe (&a)[3], fe* sh) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nw = blockDim.x >> 5;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int c = 0; c < 3; ++c)
            a[c] = fe_add<F>(a[c], fe_shfl_down<F>(a[c], off));
    if (nw == 1) return;
    __syncthreads();                 // sh may hold an earlier call's sums
    if (lane == 0)
#pragma unroll
        for (int c = 0; c < 3; ++c) sh[c * SC_WARPS + warp] = a[c];
    __syncthreads();
    if (warp != 0) return;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        for (int l = 0; l < 8; ++l) a[c].v[l] = 0;
        if (lane < nw) a[c] = sh[c * SC_WARPS + lane];
    }
#pragma unroll
    for (int off = SC_WARPS / 2; off > 0; off >>= 1)
#pragma unroll
        for (int c = 0; c < 3; ++c)
            a[c] = fe_add<F>(a[c], fe_shfl_down<F>(a[c], off));
}

__device__ __forceinline__ fe load_fe_cg(const u32* base, size_t row, int c,
                                         size_t i) {
    fe r;
#pragma unroll
    for (int l = 0; l < 8; ++l) r.v[l] = __ldcg(base + (c * 8 + l) * row + i);
    return r;
}

// a[] sums, over the pairs k = grid-stride over [0, n) of the tables (t0,
// t1 with row stride st; e0, e1 with row stride se): a[0] = ts es,
// a[1] = t1 e1, a[2] = t0 e0.  With more than one block, each block
// writes its sums as column blockIdx.x of `partial` (3, 8, grid) and the
// last block sums the columns.  The final sums give g (3, 8, 1) =
// (xsq, x, con) and, when state_out is given, state_out = the (t, 8, 1)
// state_in with lanes 1..3 plus (con, x, xsq).
template <int F>
__global__ void __launch_bounds__(SC_THREADS)
coeff_kernel(const u32* __restrict__ t0, const u32* __restrict__ t1,
             const u32* __restrict__ e0, const u32* __restrict__ e1,
             size_t st, size_t se, long long n, u32* __restrict__ partial,
             unsigned* __restrict__ ticket, u32* __restrict__ g,
             const u32* __restrict__ state_in, u32* __restrict__ state_out,
             int t) {
    __shared__ fe sh[3 * SC_WARPS];
    __shared__ bool last;
    fe a[3];
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
        for (int l = 0; l < 8; ++l) a[c].v[l] = 0;
    const long long step = (long long)gridDim.x * blockDim.x;
    for (long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         k < n; k += step) {
        const fe x0 = load_fe(t0, st, 0, k), x1 = load_fe(t1, st, 0, k);
        const fe y0 = load_fe(e0, se, 0, k), y1 = load_fe(e1, se, 0, k);
        const fe ts = fe_sub<F>(x1, x0), es = fe_sub<F>(y1, y0);
        a[0] = fe_add<F>(a[0], fe_mul<F>(ts, es));
        a[1] = fe_add<F>(a[1], fe_mul<F>(x1, y1));
        a[2] = fe_add<F>(a[2], fe_mul<F>(x0, y0));
    }
    block_sum3<F>(a, sh);
    if (gridDim.x > 1) {
        if (threadIdx.x == 0) {
#pragma unroll
            for (int c = 0; c < 3; ++c)
                store_fe(partial, gridDim.x, c, blockIdx.x, a[c]);
            __threadfence();         // the partial before the ticket
            last = atomicAdd(ticket, 1u) == gridDim.x - 1;
        }
        __syncthreads();
        if (!last) return;
        // the last block: every other block's partial is written
#pragma unroll
        for (int c = 0; c < 3; ++c)
#pragma unroll
            for (int l = 0; l < 8; ++l) a[c].v[l] = 0;
        for (int b = threadIdx.x; b < (int)gridDim.x; b += blockDim.x)
#pragma unroll
            for (int c = 0; c < 3; ++c)
                a[c] = fe_add<F>(a[c], load_fe_cg(partial, gridDim.x, c, b));
        block_sum3<F>(a, sh);
        if (threadIdx.x == 0) *ticket = 0;
    }
    if (threadIdx.x != 0) return;
    // x = sum t1 e1 - xsq - con
    a[1] = fe_sub<F>(fe_sub<F>(a[1], a[0]), a[2]);
#pragma unroll
    for (int c = 0; c < 3; ++c) store_fe(g, 1, c, 0, a[c]);
    if (state_out == nullptr) return;
    for (int l = 0; l < t; ++l) {
        fe x = load_fe(state_in, 1, l, 0);
        // constant indices into a[], which then stays in registers
        if (l == 1) x = fe_add<F>(x, a[2]);
        if (l == 2) x = fe_add<F>(x, a[1]);
        if (l == 3) x = fe_add<F>(x, a[0]);
        store_fe(state_out, 1, l, 0, x);
    }
}

template <int F>
__global__ void __launch_bounds__(SC_THREADS)
fold_kernel(const u32* __restrict__ t0, const u32* __restrict__ t1,
            const u32* __restrict__ e0, const u32* __restrict__ e1,
            size_t st, size_t se, const u32* __restrict__ r, size_t sr,
            u32* __restrict__ t_out, u32* __restrict__ e_out,
            long long half) {
    const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (k >= half) return;
    const fe rr = load_fe(r, sr, 0, 0);
    const fe x0 = load_fe(t0, st, 0, k), x1 = load_fe(t1, st, 0, k);
    const fe y0 = load_fe(e0, se, 0, k), y1 = load_fe(e1, se, 0, k);
    store_fe(t_out, half, 0, k,
             fe_add<F>(x0, fe_mul<F>(rr, fe_sub<F>(x1, x0))));
    store_fe(e_out, half, 0, k,
             fe_add<F>(y0, fe_mul<F>(rr, fe_sub<F>(y1, y0))));
}

template <int F>
__global__ void __launch_bounds__(SC_THREADS)
eq_kernel(const u32* __restrict__ term, long long m, const u32* __restrict__ q,
          size_t sq, const u32* __restrict__ eq, u32* __restrict__ out) {
    const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (k >= m) return;
    const fe qq = load_fe(q, sq, 0, 0);
    const fe x = load_fe(term, m, 0, k);
    fe lo = fe_mul<F>(x, fe_sub<F>(fe_const<F>(FIELD_ONE), qq));
    fe hi = fe_mul<F>(x, qq);
    if (eq != nullptr) {
        lo = fe_add<F>(lo, load_fe(eq, 2 * m, 0, 2 * k));
        hi = fe_add<F>(hi, load_fe(eq, 2 * m, 0, 2 * k + 1));
    }
    store_fe(out, 2 * m, 0, 2 * k, lo);
    store_fe(out, 2 * m, 0, 2 * k + 1, hi);
}

static unsigned blocks_for(long long n) {
    return (unsigned)((n + SC_THREADS - 1) / SC_THREADS);
}

// One launch of `grid` blocks of `threads` (a multiple of 32, at most
// SC_THREADS) over n pairs; partial (3, 8, grid) and ticket (one word,
// 0) are needed when grid > 1.
extern "C" int reef_sc_coeffs(const void* t0, const void* t1, const void* e0,
                              const void* e1, long long st, long long se,
                              long long n, int grid, int threads,
                              void* partial, void* ticket, void* g,
                              const void* state_in, void* state_out, int t,
                              int field, void* stream) {
    if (n < 1 || grid < 1 || threads < 32 || threads > SC_THREADS ||
        threads % 32 || (grid > 1 && (partial == nullptr ||
                                      ticket == nullptr)) ||
        field < 0 || field > 1)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
#define REEF_COEFF(FF)                                                      \
    coeff_kernel<FF><<<grid, threads, 0, s>>>(                              \
        (const u32*)t0, (const u32*)t1, (const u32*)e0, (const u32*)e1, st, \
        se, n, (u32*)partial, (unsigned*)ticket, (u32*)g,                   \
        (const u32*)state_in, (u32*)state_out, t)
    if (field == 0)
        REEF_COEFF(0);
    else
        REEF_COEFF(1);
#undef REEF_COEFF
    return (int)cudaGetLastError();
}

extern "C" int reef_sc_fold(const void* t0, const void* t1, const void* e0,
                            const void* e1, long long st, long long se,
                            const void* r, long long sr, void* t_out,
                            void* e_out, long long half, int field,
                            void* stream) {
    if (half < 1 || field < 0 || field > 1) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const unsigned grid = blocks_for(half);
    if (field == 0)
        fold_kernel<0><<<grid, SC_THREADS, 0, s>>>(
            (const u32*)t0, (const u32*)t1, (const u32*)e0, (const u32*)e1, st,
            se, (const u32*)r, sr, (u32*)t_out, (u32*)e_out, half);
    else
        fold_kernel<1><<<grid, SC_THREADS, 0, s>>>(
            (const u32*)t0, (const u32*)t1, (const u32*)e0, (const u32*)e1, st,
            se, (const u32*)r, sr, (u32*)t_out, (u32*)e_out, half);
    return (int)cudaGetLastError();
}

extern "C" int reef_sc_eq_step(const void* term, long long m, const void* q,
                               long long sq, const void* eq, void* out,
                               int field, void* stream) {
    if (m < 1 || field < 0 || field > 1) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const unsigned grid = blocks_for(m);
    if (field == 0)
        eq_kernel<0><<<grid, SC_THREADS, 0, s>>>(
            (const u32*)term, m, (const u32*)q, sq, (const u32*)eq, (u32*)out);
    else
        eq_kernel<1><<<grid, SC_THREADS, 0, s>>>(
            (const u32*)term, m, (const u32*)q, sq, (const u32*)eq, (u32*)out);
    return (int)cudaGetLastError();
}
