// K6: the nlookup sumcheck round on the card, three launchers over (8, n)
// int32 field tables (one field row; see load_fe in field.cuh).
//
// Not a TPU kernel: the JAX package's ops/sumcheck_device.py computes the
// round (_one_round_kernel) and the eq build (_build_eq_kernel) in XLA,
// outside any pallas_call.  This port's plain limb arithmetic costs some
// 200 torch launches per Montgomery product, so a round in plain torch on
// the card would be thousands of launches; these kernels keep the loop at a
// handful of launches a round, with nothing copied to the host between
// rounds.
//
//   reef_sc_coeffs   the round's three coefficients over the pairs
//                    (t0, t1, e0, e1) of the tables' halves:
//                    xsq = sum ts*es, x = sum (es*t0 + ts*e0),
//                    con = sum t0*e0 (ts = t1 - t0, es = e1 - e0).  Each
//                    block sums its pairs through shared memory; with more
//                    than one block, a second launch of the same kernel
//                    sums the blocks' partials.  The final block writes
//                    (xsq, x, con) and, given a sponge state, writes that
//                    state with con, x, xsq added into lanes 1, 2, 3 (the
//                    absorb of the Fiat-Shamir sponge).  Modular sums are
//                    exact in any order, so the coefficients equal the
//                    reference's halving-tree sums;
//   reef_sc_fold     both tables folded by the challenge r, read from device
//                    memory (the sponge lane the Poseidon kernel wrote):
//                    t0 + r*ts and e0 + r*es, tables of half the length;
//   reef_sc_eq_step  one doubling step of the eq table's running-claim
//                    term: out[2k] = term[k]*(1 - q), out[2k+1] =
//                    term[k]*q, plus the scattered claim table `eq` in the
//                    last step.
//
// Bound on this card: near the line between memory and integer work.  A
// coefficient pass reads 128 bytes a pair and does 4 products (~1,056
// multiply-adds), a fold reads 128 and writes 64 for 2 products, an eq
// step reads 32 (64 with `eq`) and writes 64 for 2 products.
#include "field.cuh"

constexpr int SC_THREADS = 256;

// Sums a[c] (c < 3) over the block into thread 0's a, through shared
// memory held as three field rows of SC_THREADS lanes.
template <int F>
__device__ __forceinline__ void block_sum3(fe (&a)[3], u32* sh) {
    const int t = threadIdx.x;
#pragma unroll
    for (int c = 0; c < 3; ++c) store_fe(sh, SC_THREADS, c, t, a[c]);
    __syncthreads();
#pragma unroll 1
    for (int s = SC_THREADS / 2; s > 0; s >>= 1) {
        if (t < s) {
#pragma unroll
            for (int c = 0; c < 3; ++c) {
                a[c] = fe_add<F>(a[c], load_fe(sh, SC_THREADS, c, t + s));
                store_fe(sh, SC_THREADS, c, t, a[c]);
            }
        }
        __syncthreads();
    }
}

// FIRST: a[] sums the products of pairs k = grid-stride over [0, n) of the
// tables (t0, t1 with row stride st; e0, e1 with row stride se).
// !FIRST: a[] sums columns [0, n) of the partials' three rows (t0, row
// stride n).  With one block the sums are final: g (3, 8, 1) gets
// (xsq, x, con) and, when state_out is given, state_out gets the (t, 8, 1)
// state_in with lanes 1..3 plus (con, x, xsq).  With more blocks each
// block writes its sums as column blockIdx.x of `partial` (3, 8, grid).
template <int F, bool FIRST>
__global__ void __launch_bounds__(SC_THREADS)
coeff_kernel(const u32* __restrict__ t0, const u32* __restrict__ t1,
             const u32* __restrict__ e0, const u32* __restrict__ e1,
             size_t st, size_t se, long long n, u32* __restrict__ partial,
             u32* __restrict__ g, const u32* __restrict__ state_in,
             u32* __restrict__ state_out, int t) {
    __shared__ u32 sh[3 * 8 * SC_THREADS];
    fe a[3];
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
        for (int l = 0; l < 8; ++l) a[c].v[l] = 0;
    const long long step = (long long)gridDim.x * blockDim.x;
    for (long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         k < n; k += step) {
        if (FIRST) {
            const fe x0 = load_fe(t0, st, 0, k), x1 = load_fe(t1, st, 0, k);
            const fe y0 = load_fe(e0, se, 0, k), y1 = load_fe(e1, se, 0, k);
            const fe ts = fe_sub<F>(x1, x0), es = fe_sub<F>(y1, y0);
            a[0] = fe_add<F>(a[0], fe_mul<F>(ts, es));
            a[1] = fe_add<F>(a[1], fe_add<F>(fe_mul<F>(es, x0),
                                             fe_mul<F>(ts, y0)));
            a[2] = fe_add<F>(a[2], fe_mul<F>(x0, y0));
        } else {
#pragma unroll
            for (int c = 0; c < 3; ++c)
                a[c] = fe_add<F>(a[c], load_fe(t0, n, c, k));
        }
    }
    block_sum3<F>(a, sh);
    if (threadIdx.x != 0) return;
    if (gridDim.x > 1) {
#pragma unroll
        for (int c = 0; c < 3; ++c)
            store_fe(partial, gridDim.x, c, blockIdx.x, a[c]);
        return;
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) store_fe(g, 1, c, 0, a[c]);
    if (state_out == nullptr) return;
    for (int l = 0; l < t; ++l) {
        fe x = load_fe(state_in, 1, l, 0);
        if (l >= 1 && l <= 3) x = fe_add<F>(x, a[3 - l]);
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

// first = 1: a pass over the table pairs with `grid` blocks; first = 0: the
// pass over `n` partials (t0 = the partials; one block).
extern "C" int reef_sc_coeffs(const void* t0, const void* t1, const void* e0,
                              const void* e1, long long st, long long se,
                              long long n, int first, int grid, void* partial,
                              void* g, const void* state_in, void* state_out,
                              int t, int field, void* stream) {
    if (n < 1 || grid < 1 || (!first && grid != 1) ||
        (grid > 1 && partial == nullptr) || field < 0 || field > 1)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const u32 *a = (const u32*)t0, *b = (const u32*)t1, *c = (const u32*)e0,
              *d = (const u32*)e1, *si = (const u32*)state_in;
    u32 *p = (u32*)partial, *gg = (u32*)g, *so = (u32*)state_out;
#define REEF_COEFF(FF, FIRST)                                               \
    coeff_kernel<FF, FIRST><<<grid, SC_THREADS, 0, s>>>(a, b, c, d, st, se, \
                                                        n, p, gg, si, so, t)
    if (field == 0) {
        if (first) REEF_COEFF(0, true);
        else REEF_COEFF(0, false);
    } else {
        if (first) REEF_COEFF(1, true);
        else REEF_COEFF(1, false);
    }
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
