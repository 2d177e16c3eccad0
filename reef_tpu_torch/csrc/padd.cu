// K1: complete point addition on (3, 8, B) int32 point arrays (see ec.cuh
// for the layout), three launches:
//
//   reef_padd, path THREAD   out[i] = P[i] + Q[i], one thread a lane, the
//                            formula of ec.cuh once per thread;
//   reef_padd, path SPREAD   the same sums, each add spread over a group of
//                            SPREAD = 6 threads;
//   reef_padd_reduce         sums of a power-of-two axis of L points by
//                            halving (element i plus element i + L/2 at
//                            each level), all levels in one launch through
//                            shared memory, with an optional acc + sum as
//                            the last add.
//
// Replaces the JAX package's ec/pallas_ec.py _padd_call / _padd_body
// behind padd_soa, and the per-level loops of padd_soa calls that its
// ec/msm_v3.py runs over the Fenwick level axis (_chunk_prefixes) and the
// digit axis (_halve_digits).  The TPU kernel stacks its 14 Montgomery
// products into 3+3+2+6 independent groups so its vector unit sees
// interleaved work, and runs 8 sub-blocks of 1024 lanes per grid step to
// hide a per-step pipeline cost; here the groups become threads.
//
// Bound on this card.  Wide batches: integer multiply-adds (a lane reads
// 192 bytes, writes 96, and does 14 products of ~264 multiply-adds).  THREAD
// keeps one lane in one thread and lets the warp scheduler interleave lanes;
// ~100 live registers cap the resident warps.  Narrow batches (at most one
// block an SM) are bound by one lane's latency: 14 dependent-in-part
// products in one thread, ~0.7 us each.  SPREAD cuts that chain to 3
// products: thread r of a group computes the formula's r-th product of
// each of its three stages (6 independent products; b3*t2 and b3*y3, which
// each later thread recomputes for itself rather than wait on a fourth
// barrier; then 6 more), and the group exchanges them through shared
// memory, so it issues 17 products an add in place of 14 and loses once the
// card is full.  The per-level loops of the MSM paid a launch, a host call
// and a copy a level, with every level below the first under one block an
// SM; the reduce keeps every level's points in shared memory and picks
// THREAD or SPREAD adds level by level (`spread_mask`, from the host's
// plan).  Every product and sum is the formula's own, mod p, so all three
// launches give the plain version's canonical limbs.
#include "ec.cuh"

// SPREAD (threads a SPREAD add) and padd_spread are in ec.cuh
constexpr int THREAD_BLOCK = 128;   // threads a block of the THREAD launch
constexpr int SPREAD_BLOCK = 96;    // 16 SPREAD groups a block
constexpr int REDUCE_MAX_THREADS = 384;  // a latency-bound reduce's block
constexpr int REDUCE_THREADS = 128;      // a wide reduce's block

template <int F>
__global__ void __launch_bounds__(THREAD_BLOCK) padd_kernel(
    const u32* __restrict__ P, const u32* __restrict__ Q,
    u32* __restrict__ O, int B) {
    const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= (size_t)B) return;
    const point a = load_point(P, B, i);
    const point b = load_point(Q, B, i);
    store_point(O, B, i, padd<F>(a, b));
}

template <int F>
__global__ void __launch_bounds__(SPREAD_BLOCK) padd_spread_kernel(
    const u32* __restrict__ P, const u32* __restrict__ Q,
    u32* __restrict__ O, int B) {
    __shared__ fe sh[SPREAD_BLOCK / SPREAD][2 * SPREAD];
    const int grp = threadIdx.x / SPREAD, r = threadIdx.x % SPREAD;
    const size_t i = (size_t)blockIdx.x * (SPREAD_BLOCK / SPREAD) + grp;
    padd_spread<F>(P, B, i, Q, B, i, O, B, i, r, sh[grp], i < (size_t)B);
}

// The sums over axis j of L points, X at lane
//   (o / inner) * s_hi + (o % inner) * s_lo + j * s_l   (row `row`),
// for each output o < n_out: out (3, 8, n_out) gets, in o, the halving sum
// of its L points, plus acc[o] first where acc is given (acc + sum).  A
// block owns `gpb` outputs; level lev (0 = the first halving, log2 L = the
// acc add) adds by THREAD when bit lev of spread_mask is clear, else by
// SPREAD groups of blockDim / 6.  Level 0 reads X, the other levels the
// L/2 points of each output kept in shared memory (gpb * L / 2 points,
// SoA, point k of the block's output lg in slot k * gpb + lg).  Add a of
// a level is point k = a / gpb of output lg = a % gpb, so neighbouring
// threads read neighbouring outputs (contiguous lanes where the outputs
// are, as on the Fenwick axis) and neighbouring slots.  MAXT is the
// block's most threads: a wide reduce runs blocks of REDUCE_THREADS, four
// an SM; a latency-bound one up to REDUCE_MAX_THREADS.
template <int F, int MAXT>
__global__ void __launch_bounds__(MAXT, MAXT == REDUCE_THREADS ? 4 : 1)
padd_reduce_kernel(
    const u32* __restrict__ X, size_t row, long long n_out, long long inner,
    long long s_hi, long long s_lo, long long s_l, int L,
    const u32* __restrict__ acc, u32* __restrict__ out, int gpb,
    unsigned spread_mask) {
    extern __shared__ u32 smem[];
    const int half = L / 2;
    const size_t srow = (size_t)gpb * half;    // shared point slots
    u32* pts = smem;
    fe* scratch = reinterpret_cast<fe*>(smem + 3 * 8 * srow);
    const int tid = threadIdx.x, T = blockDim.x;
    const long long o0 = (long long)blockIdx.x * gpb;
    const int levels = __ffs(L) - 1 + (acc != nullptr);
    int h = half;
    for (int lev = 0; lev < levels; ++lev, h = h > 1 ? h / 2 : 1) {
        const bool acc_add = lev == levels - 1 && acc != nullptr;
        const bool last = lev == levels - 1;
        const int adds = gpb * (acc_add ? 1 : h);
        const bool spread = (spread_mask >> lev) & 1u;
        const int workers = spread ? T / SPREAD : T;
        const int w = spread ? tid / SPREAD : tid;
        const int r = spread ? tid % SPREAD : 0;
        for (int base = 0; base < adds; base += workers) {
            const int a = base + w;
            const bool live = a < adds && w < workers;
            const int lg = live ? a % gpb : 0;
            const int k = live ? a / gpb : 0;
            const long long o = o0 + lg;
            const bool on = live && o < n_out;
            const u32 *p, *q;
            size_t prow, qrow, pi, qi;
            if (acc_add) {
                p = acc, prow = n_out, pi = on ? o : 0;
                q = pts, qrow = srow, qi = lg;
            } else if (lev == 0) {
                const long long lane = on ? (o / inner) * s_hi +
                                            (o % inner) * s_lo : 0;
                p = q = X, prow = qrow = row;
                pi = lane + k * s_l, qi = lane + (k + h) * s_l;
            } else {
                p = q = pts, prow = qrow = srow;
                pi = (size_t)k * gpb + lg, qi = pi + (size_t)h * gpb;
            }
            u32* dst = last ? out : pts;
            const size_t drow = last ? n_out : srow;
            const size_t di = last ? (on ? o : 0) : (size_t)k * gpb + lg;
            if (spread) {
                padd_spread<F>(p, prow, pi, q, qrow, qi, dst, drow, di, r,
                               scratch + 2 * SPREAD * (live ? w : 0), on);
            } else if (on) {
                store_point(dst, drow, di, padd<F>(load_point(p, prow, pi),
                                                   load_point(q, qrow, qi)));
            }
        }
        __syncthreads();
    }
}

// path 0: THREAD, 1: SPREAD
extern "C" int reef_padd(const void* P, const void* Q, void* O, int B,
                         int field, int path, void* stream) {
    if (B < 1 || field < 0 || field > 1 || path < 0 || path > 1)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const u32* p = (const u32*)P;
    const u32* q = (const u32*)Q;
    u32* o = (u32*)O;
    if (path == 0) {
        const dim3 grid((B + THREAD_BLOCK - 1) / THREAD_BLOCK);
        if (field == 0)
            padd_kernel<0><<<grid, THREAD_BLOCK, 0, s>>>(p, q, o, B);
        else
            padd_kernel<1><<<grid, THREAD_BLOCK, 0, s>>>(p, q, o, B);
    } else {
        constexpr int G = SPREAD_BLOCK / SPREAD;
        const dim3 grid((B + G - 1) / G);
        if (field == 0)
            padd_spread_kernel<0><<<grid, SPREAD_BLOCK, 0, s>>>(p, q, o, B);
        else
            padd_spread_kernel<1><<<grid, SPREAD_BLOCK, 0, s>>>(p, q, o, B);
    }
    return (int)cudaGetLastError();
}

extern "C" int reef_padd_reduce(const void* X, long long row,
                                long long n_out, long long inner,
                                long long s_hi, long long s_lo,
                                long long s_l, int L, const void* acc,
                                void* out, int gpb, int threads,
                                unsigned spread_mask, int field,
                                void* stream) {
    if (n_out < 1 || inner < 1 || L < 2 || (L & (L - 1)) || gpb < 1 ||
        threads < SPREAD || threads > REDUCE_MAX_THREADS || field < 0 ||
        field > 1)
        return (int)cudaErrorInvalidValue;
    const size_t shmem = (size_t)gpb * (L / 2) * 3 * 8 * sizeof(u32) +
                         (size_t)(threads / SPREAD) * 2 * SPREAD * sizeof(fe);
    if (shmem > 48 * 1024) return (int)cudaErrorInvalidValue;
    const unsigned grid = (unsigned)((n_out + gpb - 1) / gpb);
    cudaStream_t s = (cudaStream_t)stream;
#define REEF_REDUCE(FF, MT)                                                  \
    padd_reduce_kernel<FF, MT><<<grid, threads, shmem, s>>>(                 \
        (const u32*)X, (size_t)row, n_out, inner, s_hi, s_lo, s_l, L,        \
        (const u32*)acc, (u32*)out, gpb, spread_mask)
    const bool wide = threads <= REDUCE_THREADS;
    if (field == 0) {
        if (wide) REEF_REDUCE(0, REDUCE_THREADS);
        else REEF_REDUCE(0, REDUCE_MAX_THREADS);
    } else {
        if (wide) REEF_REDUCE(1, REDUCE_THREADS);
        else REEF_REDUCE(1, REDUCE_MAX_THREADS);
    }
#undef REEF_REDUCE
    return (int)cudaGetLastError();
}
