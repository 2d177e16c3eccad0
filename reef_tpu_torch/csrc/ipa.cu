// The IPA prover's rounds on the card (backend/ipa.py, ec/ipa_device.py):
// four launchers over (8, n) int32 scalar-field tables (one field row;
// see load_fe in field.cuh), the MSM's window sums and the basis.
//
// Not a TPU kernel: the JAX package runs these rounds on its host, in
// native/msm.cpp (ipa_cross, ipa_fold, ipa_materialize), and so did this
// port.  On the card the round state stays resident: w, R and the fold
// coefficients, with the basis the fold steps' commits already hold
// (PedersenGens.device_G).  A round sends down one challenge and brings
// back two points and two scalars.
//
// Values: w and R are canonical scalars (not Montgomery), the
// coefficients and the challenges Montgomery.  A Montgomery product of a
// canonical value by a Montgomery one is then canonical (w coeff R R^-1),
// so the expanded scalars go to the MSM's bytes with no conversion, the
// folds keep w and R canonical, and coeff x stays Montgomery.  The cross
// dots sum products of two canonical values, so they come out times
// R^-1: the host multiplies the read-back by R mod p.
//
//   reef_ipa_scalars     both rows of expanded scalars over the basis, as
//                        the MSM's scalar bytes (n2, 64): row L (bytes
//                        0..31) is w_lo[pos - half] coeff[j] where
//                        pos = j mod n >= half, row R (bytes 32..63) is
//                        w_hi[pos] coeff[j] elsewhere, zero in the other;
//   reef_ipa_dots        the two cross dots, sum w_lo R_hi and sum w_hi R_lo,
//                        as one partial a block (a block sums by warp
//                        shuffles, then across its warps);
//   reef_ipa_combine     each row's 32 window sums (the MSM's, windows
//                        r*32 .. r*32+31 of row r) by Horner, 8 doublings
//                        and one add a window, a SPREAD group of six
//                        threads a row (ec.cuh padd_spread); two more
//                        threads sum the dots' partials;
//   reef_ipa_fold        w <- x w_lo + x^-1 w_hi, R <- x^-1 R_lo + x R_hi,
//                        coeff[j] *= x^-1 where j mod n < half, else x; x
//                        and x^-1 come by value.
//
// Bound on this card.  A scalar pass is one product and 64 written bytes a
// basis point; a fold two products a pair and one a coefficient: integer
// work spread over the whole grid, tens of microseconds at 2^16.  The
// combine is latency: a chain of 288 complete adds, each 3 products deep
// spread over six threads, where one thread an add was 14 deep (2.66 ms
// a combine on the H100, PERF.md).  The MSM between them (K2 and K1), over
// the whole original basis every round, sets a round's time.
#include "ec.cuh"

constexpr int IPA_THREADS = 128;
constexpr int DOT_THREADS = 256;
constexpr int DOT_WARPS = DOT_THREADS / 32;

template <int F>
__global__ void __launch_bounds__(IPA_THREADS) ipa_scalars_kernel(
    const u32* __restrict__ w, const u32* __restrict__ coeff,
    u32* __restrict__ out, long long n_orig, long long n) {
    const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (j >= n_orig) return;
    const long long half = n >> 1, pos = j & (n - 1);
    const bool to_l = pos >= half;
    const fe s = fe_mul<F>(load_fe(w, n_orig, 0, to_l ? pos - half : half + pos),
                           load_fe(coeff, n_orig, 0, j));
    uint4* o = reinterpret_cast<uint4*>(out + 16 * j);
    const uint4 lo = {s.v[0], s.v[1], s.v[2], s.v[3]};
    const uint4 hi = {s.v[4], s.v[5], s.v[6], s.v[7]};
    const uint4 zero = {0u, 0u, 0u, 0u};
    o[0] = to_l ? lo : zero;
    o[1] = to_l ? hi : zero;
    o[2] = to_l ? zero : lo;
    o[3] = to_l ? zero : hi;
}

__device__ __forceinline__ fe shfl_down(const fe& a, int off) {
    fe r;
#pragma unroll
    for (int l = 0; l < 8; ++l)
        r.v[l] = __shfl_down_sync(0xffffffffu, a.v[l], off);
    return r;
}

// partial (2, 8, gridDim.x): block b's sums of w[i] R[half + i] and
// w[half + i] R[i] over its grid-stride share of i < half
template <int F>
__global__ void __launch_bounds__(DOT_THREADS) ipa_dots_kernel(
    const u32* __restrict__ w, const u32* __restrict__ R,
    u32* __restrict__ partial, long long stride, long long half) {
    __shared__ fe warp_sums[2][DOT_WARPS];
    fe a = {}, b = {};
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < half; i += (long long)gridDim.x * blockDim.x) {
        a = fe_add<F>(a, fe_mul<F>(load_fe(w, stride, 0, i),
                                   load_fe(R, stride, 0, half + i)));
        b = fe_add<F>(b, fe_mul<F>(load_fe(w, stride, 0, half + i),
                                   load_fe(R, stride, 0, i)));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        a = fe_add<F>(a, shfl_down(a, off));
        b = fe_add<F>(b, shfl_down(b, off));
    }
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) {
        warp_sums[0][warp] = a;
        warp_sums[1][warp] = b;
    }
    __syncthreads();
    if (threadIdx.x < 2) {
        fe s = warp_sums[threadIdx.x][0];
        for (int k = 1; k < DOT_WARPS; ++k)
            s = fe_add<F>(s, warp_sums[threadIdx.x][k]);
        store_fe(partial, gridDim.x, threadIdx.x, blockIdx.x, s);
    }
}

// out: (3, 8, rows) points, then (2, 8) dots; acc (3, 8, rows * 32).
// A SPREAD group a row runs Horner in shared memory, a doubling being the
// complete add of the point to itself; every thread of the block takes
// part in every barrier.
constexpr int COMBINE_THREADS = 32;
constexpr int COMBINE_ROWS = COMBINE_THREADS / SPREAD - 1;   // 2 threads
                                                             // for the dots
template <int FB, int FS>
__global__ void __launch_bounds__(COMBINE_THREADS) ipa_combine_kernel(
    const u32* __restrict__ acc, int rows, const u32* __restrict__ partial,
    int nb, u32* __restrict__ out) {
    __shared__ fe sh[COMBINE_ROWS][2 * SPREAD];
    __shared__ u32 a[3 * 8 * COMBINE_ROWS];
    const int t = threadIdx.x, g = t / SPREAD, r = t % SPREAD;
    const bool live = g < rows;
    const size_t stride = (size_t)rows * 32;
    if (live && r < 3)
        store_fe(a, COMBINE_ROWS, r, g,
                 r == 1 ? fe_const<FB>(FIELD_ONE) : fe{});
    if (t >= COMBINE_THREADS - 2) {            // the dots' partials
        const int d = t - (COMBINE_THREADS - 2);
        fe s = load_fe(partial, nb, d, 0);
        for (int k = 1; k < nb; ++k)
            s = fe_add<FS>(s, load_fe(partial, nb, d, k));
        u32* o = out + 3 * 8 * rows + 8 * d;
#pragma unroll
        for (int l = 0; l < 8; ++l) o[l] = s.v[l];
    }
    __syncthreads();
    for (int w = 31; w >= 0; --w) {
#pragma unroll 1
        for (int k = 0; k < 8; ++k) {
            padd_spread<FB>(a, COMBINE_ROWS, g, a, COMBINE_ROWS, g, a,
                            COMBINE_ROWS, g, r, sh[live ? g : 0], live);
            __syncthreads();
        }
        padd_spread<FB>(a, COMBINE_ROWS, g, acc, stride, (size_t)g * 32 + w,
                        a, COMBINE_ROWS, g, r, sh[live ? g : 0], live);
        __syncthreads();
    }
    if (live && r < 3) store_fe(out, rows, r, g, load_fe(a, COMBINE_ROWS, r, g));
}

template <int F>
__global__ void __launch_bounds__(IPA_THREADS) ipa_fold_kernel(
    u32* w, u32* R, u32* coeff, long long n_orig, long long n, fe x, fe xi) {
    const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long half = n >> 1;
    if (j < half) {
        // thread j alone reads index j of the low half: in place is safe
        store_fe(w, n_orig, 0, j,
                 fe_add<F>(fe_mul<F>(x, load_fe(w, n_orig, 0, j)),
                           fe_mul<F>(xi, load_fe(w, n_orig, 0, half + j))));
        store_fe(R, n_orig, 0, j,
                 fe_add<F>(fe_mul<F>(xi, load_fe(R, n_orig, 0, j)),
                           fe_mul<F>(x, load_fe(R, n_orig, 0, half + j))));
    }
    if (j < n_orig)
        store_fe(coeff, n_orig, 0, j,
                 fe_mul<F>(load_fe(coeff, n_orig, 0, j),
                           (j & (n - 1)) < half ? xi : x));
}

static unsigned blocks(long long n, int threads) {
    return (unsigned)((n + threads - 1) / threads);
}

extern "C" int reef_ipa_scalars(const void* w, const void* coeff, void* out,
                                long long n_orig, long long n, int field,
                                void* stream) {
    if (n < 2 || (n & (n - 1)) || n_orig < n || (n_orig & (n_orig - 1)) ||
        field < 0 || field > 1)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const unsigned g = blocks(n_orig, IPA_THREADS);
    if (field == 0)
        ipa_scalars_kernel<0><<<g, IPA_THREADS, 0, s>>>(
            (const u32*)w, (const u32*)coeff, (u32*)out, n_orig, n);
    else
        ipa_scalars_kernel<1><<<g, IPA_THREADS, 0, s>>>(
            (const u32*)w, (const u32*)coeff, (u32*)out, n_orig, n);
    return (int)cudaGetLastError();
}

extern "C" int reef_ipa_dots(const void* w, const void* R, void* partial,
                             long long stride, long long half, int grid,
                             int field, void* stream) {
    if (half < 1 || grid < 1 || field < 0 || field > 1)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (field == 0)
        ipa_dots_kernel<0><<<grid, DOT_THREADS, 0, s>>>(
            (const u32*)w, (const u32*)R, (u32*)partial, stride, half);
    else
        ipa_dots_kernel<1><<<grid, DOT_THREADS, 0, s>>>(
            (const u32*)w, (const u32*)R, (u32*)partial, stride, half);
    return (int)cudaGetLastError();
}

// base: the curve's base field (the points); scalar: its scalar field
// (the dots) — the other field id of the two
extern "C" int reef_ipa_combine(const void* acc, int rows, const void* partial,
                                int nb, void* out, int base, void* stream) {
    if (rows < 1 || rows > COMBINE_ROWS || nb < 1 || base < 0 || base > 1)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (base == 0)
        ipa_combine_kernel<0, 1><<<1, COMBINE_THREADS, 0, s>>>(
            (const u32*)acc, rows, (const u32*)partial, nb, (u32*)out);
    else
        ipa_combine_kernel<1, 0><<<1, COMBINE_THREADS, 0, s>>>(
            (const u32*)acc, rows, (const u32*)partial, nb, (u32*)out);
    return (int)cudaGetLastError();
}

// xs: 16 host words, x then x^-1, Montgomery
extern "C" int reef_ipa_fold(void* w, void* R, void* coeff, long long n_orig,
                             long long n, const void* xs, int field,
                             void* stream) {
    if (n < 2 || (n & (n - 1)) || n_orig < n || xs == nullptr ||
        field < 0 || field > 1)
        return (int)cudaErrorInvalidValue;
    fe x, xi;
    const u32* h = (const u32*)xs;
#pragma unroll
    for (int l = 0; l < 8; ++l) {
        x.v[l] = h[l];
        xi.v[l] = h[8 + l];
    }
    cudaStream_t s = (cudaStream_t)stream;
    const unsigned g = blocks(n_orig, IPA_THREADS);
    if (field == 0)
        ipa_fold_kernel<0><<<g, IPA_THREADS, 0, s>>>(
            (u32*)w, (u32*)R, (u32*)coeff, n_orig, n, x, xi);
    else
        ipa_fold_kernel<1><<<g, IPA_THREADS, 0, s>>>(
            (u32*)w, (u32*)R, (u32*)coeff, n_orig, n, x, xi);
    return (int)cudaGetLastError();
}
