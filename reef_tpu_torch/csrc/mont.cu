// K3 and K4: the standalone field kernels, on the plain layout.
//
// K3 reef_mont_mul replaces the JAX package's ops/pallas_field.py
// _mul_call / _mul_body behind mont_mul: out[i] = a[i] * b[i] * 2^-256
// mod p.  K4 reef_mont_redc replaces _redc_call / _redc_body behind
// mont_redc_cols: the Montgomery reduction of 32 column sums (an MXU
// accumulation of the byte-matmul Poseidon MDS, or a product's schoolbook
// columns) to a canonical element.
//
// Layout: both kernels read and write the port's plain layout directly,
// sixteen 16-bit limbs in int64 rows, element (l, i) at l * n + i: K3
// (16, n) and (16, n) -> (16, n), K4 (32, n) -> (16, n).  The callers of
// the dispatch hook (ops/field_kernel.py) hold that layout, so a kernel
// layout of eight 32-bit limbs would cost a split and a join of torch ops
// around every call; instead a thread packs pairs of 16-bit limbs into
// field.cuh's 32-bit limbs in registers.  The TPU kernels pad the batch
// to 1024-element blocks; here one thread owns one element and the last
// block masks the tail, so nothing is padded.
//
// K3's body is field.cuh's CIOS product (the port of mul_tile).  K4 keeps
// the reference's 16 REDC rounds on 16-bit limbs, with 64-bit columns:
// the reference's uint32 columns hold inputs below 2^31 (and wrap above);
// int64 columns hold those exactly and also a product's schoolbook
// columns (below 2^40), so K4 is exact wherever its plain version is.
// An MXU value reaches ~5p^2 > p*2^256, so the REDC leaves up to ~2.3p
// and two conditional subtracts (field.cuh's) make it canonical.
//
// Bound on this card: K3 moves 384 bytes an element for one product of
// ~264 32-bit multiply-adds, which is operation-bound by the table's
// float32 rate but near the balance point; K4 moves 384 bytes for 256
// 64-bit multiply-adds (about four 32-bit ones each).  Both are simple:
// one element a thread, 128 threads a block.
#include "field.cuh"

typedef long long i64;
typedef unsigned long long u64;

__device__ __forceinline__ fe load_plain(const i64* base, size_t n,
                                         size_t i) {
    fe r;
#pragma unroll
    for (int l = 0; l < 8; ++l)
        r.v[l] = (u32)base[(size_t)(2 * l) * n + i] |
                 ((u32)base[(size_t)(2 * l + 1) * n + i] << 16);
    return r;
}

__device__ __forceinline__ void store_plain(i64* base, size_t n, size_t i,
                                            const fe& a) {
#pragma unroll
    for (int l = 0; l < 8; ++l) {
        base[(size_t)(2 * l) * n + i] = (i64)(a.v[l] & 0xffffu);
        base[(size_t)(2 * l + 1) * n + i] = (i64)(a.v[l] >> 16);
    }
}

template <int F>
__global__ void __launch_bounds__(128) mont_mul_kernel(
    const i64* __restrict__ A, const i64* __restrict__ B,
    i64* __restrict__ O, i64 n) {
    const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= (size_t)n) return;
    store_plain(O, n, i, fe_mul<F>(load_plain(A, n, i), load_plain(B, n, i)));
}

// 16-bit limb j of p
template <int F>
__device__ __forceinline__ u64 p16(int j) {
    return (FIELD_P[F][j >> 1] >> (16 * (j & 1))) & 0xffffu;
}

template <int F>
__global__ void __launch_bounds__(128) mont_redc_kernel(
    const i64* __restrict__ C, i64* __restrict__ O, i64 n) {
    const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= (size_t)n) return;
    u64 c[32];
#pragma unroll
    for (int k = 0; k < 32; ++k) c[k] = (u64)C[(size_t)k * n + i];
    // -p^-1 mod 2^16 is the low half of field.cuh's -p^-1 mod 2^32
    const u32 n0 = FIELD_N0[F] & 0xffffu;
#pragma unroll
    for (int r = 0; r < 16; ++r) {
        const u64 m = ((u32)c[r] * n0) & 0xffffu;
#pragma unroll
        for (int j = 0; j < 16; ++j) c[r + j] += m * p16<F>(j);
        c[r + 1] += c[r] >> 16;   // c[r] is now 0 mod 2^16
    }
#pragma unroll
    for (int k = 16; k < 31; ++k) {
        c[k + 1] += c[k] >> 16;
        c[k] &= 0xffffu;
    }
    fe t;
#pragma unroll
    for (int l = 0; l < 8; ++l)
        t.v[l] = (u32)c[16 + 2 * l] | ((u32)c[17 + 2 * l] << 16);
    store_plain(O, n, i, fe_reduce_once<F>(fe_reduce_once<F>(t)));
}

extern "C" int reef_mont_mul(const void* A, const void* B, void* O, i64 n,
                             int field, void* stream) {
    const dim3 block(128);
    const dim3 grid((unsigned)((n + 127) / 128));
    cudaStream_t s = (cudaStream_t)stream;
    const i64* a = (const i64*)A;
    const i64* b = (const i64*)B;
    i64* o = (i64*)O;
    if (field == 0)
        mont_mul_kernel<0><<<grid, block, 0, s>>>(a, b, o, n);
    else
        mont_mul_kernel<1><<<grid, block, 0, s>>>(a, b, o, n);
    return (int)cudaGetLastError();
}

extern "C" int reef_mont_redc(const void* C, void* O, i64 n, int field,
                              void* stream) {
    const dim3 block(128);
    const dim3 grid((unsigned)((n + 127) / 128));
    cudaStream_t s = (cudaStream_t)stream;
    const i64* c = (const i64*)C;
    i64* o = (i64*)O;
    if (field == 0)
        mont_redc_kernel<0><<<grid, block, 0, s>>>(c, o, n);
    else
        mont_redc_kernel<1><<<grid, block, 0, s>>>(c, o, n);
    return (int)cudaGetLastError();
}
