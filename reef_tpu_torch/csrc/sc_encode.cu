// K6's table encode: an nlookup table's raw values into the Montgomery
// (8, n_pad) int32 layout that the sumcheck rounds read (sumcheck.cu),
// on the card that holds the table.
//
// Not a TPU kernel: the JAX package encodes the table on the host
// (limb.mont_words) and copies 32 bytes an entry to the device.  Here the
// host copies each value as one little-endian 64-bit word (a document's
// codes lie far below 2^63, an automaton's packed rows mostly do; a table
// with a value at or above 2^63 keeps the host encoder) and the card
// computes x R mod p as fe_mul(x, R^2): a quarter of the bytes crossing
// the bus and no host Montgomery work.
//
//   reef_sc_encode   out[:, k] = Montgomery(vals[k]) for k < n, 0 for
//                    n <= k < n_pad (the table's zero padding).
//
// Bound on this card: near the line between integer work and bytes.  An
// entry reads 8 bytes and writes 32 for one product (~270 multiply-adds):
// a 2^20-entry table is ~17 us of multiply-adds and ~13 us of traffic at
// 3.35 TB/s, once a prove, against the ~0.2 s the host encode and the
// 32-byte copy took.  Its own library, so that the benchmark's work count
// of the round kernels (sumcheck.cu) and their roofline share stay as
// they are.
#include "field.cuh"

constexpr int ENC_THREADS = 256;

template <int F>
__global__ void __launch_bounds__(ENC_THREADS)
encode_kernel(const uint2* __restrict__ vals, long long n, long long n_pad,
              u32* __restrict__ out) {
    const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (k >= n_pad) return;
    fe x;
#pragma unroll
    for (int l = 0; l < 8; ++l) x.v[l] = 0;
    if (k < n) {
        const uint2 v = vals[k];     // < 2^64 < p: fe_mul's operand range
        x.v[0] = v.x;
        x.v[1] = v.y;
        x = fe_mul<F>(x, fe_const<F>(FIELD_R2));
    }
    store_fe(out, n_pad, 0, k, x);
}

// vals: n little-endian 64-bit words (8-byte aligned); out: (8, n_pad)
// int32, n <= n_pad.
extern "C" int reef_sc_encode(const void* vals, long long n, long long n_pad,
                              void* out, int field, void* stream) {
    if (n < 0 || n_pad < 1 || n > n_pad || (n > 0 && vals == nullptr) ||
        ((unsigned long long)vals & 7) || field < 0 || field > 1)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const unsigned grid = (unsigned)((n_pad + ENC_THREADS - 1) / ENC_THREADS);
    if (field == 0)
        encode_kernel<0><<<grid, ENC_THREADS, 0, s>>>(
            (const uint2*)vals, n, n_pad, (u32*)out);
    else
        encode_kernel<1><<<grid, ENC_THREADS, 0, s>>>(
            (const uint2*)vals, n, n_pad, (u32*)out);
    return (int)cudaGetLastError();
}
