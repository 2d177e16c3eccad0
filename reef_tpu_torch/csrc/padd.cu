// K1: batched complete point addition, out[i] = P[i] + Q[i], on (3, 8, B)
// int32 point arrays (see ec.cuh for the layout).
//
// Replaces the JAX package's ec/pallas_ec.py _padd_call / _padd_body
// behind padd_soa.  The TPU kernel stacks its 14 Montgomery products into
// 3+3+2+6 independent groups so its vector unit sees interleaved work,
// and runs 8 sub-blocks of 1024 lanes per grid step to hide a per-step
// pipeline cost.  Neither applies here: one thread owns one lane and the
// warp scheduler interleaves independent lanes, so the kernel is the
// addition formula once per thread, 128 threads a block.
//
// Bound on this card: integer multiply-adds.  A lane reads 192 bytes and
// writes 96 but does 14 products of ~270 32-bit multiply-adds each, far
// above the H100's bytes-per-operation balance.  The ~200 live registers
// of the 255-bit operands cap the resident warps, so latency hiding comes
// from instruction-level parallelism within a lane.
#include "ec.cuh"

template <int F>
__global__ void __launch_bounds__(128) padd_kernel(const u32* __restrict__ P,
                                                   const u32* __restrict__ Q,
                                                   u32* __restrict__ O, int B) {
    const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= (size_t)B) return;
    const point a = load_point(P, B, i);
    const point b = load_point(Q, B, i);
    store_point(O, B, i, padd<F>(a, b));
}

extern "C" int reef_padd(const void* P, const void* Q, void* O, int B,
                         int field, void* stream) {
    const dim3 block(128);
    const dim3 grid((B + 127) / 128);
    cudaStream_t s = (cudaStream_t)stream;
    const u32* p = (const u32*)P;
    const u32* q = (const u32*)Q;
    u32* o = (u32*)O;
    if (field == 0)
        padd_kernel<0><<<grid, block, 0, s>>>(p, q, o, B);
    else
        padd_kernel<1><<<grid, block, 0, s>>>(p, q, o, B);
    return (int)cudaGetLastError();
}
