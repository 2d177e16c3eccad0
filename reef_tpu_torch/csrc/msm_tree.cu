// K2: the per-window pairwise-sum tree of the MSM chunk, all levels.
//
// Replaces the JAX package's ec/msm_v3.py _tree_call / _tree_body.  Input:
// the chunk's basis points gathered in each window's digit-sorted order,
// affine (X, Y) only, as a (2, 8, W, cap) int32 array (every basis lane has
// Z = 1: the basis pads with zero-scalar generators).  Output: a
// (3, 8, W, cap) int32 array holding, for each window, level b of the tree
// (b = 1 .. log2 cap, cap >> b nodes; node k = sorted points
// [k 2^b, (k+1) 2^b)) at lanes [cap - (cap >> (b-1)), ... + (cap >> b)).
// Node k of level b is node 2k + node 2k+1 of level b-1 — the same pairs as
// the reference, so the projective results are identical.
//
// The TPU kernel keeps every level of one window in VMEM (megabytes) and
// runs the windows one after another; it places points in bit-reversed
// order so that each level's pairs are two contiguous sublane slices, and
// leaves the levels narrower than 1024 lanes to separate XLA adds.  Here a
// block has ~227 KB of shared memory and the blocks run in parallel, so the
// tree is cut into sub-trees: one pass of this kernel takes 2^n nodes of
// one level (natural order, pairs adjacent) per block and reduces them
// through shared memory to one node, writing every level it makes; the
// grid is (sub-trees, windows).  Level 1 is the 10-product affine add.  A
// second pass, of the same kernel with the level-n nodes as its input,
// makes the levels above (n <= 8 per pass, so two passes up to
// cap = 65536).
//
// Bound on this card: integer multiply-adds, as for K1 (padd.cu).  Each
// level halves the active threads: the first level of a block keeps all
// of them busy, and the levels above it, which hold the other half of the
// block's additions, leave more and more of them idle.
#include "ec.cuh"

__device__ __forceinline__ size_t level_off(int cap, int b) {
    return (size_t)(cap - (cap >> (b - 1)));
}

template <int F, bool AFFINE_IN>
__global__ void __launch_bounds__(128)
tree_pass(const u32* __restrict__ src, u32* out, int W, int cap, int lvl_in,
          int n_levels) {
    extern __shared__ u32 sh[];            // 24 rows of `half` words
    const int half = 1 << (n_levels - 1);  // == blockDim.x
    const int t = threadIdx.x;
    const size_t row = (size_t)W * cap;    // limb-row stride
    const size_t base = (size_t)blockIdx.y * cap;
    const size_t j = (size_t)blockIdx.x * half + t;

    point r;
    if (AFFINE_IN) {
        const size_t i0 = base + 2 * j;
        r = padd_affine<F>(load_fe(src, row, 0, i0), load_fe(src, row, 1, i0),
                           load_fe(src, row, 0, i0 + 1),
                           load_fe(src, row, 1, i0 + 1));
    } else {
        const size_t i0 = base + level_off(cap, lvl_in) + 2 * j;
        r = padd<F>(load_point(out, row, i0), load_point(out, row, i0 + 1));
    }
    int lvl = lvl_in + 1;
    store_point(out, row, base + level_off(cap, lvl) + j, r);

    for (int k = 1; k < n_levels; ++k) {
        const int width = half >> k;       // this level's nodes in the block
        if (t < 2 * width) store_point(sh, half, t, r);
        __syncthreads();
        if (t < width)
            r = padd<F>(load_point(sh, half, 2 * t),
                        load_point(sh, half, 2 * t + 1));
        __syncthreads();
        ++lvl;
        if (t < width)
            store_point(out, row,
                        base + level_off(cap, lvl) +
                            (size_t)blockIdx.x * width + t,
                        r);
    }
}

// One pass: levels lvl_in+1 .. lvl_in+n_levels of every window.  lvl_in 0
// reads the gathered affine points from `src`; a later pass reads level
// lvl_in from `out` itself.
extern "C" int reef_tree_pass(const void* src, void* out, int W, int cap,
                              int lvl_in, int n_levels, int field,
                              void* stream) {
    if (n_levels < 1 || n_levels > 8 || (cap >> lvl_in) < (1 << n_levels))
        return (int)cudaErrorInvalidValue;
    const int half = 1 << (n_levels - 1);
    const dim3 grid((cap >> lvl_in) / (2 * half), W);
    const dim3 block(half);
    const size_t smem = 24 * half * sizeof(u32);
    cudaStream_t s = (cudaStream_t)stream;
    const u32* in = (const u32*)src;
    u32* o = (u32*)out;
    if (field == 0) {
        if (lvl_in == 0)
            tree_pass<0, true><<<grid, block, smem, s>>>(in, o, W, cap, 0,
                                                         n_levels);
        else
            tree_pass<0, false><<<grid, block, smem, s>>>(in, o, W, cap,
                                                          lvl_in, n_levels);
    } else {
        if (lvl_in == 0)
            tree_pass<1, true><<<grid, block, smem, s>>>(in, o, W, cap, 0,
                                                         n_levels);
        else
            tree_pass<1, false><<<grid, block, smem, s>>>(in, o, W, cap,
                                                          lvl_in, n_levels);
    }
    return (int)cudaGetLastError();
}
