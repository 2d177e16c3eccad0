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
// the reference, so the projective results are identical.  Level 1 is the
// 10-product affine add, the levels above the 14-product complete add.
//
// The TPU kernel keeps every level of one window in VMEM (megabytes) and
// runs the windows one after another; it places points in bit-reversed
// order so that each level's pairs are two contiguous sublane slices, and
// leaves the levels narrower than 1024 lanes to separate XLA adds.  Here
// the blocks run in parallel and nothing carries over between them, so the
// tree is level-synchronous: one launch of tree_level a level, over all
// windows, in which thread k adds nodes 2k and 2k+1 of the level below.
// Every launched thread adds, with K1's registers and no barrier or shared
// memory; all levels go out from one host call (reef_tree_levels), since
// the MSM chunk around them is bound by its host's launches.  (A shared-
// memory block that halves its adding threads each level, the earlier
// design, keeps ~25% of them busy; sub-trees a thread keep a point live
// across adds and spill; one cooperative launch for the levels above the
// first, with a grid barrier between levels, is slower than the
// launches: PERF.md has the measurements.)
//
// Bound on this card: integer multiply-adds, as for K1 (padd.cu), on the
// bottom levels; each level narrower than the card (the top ~9 at
// cap 16384, W = 32) costs one complete add's latency, ~14 dependent
// Montgomery products.
#include "ec.cuh"

__device__ __forceinline__ size_t level_off(int cap, int b) {
    return (size_t)(cap - (cap >> (b - 1)));
}

// Level lvl of every window: node k from nodes 2k and 2k+1 of level lvl-1
// (the gathered affine points in `src` when AFFINE_IN).
template <int F, bool AFFINE_IN>
__global__ void __launch_bounds__(128)
tree_level(const u32* __restrict__ src, u32* out, int W, int cap, int lvl) {
    const int shift = __ffs(cap) - 1 - lvl;      // log2(nodes a window)
    const size_t g = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (g >= ((size_t)W << shift)) return;
    const size_t row = (size_t)W * cap;          // limb-row stride
    const size_t base = (g >> shift) * cap, k = g & ((1u << shift) - 1);
    point r;
    if constexpr (AFFINE_IN) {
        const size_t i0 = base + 2 * k;
        r = padd_affine<F>(load_fe(src, row, 0, i0), load_fe(src, row, 1, i0),
                           load_fe(src, row, 0, i0 + 1),
                           load_fe(src, row, 1, i0 + 1));
    } else {
        const size_t i0 = base + level_off(cap, lvl - 1) + 2 * k;
        r = padd<F>(load_point(out, row, i0), load_point(out, row, i0 + 1));
    }
    store_point(out, row, base + level_off(cap, lvl) + k, r);
}

template <int F>
static void launch_levels(const u32* in, u32* o, int W, int cap, int lo,
                          int hi, cudaStream_t s) {
    for (int lvl = lo; lvl <= hi; ++lvl) {
        const size_t threads = (size_t)W * (cap >> lvl);
        const unsigned blocks = (unsigned)((threads + 127) / 128);
        if (lvl == 1)
            tree_level<F, true><<<blocks, 128, 0, s>>>(in, o, W, cap, 1);
        else
            tree_level<F, false><<<blocks, 128, 0, s>>>(in, o, W, cap, lvl);
    }
}

// Levels lo .. hi (1 <= lo <= hi <= log2 cap) of every window, one launch
// a level, in order: level 1 reads the gathered affine points from `src`,
// a level above reads the level below it from `out` itself.
extern "C" int reef_tree_levels(const void* src, void* out, int W, int cap,
                                int lo, int hi, int field, void* stream) {
    if (W < 1 || cap < 2 || (cap & (cap - 1)) || lo < 1 || hi < lo ||
        (cap >> hi) < 1 || field < 0 || field > 1)
        return (int)cudaErrorInvalidValue;
    if (field == 0)
        launch_levels<0>((const u32*)src, (u32*)out, W, cap, lo, hi,
                         (cudaStream_t)stream);
    else
        launch_levels<1>((const u32*)src, (u32*)out, W, cap, lo, hi,
                         (cudaStream_t)stream);
    return (int)cudaGetLastError();
}
