// traverse_items: nearest triangle hit per ray over a global list of
// (ray block, cluster) items.
//
// Replaces the TPU kernel _items_kernel (rayito_tpu/render/
// pallas_traverse.py, launched by _traverse_items). There the item list
// was the kernel grid: the grid ran in order on one core, each step folded
// ITEMS_W items of one ray block into a [B, 128] running best carried in
// scratch from the block's first step to its last. CUDA blocks run
// concurrently and in no order, so nothing is carried between them here:
// each ray's best is a 64-bit word merged with atomicMin (common.cuh).
//
// What bounds it on the H100: the triangle arithmetic, 32 x 32 tests of
// 31 (bw) or 46 (vpu) flops per slice a warp runs, one instruction each
// under -fmad=false, ~45-50 issued instructions per test with the IEEE
// division;
// the cluster tables sit in the 50 MB L2. The issue rate is the floor, so
// the design keeps every SM issuing tests until the list ends and spends
// little else per item:
//
//   1. init: every ray's best = LLONG_MAX, the group counter = 0;
//   2. fold: a resident grid of CTAs (the occupancy the card allows)
//      whose warps take fold units through an atomic counter: a unit is
//      a chunk of consecutive item groups (at most 32 items), one 32-ray
//      group and one slice, up to the group count read from device
//      memory (never from the host). The warp reads its chunk's items
//      (one a lane) and drops the pads (an item equal to the one before
//      it: a run repeats its last cluster to the w-alignment), then walks
//      them through the fold shared with traverse_blocks (fold.cuh: the
//      slice's rows read when one of the warp's rays hits its box, a
//      strict < per lane). The list is block-major and w-aligned, so a
//      chunk holds the tail of one block's run, whole runs and the head of
//      another; the warp merges its rays' bests (one atomicMin per ray)
//      whenever the ray block changes and at the end. Equal keys go to the
//      lowest cluster, as in the scan, so the result equals
//      traverse_blocks' bit for bit whatever the order of units;
//   3. emit: t and prim from each best; rays never reached are misses.
//
// A set skip flag (the launch's overflow flag, read from device memory)
// makes the fold exit at once; the emit then writes misses. A NaN tmax
// keeps its own bits in the initial key, as the plain version's clamp_max
// does.
#include "fold.cuh"

namespace {

constexpr int kCidBits = 13;
constexpr int kCidMask = (1 << kCidBits) - 1;
constexpr int kChunkItems = 32;  // items per chunk, at most
constexpr unsigned kFull = 0xffffffffu;

__global__ void items_init_kernel(long long* __restrict__ best,
                                  int32_t* __restrict__ counter, int n) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i == 0) *counter = 0;
    if (i < n) best[i] = LLONG_MAX;
}

template <bool BW>
__global__ void __launch_bounds__(RT_FOLD_WARPS * 32) items_fold_kernel(
    const int32_t* __restrict__ items,    // [maxitems + w] bid << 13 | cid
    const int32_t* __restrict__ n_steps,  // [] item groups to run
    const float* __restrict__ soab,       // [n_blocks, b, 8]
    const float* __restrict__ tri,        // [n_clusters, 16, 128]
    const float* __restrict__ slices,     // [n_clusters, 4, 8]
    const uint8_t* __restrict__ skip,     // [] or null: exit when set
    int32_t* __restrict__ counter,        // [] units handed out
    long long* __restrict__ best,         // [n_blocks * b]
    unsigned long long* __restrict__ runs_out,  // [] or null
    int n_blocks, int b, int n_clusters, int max_groups, int w,
    float tmin) {
    __shared__ FoldStage stage[RT_FOLD_WARPS];
    __shared__ unsigned s_runs;
    if (skip != nullptr && *skip) return;
    const int lane = threadIdx.x & 31;
    FoldStage& st = stage[threadIdx.x >> 5];
    const int n_groups = min(max(*n_steps, 0), max_groups);
    const int per = kChunkItems / w;  // groups a chunk
    const int n_chunks = (n_groups + per - 1) / per;
    const int groups = b > 32 ? b / 32 : 1;
    const int per_chunk = groups * RT_SLICES;
    unsigned runs = 0;
    for (;;) {
        int t = 0;
        if (lane == 0) t = atomicAdd(counter, 1);
        t = __shfl_sync(kFull, t, 0);
        const int k = t / per_chunk;
        if (k >= n_chunks) break;
        const int grp = (t - k * per_chunk) / RT_SLICES;
        const int s = t - k * per_chunk - grp * RT_SLICES;
        const long long i = (long long)k * per * w + lane;
        int32_t v = -1;
        bool keep = false;
        if (i < (long long)min(k * per + per, n_groups) * w) {
            v = items[i];
            const int bid = v >> kCidBits;
            // a pad repeats the item before it
            keep = bid >= 0 && bid < n_blocks &&
                   (i == 0 || v != items[i - 1]);
        }
        const int ray = grp * 32 + lane;
        const bool valid = ray < b;
        int cur = -1;
        long long g = 0;
        FoldRay<BW> f;
        for (unsigned m = __ballot_sync(kFull, keep); m != 0; m &= m - 1) {
            const int32_t it = __shfl_sync(kFull, v, __ffs(m) - 1);
            const int bid = it >> kCidBits;
            if (bid != cur) {
                if (cur >= 0 && valid) f.merge(best, g);
                cur = bid;
                g = (long long)bid * b + ray;
                f.template start<true>(soab, g, valid, tmin);
            }
            f.cluster(tri, slices, st, it & kCidMask, s, n_clusters, tmin,
                      runs);
        }
        if (cur >= 0 && valid) f.merge(best, g);
    }
    fold_count(runs_out, runs, s_runs);
}

__global__ void items_emit_kernel(const long long* __restrict__ best,
                                  float* __restrict__ t_out,
                                  int32_t* __restrict__ p_out, int n) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) emit_best(best[i], t_out + i, p_out + i);
}

}  // namespace

// best: [n_blocks * b] int64 scratch; counter: one int32 of scratch.
extern "C" int rt_traverse_items(const int32_t* items, const int32_t* n_steps,
                                 const float* soab, const float* tri,
                                 const float* slices, const uint8_t* skip,
                                 long long* best, int32_t* counter,
                                 float* t_out, int32_t* p_out,
                                 long long* runs, int n_blocks, int b,
                                 int n_clusters, int max_groups, int w,
                                 float tmin, int bw, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    const int n = n_blocks * b;
    const int threads = 256;
    const int blocks = (n + threads - 1) / threads;
    if (n == 0) return (int)cudaGetLastError();
    items_init_kernel<<<blocks, threads, 0, s>>>(best, counter, n);
    static int cache[2] = {};
    const long long tickets =
        ((long long)max_groups * w / kChunkItems + 1) *
        (b > 32 ? b / 32 : 1) * RT_SLICES;
    const long long cap = (tickets + RT_FOLD_WARPS - 1) / RT_FOLD_WARPS;
    const long long grid =
        bw ? fold_grid(items_fold_kernel<true>, cache[1], cap)
           : fold_grid(items_fold_kernel<false>, cache[0], cap);
    if (grid > 0) {
        if (bw)
            items_fold_kernel<true><<<(int)grid, RT_FOLD_WARPS * 32, 0, s>>>(
                items, n_steps, soab, tri, slices, skip, counter, best,
                (unsigned long long*)runs, n_blocks, b, n_clusters,
                max_groups, w, tmin);
        else
            items_fold_kernel<false><<<(int)grid, RT_FOLD_WARPS * 32, 0,
                                       s>>>(
                items, n_steps, soab, tri, slices, skip, counter, best,
                (unsigned long long*)runs, n_blocks, b, n_clusters,
                max_groups, w, tmin);
    }
    items_emit_kernel<<<blocks, threads, 0, s>>>(best, t_out, p_out, n);
    return (int)cudaGetLastError();
}
