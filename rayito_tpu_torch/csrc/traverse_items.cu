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
// What bounds it on the H100: the triangle arithmetic, 128 x 128 tests of
// 31 (bw) or 46 (vpu) flops per item, one instruction each under
// -fmad=false, ~45-50 issued instructions per test with the IEEE division;
// the cluster tables sit in the 50 MB L2. The issue rate is the floor, so
// the design keeps every SM issuing tests until the list ends and spends
// little else per item:
//
//   1. init: every ray's best = LLONG_MAX, the group counter = 0;
//   2. fold: a resident grid of b * split-thread CTAs (the occupancy the
//      card allows) takes chunks of consecutive item groups through an
//      atomic counter, up to the group count read from device memory
//      (never from the host). Chunks are guided: at most 32 items, and
//      the groups left over 4 x the grid, so the launch starts on long
//      chunks (few hand-offs, runs kept whole) and ends on one-group ones
//      (no CTA holds the end of the launch: fixed 32-item chunks lost ~8%
//      on an H100 to that tail on big-scene camera rays). One warp reads
//      a chunk's items and drops the pads (an item equal to the one before
//      it: a run repeats its last cluster to the w-alignment) before any
//      row is copied; the CTA asks for its next chunk while it folds this
//      one. The items stream through the fold shared with traverse_blocks
//      (fold.cuh): split threads per ray, each cluster's rows staged
//      triangle-major by double-buffered cp.async while the one before is
//      tested, across chunk and ray-block boundaries, a strict < per
//      thread. The list is block-major and w-aligned, so a chunk holds
//      the tail of one block's run, whole runs and the head of another;
//      the fold merges its rays' bests (min over split threads, one
//      atomicMin per ray) whenever the ray block changes and at the end.
//      Equal keys go to the lowest cluster, as in the scan, so the result
//      equals traverse_blocks' bit for bit whatever the order of chunks;
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
constexpr int kSpread = 4;       // guided chunks: groups left / (4 x grid)

__global__ void items_init_kernel(long long* __restrict__ best,
                                  int32_t* __restrict__ counter, int n) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i == 0) *counter = 0;
    if (i < n) best[i] = LLONG_MAX;
}

// The CTA's items, chunk after chunk, as (ray block, cluster). A chunk is
// a run of consecutive groups taken with one atomicAdd on the group
// counter; its size shrinks with the groups left (guided: the groups left
// over kSpread times the grid, at least 1 and at most kChunkItems / w), so
// the launch starts on long chunks and ends on one-group ones. next() is
// called by every thread at the same point; taking a chunk costs two
// barriers, and the CTA's next chunk is asked for while this one is
// folded.
struct ItemStream {
    static constexpr bool kOneBlock = false;
    const int32_t* items;
    int32_t* counter;  // groups handed out
    int32_t* s_items;  // [kChunkItems] the chunk's live items, pads dropped
    int* s_g;          // [2] the chunk taken: groups [s_g[0], s_g[1])
    int* s_n;          // its live item count
    int n_blocks, w, per, n_groups, spread;
    int next_g, next_len;  // thread 0: the CTA's next chunk
    int k, n;

    __device__ __forceinline__ void ask(int g_seen) {
        next_len = min(max((n_groups - g_seen) / spread, 1), per);
        next_g = atomicAdd(counter, next_len);
    }

    __device__ bool take() {
        for (;;) {
            if (threadIdx.x == 0) {
                s_g[0] = next_g;
                s_g[1] = min(next_g + next_len, n_groups);
            }
            __syncthreads();
            const int g0 = s_g[0], g1 = s_g[1];
            if (g0 >= n_groups) return false;
            if (threadIdx.x < 32) {
                const long long i = (long long)g0 * w + threadIdx.x;
                bool keep = false;
                int32_t v = -1;
                if (i < (long long)g1 * w) {
                    v = items[i];
                    const int bid = v >> kCidBits;
                    // a pad repeats the item before it
                    keep = bid >= 0 && bid < n_blocks &&
                           (i == 0 || v != items[i - 1]);
                }
                const unsigned m = __ballot_sync(0xffffffffu, keep);
                if (keep) s_items[__popc(m & ((1u << threadIdx.x) - 1u))] = v;
                if (threadIdx.x == 0) *s_n = __popc(m);
            }
            __syncthreads();
            if (threadIdx.x == 0) ask(g0);
            n = *s_n;
            k = 0;
            if (n > 0) return true;
        }
    }

    __device__ __forceinline__ bool next(int& b, int& c) {
        if (k >= n && !take()) return false;
        const int32_t it = s_items[k++];
        b = it >> kCidBits;
        c = it & kCidMask;
        return true;
    }
};

template <bool BW>
__global__ void __launch_bounds__(RT_FOLD_MAX_THREADS) items_fold_kernel(
    const int32_t* __restrict__ items,    // [maxitems + w] bid << 13 | cid
    const int32_t* __restrict__ n_steps,  // [] item groups to run
    const float* __restrict__ soab,       // [n_blocks, b, 8]
    const float* __restrict__ tri,        // [n_clusters, 16, 128]
    const uint8_t* __restrict__ skip,     // [] or null: exit when set
    int32_t* __restrict__ counter,        // [] groups handed out
    long long* __restrict__ best,         // [n_blocks * b]
    int n_blocks, int b, int n_clusters, int max_groups, int w,
    float tmin) {
    __shared__ FoldShared sm;
    __shared__ int32_t s_items[kChunkItems];
    __shared__ int s_g[2], s_n;
    if (skip != nullptr && *skip) return;
    const int n_groups = min(max(*n_steps, 0), max_groups);
    ItemStream it{items, counter, s_items, s_g, &s_n, n_blocks, w,
                  kChunkItems / w, n_groups, kSpread * (int)gridDim.x,
                  0, 0, 0, 0};
    if (threadIdx.x == 0) it.ask(0);
    fold_clusters<BW, true>(it, sm, soab, tri, best, b, n_clusters, tmin,
                            false);
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
                                 const uint8_t* skip, long long* best,
                                 int32_t* counter, float* t_out,
                                 int32_t* p_out, int n_blocks, int b,
                                 int n_clusters, int max_groups, int w,
                                 float tmin, int bw, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    const int n = n_blocks * b;
    const int threads = 256;
    const int blocks = (n + threads - 1) / threads;
    if (n == 0) return (int)cudaGetLastError();
    items_init_kernel<<<blocks, threads, 0, s>>>(best, counter, n);
    static int cache[2][11] = {};
    const int fold_threads = b * fold_split(b);
    const long long grid =
        bw ? fold_grid(items_fold_kernel<true>, fold_threads, cache[1],
                       max_groups)
           : fold_grid(items_fold_kernel<false>, fold_threads, cache[0],
                       max_groups);
    if (grid > 0) {
        if (bw)
            items_fold_kernel<true><<<(int)grid, fold_threads, 0, s>>>(
                items, n_steps, soab, tri, skip, counter, best, n_blocks, b,
                n_clusters, max_groups, w, tmin);
        else
            items_fold_kernel<false><<<(int)grid, fold_threads, 0, s>>>(
                items, n_steps, soab, tri, skip, counter, best, n_blocks, b,
                n_clusters, max_groups, w, tmin);
    }
    items_emit_kernel<<<blocks, threads, 0, s>>>(best, t_out, p_out, n);
    return (int)cudaGetLastError();
}
