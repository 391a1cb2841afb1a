// traverse_blocks: nearest (or any) triangle hit per ray over the clusters
// its ray block's mask lists.
//
// Replaces the TPU kernel _traverse_kernel (rayito_tpu/render/
// pallas_traverse.py, launched by _traverse_blocks) in its main-path
// configuration: prune off, no sub-blocks, modes 'bw' (Baldwin-Weber rows,
// closest-hit launches) and 'vpu' (exact Möller-Trumbore, occlusion
// launches). The TPU kernel's de Bruijn bit scan, SMEM worklist and WIDE=4
// lane-carried chains were TPU latency tricks and are not carried over.
//
// What bounds it on the H100: the triangle arithmetic, 128 tests of 31
// (bw) or 46 (vpu) flops per (ray, listed cluster), one instruction each
// under -fmad=false; the cluster tables sit in the 50 MB L2. The TPU grid
// walked a block's list serially, and one CUDA block per ray block does
// the same: a launch then lasts as long as its longest list (hundreds of
// clusters against a mean of 7-40) while most SMs idle. So the work is
// cut into units of (ray block, one nonzero 32-cluster mask word):
//
//   1. init: every ray's 64-bit best = LLONG_MAX, the unit counters = 0;
//   2. units: one thread per mask word appends the index of each nonzero
//      word of a live step to a list in device memory (warp-aggregated
//      atomics). Units listing 16 or more clusters fill the list from the
//      front, the rest from the back, so the long ones are taken first and
//      the launch does not end on one. A compaction pass, and not a grid
//      of n_blocks x n_words CTAs of which most would exit at once: the
//      list costs one small launch and the fold's grid stays the resident
//      size. The count stays on the device: no host sync, no budget, no
//      overflow path;
//   3. fold: a resident grid of CTAs takes units one by one (an atomic
//      counter) and folds each unit's clusters into its rays' bests with
//      the fold shared with traverse_items (fold.cuh: split threads per
//      ray, double-buffered cp.async staging, a strict < per thread, one
//      64-bit atomicMin per ray);
//   4. emit: t and prim from each best; rays never merged are misses.
//
// With any_hit a CTA reads its rays' best before a unit and skips the unit
// when every ray already has a hit, and stops the unit once all have one:
// only prim >= 0 is defined then, as in the reference's any-hit launch.
// Steps at or past the live prefix list no unit and come out as misses.
// With a run_if flag (the item route's overflow flag, read from device
// memory) every pass exits at once when the flag is clear and nothing is
// written.
#include "fold.cuh"

namespace {

constexpr int kHead = 4;        // list head: heavy, light, next, pad
constexpr int kHeavy = 16;      // clusters that make a unit heavy
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool gated_off(const uint8_t* run_if) {
    return run_if != nullptr && !*run_if;
}

// Mask bits of word w restricted to clusters below n_clusters (the box
// table's lane padding may list clusters the tri table lacks).
__device__ __forceinline__ uint32_t word_bits(const int32_t* masks,
                                              long long i, int w,
                                              int n_clusters) {
    uint32_t bits = (uint32_t)masks[i];
    const int over = w * 32 + 32 - n_clusters;
    if (over >= 32) return 0;
    return over > 0 ? bits & (kFull >> over) : bits;
}

__global__ void blocks_init_kernel(long long* __restrict__ best,
                                   int32_t* __restrict__ head,
                                   const uint8_t* __restrict__ run_if,
                                   int n) {
    if (gated_off(run_if)) return;
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < kHead) head[i] = 0;
    if (i < n) best[i] = LLONG_MAX;
}

__global__ void blocks_units_kernel(const int32_t* __restrict__ masks,
                                    const int32_t* __restrict__ n_live,
                                    const uint8_t* __restrict__ run_if,
                                    int32_t* __restrict__ head,
                                    int32_t* __restrict__ units,
                                    int n_blocks, int n_words,
                                    int n_clusters, int b, int sb,
                                    int n_steps) {
    if (gated_off(run_if)) return;
    const long long total = (long long)n_blocks * n_words;
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    uint32_t bits = 0;
    if (i < total) {
        const int blk = (int)(i / n_words);
        const int step = (int)(((long long)blk * b) / sb);
        if (step < live_steps(n_live, n_steps))
            bits = word_bits(masks, i, (int)(i - (long long)blk * n_words),
                             n_clusters);
    }
    const bool heavy = __popc(bits) >= kHeavy;
    const unsigned mh = __ballot_sync(kFull, bits != 0 && heavy);
    const unsigned ml = __ballot_sync(kFull, bits != 0 && !heavy);
    const int lane = threadIdx.x & 31;
    int base_h = 0, base_l = 0;
    if (lane == 0) {
        if (mh) base_h = atomicAdd(head + 0, __popc(mh));
        if (ml) base_l = atomicAdd(head + 1, __popc(ml));
    }
    base_h = __shfl_sync(kFull, base_h, 0);
    base_l = __shfl_sync(kFull, base_l, 0);
    const unsigned below = (1u << lane) - 1u;
    if (bits != 0) {
        if (heavy)
            units[base_h + __popc(mh & below)] = (int32_t)i;
        else
            units[total - 1 - (base_l + __popc(ml & below))] = (int32_t)i;
    }
}

// The mask word's set clusters, ascending, all of ray block blk.
struct WordClusters {
    static constexpr bool kOneBlock = true;
    uint32_t bits;
    int base, blk;
    __device__ __forceinline__ bool next(int& b, int& c) {
        if (bits == 0) return false;
        b = blk;
        c = base + __ffs(bits) - 1;
        bits &= bits - 1;
        return true;
    }
};

template <bool BW>
__global__ void __launch_bounds__(RT_FOLD_MAX_THREADS) blocks_fold_kernel(
    const int32_t* __restrict__ masks,  // [n_blocks, n_words]
    const float* __restrict__ soat,     // [n_steps * sb, 8]
    const float* __restrict__ tri,      // [n_clusters, 16, 128]
    const uint8_t* __restrict__ run_if, // [] or null: exit when clear
    int32_t* __restrict__ head,         // [kHead] list counters
    const int32_t* __restrict__ units,  // [n_blocks * n_words] word ids
    long long* __restrict__ best,       // [n_steps * sb]
    int total, int n_words, int n_clusters, int b, float tmin,
    int any_hit) {
    __shared__ FoldShared sm;
    __shared__ int s_unit;
    if (gated_off(run_if)) return;
    const int n_heavy = head[0];
    const int n_units = head[0] + head[1];
    const int ray = threadIdx.x % b;

    for (;;) {
        if (threadIdx.x == 0) s_unit = atomicAdd(head + 2, 1);
        __syncthreads();
        const int u = s_unit;
        __syncthreads();
        if (u >= n_units) break;
        const int idx = u < n_heavy ? units[u]
                                    : units[total - 1 - (u - n_heavy)];
        const int blk = idx / n_words;
        const int w = idx - blk * n_words;
        if (any_hit) {
            // bests merged by other CTAs: read through L2
            if (threadIdx.x < b)
                sm.ray_hit[ray] =
                    __ldcg(best + (long long)blk * b + ray) != LLONG_MAX;
            __syncthreads();
            if (__syncthreads_and(sm.ray_hit[ray] != 0)) continue;
        }
        WordClusters it{word_bits(masks, idx, w, n_clusters), w * 32, blk};
        fold_clusters<BW, false>(it, sm, soat, tri, best, b, n_clusters,
                                 tmin, any_hit != 0);
    }
}

__global__ void blocks_emit_kernel(const long long* __restrict__ best,
                                   const uint8_t* __restrict__ run_if,
                                   float* __restrict__ t_out,
                                   int32_t* __restrict__ p_out, int n) {
    if (gated_off(run_if)) return;
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) emit_best(best[i], t_out + i, p_out + i);
}

}  // namespace

// scratch: best [n_blocks * b] int64, then the unit list: kHead counters
// and n_blocks * n_words word ids.
extern "C" int rt_traverse_blocks(const int32_t* masks, const float* soat,
                                  const float* tri, const int32_t* n_live,
                                  const uint8_t* run_if, long long* best,
                                  int32_t* list, float* t_out,
                                  int32_t* p_out, int n_blocks, int b,
                                  int n_words, int n_clusters, int sb,
                                  int n_steps, float tmin, int bw,
                                  int any_hit, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    const int n = n_blocks * b;
    const int total = n_blocks * n_words;
    int32_t* head = list;
    int32_t* units = list + kHead;
    const int threads = 256;
    const int init_n = n > kHead ? n : kHead;
    blocks_init_kernel<<<(init_n + threads - 1) / threads, threads, 0, s>>>(
        best, head, run_if, n);
    if (total > 0) {
        blocks_units_kernel<<<(total + threads - 1) / threads, threads, 0,
                              s>>>(masks, n_live, run_if, head, units,
                                   n_blocks, n_words, n_clusters, b, sb,
                                   n_steps);
        static int cache[2][11] = {};
        const int fold_threads = b * fold_split(b);
        const long long grid =
            bw ? fold_grid(blocks_fold_kernel<true>, fold_threads, cache[1],
                           total)
               : fold_grid(blocks_fold_kernel<false>, fold_threads,
                           cache[0], total);
        if (bw)
            blocks_fold_kernel<true><<<(int)grid, fold_threads, 0, s>>>(
                masks, soat, tri, run_if, head, units, best, total,
                n_words, n_clusters, b, tmin, any_hit);
        else
            blocks_fold_kernel<false><<<(int)grid, fold_threads, 0, s>>>(
                masks, soat, tri, run_if, head, units, best, total,
                n_words, n_clusters, b, tmin, any_hit);
    }
    if (n > 0)
        blocks_emit_kernel<<<(n + threads - 1) / threads, threads, 0, s>>>(
            best, run_if, t_out, p_out, n);
    return (int)cudaGetLastError();
}
