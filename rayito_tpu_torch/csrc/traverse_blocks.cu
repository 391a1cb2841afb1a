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
// What bounds it on the H100: the triangle arithmetic, 32 tests of 31
// (bw) or 46 (vpu) flops per (ray, slice its warp runs), one instruction
// each under -fmad=false; the cluster tables sit in the 50 MB L2. The TPU grid
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
//   3. fold: a resident grid of CTAs whose warps take (unit, 32-ray
//      group, slice) tickets one by one (an atomic counter) and fold the
//      unit's clusters into their rays' bests with the fold shared with
//      traverse_items (fold.cuh: a slice's rows read only when one of the
//      warp's rays hits the slice's box, a strict < per lane, one 64-bit
//      atomicMin per ray; no warp waits on another);
//   4. emit: t and prim from each best; rays never merged are misses.
//
// With any_hit a warp re-reads its rays' bests before each cluster, merges
// a ray's first hit at once, and stops once every ray has one: only prim
// >= 0 is defined then, as in the reference's any-hit launch.
// Steps at or past the live prefix list no unit and come out as misses.
// With a run_if flag (the item route's overflow flag, read from device
// memory) every pass exits at once when the flag is clear and nothing is
// written. With a counter (slices, an int64 in device memory; null when
// tracing is off) the fold adds the slices its warps ran.
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

// A resident grid of CTAs of RT_FOLD_WARPS warps; each warp takes fold
// units one by one (an atomic counter): a unit is a work unit (ray block,
// mask word), one 32-ray group of the block and one slice, consecutive
// tickets taking the groups and slices of one word. The warp walks the
// word's clusters ascending. With any_hit the warp re-reads its rays'
// bests through L2 before each cluster, merges a hit at once, and stops
// once every ray has one.
template <bool BW>
__global__ void __launch_bounds__(RT_FOLD_WARPS * 32) blocks_fold_kernel(
    const int32_t* __restrict__ masks,  // [n_blocks, n_words]
    const float* __restrict__ soat,     // [n_steps * sb, 8]
    const float* __restrict__ tri,      // [n_clusters, 16, 128]
    const float* __restrict__ slices,   // [n_clusters, 4, 8]
    const uint8_t* __restrict__ run_if, // [] or null: exit when clear
    int32_t* __restrict__ head,         // [kHead] list counters
    const int32_t* __restrict__ units,  // [n_blocks * n_words] word ids
    long long* __restrict__ best,       // [n_steps * sb]
    unsigned long long* __restrict__ counter,  // [] or null
    int total, int n_words, int n_clusters, int b, float tmin,
    int any_hit) {
    __shared__ FoldStage stage[RT_FOLD_WARPS];
    __shared__ unsigned s_runs;
    if (gated_off(run_if)) return;
    const int lane = threadIdx.x & 31;
    FoldStage& st = stage[threadIdx.x >> 5];
    const int n_heavy = head[0];
    const int n_units = head[0] + head[1];
    const int groups = b > 32 ? b / 32 : 1;
    const int per_unit = groups * RT_SLICES;
    unsigned runs = 0;
    for (;;) {
        int t = 0;
        if (lane == 0) t = atomicAdd(head + 2, 1);
        t = __shfl_sync(kFull, t, 0);
        const int u = t / per_unit;
        if (u >= n_units) break;
        const int grp = (t - u * per_unit) / RT_SLICES;
        const int s = t - u * per_unit - grp * RT_SLICES;
        const int idx = u < n_heavy ? units[u]
                                    : units[total - 1 - (u - n_heavy)];
        const int blk = idx / n_words;
        const int w = idx - blk * n_words;
        const int ray = grp * 32 + lane;
        const bool valid = ray < b;
        const long long g = (long long)blk * b + ray;
        FoldRay<BW> f;
        f.template start<false>(soat, g, valid, tmin);
        uint32_t bits = word_bits(masks, idx, w, n_clusters);
        while (bits != 0) {
            if (any_hit) {
                // bests merged by other warps: read through L2
                f.live = f.live && __ldcg(best + g) == LLONG_MAX;
                if (!__any_sync(kFull, f.live)) break;
            }
            const int c = w * 32 + __ffs(bits) - 1;
            bits &= bits - 1;
            f.cluster(tri, slices, st, c, s, n_clusters, tmin, runs);
            if (any_hit && f.cb >= 0 && f.live) {
                f.merge(best, g);
                f.live = false;
            }
        }
        if (!any_hit && valid) f.merge(best, g);
    }
    fold_count(counter, runs, s_runs);
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
                                  const float* tri, const float* slices,
                                  const int32_t* n_live,
                                  const uint8_t* run_if, long long* best,
                                  int32_t* list, float* t_out,
                                  int32_t* p_out, long long* counter,
                                  int n_blocks, int b, int n_words,
                                  int n_clusters, int sb, int n_steps,
                                  float tmin, int bw, int any_hit,
                                  void* stream) {
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
        static int cache[2] = {};
        const long long tickets = (long long)total * (b > 32 ? b / 32 : 1) *
                                  RT_SLICES;
        const long long cap = (tickets + RT_FOLD_WARPS - 1) / RT_FOLD_WARPS;
        const long long grid =
            bw ? fold_grid(blocks_fold_kernel<true>, cache[1], cap)
               : fold_grid(blocks_fold_kernel<false>, cache[0], cap);
        if (bw)
            blocks_fold_kernel<true><<<(int)grid, RT_FOLD_WARPS * 32, 0, s>>>(
                masks, soat, tri, slices, run_if, head, units, best,
                (unsigned long long*)counter, total, n_words, n_clusters, b,
                tmin, any_hit);
        else
            blocks_fold_kernel<false><<<(int)grid, RT_FOLD_WARPS * 32, 0,
                                        s>>>(
                masks, soat, tri, slices, run_if, head, units, best,
                (unsigned long long*)counter, total, n_words, n_clusters, b,
                tmin, any_hit);
    }
    if (n > 0)
        blocks_emit_kernel<<<(n + threads - 1) / threads, threads, 0, s>>>(
            best, run_if, t_out, p_out, n);
    return (int)cudaGetLastError();
}
