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
//      counter). A CTA holds one ray block, split threads per ray (4 at
//      b = 128), each testing 128 / split lanes of every cluster. Each
//      cluster's rows are copied with cp.async into shared memory,
//      triangle-major (one triangle's rows in 20 floats: three 16-byte
//      broadcast loads per test; 20 and not 16 so the transposing 4-byte
//      copies meet 4-way and not 16-way bank conflicts), double-buffered so
//      cluster k+1 loads while cluster k is tested. Each thread keeps its
//      minimum key with a strict < over the unit's ascending clusters; the
//      split threads of a ray take the minimum of their pack_best values,
//      and a hit below the ray's initial key is merged into its best with
//      a 64-bit atomicMin (common.cuh: least key, then lowest cluster, the
//      order of the scan's strict <, so any unit order gives the same bits);
//   4. emit: t and prim from each best; rays never merged are misses.
//
// With any_hit a CTA reads its rays' best before a unit and skips the unit
// when every ray already has a hit, and stops the unit once all have one:
// only prim >= 0 is defined then, as in the reference's any-hit launch.
// Steps at or past the live prefix list no unit and come out as misses.
// With a run_if flag (the item route's overflow flag, read from device
// memory) every pass exits at once when the flag is clear and nothing is
// written.
#include "common.cuh"

namespace {

constexpr int kHead = 4;        // list head: heavy, light, next, pad
constexpr int kHeavy = 16;      // clusters that make a unit heavy
constexpr int kStride = 20;     // floats per staged triangle
constexpr int kMaxThreads = 1024;
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

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s),
                 "l"(gmem)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Copy cluster c's rows [kRows, 128] into dst triangle-major [128, kStride].
template <int kRows>
__device__ __forceinline__ void stage(float* dst, const float* tri, int c) {
    const float* src = tri + (long long)c * RT_KCOMP * RT_KTRI;
    for (int e = threadIdx.x; e < kRows * RT_KTRI; e += blockDim.x)
        cp_async4(dst + (e & (RT_KTRI - 1)) * kStride + (e >> 7), src + e);
    cp_async_commit();
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

template <bool BW>
__global__ void __launch_bounds__(kMaxThreads) blocks_fold_kernel(
    const int32_t* __restrict__ masks,  // [n_blocks, n_words]
    const float* __restrict__ soat,     // [n_steps * sb, 8]
    const float* __restrict__ tri,      // [n_clusters, 16, 128]
    const uint8_t* __restrict__ run_if, // [] or null: exit when clear
    int32_t* __restrict__ head,         // [kHead] list counters
    const int32_t* __restrict__ units,  // [n_blocks * n_words] word ids
    long long* __restrict__ best,       // [n_steps * sb]
    int total, int n_words, int n_clusters, int b, float tmin,
    int any_hit) {
    constexpr int kRows = BW ? 12 : 9;
    __shared__ __align__(16) float tri_s[2][RT_KTRI * kStride];
    __shared__ long long red[kMaxThreads];
    __shared__ uint8_t ray_hit[kMaxThreads];
    __shared__ int s_unit;
    if (gated_off(run_if)) return;
    const int n_heavy = head[0];
    const int n_units = head[0] + head[1];
    const int split = blockDim.x / b;
    const int q = threadIdx.x / b;  // which lanes of each cluster
    const int ray = threadIdx.x - q * b;
    const int lanes = RT_KTRI / split;
    const int j0 = q * lanes;
    const unsigned warp_mask =
        blockDim.x >= 32 ? kFull : (kFull >> (32 - blockDim.x));

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
        uint32_t bits = word_bits(masks, idx, w, n_clusters);
        const long long g = (long long)blk * b + ray;
        const float4* r4 = (const float4*)(soat + g * 8);
        const float4 ra = r4[0], rb = r4[1];
        const float ox = ra.x, oy = ra.y, oz = ra.z;
        const float dx = ra.w, dy = rb.x, dz = rb.y;
        // clamp: an inf tmax would pack to NaN bits
        int32_t kb = pack_key(nan_min(rb.z, 3e38f), RT_KTRI - 1);
        int32_t cb = -1;
        bool done = false;
        if (any_hit) {
            // bests merged by other CTAs: read through L2
            if (q == 0) ray_hit[ray] = __ldcg(best + g) != LLONG_MAX;
            __syncthreads();
            done = ray_hit[ray] != 0;
            if (__syncthreads_and(done)) continue;
        }

        int c = w * 32 + __ffs(bits) - 1;
        bits &= bits - 1;
        stage<kRows>(tri_s[0], tri, c);
        for (int k = 0;; ++k) {
            const bool more = bits != 0;
            const int next = more ? w * 32 + __ffs(bits) - 1 : -1;
            if (more) {
                bits &= bits - 1;
                stage<kRows>(tri_s[(k + 1) & 1], tri, next);
                cp_async_wait<1>();
            } else {
                cp_async_wait<0>();
            }
            __syncthreads();
            if (!(any_hit && __all_sync(warp_mask, done))) {
                const float4* s4 = (const float4*)tri_s[k & 1];
#pragma unroll 2
                for (int j = j0; j < j0 + lanes; ++j) {
                    const float4 a = s4[j * (kStride / 4) + 0];
                    const float4 m = s4[j * (kStride / 4) + 1];
                    const float4 z = s4[j * (kStride / 4) + 2];
                    const float r[12] = {a.x, a.y, a.z, a.w, m.x, m.y,
                                         m.z, m.w, z.x, z.y, z.z, z.w};
                    const int32_t key =
                        BW ? key_bw(r, j, ox, oy, oz, dx, dy, dz, tmin)
                           : key_vpu(r, j, ox, oy, oz, dx, dy, dz, tmin);
                    if (key < kb) {
                        kb = key;
                        cb = c;
                    }
                }
            }
            // the buffer just read is refilled by the next step's copy
            if (any_hit) {
                if (cb >= 0) ray_hit[ray] = 1;
                __syncthreads();
                done = ray_hit[ray] != 0;
                if (__syncthreads_and(done)) break;
            } else {
                __syncthreads();
            }
            if (!more) break;
            c = next;
        }
        cp_async_wait<0>();  // an any-hit stop may leave a copy in flight

        if (split > 1) {
            red[threadIdx.x] = cb >= 0 ? pack_best(kb, cb) : LLONG_MAX;
            __syncthreads();
            if (q == 0) {
                long long m = red[ray];
                for (int s = 1; s < split; ++s) m = min(m, red[s * b + ray]);
                if (m != LLONG_MAX) atomicMin(best + g, m);
            }
        } else if (cb >= 0) {
            atomicMin(best + g, pack_best(kb, cb));
        }
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

// Resident fold CTAs per SM, per mode and thread count (log2 index).
int resident_ctas(bool bw, int threads) {
    static int cache[2][11] = {};
    int lg = 0;
    while ((1 << lg) < threads) ++lg;
    int& v = cache[bw][lg];
    if (v == 0) {
        int n = 0;
        if (bw)
            cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &n, blocks_fold_kernel<true>, threads, 0);
        else
            cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &n, blocks_fold_kernel<false>, threads, 0);
        v = n > 0 ? n : 1;
    }
    return v;
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
        const int split = b >= 512 ? 1 : (b == 256 ? 2 : 4);
        const int fold_threads = b * split;
        int dev = 0, n_sm = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
        long long grid = (long long)n_sm * resident_ctas(bw, fold_threads);
        if (grid > total) grid = total;
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
