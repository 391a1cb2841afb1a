// traverse_items: nearest triangle hit per ray over a global list of
// (ray block, cluster) items.
//
// Replaces the TPU kernel _items_kernel (rayito_tpu/render/
// pallas_traverse.py, launched by _traverse_items). There the item list
// was the kernel grid: the grid ran in order on one core, each step folded
// ITEMS_W items of one ray block into a [B, 128] running best carried in
// scratch from the block's first step to its last. CUDA blocks run
// concurrently and in no order, so nothing is carried between them here.
//
// What bounds it on the H100: the triangle arithmetic, 128 tests of ~25-30
// flops per (ray, item), as in traverse_blocks; what the item list adds is
// balance. The scan gives each ray block one CUDA block, so a block whose
// rays see many clusters holds its SM while the rest idle; here the
// list's groups (w items of one ray block, the list is w-aligned per
// block) are split evenly over a fixed grid. Design, per CUDA block of b
// threads (one per ray): take a contiguous run of groups (the count is
// read from device memory; blocks past it exit); stage each group's w
// cluster blocks (9 or 12 rows x 128 floats) in shared memory; each thread
// folds its ray's keys with a strict < in item order (pads repeat the
// block's last cluster and are skipped: a repeat never wins a strict <);
// when the run moves to another ray block, and at its end, each thread
// that found a hit below its initial key merges ((int64)key << 32) | cid
// into the ray's 64-bit best with atomicMin. Lower cluster wins a key tie,
// as in the scan, so the result equals traverse_blocks' bit for bit. An
// emit pass decodes t and prim; rays never reached are misses.
//
// A set skip flag (the launch's overflow flag, read from device memory)
// makes the fold exit at once; the emit then writes misses.
#include "common.cuh"

namespace {

constexpr int kCidBits = 13;
constexpr int kCidMask = (1 << kCidBits) - 1;
constexpr int kMaxGrid = 2048;  // CUDA blocks sharing the item groups

__global__ void items_init_kernel(long long* __restrict__ best, int n) {
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += gridDim.x * blockDim.x)
        best[i] = LLONG_MAX;
}

template <bool BW>
__global__ void traverse_items_kernel(
    const int32_t* __restrict__ items,    // [maxitems + w] bid << 13 | cid
    const int32_t* __restrict__ n_steps,  // [] item groups to run
    const float* __restrict__ soab,       // [n_blocks, b, 8]
    const float* __restrict__ tri,        // [n_clusters, 16, 128]
    const uint8_t* __restrict__ skip,     // [] or null: exit when set
    long long* __restrict__ best,         // [n_blocks * b]
    int n_blocks, int n_clusters, int w, float tmin) {
    constexpr int kRows = BW ? 12 : 9;
    constexpr int kBlock = kRows * RT_KTRI;
    extern __shared__ float tri_s[];  // [w, kRows, 128]
    if (skip != nullptr && *skip) return;
    const int b = blockDim.x;
    const int n_groups = *n_steps;
    const int per = (n_groups + gridDim.x - 1) / gridDim.x;
    const int g0 = blockIdx.x * per;
    const int g1 = min(g0 + per, n_groups);

    // every branch below depends only on the item list, so it is uniform
    // across the block and every thread reaches each barrier
    int cur = -1;
    float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
    int32_t kb = 0, cb = -1;
    for (int g = g0; g < g1; ++g) {
        const int32_t* grp = items + (long long)g * w;
        const int bid = grp[0] >> kCidBits;
        if (bid < 0 || bid >= n_blocks) break;  // not a live item
        if (bid != cur) {
            if (cb >= 0)
                atomicMin(best + (long long)cur * b + threadIdx.x,
                          pack_best(kb, cb));
            cur = bid;
            const float* r = soab + ((long long)bid * b + threadIdx.x) * 8;
            ox = r[0], oy = r[1], oz = r[2];
            dx = r[3], dy = r[4], dz = r[5];
            // clamp: an inf tmax would pack to NaN bits; a NaN tmax keeps
            // its own bits, sign included, as torch.clamp_max does
            const float tm = r[6];
            kb = pack_key(tm != tm ? tm : nan_min(tm, 3e38f), RT_KTRI - 1);
            cb = -1;
        }
        for (int i = threadIdx.x; i < w * kBlock; i += b) {
            const int jj = i / kBlock;
            // the reference's index map clamps cluster ids to the table
            const int c = min(grp[jj] & kCidMask, n_clusters - 1);
            tri_s[i] =
                tri[(long long)c * RT_KCOMP * RT_KTRI + (i - jj * kBlock)];
        }
        __syncthreads();
        int prev = -1;
        for (int jj = 0; jj < w; ++jj) {
            const int cid = grp[jj] & kCidMask;
            if (cid == prev) continue;  // a pad: repeats the last cluster
            prev = cid;
            const float* s = tri_s + jj * kBlock;
            for (int j = 0; j < RT_KTRI; ++j) {
                float r[12];
#pragma unroll
                for (int k = 0; k < kRows; ++k) r[k] = s[k * RT_KTRI + j];
                const int32_t key =
                    BW ? key_bw(r, j, ox, oy, oz, dx, dy, dz, tmin)
                       : key_vpu(r, j, ox, oy, oz, dx, dy, dz, tmin);
                if (key < kb) {
                    kb = key;
                    cb = cid;
                }
            }
        }
        __syncthreads();
    }
    if (cb >= 0)
        atomicMin(best + (long long)cur * b + threadIdx.x, pack_best(kb, cb));
}

__global__ void items_emit_kernel(const long long* __restrict__ best,
                                  float* __restrict__ t_out,
                                  int32_t* __restrict__ p_out, int n) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) emit_best(best[i], t_out + i, p_out + i);
}

}  // namespace

extern "C" int rt_traverse_items(const int32_t* items, const int32_t* n_steps,
                                 const float* soab, const float* tri,
                                 const uint8_t* skip, long long* best,
                                 float* t_out, int32_t* p_out, int n_blocks,
                                 int b, int n_clusters, int max_groups, int w,
                                 float tmin, int bw, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    const int n = n_blocks * b;
    const int threads = 256;
    const int blocks = (n + threads - 1) / threads;
    if (n == 0) return (int)cudaGetLastError();
    items_init_kernel<<<blocks, threads, 0, s>>>(best, n);
    const int grid = max_groups < kMaxGrid ? max_groups : kMaxGrid;
    const size_t smem = (size_t)w * (bw ? 12 : 9) * RT_KTRI * sizeof(float);
    if (grid > 0) {
        if (bw)
            traverse_items_kernel<true><<<grid, b, smem, s>>>(
                items, n_steps, soab, tri, skip, best, n_blocks, n_clusters,
                w, tmin);
        else
            traverse_items_kernel<false><<<grid, b, smem, s>>>(
                items, n_steps, soab, tri, skip, best, n_blocks, n_clusters,
                w, tmin);
    }
    items_emit_kernel<<<blocks, threads, 0, s>>>(best, t_out, p_out, n);
    return (int)cudaGetLastError();
}
