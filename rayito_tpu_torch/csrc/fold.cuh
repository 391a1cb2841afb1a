// The cluster fold shared by traverse_blocks and traverse_items.
//
// A CTA of b * split threads holds one ray block at a time, split threads
// per ray (4 at b = 128), each testing 128 / split lanes of every cluster.
// It walks a sequence of (ray block, cluster) entries, each ray block's
// clusters ascending. Each cluster's rows are copied with 4-byte cp.async
// into shared memory, triangle-major (one triangle's rows in 20 floats:
// three 16-byte broadcast loads per test; 20 and not 16 so the
// transposing copies meet 4-way and not 16-way bank conflicts),
// double-buffered so the next entry's cluster loads while this one is
// tested, across a change of ray block too. Each thread keeps its minimum
// key with a strict < over the ascending clusters. When the ray block
// changes, and at the end, the split threads of a ray take the minimum of
// their pack_best values in shared memory and a hit below the ray's
// initial key is merged into its best with one 64-bit atomicMin
// (common.cuh: least key, then lowest cluster, the order of the strict <,
// so any order of sequences gives the same bits).
#pragma once

#include "common.cuh"

#define RT_FOLD_STRIDE 20         // floats per staged triangle
#define RT_FOLD_MAX_THREADS 1024

struct __align__(16) FoldShared {
    float tri[2][RT_KTRI * RT_FOLD_STRIDE];
    long long red[RT_FOLD_MAX_THREADS];
    uint8_t ray_hit[RT_FOLD_MAX_THREADS];  // any-hit: the ray has a hit
};

// Threads per ray for ray blocks of b: the CTA holds at least one warp.
inline int fold_split(int b) {
    if (b >= 512) return 1;
    if (b == 256) return 2;
    return b >= 8 ? 4 : 32 / b;
}

// Resident CTAs of `kernel` at `threads` on the whole card, at most `cap`;
// `cache` holds the per-SM count per log2 thread count.
template <class Kernel>
long long fold_grid(Kernel kernel, int threads, int (&cache)[11],
                    long long cap) {
    int lg = 0;
    while ((1 << lg) < threads) ++lg;
    if (cache[lg] == 0) {
        int n = 0;
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, 0);
        cache[lg] = n > 0 ? n : 1;
    }
    int dev = 0, n_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    const long long grid = (long long)n_sm * cache[lg];
    return grid < cap ? grid : cap;
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s),
                 "l"(gmem)
                 : "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Copy cluster c's rows [kRows, 128] into dst triangle-major [128, 20].
template <int kRows>
__device__ __forceinline__ void fold_stage(float* dst, const float* tri,
                                           int c) {
    const float* src = tri + (long long)c * RT_KCOMP * RT_KTRI;
    for (int e = threadIdx.x; e < kRows * RT_KTRI; e += blockDim.x)
        cp_async4(dst + (e & (RT_KTRI - 1)) * RT_FOLD_STRIDE + (e >> 7),
                  src + e);
    asm volatile("cp.async.commit_group;" ::: "memory");
}

// Merge the CTA's bests of ray g (split threads per ray) into best[g].
__device__ __forceinline__ void fold_flush(FoldShared& sm, long long* best,
                                           long long g, int32_t kb,
                                           int32_t cb, int q, int ray,
                                           int split, int b) {
    if (split > 1) {
        sm.red[threadIdx.x] = cb >= 0 ? pack_best(kb, cb) : LLONG_MAX;
        __syncthreads();
        if (q == 0) {
            long long m = sm.red[ray];
            for (int s = 1; s < split; ++s) m = min(m, sm.red[s * b + ray]);
            if (m != LLONG_MAX) atomicMin(best + g, m);
        }
    } else if (cb >= 0) {
        atomicMin(best + g, pack_best(kb, cb));
    }
}

// Fold the entries that it.next(blk, cid) yields (false at the end) into
// best[blk * b + ray]; It::kOneBlock says that they all share one ray
// block. rays: [n_blocks * b, 8] (o, d, tmax, pad), 16-byte
// aligned; tri: [n_clusters, 16, 128], cluster ids past it read its last
// cluster (the result still names the id given). The initial key is
// pack(min(tmax, 3e38), 127); kKeepNaN keeps a NaN tmax's own bits in it,
// else min.NaN gives the canonical NaN. With any_hit the sequence holds
// one ray block, sm.ray_hit holds its rays' hits on entry, warps whose
// rays all have a hit skip their tests, and the fold stops once every ray
// has one. Every branch depends only on the sequence (or on a CTA-wide
// vote), so all threads reach each barrier.
template <bool BW, bool kKeepNaN, class It>
__device__ __forceinline__ void fold_clusters(It& it, FoldShared& sm,
                                              const float* __restrict__ rays,
                                              const float* __restrict__ tri,
                                              long long* __restrict__ best,
                                              int b, int n_clusters,
                                              float tmin, bool any_hit) {
    constexpr int kRows = BW ? 12 : 9;
    const int split = blockDim.x / b;
    const int q = threadIdx.x / b;  // which lanes of each cluster
    const int ray = threadIdx.x - q * b;
    const int lanes = RT_KTRI / split;
    const int j0 = q * lanes;
    int blk, c;
    if (!it.next(blk, c)) return;
    int cur = -1;
    long long g = 0;
    float4 ra = {}, rb = {};
    float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
    int32_t kb = 0, cb = -1;
    bool done = false;
    // a ray block's rays: load() issues the loads, start() decodes them
    // into the ray and its initial key where they are first needed
    auto load = [&](int blk_) {
        cur = blk_;
        g = (long long)blk_ * b + ray;
        const float4* r4 = (const float4*)(rays + g * 8);
        ra = r4[0];
        rb = r4[1];
    };
    auto start = [&]() {
        ox = ra.x, oy = ra.y, oz = ra.z;
        dx = ra.w, dy = rb.x, dz = rb.y;
        // clamp: an inf tmax would pack to NaN bits
        const float tm = rb.z;
        kb = pack_key(kKeepNaN && tm != tm ? tm : nan_min(tm, 3e38f),
                      RT_KTRI - 1);
        cb = -1;
        done = any_hit && sm.ray_hit[ray] != 0;
    };
    if (It::kOneBlock) {
        load(blk);
        start();
    }
    fold_stage<kRows>(sm.tri[0], tri, min(c, n_clusters - 1));
    for (int k = 0;; ++k) {
        int nblk, nc;
        const bool more = it.next(nblk, nc);
        if (more)
            fold_stage<kRows>(sm.tri[(k + 1) & 1], tri,
                              min(nc, n_clusters - 1));
        // a new ray block: merge the last one's bests, and load its rays
        // while the cluster's copy lands
        const bool fresh = !It::kOneBlock && blk != cur;
        if (fresh) {
            if (cur >= 0) fold_flush(sm, best, g, kb, cb, q, ray, split, b);
            load(blk);
        }
        if (more)
            cp_async_wait<1>();
        else
            cp_async_wait<0>();
        __syncthreads();
        if (fresh) start();
        if (!(any_hit && __all_sync(0xffffffffu, done))) {
            const float4* s4 = (const float4*)sm.tri[k & 1];
#pragma unroll 2
            for (int j = j0; j < j0 + lanes; ++j) {
                const float4 a = s4[j * (RT_FOLD_STRIDE / 4) + 0];
                const float4 m = s4[j * (RT_FOLD_STRIDE / 4) + 1];
                const float4 z = s4[j * (RT_FOLD_STRIDE / 4) + 2];
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
            if (cb >= 0) sm.ray_hit[ray] = 1;
            __syncthreads();
            done = sm.ray_hit[ray] != 0;
            if (__syncthreads_and(done)) break;
        } else {
            __syncthreads();
        }
        if (!more) break;
        blk = nblk;
        c = nc;
    }
    cp_async_wait<0>();  // an any-hit stop may leave a copy in flight
    fold_flush(sm, best, g, kb, cb, q, ray, split, b);
}
