// The mesh fold shared by traverse_blocks and traverse_items: one warp
// folds 32 rays (a 32-ray group of a ray block; fewer at b < 32) against
// one 32-lane slice of each cluster of a sequence, the clusters ascending.
//
// The slice cull. The mask lists a cluster for a whole 128-ray block, but
// a warp's rays reach few of its four slices. Before a slice's tests each
// lane slab-tests its ray against the slice's box (the slice table,
// accel/kernel_tables.py build_slice_boxes: the padded box of the slice's
// triangles) and the warp runs the 32 tests only when one of its rays
// hits the box (__any_sync), so every branch is warp-uniform. A ray that
// misses the box cannot take a key there: the table's pad and the ray's
// own (2^-16 |o| + 2 tmin |d| on every side) cover the slab's rounding, a
// key's placement of its hit and a self-hit at tmin; the slab's upper t
// is tmax widened by 2^-14 (a key's 128-ulp t bucket) on BW rows and none
// on MT rows (an MT key's t can err far on a grazing ray while the line
// still crosses the triangle inside its box). So the bests are the bits a
// fold of every listed test gives.
//
// Warps run alone. Each warp takes its own (sequence, ray group, slice)
// units; a live slice's rows are read coalesced (lane i: triangle i's
// rows) into the warp's own shared buffer, triangle-major in 12 floats
// (three 16-byte broadcast loads a test), and tested; nothing waits on
// another warp: with most slices skipped, a cluster staged for a whole
// CTA behind barriers would hold every warp for as long as its busiest
// one (measured: half the fall in tests lost). Each lane keeps its ray's
// least key with a strict < over the ascending clusters and merges a hit
// below the ray's initial key into its best with one 64-bit atomicMin
// (common.cuh: least key, then lowest cluster, the order of the strict <,
// so any order of units gives the same bits).
#pragma once

#include "common.cuh"

#define RT_SLICE 32               // lanes of a slice
#define RT_SLICES (RT_KTRI / RT_SLICE)
#define RT_FOLD_ROW 12            // floats per staged triangle
#define RT_FOLD_WARPS 8           // warps per CTA

constexpr unsigned kFoldFull = 0xffffffffu;

// A warp's staged slice: 32 triangles' rows, triangle-major.
struct __align__(16) FoldStage {
    float4 tri[RT_SLICE * RT_FOLD_ROW / 4];
};

// Resident CTAs of `kernel` at RT_FOLD_WARPS warps on the whole card, at
// most `cap`; `cache` holds the per-SM count.
template <class Kernel>
long long fold_grid(Kernel kernel, int& cache, long long cap) {
    if (cache == 0) {
        int n = 0;
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel,
                                                      RT_FOLD_WARPS * 32, 0);
        cache = n > 0 ? n : 1;
    }
    int dev = 0, n_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    const long long grid = (long long)n_sm * cache;
    return grid < cap ? grid : cap;
}

// A ray's terms of the slice test (render/traverse.py slice_rays_plain).
struct SliceRay {
    float ox, oy, oz, ix, iy, iz;
    float pad;  // every side of a box widened by this
    float cap;  // the slab's upper t: tm widened, NaN -> inf
};

__device__ __forceinline__ SliceRay slice_ray(float ox, float oy, float oz,
                                              float dx, float dy, float dz,
                                              float tm, float tmin) {
    SliceRay r;
    r.ox = ox, r.oy = oy, r.oz = oz;
    r.ix = 1.0f / dx, r.iy = 1.0f / dy, r.iz = 1.0f / dz;
    const float om = nan_max(nan_max(fabsf(ox), fabsf(oy)), fabsf(oz));
    const float dm = nan_max(nan_max(fabsf(dx), fabsf(dy)), fabsf(dz));
    r.pad = 0x1p-16f * om + (2.0f * tmin) * dm;
    r.cap = tm != tm ? __int_as_float(0x7f800000)
                     : fmaxf(tm * (1.0f + 0x1p-14f), 0.0f);
    return r;
}

// Whether ray r slab-hits slice box (lo.xyz, hi.xyz) = (a.xyz, a.w, b.xy)
// widened by r.pad over [tmin, r.cap], cluster_masks' NaN-robust root
// slab (an axis whose entry or exit is NaN spans (-inf, inf)); the
// operation order of slice_slab_plain.
__device__ __forceinline__ bool slice_hit(float4 a, float4 b,
                                          const SliceRay& r, float tmin) {
    const float lo[3] = {a.x, a.y, a.z}, hi[3] = {a.w, b.x, b.y};
    const float o[3] = {r.ox, r.oy, r.oz}, inv[3] = {r.ix, r.iy, r.iz};
    float near = -__int_as_float(0x7f800000);
    float far = __int_as_float(0x7f800000);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        const float t0 = ((lo[k] - r.pad) - o[k]) * inv[k];
        const float t1 = ((hi[k] + r.pad) - o[k]) * inv[k];
        if (t0 == t0 && t1 == t1) {
            near = fmaxf(near, fminf(t0, t1));
            far = fminf(far, fmaxf(t0, t1));
        }
    }
    return fmaxf(near, tmin) <= fminf(far, r.cap) && far >= tmin;
}

// One lane's ray in a warp's unit: start() loads it (rays: [n, 8] (o, d,
// tmax, pad) rows, 16-byte aligned; g its row, valid whether the lane has
// a ray); the initial key is pack(min(tmax, 3e38), 127), kKeepNaN keeping
// a NaN tmax's own bits (else min.NaN gives the canonical NaN).
// cluster() folds slice s of cluster c (tri [n_clusters, 16, 128] rows,
// slices [n_clusters, 4, 8]; ids past the table read its last cluster, the
// result still names the id given); merge() puts a hit into best[g].
template <bool BW>
struct FoldRay {
    float ox, oy, oz, dx, dy, dz;
    SliceRay sr;
    int32_t kb, cb;
    bool live;  // the lane has a ray that still takes part

    template <bool kKeepNaN>
    __device__ __forceinline__ void start(const float* __restrict__ rays,
                                          long long g, bool valid,
                                          float tmin) {
        float4 ra = {}, rb = {};
        if (valid) {
            const float4* r4 = (const float4*)(rays + g * 8);
            ra = r4[0];
            rb = r4[1];
        }
        ox = ra.x, oy = ra.y, oz = ra.z;
        dx = ra.w, dy = rb.x, dz = rb.y;
        // clamp: an inf tmax would pack to NaN bits
        const float tm = rb.z;
        kb = pack_key(kKeepNaN && tm != tm ? tm : nan_min(tm, 3e38f),
                      RT_KTRI - 1);
        cb = -1;
        live = valid;
        // a BW key's t places the ray at its triangle, so tmax bounds the
        // slab; an MT key's t can err far on a grazing ray, so no upper t
        sr = slice_ray(ox, oy, oz, dx, dy, dz,
                       BW ? tm : __int_as_float(0x7f800000), tmin);
    }

    __device__ __forceinline__ void cluster(
        const float* __restrict__ tri, const float* __restrict__ slices,
        FoldStage& st, int c, int s, int n_clusters, float tmin,
        unsigned& runs) {
        constexpr int kRows = BW ? 12 : 9;
        const int cc = min(c, n_clusters - 1);
        const float4* bx = (const float4*)slices +
                           ((long long)cc * RT_SLICES + s) * 2;
        const float4 a = __ldg(bx), z = __ldg(bx + 1);
        if (!__any_sync(kFoldFull, live && slice_hit(a, z, sr, tmin)))
            return;
        ++runs;
        const int lane = threadIdx.x & 31;
        const float* src = tri + (long long)cc * RT_KCOMP * RT_KTRI +
                           s * RT_SLICE + lane;
        float* dst = (float*)st.tri + lane * RT_FOLD_ROW;
#pragma unroll
        for (int k = 0; k < kRows; ++k) dst[k] = __ldg(src + k * RT_KTRI);
        __syncwarp();
#pragma unroll 2
        for (int j = 0; j < RT_SLICE; ++j) {
            const float4 p = st.tri[j * 3 + 0];
            const float4 m = st.tri[j * 3 + 1];
            const float4 q = st.tri[j * 3 + 2];
            const float r[12] = {p.x, p.y, p.z, p.w, m.x, m.y,
                                 m.z, m.w, q.x, q.y, q.z, q.w};
            const int lj = s * RT_SLICE + j;
            const int32_t key =
                BW ? key_bw(r, lj, ox, oy, oz, dx, dy, dz, tmin)
                   : key_vpu(r, lj, ox, oy, oz, dx, dy, dz, tmin);
            if (key < kb) {
                kb = key;
                cb = c;
            }
        }
        __syncwarp();  // the buffer is refilled by the next live slice
    }

    __device__ __forceinline__ void merge(long long* __restrict__ best,
                                          long long g) {
        if (cb >= 0) atomicMin(best + g, pack_best(kb, cb));
    }
};

// Add the CTA's slice runs to *counter (null: tracing off), one add a
// CTA; every thread calls it at its end. runs: its warp's count.
__device__ __forceinline__ void fold_count(unsigned long long* counter,
                                           unsigned runs, unsigned& s_runs) {
    if (counter == nullptr) return;
    if (threadIdx.x == 0) s_runs = 0;
    __syncthreads();
    if ((threadIdx.x & 31) == 0 && runs != 0) atomicAdd(&s_runs, runs);
    __syncthreads();
    if (threadIdx.x == 0 && s_runs != 0)
        atomicAdd(counter, (unsigned long long)s_runs);
}
