// cluster_pipeline: phases 2-3 of the traversal='xla' route's two-level
// cluster pipeline, one compacted ray slot per warp.
//
// Replaces no pallas_call: it is the body of the reference's XLA
// while_loop (rayito_tpu/render/mesh_intersect.py:186-281, the loop at
// :283), which walks the compacted rays in blocks of R slots until the
// count of rays with a candidate, held on the device, is covered. Here one
// launch covers every slot (the worst case); a warp whose slot is at or
// past n_active, read from device memory, writes a miss and returns. The
// trip count stays on the device, so a CUDA graph can hold the launch.
//
// Per slot s < n_active, for the lane r = ray_of_slot[s], the same values
// as _pipeline_chunk (render/traverse.py), whose sorts and argmin it
// replaces with warp selections:
//
//   1. the k1 nearest superclusters of r's phase-1 row t_sc[r] (ascending
//      t, ties to the lower index, as a stable sort and jax.lax.top_k order
//      them): round j takes the warp's least (t, index) strictly above
//      round j - 1's, over the finite entries only; overflow max(#finite -
//      k1, 0);
//   2. the 16 children of each kept supercluster slab-tested from its
//      sc_rows row (lane l takes entries l, l + 32, ... of the k1 x 16,
//      eight in registers); the k2 nearest of the finite ones the same
//      way; overflow += max(#finite - k2, 0);
//   3. Möller-Trumbore in the reference's formulation and operation order
//      over the 48 triangles of each kept cluster's tri_rows row (lane l
//      takes flat candidates l, l + 32, ... of the k2 x 48); a warp min of
//      (t, candidate index) gives the first minimum, torch.argmin's and
//      jnp.argmin's tie rule. prim = tri0 + cluster * 48 + index % 48; on
//      an all-miss slot the first candidate's first triangle (the nearest
//      cluster, or child 0 of the nearest supercluster when no child box
//      is entered), as the plain version's argmin of an all-INF row gives.
//
// Entries with t = INF are never selected: the plain version keeps them in
// its cut of k (masked there), and their indices reach no output.
// Slots at or past n_active are t = INF, prim = -1, overflow 0.
//
// What bounds it on the H100: operations, ~24 flops per slab test and ~46
// per Möller-Trumbore test (k1 x 16 and k2 x 48 per active slot, at most
// 256 and 1,152) at 67 TFLOP/s f32 (at most half of it without FMA). The
// tables are small and L2-resident: stage 6's n=64 stand-in has 64 sc_rows
// rows (32 KB) and 1,024 tri_rows rows (2 MB). The selections cost k1
// and k2 rounds of a five-step warp reduction each. One warp per slot
// keeps each slot's candidate lists in registers and shared memory; no
// [R, 24, 512] gather is written to memory. Build with -fmad=false (slab
// and triangle tests round every multiply and add on their own, as the
// plain version does); NaN-propagating min/max as torch.maximum /
// torch.minimum (common.cuh).
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;  // slots per block
constexpr unsigned kFull = 0xffffffffu;
constexpr int kK1Max = 16;
constexpr int kK2Max = 24;
constexpr int kKids = 16;       // clusters per supercluster
constexpr int kTri = 48;        // triangles per cluster
constexpr int kScRow = 128;     // sc_rows row: 6 x 16 child box planes
constexpr int kTriRow = 512;    // tri_rows row: 9 x 48 vertex components
constexpr int kPerLane = kK1Max * kKids / 32;  // children entries per lane

__device__ __forceinline__ float f_inf() { return __int_as_float(0x7f800000); }

// (t, i) < (bt, bi) in the order of a stable ascending sort.
__device__ __forceinline__ bool before(float t, int i, float bt, int bi) {
    return t < bt || (t == bt && i < bi);
}

// The warp's least (t, i); every lane gets it (the order is total: the i
// are distinct or the pairs equal).
__device__ __forceinline__ void warp_min(float& t, int& i) {
#pragma unroll
    for (int off = 16; off; off >>= 1) {
        const float t2 = __shfl_xor_sync(kFull, t, off);
        const int i2 = __shfl_xor_sync(kFull, i, off);
        if (before(t2, i2, t, i)) {
            t = t2;
            i = i2;
        }
    }
}

// _slab6 of render/traverse.py for one ray and one box: entry t or INF.
__device__ __forceinline__ float slab6(float ox, float oy, float oz, float ix,
                                       float iy, float iz, float tmin,
                                       float tmax, float bx0, float by0,
                                       float bz0, float bx1, float by1,
                                       float bz1) {
    const float tx0 = (bx0 - ox) * ix;
    const float tx1 = (bx1 - ox) * ix;
    const float ty0 = (by0 - oy) * iy;
    const float ty1 = (by1 - oy) * iy;
    const float tz0 = (bz0 - oz) * iz;
    const float tz1 = (bz1 - oz) * iz;
    const float near = nan_max(nan_max(nan_min(tx0, tx1), nan_min(ty0, ty1)),
                               nan_min(tz0, tz1));
    const float far = nan_min(nan_min(nan_max(tx0, tx1), nan_max(ty0, ty1)),
                              nan_max(tz0, tz1));
    const float t0 = nan_max(near, tmin);
    const float t1 = nan_min(far, tmax);
    return t0 <= t1 ? t0 : f_inf();
}

__global__ void __launch_bounds__(kWarps * 32)
cluster_pipeline_kernel(const int32_t* __restrict__ ray_of_slot,
                        const int32_t* __restrict__ n_active,
                        const float* __restrict__ ox_,
                        const float* __restrict__ oy_,
                        const float* __restrict__ oz_,
                        const float* __restrict__ dx_,
                        const float* __restrict__ dy_,
                        const float* __restrict__ dz_,
                        const float* __restrict__ tmax_,
                        const float* __restrict__ t_sc,
                        const float* __restrict__ sc_rows,
                        const float* __restrict__ tri_rows,
                        float* __restrict__ t_out, int32_t* __restrict__ p_out,
                        int32_t* __restrict__ ovf_out, int n, int s, int k1,
                        int k2, int tri0, float tmin) {
    __shared__ int sc_sel[kWarps][kK1Max];  // kept superclusters, nearest first
    __shared__ int cl_sel[kWarps][kK2Max];  // kept clusters, nearest first
    const int l = threadIdx.x & 31;
    const int w = threadIdx.x >> 5;
    const int slot = blockIdx.x * kWarps + w;
    if (slot >= n) return;
    if (slot >= *n_active) {
        if (l == 0) {
            t_out[slot] = f_inf();
            p_out[slot] = -1;
            ovf_out[slot] = 0;
        }
        return;
    }
    const int r = ray_of_slot[slot];
    const float ox = ox_[r], oy = oy_[r], oz = oz_[r];
    const float dx = dx_[r], dy = dy_[r], dz = dz_[r];
    const float tmax = tmax_[r];
    const float inf = f_inf();

    // 1. the k1 nearest superclusters
    const float* row = t_sc + (long long)r * s;
    int finite = 0;
    for (int j = l; j < s; j += 32) finite += isfinite(row[j]) ? 1 : 0;
    finite = __reduce_add_sync(kFull, finite);
    const int n1 = min(k1, finite);
    int ovf = max(finite - k1, 0);
    float last_t = -inf;
    int last_i = -1;
    for (int k = 0; k < n1; ++k) {
        float bt = inf;
        int bi = INT_MAX;
        for (int j = l; j < s; j += 32) {
            const float t = row[j];
            if (isfinite(t) && before(last_t, last_i, t, j) &&
                before(t, j, bt, bi)) {
                bt = t;
                bi = j;
            }
        }
        warp_min(bt, bi);
        if (l == 0) sc_sel[w][k] = bi;
        last_t = bt;
        last_i = bi;
    }
    __syncwarp();

    // 2. their children, then the k2 nearest clusters
    const float ix = 1.0f / dx, iy = 1.0f / dy, iz = 1.0f / dz;
    float t_cl[kPerLane];
    int entered = 0;
#pragma unroll
    for (int m = 0; m < kPerLane; ++m) {
        const int e = l + 32 * m;  // kept supercluster e / 16, child e % 16
        t_cl[m] = inf;
        if (e / kKids < n1) {
            const float* b = sc_rows + (long long)sc_sel[w][e / kKids] * kScRow
                             + e % kKids;
            t_cl[m] = slab6(ox, oy, oz, ix, iy, iz, tmin, tmax, b[0],
                            b[kKids], b[2 * kKids], b[3 * kKids],
                            b[4 * kKids], b[5 * kKids]);
        }
        entered += __popc(__ballot_sync(kFull, t_cl[m] < inf));
    }
    const int n2 = min(k2, entered);
    ovf += max(entered - k2, 0);
    last_t = -inf;
    last_i = -1;
    for (int k = 0; k < n2; ++k) {
        float bt = inf;
        int bi = INT_MAX;
#pragma unroll
        for (int m = 0; m < kPerLane; ++m) {
            const int e = l + 32 * m;
            const float t = t_cl[m];
            if (t < inf && before(last_t, last_i, t, e) &&
                before(t, e, bt, bi)) {
                bt = t;
                bi = e;
            }
        }
        warp_min(bt, bi);
        if (l == 0) cl_sel[w][k] = sc_sel[w][bi / kKids] * kKids + bi % kKids;
        last_t = bt;
        last_i = bi;
    }
    if (n2 == 0 && l == 0) cl_sel[w][0] = sc_sel[w][0] * kKids;
    __syncwarp();

    // 3. Möller-Trumbore over the kept clusters' triangles
    float best_t = inf;
    int best_f = 0;
    for (int f = l; f < n2 * kTri; f += 32) {
        const float* v = tri_rows + (long long)cl_sel[w][f / kTri] * kTriRow
                         + f % kTri;
        const float v0x = v[0], v0y = v[kTri], v0z = v[2 * kTri];
        const float v1x = v[3 * kTri], v1y = v[4 * kTri], v1z = v[5 * kTri];
        const float v2x = v[6 * kTri], v2y = v[7 * kTri], v2z = v[8 * kTri];
        const float t = mt_exact(v0x, v0y, v0z, v1x, v1y, v1z, v2x, v2y, v2z,
                                 ox, oy, oz, dx, dy, dz, tmin, tmax).t;
        if (t < best_t) {  // f ascends per lane: the first minimum
            best_t = t;
            best_f = f;
        }
    }
    warp_min(best_t, best_f);
    if (l == 0) {
        t_out[slot] = best_t;
        p_out[slot] = tri0 + cl_sel[w][best_f / kTri] * kTri + best_f % kTri;
        ovf_out[slot] = ovf;
    }
}

}  // namespace

extern "C" int rt_cluster_pipeline(
    const int32_t* ray_of_slot, const int32_t* n_active, const float* ox,
    const float* oy, const float* oz, const float* dx, const float* dy,
    const float* dz, const float* tmax, const float* t_sc,
    const float* sc_rows, const float* tri_rows, float* t_out, int32_t* p_out,
    int32_t* ovf_out, int n, int s, int k1, int k2, int tri0, float tmin,
    void* stream) {
    if (n <= 0 || s <= 0 || k1 < 1 || k1 > kK1Max || k1 > s || k2 < 1 ||
        k2 > kK2Max || k2 > k1 * kKids)
        return (int)cudaErrorInvalidValue;
    const int blocks = (n + kWarps - 1) / kWarps;
    cluster_pipeline_kernel<<<blocks, kWarps * 32, 0, (cudaStream_t)stream>>>(
        ray_of_slot, n_active, ox, oy, oz, dx, dy, dz, tmax, t_sc, sc_rows,
        tri_rows, t_out, p_out, ovf_out, n, s, k1, k2, tri0, tmin);
    return (int)cudaGetLastError();
}
