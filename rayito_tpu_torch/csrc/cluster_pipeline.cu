// cluster_pipeline: phases 2-3 of the traversal='xla' route's two-level
// cluster pipeline, one compacted ray slot per warp.
//
// Replaces no pallas_call: it is the body of the reference's XLA
// while_loop (rayito_tpu/render/mesh_intersect.py:186-281, the loop at
// :283), which walks the compacted rays in blocks of R slots until the
// count of rays with a candidate, held on the device, is covered. Here a
// grid sized to the card (as many blocks as fit on its SMs at once) walks
// the slots below n_active, read from device memory, warp by warp with a
// stride over the grid, and writes misses past it. The trip count stays on
// the device, so a CUDA graph can hold the launch.
//
// Per slot s < n_active, for the lane r = ray_of_slot[s], the same values
// as _pipeline_chunk (render/traverse.py), whose sorts and argmin it
// replaces with warp sorts:
//
//   1. the k1 nearest superclusters of r's phase-1 row t_sc[r]: the finite
//      entries, as 64-bit keys (t's bits, order-preserving, above the
//      index: the order of a stable ascending sort of t and of
//      jax.lax.top_k), are compacted into a per-warp list and bitonic
//      sorted, 32 to 256 keys at once (one to eight per lane); a row of
//      more than 256 finite entries is sorted in chunks, each keeping the
//      best k1 before the next is appended. overflow max(#finite - k1, 0);
//   2. the 16 children of each kept supercluster slab-tested from its
//      sc_rows row (lane l takes entries l, l + 32, ... of the k1 x 16);
//      the finite ones compacted and sorted the same way, the first k2
//      kept; overflow += max(#finite - k2, 0);
//   3. Möller-Trumbore in the reference's formulation and operation order
//      over the 48 triangles of each kept cluster's tri_rows row: lane l
//      takes candidates l, l + 32, ... of the k2 x 48, four at a time,
//      their 9 floats each read from L2 before any of the four is tested;
//      a warp min of (t, candidate index) gives the first minimum,
//      torch.argmin's and jnp.argmin's tie rule. prim = tri0 + cluster *
//      48 + index % 48; on an all-miss slot the first candidate's first
//      triangle (the nearest cluster, or child 0 of the nearest
//      supercluster when no child box is entered), as the plain version's
//      argmin of an all-INF row gives.
//
// Entries with t = INF are never selected: the plain version keeps them in
// its cut of k (masked there), and their indices reach no output.
// Slots at or past n_active are t = INF, prim = -1, overflow 0.
//
// What bounds it on the H100: the instructions its warps issue (a warp
// works on one slot, so a test costs an instruction issue per warp, not
// per lane). chip_smoke.py counts, from the built SASS (tools/cmj_sass.py
// --kernels cluster_pipeline_kernel), the float instructions and loads of
// a slab-loop iteration and of a triangle test, with this run's work, at
// the SMs' issue limit; integer, address and sorting work is not counted,
// so the bound is low. The tables are small and L2-resident: stage 6's
// n=64 stand-in has 64 sc_rows rows (32 KB) and 1,024 tri_rows rows
// (2 MB). Design: no block is launched for a slot without a candidate
// (86-90% of the slots on stage 6's bands); the selections take a fixed
// network per sort, not a five-step warp reduction per kept entry (up to
// 40 dependent rounds per slot before); each lane has four triangles'
// rows in flight before it tests them, and a slot's ray and phase-1 row
// load while the slot before it is tested. (Rows staged in shared memory
// by TMA bulk copies, two clusters ahead, were no faster on stage 6's
// bands and slower on the 420-layer stack.) Build with -fmad=false (slab
// and triangle tests round every multiply and add on their own, as the
// plain version does); NaN-propagating min/max as torch.maximum /
// torch.minimum (common.cuh).
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;  // warps per block
constexpr unsigned kFull = 0xffffffffu;
constexpr int kK1Max = 16;
constexpr int kK2Max = 24;
constexpr int kKids = 16;       // clusters per supercluster
constexpr int kTri = 48;        // triangles per cluster
constexpr int kScRow = 128;     // sc_rows row: 6 x 16 child box planes
constexpr int kTriRow = 512;    // tri_rows row: 9 x 48 vertex components
constexpr int kUnroll = 4;      // triangle tests in flight per lane
constexpr int kPerLane = kK1Max * kKids / 32;  // children entries per lane
constexpr int kSortMax = 256;   // keys one sort takes
constexpr unsigned long long kNoKey = ~0ull;

__device__ __forceinline__ float f_inf() { return __int_as_float(0x7f800000); }

// (t, index) as one key whose unsigned order is the order of a stable
// ascending sort of t: -0 as +0, then the sign-magnitude bits made
// monotone, above the index.
__device__ __forceinline__ unsigned long long make_key(float t, int i) {
    unsigned u = __float_as_uint(t == 0.0f ? 0.0f : t);
    u ^= (u & 0x80000000u) ? 0xffffffffu : 0x80000000u;
    return ((unsigned long long)u << 32) | (unsigned)i;
}

__device__ __forceinline__ int key_index(unsigned long long k) {
    return (int)(unsigned)(k & 0xffffffffull);
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

// Bitonic sort of the 32 * M keys a warp holds, M per lane in blocked
// order (lane l holds ranks l * M .. l * M + M - 1 afterwards), ascending.
template <int M>
__device__ __forceinline__ void warp_sort(unsigned long long (&k)[M],
                                          int l) {
#pragma unroll
    for (int size = 2; size <= 32 * M; size <<= 1) {
#pragma unroll
        for (int j = size >> 1; j > 0; j >>= 1) {
            if (j >= M) {  // the partner is in lane l ^ (j / M)
                const int lj = j / M;
                const bool low = (l & lj) == 0;
#pragma unroll
                for (int r = 0; r < M; ++r) {
                    const unsigned long long o =
                        __shfl_xor_sync(kFull, k[r], lj);
                    const bool up = ((l * M + r) & size) == 0;
                    const bool take_min = low == up;
                    k[r] = (o < k[r]) == take_min ? o : k[r];
                }
            } else {  // in the lane's own registers
#pragma unroll
                for (int r = 0; r < M; ++r) {
                    const int p = r ^ j;
                    if (p > r) {
                        const bool up = ((l * M + r) & size) == 0;
                        const unsigned long long a = k[r], b = k[p];
                        const bool swap = up ? b < a : a < b;
                        k[r] = swap ? b : a;
                        k[p] = swap ? a : b;
                    }
                }
            }
        }
    }
}

// One function per width, not inlined: the 256-key network alone is
// thousands of instructions, and three call sites would copy each.
template <int M>
__device__ __noinline__ void sort_list_m(unsigned long long* list, int n,
                                         int l) {
    __syncwarp();  // the list was written by other lanes
    unsigned long long k[M];
#pragma unroll
    for (int r = 0; r < M; ++r)
        k[r] = l * M + r < n ? list[l * M + r] : kNoKey;
    warp_sort<M>(k, l);
#pragma unroll
    for (int r = 0; r < M; ++r)
        if (l * M + r < n) list[l * M + r] = k[r];
    __syncwarp();
}

// Sorts the warp's list of n <= 256 distinct keys in place, ascending.
__device__ __forceinline__ void sort_list(unsigned long long* list, int n,
                                          int l) {
    if (n <= 32)
        sort_list_m<1>(list, n, l);
    else if (n <= 64)
        sort_list_m<2>(list, n, l);
    else if (n <= 128)
        sort_list_m<4>(list, n, l);
    else
        sort_list_m<8>(list, n, l);
}

// Appends the keys of the lanes with ``take`` to the list after its n
// entries (in lane order); returns the new n, the same in every lane.
__device__ __forceinline__ int append(unsigned long long* list, int n,
                                      bool take, unsigned long long key,
                                      int l) {
    const unsigned m = __ballot_sync(kFull, take);
    if (take) list[n + __popc(m & ((1u << l) - 1u))] = key;
    return n + __popc(m);
}

struct WarpSmem {
    unsigned long long list[kSortMax];
    int sc_sel[kK1Max];  // kept superclusters, nearest first
    int cl_sel[kK2Max];  // kept clusters, nearest first
};

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
    __shared__ WarpSmem smem[kWarps];
    const int l = threadIdx.x & 31;
    const int w = threadIdx.x >> 5;
    WarpSmem& sm = smem[w];
    const int n_act = min(max(*n_active, 0), n);
    const float inf = f_inf();
    // the slots without a candidate: misses
    for (int slot = n_act + blockIdx.x * blockDim.x + threadIdx.x; slot < n;
         slot += gridDim.x * blockDim.x) {
        t_out[slot] = inf;
        p_out[slot] = -1;
        ovf_out[slot] = 0;
    }
    // a slot's ray and the head of its phase-1 row, loaded while the slot
    // before it is tested
    const int stride = gridDim.x * kWarps;
    int next = blockIdx.x * kWarps + w;
    int r_next = 0;
    float t_next = inf;
    if (next < n_act) {
        r_next = ray_of_slot[next];
        t_next = l < s ? t_sc[(long long)r_next * s + l] : inf;
    }
    for (int slot = next; slot < n_act; slot = next) {
        const int r = r_next;
        const float t_head = t_next;
        const float ox = ox_[r], oy = oy_[r], oz = oz_[r];
        const float dx = dx_[r], dy = dy_[r], dz = dz_[r];
        const float tmax = tmax_[r];
        next = slot + stride;

        // 1. the k1 nearest superclusters
        const float* row = t_sc + (long long)r * s;
        int have = 0, finite = 0;
        for (int j0 = 0; j0 < s; j0 += 32) {
            const int j = j0 + l;
            const float t = j0 == 0 ? t_head : j < s ? row[j] : inf;
            const bool take = isfinite(t);
            const int cnt = __popc(__ballot_sync(kFull, take));
            if (have + cnt > kSortMax) {  // keep the best k1 so far
                sort_list(sm.list, have, l);
                have = min(have, k1);
            }
            have = append(sm.list, have, take, make_key(t, j), l);
            finite += cnt;
        }
        __syncwarp();
        sort_list(sm.list, have, l);
        const int n1 = min(k1, finite);
        int ovf = max(finite - k1, 0);
        if (l < n1) sm.sc_sel[l] = key_index(sm.list[l]);
        __syncwarp();

        // 2. their children, then the k2 nearest clusters
        const float ix = 1.0f / dx, iy = 1.0f / dy, iz = 1.0f / dz;
        have = 0;
#pragma unroll 1
        for (int m = 0; m < kPerLane; ++m) {
            const int e = l + 32 * m;  // kept supercluster e / 16, child e % 16
            if (m * 32 >= n1 * kKids) break;  // the same in every lane
            float t = inf;
            if (e / kKids < n1) {
                const float* b = sc_rows
                                 + (long long)sm.sc_sel[e / kKids] * kScRow
                                 + e % kKids;
                t = slab6(ox, oy, oz, ix, iy, iz, tmin, tmax, b[0], b[kKids],
                          b[2 * kKids], b[3 * kKids], b[4 * kKids],
                          b[5 * kKids]);
            }
            have = append(sm.list, have, t < inf, make_key(t, e), l);
        }
        __syncwarp();
        sort_list(sm.list, have, l);
        const int n2 = min(k2, have);
        ovf += max(have - k2, 0);
        if (l < n2) {
            const int e = key_index(sm.list[l]);
            sm.cl_sel[l] = sm.sc_sel[e / kKids] * kKids + e % kKids;
        }
        if (n2 == 0 && l == 0) sm.cl_sel[0] = sm.sc_sel[0] * kKids;
        __syncwarp();

        // 3. Möller-Trumbore over the kept clusters' triangles, each
        // lane's four next rows read before they are tested
        if (next < n_act) {
            r_next = ray_of_slot[next];
            t_next = l < s ? t_sc[(long long)r_next * s + l] : inf;
        }
        const int n_tri = n2 * kTri;
        float best_t = inf;
        int best_f = 0;
        for (int g0 = 0; g0 < n_tri; g0 += 32 * kUnroll) {
            float v[kUnroll][9];
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
                const int g = g0 + 32 * u + l;  // ascends per lane
                if (g < n_tri) {
                    const float* row =
                        tri_rows + (long long)sm.cl_sel[g / kTri] * kTriRow
                        + g % kTri;
#pragma unroll
                    for (int k = 0; k < 9; ++k)
                        v[u][k] = __ldg(row + k * kTri);
                }
            }
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
                const int g = g0 + 32 * u + l;
                if (g < n_tri) {
                    const float t = mt_exact(
                        v[u][0], v[u][1], v[u][2], v[u][3], v[u][4], v[u][5],
                        v[u][6], v[u][7], v[u][8], ox, oy, oz, dx, dy, dz,
                        tmin, tmax).t;
                    if (t < best_t) {  // the first minimum
                        best_t = t;
                        best_f = g;
                    }
                }
            }
        }
#pragma unroll
        for (int off = 16; off; off >>= 1) {
            const float t2 = __shfl_xor_sync(kFull, best_t, off);
            const int f2 = __shfl_xor_sync(kFull, best_f, off);
            if (t2 < best_t || (t2 == best_t && f2 < best_f)) {
                best_t = t2;
                best_f = f2;
            }
        }
        if (l == 0) {
            t_out[slot] = best_t;
            p_out[slot] = tri0 + sm.cl_sel[best_f / kTri] * kTri
                          + best_f % kTri;
            ovf_out[slot] = ovf;
        }
        __syncwarp();  // sc_sel / cl_sel / list are the next slot's
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
    // as many blocks as fit on the card at once, no more than the slots
    // need; the same for every call on a device, so a graph holds it
    static int fit_blocks = 0;
    if (fit_blocks == 0) {
        int dev = 0, sms = 0, per_sm = 0;
        cudaError_t err = cudaGetDevice(&dev);
        if (err == cudaSuccess)
            err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                         dev);
        if (err == cudaSuccess)
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, cluster_pipeline_kernel, kWarps * 32, 0);
        if (err != cudaSuccess) return (int)err;
        fit_blocks = max(1, sms * per_sm);
    }
    const int blocks = min(fit_blocks, (n + kWarps - 1) / kWarps);
    cluster_pipeline_kernel<<<blocks, kWarps * 32, 0, (cudaStream_t)stream>>>(
        ray_of_slot, n_active, ox, oy, oz, dx, dy, dz, tmax, t_sc, sc_rows,
        tri_rows, t_out, p_out, ovf_out, n, s, k1, k2, tri0, tmin);
    return (int)cudaGetLastError();
}
