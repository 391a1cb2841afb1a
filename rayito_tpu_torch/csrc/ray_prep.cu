// ray_prep: the traversal's plumbing around the coherence sort
// (render/traverse.py traverse()), three launches a call:
//
//   ray_pack_kernel     takes each lane into the traversal domain's space
//                       when the domain has a transform chain, packs the
//                       rays into the kernels' 32-byte rows (o, d, tmax, 0;
//                       padding lanes d = 1, tmax = 0) and writes each
//                       lane's sort operand: its coherence key (miss flag,
//                       direction octant, Morton cell of the root-box entry
//                       point), packed above the lane id when the launch has
//                       at most 2^17 lanes;
//   ray_reorder_kernel  moves the rows into the sorted order and writes the
//                       permutation and the live step count;
//   ray_unsort_kernel   scatters the traversal's results back to the
//                       caller's lane order.
//
// Replaces no TPU kernel: the reference leaves this plumbing to XLA
// (rayito_tpu/render/pallas_traverse.py traverse(), _coherence_key). The
// port ran it as ~140 plain torch ops a call; the plain twins in
// render/traverse.py (ray_pack_plain, ray_reorder_plain, ray_unsort_plain)
// are that code, and the sort between the launches stays torch.sort.
//
// Bits: the key is float arithmetic in the plain twin's op order, built
// with the library's flags (-fmad=false, IEEE division, no flush to zero):
// `1.0 / d` is PyTorch's correctly rounded reciprocal, the divisions by the
// box extent are IEEE, torch.minimum / maximum / clamp keep a NaN operand,
// and nan_to_num comes before the int cast. The root box is a min and max,
// exact in any order (the sign of a zero in it cannot reach the key's
// integer cells). So the operand, and the sort's permutation, are the plain
// twin's bit for bit.
//
// The chain (ChainIo: the domain's slots, outermost first, read from the
// device table the scene holds, SceneData.ktab_chain, so a replayed graph
// reads the same slots) is ops/transform.py local_ray's:
// per link, at the lane's own time, eval_link of xform.cuh, then
// (~R)(o - T) / S and (~R)d / S, and the world-from-local rotation
// composed as rot * R, in the plain twin's operation order, so the local
// ray, the rows and the operand are its bits too. A table of one key
// takes its keys as constants and reads no time. On request the kernel
// also writes the local ray ([6, N] rows, for the winner re-test) and the
// rotation ([4, N] rows, w x y z, for the shading). A domain without a
// chain takes the kChain = false instance: no time read, no extra output.
//
// What bounds it on the H100: bytes, all of them in L2 at the main path's
// 262,144 lanes. ray_pack reads 28 B a lane and writes 36 B (through a
// chain it reads the lane's time, 4 B, where the table has keys, and writes
// the local ray's 24 B and the rotation's 16 B where asked), ray_reorder
// reads the lane order (4 B, or 8 and the sorted key's 4) and a 32-byte
// row and writes 36 B, ray_unsort reads 8 B (12 with t) and writes 4 (8). Design: ray_pack runs two lanes a thread,
// each block reducing the root box over the table's columns once (the
// 1,024 lanes of a block share it), after it has stored its lanes' rows;
// ray_reorder moves each row with two threads, one 16-byte load and store
// each; the live count is where the sorted operand crosses the miss flag,
// found by the one thread that sees the crossing, so no counter has to be
// reset between calls or graph replays.
#include "common.cuh"
#include "xform.cuh"

namespace {

constexpr int kPackThreads = 512;
constexpr int kPackLanes = 2;  // lanes a thread packs
constexpr int kThreads = 256;
constexpr int32_t kMissFlag = 1 << 30;
constexpr int kLaneBits = 17;  // lane field of a packed sort operand

// A traversal domain's transform chain: depth slots of the transform
// tables, outermost first, of tables of k keys a slot; the lanes' times;
// and where the chain's outputs go, the local ray [6, n] and the rotation
// [4, n] (each null where the caller does not want it).
struct ChainIo {
    XfTables tb;
    const int32_t* slots;
    int depth, k;
    const float* time;
    float* local;
    float* rot;
};

// torch.clamp / clamp_min on the card: a NaN operand comes back as it is
__device__ __forceinline__ float tclamp(float v, float lo, float hi) {
    return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ float tclamp_min(float v, float lo) {
    return isnan(v) ? v : fmaxf(v, lo);
}

// traverse._part1by2: the low 9 bits of x spread to every third bit
__device__ __forceinline__ int32_t part1by2(int32_t x) {
    x &= 0x1FF;
    x = (x | (x << 16)) & 0x030000FF;
    x = (x | (x << 8)) & 0x0300F00F;
    x = (x | (x << 4)) & 0x030C30C3;
    x = (x | (x << 2)) & 0x09249249;
    return x;
}

// The root box into root[0..5] (min xyz, max xyz): rows 0-2 of cl_box
// reduced by min over every column, rows 3-5 by max over the columns
// below 1e29 (coherence_key's rmin and rmax). Every thread of the block
// calls it.
__device__ void root_box(const float* __restrict__ box, int c_pad,
                         float* root) {
    const float inf = __int_as_float(0x7f800000);
    float v[6] = {inf, inf, inf, -inf, -inf, -inf};
    for (int c = threadIdx.x; c < c_pad; c += blockDim.x) {
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            v[k] = nan_min(v[k], box[k * c_pad + c]);
            const float hi = box[(3 + k) * c_pad + c];
            v[3 + k] = nan_max(v[3 + k], hi >= 1e29f ? -inf : hi);
        }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            v[k] = nan_min(v[k], __shfl_xor_sync(0xffffffffu, v[k], off));
            v[3 + k] =
                nan_max(v[3 + k], __shfl_xor_sync(0xffffffffu, v[3 + k], off));
        }
    }
    __shared__ float part[kPackThreads / 32][6];
    const int warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
    if ((threadIdx.x & 31) == 0) {
#pragma unroll
        for (int k = 0; k < 6; ++k) part[warp][k] = v[k];
    }
    __syncthreads();
    if (threadIdx.x < 6) {
        const int k = threadIdx.x;
        float r = part[0][k];
        for (int w = 1; w < warps; ++w)
            r = k < 3 ? nan_min(r, part[w][k]) : nan_max(r, part[w][k]);
        root[k] = r;
    }
    __syncthreads();
}

// coherence_key of one ray against the root box, op for op
__device__ __forceinline__ int32_t coherence_key(float ox, float oy, float oz,
                                                 float dx, float dy, float dz,
                                                 float tmax, const float* r,
                                                 float tmin) {
    const float ix = 1.0f / dx, iy = 1.0f / dy, iz = 1.0f / dz;
    const float tx0 = (r[0] - ox) * ix, ty0 = (r[1] - oy) * iy,
                tz0 = (r[2] - oz) * iz;
    const float tx1 = (r[3] - ox) * ix, ty1 = (r[4] - oy) * iy,
                tz1 = (r[5] - oz) * iz;
    const float near = nan_max(nan_max(nan_min(tx0, tx1), nan_min(ty0, ty1)),
                               nan_min(tz0, tz1));
    const float far = nan_min(nan_min(nan_max(tx0, tx1), nan_max(ty0, ty1)),
                              nan_max(tz0, tz1));
    if (!(tclamp_min(near, tmin) <= nan_min(far, tmax)) || !(tmax > tmin))
        return kMissFlag;
    const float tn = tclamp(near, 0.0f, 3e38f);
    const float o[3] = {ox, oy, oz}, d[3] = {dx, dy, dz};
    int32_t morton = 0;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        const float ext = tclamp_min(r[3 + k] - r[k], 1e-30f);
        const float q =
            tclamp((o[k] + d[k] * tn - r[k]) / ext * 512.0f, 0.0f, 511.0f);
        morton |= part1by2(isnan(q) ? 0 : (int32_t)q) << (2 - k);
    }
    const int32_t octant = (dx < 0.0f) * 4 + (dy < 0.0f) * 2 + (dz < 0.0f);
    return (octant << 27) | morton;
}

// Lane i's ray r[0..5] (o, d) into the chain's space, in place; writes
// the local ray and the rotation where io asks for them.
__device__ __forceinline__ void to_local(const ChainIo& io, int n, int i,
                                         float* r) {
    const float tm = io.k > 1 ? io.time[i] : 0.0f;
    Rot rot = {1.0f, 0.0f, 0.0f, 0.0f};
    for (int c = 0; c < io.depth; ++c) {
        Vec tr, sc;
        Rot ro;
        eval_link(io.tb, io.k, io.slots[c], tm, tr, sc, ro);
        const Vec po = unrotate(ro, {r[0] - tr.x, r[1] - tr.y, r[2] - tr.z});
        const Vec pd = unrotate(ro, {r[3], r[4], r[5]});
        r[0] = po.x / sc.x;
        r[1] = po.y / sc.y;
        r[2] = po.z / sc.z;
        r[3] = pd.x / sc.x;
        r[4] = pd.y / sc.y;
        r[5] = pd.z / sc.z;
        rot = c == 0 ? ro : qmul(rot, ro);
    }
    if (io.local != nullptr) {
#pragma unroll
        for (int k = 0; k < 6; ++k) io.local[(long long)k * n + i] = r[k];
    }
    if (io.rot != nullptr) {
        io.rot[i] = rot.w;
        io.rot[(long long)n + i] = rot.x;
        io.rot[2 * (long long)n + i] = rot.y;
        io.rot[3 * (long long)n + i] = rot.z;
    }
}

template <bool kKey, bool kPacked, bool kChain>
__global__ void __launch_bounds__(kPackThreads) ray_pack_kernel(
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz,
    const float* __restrict__ tmax, const float* __restrict__ box,
    float4* __restrict__ soa8, int32_t* __restrict__ operand,
    unsigned long long* __restrict__ live_rays, const ChainIo io, int n,
    int n_tot, int c_pad, float tmin) {
    float ray[kPackLanes][7];
    const int i0 = blockIdx.x * (kPackThreads * kPackLanes) + threadIdx.x;
#pragma unroll
    for (int u = 0; u < kPackLanes; ++u) {
        const int i = i0 + u * kPackThreads;
        const bool real = i < n;
        ray[u][0] = real ? ox[i] : 0.0f;
        ray[u][1] = real ? oy[i] : 0.0f;
        ray[u][2] = real ? oz[i] : 0.0f;
        ray[u][3] = real ? dx[i] : 1.0f;
        ray[u][4] = real ? dy[i] : 1.0f;
        ray[u][5] = real ? dz[i] : 1.0f;
        ray[u][6] = real ? tmax[i] : 0.0f;
        if constexpr (kChain) {
            if (real) to_local(io, n, i, ray[u]);
        }
        if (i < n_tot) {
            soa8[2 * (long long)i] =
                make_float4(ray[u][0], ray[u][1], ray[u][2], ray[u][3]);
            soa8[2 * (long long)i + 1] =
                make_float4(ray[u][4], ray[u][5], ray[u][6], 0.0f);
        }
    }
    if (!kKey) return;
    __shared__ float root[6];
    root_box(box, c_pad, root);
    int live = 0;
#pragma unroll
    for (int u = 0; u < kPackLanes; ++u) {
        const int i = i0 + u * kPackThreads;
        if (i >= n_tot) continue;
        const float* r = ray[u];
        const int32_t key = coherence_key(r[0], r[1], r[2], r[3], r[4], r[5],
                                          r[6], root, tmin);
        live += key < kMissFlag;
        operand[i] = kPacked ? ((key >> kLaneBits) << kLaneBits) | i : key;
    }
    if (live_rays == nullptr) return;
    __shared__ int part[kPackThreads / 32];
    live = __reduce_add_sync(0xffffffffu, live);
    if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = live;
    __syncthreads();
    if (threadIdx.x == 0) {
        int sum = 0;
        for (int w = 0; w < kPackThreads / 32; ++w) sum += part[w];
        if (sum) atomicAdd(live_rays, (unsigned long long)sum);
    }
}

// Two threads a sorted slot j: half h of the row of lane perm[j]. The
// lane is the packed operand's low bits or the stable sort's index.
__global__ void __launch_bounds__(kThreads) ray_reorder_kernel(
    const float4* __restrict__ soa8, const int32_t* __restrict__ vals,
    const long long* __restrict__ idx, float4* __restrict__ soat,
    int32_t* __restrict__ perm, int32_t* __restrict__ n_live, int n_tot,
    int sb) {
    const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
    const int j = (int)(t >> 1), h = (int)(t & 1);
    if (j >= n_tot) return;
    const int32_t lane = idx != nullptr
                             ? (int32_t)idx[j]
                             : (vals[j] & ((1 << kLaneBits) - 1));
    soat[2 * (long long)j + h] = soa8[2 * (long long)lane + h];
    if (h) return;
    perm[j] = lane;
    if (n_live == nullptr) return;
    // live lanes (operand below the miss flag) sort first: the one slot
    // where the sorted operand crosses the flag writes their step count
    const bool live = vals[j] < kMissFlag;
    if (live && (j + 1 == n_tot || vals[j + 1] >= kMissFlag))
        *n_live = (j + sb) / sb;
    else if (j == 0 && !live)
        *n_live = 0;
}

__global__ void __launch_bounds__(kThreads) ray_unsort_kernel(
    const int32_t* __restrict__ p_bn, const float* __restrict__ t_bn,
    const int32_t* __restrict__ perm, int32_t* __restrict__ prim,
    float* __restrict__ t, int n, int n_slots, int hit_only) {
    const int j = blockIdx.x * kThreads + threadIdx.x;
    if (j >= n_slots) return;
    const int32_t lane = perm != nullptr ? perm[j] : j;
    if (lane >= n) return;
    const int32_t p = p_bn[j];
    prim[lane] = hit_only ? (p >= 0 ? 0 : -1) : p;
    if (t != nullptr) t[lane] = t_bn[j];
}

}  // namespace

extern "C" int rt_ray_pack(const float* ox, const float* oy, const float* oz,
                           const float* dx, const float* dy, const float* dz,
                           const float* tmax, const float* box, float* soa8,
                           int32_t* operand, long long* live_rays,
                           const int32_t* slots, const float* xf_times,
                           const float* xf_translate, const float* xf_scale,
                           const float* xf_rotate, const int32_t* xf_nkeys,
                           const float* time, float* local, float* rot,
                           int depth, int k, int n, int n_tot, int c_pad,
                           float tmin, int key, void* stream) {
    if (n < 0 || n > n_tot || c_pad <= 0 || (key && operand == nullptr))
        return (int)cudaErrorInvalidValue;
    if (depth == 0 ? local != nullptr || rot != nullptr
                   : depth < 0 || k < 1 || slots == nullptr ||
                         xf_times == nullptr || xf_translate == nullptr ||
                         xf_scale == nullptr || xf_rotate == nullptr ||
                         xf_nkeys == nullptr || (k > 1 && time == nullptr))
        return (int)cudaErrorInvalidValue;
    const int per_block = kPackThreads * kPackLanes;
    const int blocks = (n_tot + per_block - 1) / per_block;
    cudaStream_t s = (cudaStream_t)stream;
    auto* rows = (float4*)soa8;
    auto* live = (unsigned long long*)live_rays;
    const ChainIo io = {{xf_times, xf_translate, xf_scale, xf_rotate,
                         xf_nkeys},
                        slots, depth, k, time, local, rot};
#define RT_RAY_PACK(KEY, PACKED, CHAIN)                                    \
    ray_pack_kernel<KEY, PACKED, CHAIN><<<blocks, kPackThreads, 0, s>>>(   \
        ox, oy, oz, dx, dy, dz, tmax, box, rows, operand, live, io, n,     \
        n_tot, c_pad, tmin)
#define RT_RAY_PACK_KEYS(CHAIN)                                            \
    if (!key)                                                              \
        RT_RAY_PACK(false, false, CHAIN);                                  \
    else if (n_tot <= (1 << kLaneBits))                                    \
        RT_RAY_PACK(true, true, CHAIN);                                    \
    else                                                                   \
        RT_RAY_PACK(true, false, CHAIN)
    if (depth == 0) {
        RT_RAY_PACK_KEYS(false);
    } else {
        RT_RAY_PACK_KEYS(true);
    }
#undef RT_RAY_PACK_KEYS
#undef RT_RAY_PACK
    return (int)cudaGetLastError();
}

extern "C" int rt_ray_reorder(const float* soa8, const int32_t* vals,
                              const long long* idx, float* soat,
                              int32_t* perm, int32_t* n_live, int n_tot,
                              int sb, void* stream) {
    if (n_tot <= 0 || sb <= 0 || (idx == nullptr && n_tot > (1 << kLaneBits))
        || (vals == nullptr && (idx == nullptr || n_live != nullptr)))
        return (int)cudaErrorInvalidValue;
    const long long threads = 2 * (long long)n_tot;
    const int blocks = (int)((threads + kThreads - 1) / kThreads);
    ray_reorder_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const float4*)soa8, vals, idx, (float4*)soat, perm, n_live, n_tot,
        sb);
    return (int)cudaGetLastError();
}

extern "C" int rt_ray_unsort(const int32_t* p_bn, const float* t_bn,
                             const int32_t* perm, int32_t* prim, float* t,
                             int n, int n_slots, int hit_only, void* stream) {
    if (n < 0 || n > n_slots || (t != nullptr && t_bn == nullptr))
        return (int)cudaErrorInvalidValue;
    if (n_slots == 0) return (int)cudaGetLastError();
    const int blocks = (n_slots + kThreads - 1) / kThreads;
    ray_unsort_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        p_bn, t_bn, perm, prim, t, n, n_slots, hit_only);
    return (int)cudaGetLastError();
}
