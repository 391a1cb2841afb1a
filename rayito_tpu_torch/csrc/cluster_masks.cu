// cluster_masks: per 128-ray block, which cluster boxes any of its rays
// slab-hits, bit-packed 32 clusters to an int32 word.
//
// Replaces the TPU kernel _mask_kernel (rayito_tpu/render/
// pallas_traverse.py, launched by _block_masks_pallas), which ran a dense
// [B, C_pad] slab test in VMEM, packed the bits with an MXU matmul against
// 0/2^k weights, and could skip 1,024-cluster units behind a unit-root
// pre-test (mask_gate).
//
// What bounds it on the H100: the slab arithmetic, ~24 flops per (ray,
// box) test; the inputs are small (b rays and an [8, C_pad] box table that
// stays in L2). A dense pass tests b * C_pad pairs per block, but cluster
// ids follow the BVH-DFS triangle order, so a word's 32 clusters are
// spatial neighbours and a block's rays reach few of them (~7 of 392 at
// stage 6). Design: one CUDA block per ray block, rays in shared memory;
// warp w of 16 takes words w, w + 16, ...; for each word:
//
//   1. each lane loads its cluster's box; redux.sync min/max over the
//      lanes (floats as order-preserving ints) give the exact f32 union
//      box (word_roots_plain) of the word's real clusters and, apart, of
//      its lane pads (box[0] >= 1e29, the never-hit boxes, left out of the
//      real union as the reference's unit roots leave them);
//   2. each lane tests b / 32 rays against those roots with the
//      reference's NaN-robust root slab (slab_root: an axis that goes NaN
//      is dropped), and a ballot per 32 rays names the candidate rays.
//      Slab-hit(cluster) implies slab-hit(root) for a box inside the root,
//      and a NaN'd cluster test never hits, so a ray that misses both
//      roots hits no cluster of the word; a word without candidates is 0;
//   3. only candidate rays are tested against each lane's own box with
//      the exact slab, four at a time (independent tests that keep the
//      pipeline full) and in the same ray order for every lane (no
//      divergence), until every lane has a hit; one __ballot_sync gives
//      the word.
//
// Few blocks are live at once (the coherence sort packs the live rays into
// the first steps), so the kernel is latency-bound: 16 warps per block
// give one word each at stage 6 (16 words) and four at the big scene (60).
//
// The words equal the dense pass's bit for bit: the gate only skips tests
// whose result is false. NaN-propagating min/max are one instruction each
// (min.NaN / max.NaN, common.cuh).
//
// Rows of steps at or past the live prefix (n_live, read from device
// memory so the host never waits) and of steps whose max tmax is not > 0
// (step_alive, the reference's dead-step guard) are written as zeros.
//
// With a counter (pairs, an int64 in device memory; null when tracing is
// off) the set bits of every word written are added to it: the (ray block,
// cluster) pairs the traversal's fold walks.
#include "common.cuh"

namespace {

constexpr int kThreads = 512;  // one warp per word at stage 6 (16 words)
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNeverHit = 1e30f;

// Order-preserving map of non-NaN floats to int32 (and back).
__device__ __forceinline__ int f2o(float x) {
    const int i = __float_as_int(x);
    return i ^ ((i >> 31) & 0x7fffffff);
}

__device__ __forceinline__ float o2f(int k) {
    return __int_as_float(k ^ ((k >> 31) & 0x7fffffff));
}

// Exact f32 union of the boxes of the lanes that are members; the
// never-hit point box when no lane is. Each axis takes the min and max of
// both planes, so the root also holds a box given with lo > hi (the slab
// test swaps its planes). A NaN plane lands in the root as NaN or not at
// all: slab_root drops a NaN axis, and a NaN box is never hit.
__device__ __forceinline__ void word_union(const float (&bx)[6], bool member,
                                           float (&root)[6]) {
    const bool any = __any_sync(kFull, member);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        const float a = bx[k], z = bx[k + 3];
        const int lo =
            __reduce_min_sync(kFull, member ? f2o(nan_min(a, z)) : INT_MAX);
        const int hi =
            __reduce_max_sync(kFull, member ? f2o(nan_max(a, z)) : INT_MIN);
        root[k] = any ? o2f(lo) : kNeverHit;
        root[k + 3] = any ? o2f(hi) : kNeverHit;
    }
}

struct Ray {
    float ox, oy, oz, ix, iy, iz, tmax;
};

__device__ __forceinline__ Ray load_ray(const float* rays, int b, int r) {
    return {rays[r], rays[b + r], rays[2 * b + r], rays[3 * b + r],
            rays[4 * b + r], rays[5 * b + r], rays[6 * b + r]};
}

// The reference's cluster slab test, NaN propagating.
__device__ __forceinline__ bool slab(const float (&bx)[6], const Ray& r,
                                     float tmin) {
    const float tx0 = (bx[0] - r.ox) * r.ix, ty0 = (bx[1] - r.oy) * r.iy;
    const float tz0 = (bx[2] - r.oz) * r.iz, tx1 = (bx[3] - r.ox) * r.ix;
    const float ty1 = (bx[4] - r.oy) * r.iy, tz1 = (bx[5] - r.oz) * r.iz;
    const float near = nan_max(
        nan_max(nan_min(tx0, tx1), nan_min(ty0, ty1)), nan_min(tz0, tz1));
    const float far = nan_min(
        nan_min(nan_max(tx0, tx1), nan_max(ty0, ty1)), nan_max(tz0, tz1));
    return (nan_max(near, tmin) <= nan_min(far, r.tmax)) && (far >= tmin);
}

// The reference's NaN-robust root slab (slab_root): an axis whose entry
// or exit is NaN spans (-inf, inf).
__device__ __forceinline__ bool slab_root(const float (&rt)[6], const Ray& r,
                                          float tmin) {
    const float o[3] = {r.ox, r.oy, r.oz};
    const float inv[3] = {r.ix, r.iy, r.iz};
    float near = -__int_as_float(0x7f800000);
    float far = __int_as_float(0x7f800000);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        const float t0 = (rt[k] - o[k]) * inv[k];
        const float t1 = (rt[k + 3] - o[k]) * inv[k];
        if (t0 == t0 && t1 == t1) {
            near = nan_max(near, nan_min(t0, t1));
            far = nan_min(far, nan_max(t0, t1));
        }
    }
    return (nan_max(near, tmin) <= nan_min(far, r.tmax)) && (far >= tmin);
}

__global__ void __launch_bounds__(kThreads) cluster_masks_kernel(
    const float* __restrict__ soat,       // [n_steps * sb, 8]
    const float* __restrict__ box,        // [8, c_pad]
    const uint8_t* __restrict__ step_alive,  // [n_steps]
    const int32_t* __restrict__ n_live,   // [] or null
    int32_t* __restrict__ out,            // [n_blocks, n_words]
    unsigned long long* __restrict__ pairs,  // [] or null
    int c_pad, int n_words, int b, int sb, int n_steps, float tmin) {
    extern __shared__ float rays[];  // [7, b]: ox oy oz ix iy iz tmax
    const int blk = blockIdx.x;
    const int step = (int)(((long long)blk * b) / sb);
    int32_t* row = out + (long long)blk * n_words;
    if (step >= live_steps(n_live, n_steps) || !step_alive[step]) {
        for (int w = threadIdx.x; w < n_words; w += blockDim.x) row[w] = 0;
        return;
    }
    const float* r0 = soat + (long long)blk * b * 8;
    for (int r = threadIdx.x; r < b; r += blockDim.x) {
        const float* ray = r0 + r * 8;
        rays[0 * b + r] = ray[0];
        rays[1 * b + r] = ray[1];
        rays[2 * b + r] = ray[2];
        rays[3 * b + r] = 1.0f / ray[3];
        rays[4 * b + r] = 1.0f / ray[4];
        rays[5 * b + r] = 1.0f / ray[5];
        rays[6 * b + r] = ray[6];
    }
    __syncthreads();

    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int n_warps = blockDim.x >> 5;
    for (int w = warp; w < n_words; w += n_warps) {
        const int c = w * 32 + lane;
        float bx[6];
#pragma unroll
        for (int k = 0; k < 6; ++k) bx[k] = box[k * c_pad + c];
        const bool real = bx[0] < 1e29f;
        const bool has_real = __any_sync(kFull, real);
        const bool has_pad = __any_sync(kFull, !real);
        float root_real[6], root_pad[6];
        word_union(bx, real, root_real);
        word_union(bx, !real, root_pad);

        // every branch below is uniform across the warp
        bool hit = false;
        for (int r0 = 0; r0 < b; r0 += 32) {
            const int r = r0 + lane;
            bool cand = false;
            if (r < b) {
                const Ray ray = load_ray(rays, b, r);
                cand = (has_real && slab_root(root_real, ray, tmin)) ||
                       (has_pad && slab_root(root_pad, ray, tmin));
            }
            // four candidates per step (independent tests); a short step
            // repeats its last candidate, which changes no OR
            unsigned m = __ballot_sync(kFull, cand);
            while (m) {
                int k[4];
                k[0] = __ffs(m) - 1;
                m &= m - 1;
#pragma unroll
                for (int i = 1; i < 4; ++i) {
                    k[i] = m ? __ffs(m) - 1 : k[i - 1];
                    m &= m - 1;
                }
                bool h = false;
#pragma unroll
                for (int i = 0; i < 4; ++i)
                    h |= slab(bx, load_ray(rays, b, r0 + k[i]), tmin);
                hit |= h;
                if (__all_sync(kFull, hit)) break;
            }
            if (__all_sync(kFull, hit)) break;
        }
        const unsigned word = __ballot_sync(kFull, hit);
        if (lane == 0) {
            row[w] = (int32_t)word;
            if (pairs != nullptr && word != 0u)
                atomicAdd(pairs, (unsigned long long)__popc(word));
        }
    }
}

}  // namespace

extern "C" int rt_cluster_masks(const float* soat, const float* box,
                                const uint8_t* step_alive,
                                const int32_t* n_live, int32_t* out,
                                int n_blocks, int c_pad, int b, int sb,
                                int n_steps, float tmin, long long* pairs,
                                void* stream) {
    const size_t smem = (size_t)7 * b * sizeof(float);
    cluster_masks_kernel<<<n_blocks, kThreads, smem,
                           (cudaStream_t)stream>>>(
        soat, box, step_alive, n_live, out, (unsigned long long*)pairs, c_pad,
        c_pad / 32, b, sb, n_steps, tmin);
    return (int)cudaGetLastError();
}
