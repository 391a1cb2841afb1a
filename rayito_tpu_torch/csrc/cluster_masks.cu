// cluster_masks: per 128-ray block, which cluster boxes any of its rays
// slab-hits, bit-packed 32 clusters to an int32 word.
//
// Replaces the TPU kernel _mask_kernel (rayito_tpu/render/
// pallas_traverse.py, launched by _block_masks_pallas), which ran a dense
// [B, C_pad] slab test in VMEM and packed the bits with an MXU matmul
// against 0/2^k weights.
//
// What bounds it on the H100: the slab arithmetic, b * C_pad tests of ~20
// flops per block (128 x 512 at stage 6); the inputs are tiny (b rays and
// an [8, C_pad] box table that stays in L2). Design: one CUDA block per ray
// block with its rays in shared memory; warp w owns clusters
// [32w, 32w+32) of each 128-cluster pass, each lane slab-tests its cluster
// against the block's rays until the first hit, and one __ballot_sync
// yields the packed word directly. The reference's unit-root gate only
// skips work, so it is dropped; any C_pad works.
//
// Rows of steps at or past the live prefix (n_live, read from device
// memory so the host never waits) and of steps whose max tmax is not > 0
// (step_alive, the reference's dead-step guard) are written as zeros.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void cluster_masks_kernel(
    const float* __restrict__ soat,       // [n_steps * sb, 8]
    const float* __restrict__ box,        // [8, c_pad]
    const uint8_t* __restrict__ step_alive,  // [n_steps]
    const int32_t* __restrict__ n_live,   // [] or null
    int32_t* __restrict__ out,            // [n_blocks, n_words]
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
    for (int c0 = warp * 32; c0 < c_pad; c0 += n_warps * 32) {
        const int c = c0 + lane;
        const float bx0 = box[0 * c_pad + c], by0 = box[1 * c_pad + c];
        const float bz0 = box[2 * c_pad + c], bx1 = box[3 * c_pad + c];
        const float by1 = box[4 * c_pad + c], bz1 = box[5 * c_pad + c];
        bool hit = false;
        for (int r = 0; r < b && !hit; ++r) {
            const float ox = rays[r], oy = rays[b + r], oz = rays[2 * b + r];
            const float ix = rays[3 * b + r], iy = rays[4 * b + r];
            const float iz = rays[5 * b + r], tmax = rays[6 * b + r];
            const float tx0 = (bx0 - ox) * ix, ty0 = (by0 - oy) * iy;
            const float tz0 = (bz0 - oz) * iz, tx1 = (bx1 - ox) * ix;
            const float ty1 = (by1 - oy) * iy, tz1 = (bz1 - oz) * iz;
            const float near = nan_max(
                nan_max(nan_min(tx0, tx1), nan_min(ty0, ty1)),
                nan_min(tz0, tz1));
            const float far = nan_min(
                nan_min(nan_max(tx0, tx1), nan_max(ty0, ty1)),
                nan_max(tz0, tz1));
            hit = (nan_max(near, tmin) <= nan_min(far, tmax)) &&
                  (far >= tmin);
        }
        const unsigned word = __ballot_sync(0xffffffffu, hit);
        if (lane == 0) row[c0 >> 5] = (int32_t)word;
    }
}

}  // namespace

extern "C" int rt_cluster_masks(const float* soat, const float* box,
                                const uint8_t* step_alive,
                                const int32_t* n_live, int32_t* out,
                                int n_blocks, int c_pad, int b, int sb,
                                int n_steps, float tmin, void* stream) {
    const size_t smem = (size_t)7 * b * sizeof(float);
    cluster_masks_kernel<<<n_blocks, kThreads, smem,
                           (cudaStream_t)stream>>>(
        soat, box, step_alive, n_live, out, c_pad, c_pad / 32, b, sb,
        n_steps, tmin);
    return (int)cudaGetLastError();
}
