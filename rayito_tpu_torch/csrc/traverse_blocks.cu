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
// What bounds it on the H100: the triangle arithmetic, 128 tests of ~25-30
// flops per (ray, listed cluster); the cluster tables (392 x 8 KB at stage
// 6) sit in the 50 MB L2. Design: one thread per ray, b threads per block;
// the block's mask words go to shared memory, set bits are walked in
// ascending cluster order with __ffs, and each listed cluster's rows are
// loaded into shared memory once for the whole block (every thread then
// reads the same address: a broadcast). Each thread keeps the running
// minimum packed key with a strict <, which keeps the reference's tie
// order (lowest cluster; keys are lane-unique).
//
// With any_hit the block stops once every ray has an accepted hit: only
// prim >= 0 is defined then, as in the reference's any-hit launch.
// Steps at or past the live prefix write the miss values (t = inf,
// prim = -1) without reading anything.
#include "common.cuh"

namespace {

// Möller-Trumbore key for one (ray, lane); rows 0-8 are v0, e1, e2.
__device__ __forceinline__ int32_t key_vpu(const float* s, int j, float ox,
                                           float oy, float oz, float dx,
                                           float dy, float dz, float tmin) {
    const float v0x = s[0 * RT_KTRI + j], v0y = s[1 * RT_KTRI + j];
    const float v0z = s[2 * RT_KTRI + j], e1x = s[3 * RT_KTRI + j];
    const float e1y = s[4 * RT_KTRI + j], e1z = s[5 * RT_KTRI + j];
    const float e2x = s[6 * RT_KTRI + j], e2y = s[7 * RT_KTRI + j];
    const float e2z = s[8 * RT_KTRI + j];
    const float px = dy * e2z - dz * e2y;
    const float py = dz * e2x - dx * e2z;
    const float pz = dx * e2y - dy * e2x;
    const float det = e1x * px + e1y * py + e1z * pz;
    const float inv = 1.0f / det;
    const float tx = ox - v0x, ty = oy - v0y, tz = oz - v0z;
    const float u = (tx * px + ty * py + tz * pz) * inv;
    const float qx = ty * e1z - tz * e1y;
    const float qy = tz * e1x - tx * e1z;
    const float qz = tx * e1y - ty * e1x;
    const float v = (dx * qx + dy * qy + dz * qz) * inv;
    const float t = (e2x * qx + e2y * qy + e2z * qz) * inv;
    const bool ok = (u >= 0.0f) && (v >= 0.0f) && (u + v <= 1.0f) &&
                    (t >= tmin);
    return ok ? pack_key(t, j) : INT32_MAX;
}

// Baldwin-Weber key; rows: n.xyz, d, ru.xyz, ud, rv.xyz, vd.
__device__ __forceinline__ int32_t key_bw(const float* s, int j, float ox,
                                          float oy, float oz, float dx,
                                          float dy, float dz, float tmin) {
    const float nx = s[0 * RT_KTRI + j], ny = s[1 * RT_KTRI + j];
    const float nz = s[2 * RT_KTRI + j], dpl = s[3 * RT_KTRI + j];
    const float rux = s[4 * RT_KTRI + j], ruy = s[5 * RT_KTRI + j];
    const float ruz = s[6 * RT_KTRI + j], rud = s[7 * RT_KTRI + j];
    const float rvx = s[8 * RT_KTRI + j], rvy = s[9 * RT_KTRI + j];
    const float rvz = s[10 * RT_KTRI + j], rvd = s[11 * RT_KTRI + j];
    const float den = nx * dx + ny * dy + nz * dz;
    const float t = (dpl - (nx * ox + ny * oy + nz * oz)) / den;
    const float hx = ox + t * dx, hy = oy + t * dy, hz = oz + t * dz;
    const float u = rux * hx + ruy * hy + ruz * hz + rud;
    const float v = rvx * hx + rvy * hy + rvz * hz + rvd;
    const bool ok = (u >= 0.0f) && (v >= 0.0f) && (u + v <= 1.0f) &&
                    (t >= tmin);
    return ok ? pack_key(t, j) : INT32_MAX;
}

template <bool BW>
__global__ void traverse_blocks_kernel(
    const int32_t* __restrict__ masks,  // [n_blocks, n_words]
    const float* __restrict__ soat,     // [n_steps * sb, 8]
    const float* __restrict__ tri,      // [n_clusters, 16, 128]
    const int32_t* __restrict__ n_live, // [] or null
    float* __restrict__ t_out,          // [n_steps * sb]
    int32_t* __restrict__ p_out,        // [n_steps * sb]
    int n_words, int n_clusters, int sb, int n_steps, float tmin,
    int any_hit) {
    constexpr int kRows = BW ? 12 : 9;
    extern __shared__ float smem[];
    float* tri_s = smem;                                       // [kRows, 128]
    uint32_t* words = (uint32_t*)(smem + kRows * RT_KTRI);     // [n_words]
    const int b = blockDim.x;
    const long long ray = (long long)blockIdx.x * b + threadIdx.x;
    const int step = (int)(((long long)blockIdx.x * b) / sb);
    if (step >= live_steps(n_live, n_steps)) {
        t_out[ray] = __int_as_float(0x7f800000);
        p_out[ray] = -1;
        return;
    }
    const float* r = soat + ray * 8;
    const float ox = r[0], oy = r[1], oz = r[2];
    const float dx = r[3], dy = r[4], dz = r[5];
    // clamp: an inf tmax would pack to NaN bits
    int32_t kb = pack_key(nan_min(r[6], 3e38f), RT_KTRI - 1);
    int32_t cb = -1;
    const int32_t* mrow = masks + (long long)blockIdx.x * n_words;
    for (int w = threadIdx.x; w < n_words; w += b) words[w] = (uint32_t)mrow[w];
    __syncthreads();

    // the word loop and every branch on `bits` are uniform across the
    // block, so the barriers below are reached by all threads
    bool all_done = false;
    for (int w = 0; w < n_words && !all_done; ++w) {
        uint32_t bits = words[w];
        while (bits) {
            const int c = w * 32 + __ffs(bits) - 1;
            bits &= bits - 1;
            if (c >= n_clusters) break;  // box-table lane padding
            if (any_hit && __syncthreads_and(cb >= 0)) {
                all_done = true;
                break;
            }
            const float* src = tri + (long long)c * RT_KCOMP * RT_KTRI;
            for (int i = threadIdx.x; i < kRows * RT_KTRI; i += b)
                tri_s[i] = src[i];
            __syncthreads();
            if (!(any_hit && cb >= 0)) {
                for (int j = 0; j < RT_KTRI; ++j) {
                    const int32_t key =
                        BW ? key_bw(tri_s, j, ox, oy, oz, dx, dy, dz, tmin)
                           : key_vpu(tri_s, j, ox, oy, oz, dx, dy, dz, tmin);
                    if (key < kb) {
                        kb = key;
                        cb = c;
                    }
                }
            }
            __syncthreads();
        }
    }
    if (cb >= 0) {
        t_out[ray] = __int_as_float(kb & ~(RT_KTRI - 1));
        p_out[ray] = cb * RT_KTRI + (kb & (RT_KTRI - 1));
    } else {
        t_out[ray] = __int_as_float(0x7f800000);
        p_out[ray] = -1;
    }
}

}  // namespace

extern "C" int rt_traverse_blocks(const int32_t* masks, const float* soat,
                                  const float* tri, const int32_t* n_live,
                                  float* t_out, int32_t* p_out, int n_blocks,
                                  int b, int n_words, int n_clusters, int sb,
                                  int n_steps, float tmin, int bw,
                                  int any_hit, void* stream) {
    const int rows = bw ? 12 : 9;
    const size_t smem = (size_t)rows * RT_KTRI * sizeof(float) +
                        (size_t)n_words * sizeof(uint32_t);
    cudaStream_t s = (cudaStream_t)stream;
    if (bw)
        traverse_blocks_kernel<true><<<n_blocks, b, smem, s>>>(
            masks, soat, tri, n_live, t_out, p_out, n_words, n_clusters, sb,
            n_steps, tmin, any_hit);
    else
        traverse_blocks_kernel<false><<<n_blocks, b, smem, s>>>(
            masks, soat, tri, n_live, t_out, p_out, n_words, n_clusters, sb,
            n_steps, tmin, any_hit);
    return (int)cudaGetLastError();
}
