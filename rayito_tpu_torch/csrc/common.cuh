// Shared helpers for the traversal kernels.
//
// Build with -fmad=false: every multiply and add must round on its own, as
// the reference's slab and triangle tests do, or grazing rays flip bits.
// Division is IEEE (nvcc's default -prec-div=true).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define RT_KTRI 128    // triangles per cluster (lanes of a cluster block)
#define RT_KCOMP 16    // rows per cluster block

// jnp.minimum / jnp.maximum propagate NaN; fminf / fmaxf drop it. A zero
// direction component with the origin on a slab plane gives 0 * inf = NaN,
// and the reference's result depends on that NaN reaching the compare.
__device__ __forceinline__ float nan_min(float a, float b) {
    if (a != a) return a;
    if (b != b) return b;
    return a < b ? a : b;
}

__device__ __forceinline__ float nan_max(float a, float b) {
    if (a != a) return a;
    if (b != b) return b;
    return a > b ? a : b;
}

// Order-preserving (t, lane) key: the low 7 mantissa bits of t are
// replaced by the triangle's lane, so an int32 min picks the nearest
// triangle with ~2^-17 relative slack and unique ties.
__device__ __forceinline__ int32_t pack_key(float t, int32_t lane) {
    return (__float_as_int(t) & ~(RT_KTRI - 1)) | lane;
}

// Number of live ray steps (rows past it are skipped): the device-side
// count written by the coherence sort, or every step when absent.
__device__ __forceinline__ int live_steps(const int32_t* n_live,
                                          int n_steps) {
    if (n_live == nullptr) return n_steps;
    int n = *n_live;
    n = n < n_steps ? n : n_steps;
    return n > 1 ? n : 1;
}

// Triangle-test keys of one ray against lane j of a cluster block staged
// as rows of RT_KTRI floats (s), for traverse_blocks and traverse_items:
// the reference's _mt_key_rows in its operation order; INT32_MAX when the
// ray misses the triangle.

// Möller-Trumbore key; rows 0-8 are v0, e1, e2.
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
