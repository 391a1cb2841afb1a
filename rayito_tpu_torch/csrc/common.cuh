// Shared helpers for the traversal kernels.
//
// Build with -fmad=false: every multiply and add must round on its own, as
// the reference's slab and triangle tests do, or grazing rays flip bits.
// Division is IEEE (nvcc's default -prec-div=true).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

#define RT_KTRI 128    // triangles per cluster (lanes of a cluster block)
#define RT_KCOMP 16    // rows per cluster block

// jnp.minimum / jnp.maximum propagate NaN; fminf / fmaxf drop it. A zero
// direction component with the origin on a slab plane gives 0 * inf = NaN,
// and the reference's result depends on that NaN reaching the compare.
// min.NaN / max.NaN (sm_80 and later) do it in one instruction; their NaN
// is the canonical one, which no compare tells from another NaN.
__device__ __forceinline__ float nan_min(float a, float b) {
    float d;
    asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
    return d;
}

__device__ __forceinline__ float nan_max(float a, float b) {
    float d;
    asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
    return d;
}

// Order-preserving (t, lane) key: the low 7 mantissa bits of t are
// replaced by the triangle's lane, so an int32 min picks the nearest
// triangle with ~2^-17 relative slack and unique ties.
__device__ __forceinline__ int32_t pack_key(float t, int32_t lane) {
    return (__float_as_int(t) & ~(RT_KTRI - 1)) | lane;
}

// A ray's 64-bit best, ((uint32)key << 32) | cluster: a signed atomicMin
// takes the least key and, among equal keys, the lowest cluster, which is
// the tie order of a strict < over ascending clusters (keys carry the
// lane, so one cluster never ties with itself). The key goes through
// uint32, so a negative key (t = -0.0 at tmin 0) still orders as the int32
// compare does. A ray merges only a hit below its initial key and the
// best starts at LLONG_MAX, so a tie with the initial key stays a miss.
__device__ __forceinline__ long long pack_best(int32_t key, int32_t cid) {
    return (long long)(((unsigned long long)(uint32_t)key << 32) |
                       (uint32_t)cid);
}

// t (inf on a miss) and prim = cluster * 128 + lane (-1) of a 64-bit best.
__device__ __forceinline__ void emit_best(long long best, float* t_out,
                                          int32_t* p_out) {
    if (best == LLONG_MAX) {
        *t_out = __int_as_float(0x7f800000);
        *p_out = -1;
        return;
    }
    const unsigned long long v = (unsigned long long)best;
    const int32_t key = (int32_t)(uint32_t)(v >> 32);
    const int32_t cid = (int32_t)(uint32_t)(v & 0xffffffffull);
    *t_out = __int_as_float(key & ~(RT_KTRI - 1));
    *p_out = cid * RT_KTRI + (key & (RT_KTRI - 1));
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

// Triangle-test keys of one ray against one triangle of lane j, given the
// triangle's rows r[0..11] (read by the caller from its staged layout), for
// traverse_blocks and traverse_items: the reference's _mt_key_rows in its
// operation order; INT32_MAX when the ray misses the triangle.

// Möller-Trumbore key; rows 0-8 are v0, e1, e2.
__device__ __forceinline__ int32_t key_vpu(const float (&r)[12], int j,
                                           float ox, float oy, float oz,
                                           float dx, float dy, float dz,
                                           float tmin) {
    const float v0x = r[0], v0y = r[1], v0z = r[2];
    const float e1x = r[3], e1y = r[4], e1z = r[5];
    const float e2x = r[6], e2y = r[7], e2z = r[8];
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
__device__ __forceinline__ int32_t key_bw(const float (&r)[12], int j,
                                          float ox, float oy, float oz,
                                          float dx, float dy, float dz,
                                          float tmin) {
    const float nx = r[0], ny = r[1], nz = r[2], dpl = r[3];
    const float rux = r[4], ruy = r[5], ruz = r[6], rud = r[7];
    const float rvx = r[8], rvy = r[9], rvz = r[10], rvd = r[11];
    const float den = nx * dx + ny * dy + nz * dz;
    const float t = (dpl - (nx * ox + ny * oy + nz * oz)) / den;
    const float hx = ox + t * dx, hy = oy + t * dy, hz = oz + t * dz;
    const float u = rux * hx + ruy * hy + ruz * hz + rud;
    const float v = rvx * hx + rvy * hy + rvz * hz + rvd;
    const bool ok = (u >= 0.0f) && (v >= 0.0f) && (u + v <= 1.0f) &&
                    (t >= tmin);
    return ok ? pack_key(t, j) : INT32_MAX;
}

// Möller-Trumbore in the reference's formulation and operation order
// (ops/intersect.py triangle_intersect, the form the plain versions run):
// det = -dot(d, gnormal), barycentrics from scalar triple products. t is
// INF when the ray misses; beta and gamma are what the test computed,
// hit or not.
struct MtHit {
    float t, beta, gamma;
};

__device__ __forceinline__ MtHit mt_exact(
    float v0x, float v0y, float v0z, float v1x, float v1y, float v1z,
    float v2x, float v2y, float v2z, float ox, float oy, float oz, float dx,
    float dy, float dz, float tmin, float tmax) {
    const float e1x = v1x - v0x, e1y = v1y - v0y, e1z = v1z - v0z;
    const float e2x = v2x - v0x, e2y = v2y - v0y, e2z = v2z - v0z;
    const float gnx = e1y * e2z - e1z * e2y;
    const float gny = e1z * e2x - e1x * e2z;
    const float gnz = e1x * e2y - e1y * e2x;
    const float det = -(dx * gnx + dy * gny + dz * gnz);
    const float inv_det = 1.0f / (det == 0.0f ? 1.0f : det);
    const float t0x = v0x - ox, t0y = v0y - oy, t0z = v0z - oz;
    const float rcx = dy * t0z - dz * t0y;
    const float rcy = dz * t0x - dx * t0z;
    const float rcz = dx * t0y - dy * t0x;
    const float t1x = v1x - ox, t1y = v1y - oy, t1z = v1z - oz;
    const float gamma = -(t1x * rcx + t1y * rcy + t1z * rcz) * inv_det;
    const float t2x = v2x - ox, t2y = v2y - oy, t2z = v2z - oz;
    const float beta = (t2x * rcx + t2y * rcy + t2z * rcz) * inv_det;
    const float t = -(t0x * gnx + t0y * gny + t0z * gnz) * inv_det;
    const bool hit = det != 0.0f && gamma >= 0.0f && gamma <= 1.0f &&
                     beta >= 0.0f && beta + gamma <= 1.0f && t >= tmin &&
                     t < tmax;
    return {hit ? t : __int_as_float(0x7f800000), beta, gamma};
}
