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
