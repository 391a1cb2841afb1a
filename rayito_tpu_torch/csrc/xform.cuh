// Keyed transforms on the card: ops/transform.py's eval_transform and
// ops/quaternion.py's rotate_vector and multiply, in their operation order,
// for the kernels that evaluate a transform chain per lane at the lane's
// own time (fold_small.cu, shade.cu, ray_prep.cu). Build with -fmad=false
// -prec-div=true -prec-sqrt=true, as every source of this library: each
// multiply and add rounds on its own, divisions and roots are IEEE, so the
// values equal the plain PyTorch ops' bit for bit.
#pragma once

#include <math.h>
#include <stdint.h>

namespace {

struct XfTables {
    const float* times;      // [X, K]
    const float* translate;  // [X, K, 3]
    const float* scale;      // [X, K, 3]
    const float* rotate;     // [X, K, 4] (w, x, y, z)
    const int32_t* nkeys;    // [X]
};

struct Vec {
    float x, y, z;
};

struct Rot {
    float w, x, y, z;
};

__device__ __forceinline__ float f_inf() { return __int_as_float(0x7f800000); }

// torch.clamp(x, 0, 1) on the card: NaN stays.
__device__ __forceinline__ float clamp01(float x) {
    return isnan(x) ? x : ::fminf(::fmaxf(x, 0.0f), 1.0f);
}

// eval_transform (ops/transform.py) of slot s at time tm.
__device__ __forceinline__ void eval_link(const XfTables& tb, int k, int s,
                                          float tm, Vec& tr, Vec& sc,
                                          Rot& ro) {
    if (k == 1) {
        const float* a = tb.translate + s * 3;
        const float* b = tb.scale + s * 3;
        const float* q = tb.rotate + s * 4;
        tr = {a[0], a[1], a[2]};
        sc = {b[0], b[1], b[2]};
        ro = {q[0], q[1], q[2], q[3]};
        return;
    }
    const float* times = tb.times + s * k;
    const int nk = tb.nkeys[s];
    int before = 0;
    for (int j = 0; j < k; ++j) before += (j < nk && times[j] <= tm) ? 1 : 0;
    const int last = max(nk - 1, 0);
    const int i0 = min(max(before - 1, 0), last);
    const int i1 = min(i0 + 1, last);
    const float t0 = times[i0], t1 = times[i1];
    const float denom = t1 - t0;
    const float q = (tm - t0) / (denom == 0.0f ? 1.0f : denom);
    const float frac = clamp01(denom > 0.0f ? q : 0.0f);
    const float* a = tb.translate + (s * k + i0) * 3;
    const float* b = tb.translate + (s * k + i1) * 3;
    tr = {a[0] + (b[0] - a[0]) * frac, a[1] + (b[1] - a[1]) * frac,
          a[2] + (b[2] - a[2]) * frac};
    a = tb.scale + (s * k + i0) * 3;
    b = tb.scale + (s * k + i1) * 3;
    sc = {a[0] + (b[0] - a[0]) * frac, a[1] + (b[1] - a[1]) * frac,
          a[2] + (b[2] - a[2]) * frac};
    const float* p = tb.rotate + (s * k + i0) * 4;
    const float* r = tb.rotate + (s * k + i1) * 4;
    const float om = 1.0f - frac;
    const float w = p[0] * om + r[0] * frac;
    const float x = p[1] * om + r[1] * frac;
    const float y = p[2] * om + r[2] * frac;
    const float z = p[3] * om + r[3] * frac;
    const float n2 = w * w + ((x * x + y * y) + z * z);
    // torch.clamp_min on the card: NaN stays
    const float inv = 1.0f / sqrtf(isnan(n2) ? n2 : ::fmaxf(n2, 1e-37f));
    ro = {w * inv, x * inv, y * inv, z * inv};
}

// rotate_vector(conjugate(ro), v) of ops/quaternion.py.
__device__ __forceinline__ Vec unrotate(const Rot& ro, const Vec& v) {
    const float qx = -ro.x, qy = -ro.y, qz = -ro.z;
    const float tx = (qy * v.z - qz * v.y) * 2.0f;
    const float ty = (qz * v.x - qx * v.z) * 2.0f;
    const float tz = (qx * v.y - qy * v.x) * 2.0f;
    return {(v.x + tx * ro.w) + (qy * tz - qz * ty),
            (v.y + ty * ro.w) + (qz * tx - qx * tz),
            (v.z + tz * ro.w) + (qx * ty - qy * tx)};
}

// multiply(a, b) of ops/quaternion.py: the Hamilton product a * b.
__device__ __forceinline__ Rot qmul(const Rot& a, const Rot& b) {
    return {a.w * b.w - ((a.x * b.x + a.y * b.y) + a.z * b.z),
            (b.x * a.w + a.x * b.w) + (a.y * b.z - a.z * b.y),
            (b.y * a.w + a.y * b.w) + (a.z * b.x - a.x * b.z),
            (b.z * a.w + a.z * b.w) + (a.x * b.y - a.y * b.x)};
}

// rotate_vector(ro, v) of ops/quaternion.py: t = 2 (qv x v);
// v' = (v + t w) + qv x t.
__device__ __forceinline__ Vec rotate(const Rot& ro, const Vec& v) {
    const float tx = (ro.y * v.z - ro.z * v.y) * 2.0f;
    const float ty = (ro.z * v.x - ro.x * v.z) * 2.0f;
    const float tz = (ro.x * v.y - ro.y * v.x) * 2.0f;
    return {(v.x + tx * ro.w) + (ro.y * tz - ro.z * ty),
            (v.y + ty * ro.w) + (ro.z * tx - ro.x * tz),
            (v.z + tz * ro.w) + (ro.x * ty - ro.y * tx)};
}

}  // namespace
