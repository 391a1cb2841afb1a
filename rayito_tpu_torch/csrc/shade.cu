// shade: the per-bounce shading of the path tracer as two launches a
// bounce, one before the bounce's shadow queries (bounce_prepare) and one
// after them (bounce_resolve).
//
// Replaces no pallas_call: it is the XLA-fused bounce body of the
// reference's pathtrace_wave (rayito_tpu/render/pathtracer.py:150-305
// before the NEE queries, :338-396 after them). The port's plain twins are
// bounce_prepare_plain and bounce_resolve_plain (render/shade.py): per
// bounce some 6,000 elementwise PyTorch ops (the material row, the
// emission gate, each light sample's light choice, its light sample at the
// lane's time through the light's keyed chain, both BRDF evaluations and
// samples, the analytic light hit, the MIS weights and the continuation),
// each a launch that reads and writes [N] columns. Here one thread per lane
// does all of it in registers and writes each result once.
//
// Every value is the plain twin's, op by op and in its order (the file
// names each function of ops/ and render/ it follows): multiplies and adds
// round on their own (-fmad=false); divisions, reciprocals and roots are
// IEEE (-prec-div=true -prec-sqrt=true); a Python-number constant is the
// double rounded once to float32, as PyTorch casts it; `1.0 / x` is
// PyTorch's reciprocal and `3.0 / x` its reciprocal times 3; clamp_min,
// clamp, minimum and maximum keep a NaN operand (tclamp_min & co. below);
// sinf, cosf and powf are CUDA's own accurate routines, which PyTorch's
// CUDA sin, cos and pow call; subnormals are kept (-ftz=false), since the
// glossy lobe's flush to zero below FLT_MIN decides which queries run.
// The plain twin evaluates every light kind for every lane and keeps each
// lane's chosen light (lights._for_chosen_light); the kernel evaluates the
// chosen light only, with the same ops, so every lane gets the same value.
//
// What bounds it on the H100: bytes, at the lane counts of the main path.
// bounce_prepare reads ~25 words a lane (the hit, the draw set's rows,
// throughput, ray, time, the running result) and writes ~19 + 20 a light
// sample; bounce_resolve reads ~30 + 20 a light sample and writes 13. The
// arithmetic is a few hundred flops a lane plus a handful of sin, cos, pow
// and roots (chip_smoke.py counts both). Design: one thread per lane, no
// shared memory; the launch's constants are a by-value parameter
// (ShadeSpec), and the lights are the scene's device tables, built once
// with the scene (SceneData.light_table: a 28-byte record a light, its
// kind, its row of the kind's table, its chain and a mesh light's CDF
// run; SceneData.light_slots: every light's chain slots), read by pointer,
// so a lane's light choice indexes a table of any size and a chain of any
// depth runs; a link is evaluated where it is used (eval_link of
// xform.cuh, a deterministic function of the slot and the lane's time, so
// every use sees the same bits). A CUDA graph holds every launch; outputs
// are planes of [rows, N] (and [rows, nls, N]) so each output is one
// contiguous tensor.
#include <float.h>
#include <math.h>

#include "common.cuh"
#include "xform.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRowWidth = 16;  // tri_vert_rows: v0, v1, v2, then meta

// ops/brdf.py material kinds, models/scene.py light kinds
constexpr int KIND_LAMBERT = 0;
constexpr int KIND_GLOSSY = 1;
constexpr int KIND_REFLECTION = 2;
constexpr int KIND_EMITTER = 3;
constexpr int KIND_PHONG = 4;
constexpr int LIGHT_RECT = 0;
constexpr int LIGHT_SPHERE = 1;

// Python-number constants as PyTorch casts them: the double, rounded once
constexpr double kPiD = 3.14159265358979;  // ops/vec3.py PI
constexpr float kPi = (float)kPiD;
constexpr float kTwoPi = (float)(2.0 * kPiD);
constexpr float kFourPi = (float)(4.0 * kPiD);
constexpr float kInvPi = (float)(1.0 / kPiD);
constexpr float kPiOver4 = (float)(kPiD / 4.0);
constexpr float kTiny = (float)1e-37;
constexpr float kTiny12 = (float)1e-12;
constexpr float kPdfClamp = (float)1.0e10;  // render/lights.py PDF_CLAMP
constexpr float kFar = (float)1.0e30;       // RAY_TMAX
constexpr float kNear = (float)0.999;
constexpr float kInside = (float)1.00001;
constexpr float kFltMin = (float)1.1754943508222875e-38;  // brdf._FLT_MIN

// One light's record of SceneData.light_table (render/shade.py
// LIGHT_FIELDS)
struct ShadeLight {
    int32_t kind, idx, depth, chain0;  // chain: slots[chain0 ..], outermost first
    int32_t tri0, own, n_padded;       // a mesh light's CDF run
};

struct ShadeSpec {
    int32_t n_lights, nls, k, bounce, analytic, motion;
    float tmin, light_scale;
};

// Pointer slots of a launch (render/shade.py _PTRS names them alike)
enum Ptr : int {
    T_MAT_KIND, T_MAT_COLOR, T_MAT_PARAM, T_L_COLOR, T_L_POWER, T_L_SID,
    T_LIGHTS, T_L_SLOTS, T_RECT_CORNER, T_RECT_S1, T_RECT_S2, T_SPH_CENTER,
    T_SPH_RADIUS, T_CDF, T_VROWS, T_MESH_TOTAL, T_XF_TIMES, T_XF_T, T_XF_S,
    T_XF_R, T_XF_NK,
    L_HIT_T, L_HIT_VALID, L_HIT_MAT, L_NX, L_NY, L_NZ, L_CMOD, L_U, L_TPX,
    L_TPY, L_TPZ, L_ALIVE, L_NDIRAC, L_OX, L_OY, L_OZ, L_DX, L_DY, L_DZ,
    L_TIME, L_RX, L_RY, L_RZ,
    P_F_LANE, P_F_LS, P_I_LANE, P_I_LS, P_B_LANE, P_B_LS,
    Q_OCC, Q_BLOCKED, Q_VALID, Q_SID, Q_T, Q_N, R_F, R_B,
    kPtrs
};

struct Ptrs {
    const void* p[kPtrs];
};

// rows of the prepared planes (render/shade.py F_LANE, F_LS)
enum FLane : int {
    F_RES = 0, F_POS = 3, F_CMOD = 6, F_WC = 9, F_FC = 12, F_PDFC = 13,
    kFLane = 14
};
enum FLs : int {
    F_LPDF = 0, F_FL = 1, F_PDFL = 2, F_WL = 3, F_TMAXL = 6, F_WB = 7,
    F_FB = 10, F_PDFB = 11, F_TMAXB = 12, F_TL = 13, F_NL = 14, kFLs = 17
};

template <typename T>
__device__ __forceinline__ const T* in(const Ptrs& P, int k) {
    return static_cast<const T*>(P.p[k]);
}

template <typename T>
__device__ __forceinline__ T* out(const Ptrs& P, int k) {
    return static_cast<T*>(const_cast<void*>(P.p[k]));
}

// torch.clamp_min / clamp_max / minimum / maximum on the card: a NaN
// operand comes back as it is
__device__ __forceinline__ float tclamp_min(float v, float lo) {
    return isnan(v) ? v : fmaxf(v, lo);
}

__device__ __forceinline__ float tminimum(float a, float b) {
    return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}

__device__ __forceinline__ float tmaximum(float a, float b) {
    return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}

// PyTorch's reciprocal (`1.0 / t` is reciprocal(t) * 1.0)
__device__ __forceinline__ float rcp(float x) { return 1.0f / x; }

// ---- ops/vec3.py
__device__ __forceinline__ Vec add(const Vec& a, const Vec& b) {
    return {a.x + b.x, a.y + b.y, a.z + b.z};
}
__device__ __forceinline__ Vec sub(const Vec& a, const Vec& b) {
    return {a.x - b.x, a.y - b.y, a.z - b.z};
}
__device__ __forceinline__ Vec mul(const Vec& a, const Vec& b) {
    return {a.x * b.x, a.y * b.y, a.z * b.z};
}
__device__ __forceinline__ Vec muls(const Vec& a, float s) {
    return {a.x * s, a.y * s, a.z * s};
}
__device__ __forceinline__ Vec divv(const Vec& a, const Vec& b) {
    return {a.x / b.x, a.y / b.y, a.z / b.z};
}
__device__ __forceinline__ Vec divs(const Vec& a, float s) {
    return {a.x / s, a.y / s, a.z / s};
}
__device__ __forceinline__ Vec neg(const Vec& a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ Vec sel(bool m, const Vec& a, const Vec& b) {
    return {m ? a.x : b.x, m ? a.y : b.y, m ? a.z : b.z};
}
__device__ __forceinline__ float dot(const Vec& a, const Vec& b) {
    return (a.x * b.x + a.y * b.y) + a.z * b.z;
}
__device__ __forceinline__ Vec cross(const Vec& a, const Vec& b) {
    return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
            a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ Vec normalize(const Vec& v) {
    const float len2 = dot(v, v);
    const float inv = len2 > 0.0f ? rcp(sqrtf(tclamp_min(len2, kTiny))) : 1.0f;
    return muls(v, inv);
}
// x * v.x + y * v.y + z * v.z
__device__ __forceinline__ Vec from_local_frame(const Vec& v, const Vec& x,
                                                const Vec& y, const Vec& z) {
    return add(add(muls(x, v.x), muls(y, v.y)), muls(z, v.z));
}
__device__ __forceinline__ void make_coordinate_space(const Vec& normal,
                                                      Vec& x, Vec& y,
                                                      Vec& z) {
    z = normalize(normal);
    const bool not_y_axis = (z.x != 0.0f) || (z.z != 0.0f);
    const Vec up = {not_y_axis ? 0.0f : 1.0f, not_y_axis ? 1.0f : 0.0f,
                    0.0f};
    x = normalize(cross(up, z));
    y = cross(z, x);
}
__device__ __forceinline__ Vec load3(const float* t, int row) {
    return {t[row * 3], t[row * 3 + 1], t[row * 3 + 2]};
}

// ---- ops/warps.py
__device__ __forceinline__ float safe_div(float num, float den) {
    return num / (den == 0.0f ? 1.0f : den);
}
__device__ __forceinline__ void concentric_sample_disk(float u1, float u2,
                                                       float& dx, float& dy) {
    const float sx = 2.0f * u1 - 1.0f;
    const float sy = 2.0f * u2 - 1.0f;
    const bool ca = sx >= -sy, cb = sx > sy, cc = sx <= sy;
    const float q1 = safe_div(sy, sx);
    const float th1 = sy > 0.0f ? q1 : 8.0f + q1;
    const float th2 = 2.0f - safe_div(sx, sy);
    const float th3 = 4.0f - safe_div(sy, -sx);
    const float th4 = 6.0f + safe_div(sx, -sy);
    const float r = ca ? (cb ? sx : sy) : (cc ? -sx : -sy);
    float theta = ca ? (cb ? th1 : th2) : (cc ? th3 : th4);
    theta = theta * kPiOver4;
    const float x = r * cosf(theta);
    const float y = r * sinf(theta);
    const bool degenerate = (sx == 0.0f) && (sy == 0.0f);
    dx = degenerate ? 0.0f : x;
    dy = degenerate ? 0.0f : y;
}
__device__ __forceinline__ Vec uniform_to_sphere(float u1, float u2) {
    const float z = 1.0f - 2.0f * u1;
    const float radius = sqrtf(tclamp_min(1.0f - z * z, 0.0f));
    const float phi = kTwoPi * u2;
    return {radius * cosf(phi), radius * sinf(phi), z};
}
__device__ __forceinline__ Vec uniform_to_cosine_hemisphere(float u1,
                                                            float u2) {
    float dx, dy;
    concentric_sample_disk(u1, u2, dx, dy);
    const float z = sqrtf(tclamp_min((1.0f - dx * dx) - dy * dy, 0.0f));
    return {dx, dy, z};
}
__device__ __forceinline__ Vec uniform_to_cone(float u1, float u2,
                                               float cos_theta_max) {
    const float cos_theta = u1 * (cos_theta_max - 1.0f) + 1.0f;
    const float sin_theta =
        sqrtf(tclamp_min(1.0f - cos_theta * cos_theta, 0.0f));
    const float phi = kTwoPi * u2;
    return {cosf(phi) * sin_theta, sinf(phi) * sin_theta, cos_theta};
}
__device__ __forceinline__ float uniform_cone_pdf(float cos_theta_max) {
    return cos_theta_max >= 1.0f
               ? 0.0f
               : rcp(kTwoPi * tclamp_min(1.0f - cos_theta_max, kTiny));
}

// ---- ops/brdf.py
__device__ __forceinline__ float flush(float x) {
    return fabsf(x) < kFltMin ? 0.0f : x;
}
__device__ __forceinline__ bool same_hemisphere(float ni, float no) {
    return (ni > 0.0f && no > 0.0f) || (ni < 0.0f && no < 0.0f);
}
__device__ __forceinline__ void glossy_evaluate(const Vec& inc, const Vec& outg,
                                                const Vec& n, float e,
                                                float& f, float& pdf) {
    const float ni = dot(inc, n), no = dot(outg, n);
    const bool reject = same_hemisphere(ni, no);
    const bool near = dot(outg, inc) > kNear;
    const Vec half = sel(near, n, normalize(sub(outg, inc)));
    const float n_dot_h = fabsf(dot(n, half));
    const float lobe = flush(powf(tclamp_min(n_dot_h, 0.0f), e));
    const float d = flush(((e + 1.0f) * lobe) / kTwoPi);
    const float denom = 4.0f * fabsf((no + (-ni)) - no * (-ni));
    const float fv = flush(d / tclamp_min(denom, kTiny));
    const float o_dot_h = fabsf(dot(outg, half));
    const float pv = flush(d / tclamp_min(4.0f * o_dot_h, kTiny));
    f = reject ? 0.0f : fv;
    pdf = reject ? 0.0f : pv;
}
// evaluate_sa: Lambert, glossy, else (0, 0)
__device__ __forceinline__ void evaluate_sa(int kind, float e, const Vec& inc,
                                            const Vec& outg, const Vec& n,
                                            float& f, float& pdf) {
    if (kind == KIND_LAMBERT) {
        const float ni = dot(inc, n), no = dot(outg, n);
        const bool reject = same_hemisphere(ni, no);
        f = reject ? 0.0f : kInvPi;
        pdf = reject ? 0.0f : fabsf(ni) / kPi;
    } else if (kind == KIND_GLOSSY) {
        glossy_evaluate(inc, outg, n, e, f, pdf);
    } else {
        f = 0.0f;
        pdf = 0.0f;
    }
}
// sample_sa: the mirror, glossy, else Lambert; emitters and Phong give
// f = pdf = 0 (with Lambert's direction)
__device__ __forceinline__ Vec sample_sa(int kind, float e, const Vec& outg,
                                         const Vec& n, float u1, float u2,
                                         float& f, float& pdf) {
    Vec inc;
    if (kind == KIND_REFLECTION) {
        const float n_dot_o = dot(n, outg);
        const float sgn = n_dot_o < 0.0f ? 1.0f : -1.0f;
        inc = add(outg, muls(n, (2.0f * n_dot_o) * sgn));
        f = 1.0f;
        pdf = fabsf(dot(neg(inc), n));
    } else if (kind == KIND_GLOSSY) {
        const float phi = kTwoPi * u1;
        const float cos_theta =
            powf(tclamp_min(1.0f - u2, 0.0f), rcp(e + 1.0f));
        const float sin_theta =
            sqrtf(tclamp_min(1.0f - cos_theta * cos_theta, 0.0f));
        const Vec local = {sin_theta * cosf(phi), sin_theta * sinf(phi),
                           cos_theta};
        Vec x, y, z;
        make_coordinate_space(n, x, y, z);
        Vec half = from_local_frame(local, x, y, z);
        if (dot(outg, n) < 0.0f) half = neg(half);
        inc = sub(outg, muls(half, 2.0f * dot(outg, half)));
        glossy_evaluate(inc, outg, n, e, f, pdf);
    } else {
        const Vec local = neg(uniform_to_cosine_hemisphere(u1, u2));
        Vec x, y, z;
        make_coordinate_space(n, x, y, z);
        inc = from_local_frame(local, x, y, z);
        if (dot(outg, n) < 0.0f) inc = neg(inc);
        pdf = fabsf(dot(neg(inc), n)) / kPi;
        f = kInvPi;
        if (kind == KIND_EMITTER || kind == KIND_PHONG) {
            f = 0.0f;
            pdf = 0.0f;
        }
    }
    return inc;
}

// ops/mis.py power_heuristic(1.0, p1, 1.0, p2)
__device__ __forceinline__ float power_heuristic(float p1, float p2) {
    const float w1 = 1.0f * p1, w2 = 1.0f * p2;
    return (w1 * w1) / tclamp_min(w1 * w1 + w2 * w2, kTiny);
}

// ---- ops/intersect.py
__device__ __forceinline__ float sphere_intersect(const Vec& o, const Vec& d,
                                                  float tmin, float tcur,
                                                  const Vec& center,
                                                  float radius, bool& hit) {
    const Vec oc = sub(o, center);
    const float a = dot(d, d);
    const float b = 2.0f * dot(d, oc);
    const float c = dot(oc, oc) - radius * radius;
    const float disc = b * b - (4.0f * a) * c;
    const bool has_root = disc >= 0.0f;
    const float sq = sqrtf(tclamp_min(disc, 0.0f));
    const float q = b < 0.0f ? -0.5f * (b - sq) : -0.5f * (b + sq);
    const float t0 = q / a;
    const float t1 = q != 0.0f ? c / (q == 0.0f ? 1.0f : q) : tcur;
    const float lo = tminimum(t0, t1), hi = tmaximum(t0, t1);
    const bool valid_window = (lo < tcur) && (hi >= tmin);
    const bool use_lo = lo >= tmin;
    const bool use_hi = !use_lo && (hi < tcur);
    const float t = use_lo ? lo : hi;
    hit = has_root && valid_window && (use_lo || use_hi);
    return hit ? t : f_inf();
}
__device__ __forceinline__ float rect_intersect(const Vec& o, const Vec& d,
                                                float tmin, float tcur,
                                                const Vec& corner,
                                                const Vec& s1, const Vec& s2,
                                                bool& hit, Vec& nrm) {
    const Vec normal = normalize(cross(s1, s2));
    const float n_dot_d = dot(normal, d);
    const bool nonparallel = n_dot_d != 0.0f;
    const float t = (dot(corner, normal) - dot(o, normal)) /
                    (nonparallel ? n_dot_d : 1.0f);
    const bool in_range = (t < tcur) && (t >= tmin);
    const float s1_len = sqrtf(dot(s1, s1));
    const float s2_len = sqrtf(dot(s2, s2));
    const Vec s1n = divs(s1, tclamp_min(s1_len, kTiny));
    const Vec s2n = divs(s2, tclamp_min(s2_len, kTiny));
    const Vec rel = sub(add(o, muls(d, t)), corner);
    const float lx = dot(rel, s1n), ly = dot(rel, s2n);
    const bool inside =
        (lx >= 0.0f) && (lx <= s1_len) && (ly >= 0.0f) && (ly <= s2_len);
    hit = nonparallel && in_range && inside;
    nrm = sel(n_dot_d > 0.0f, neg(normal), normal);
    return hit ? t : f_inf();
}

// ---- ops/transform.py: a light's chain at the lane's time
struct Link {
    Vec tr, sc;
    Rot ro;
};

// A light's chain: depth slots of the scene's slot table, outermost
// first, each evaluated at the lane's time where it is used
struct Chain {
    int depth, k;
    const int32_t* slots;
    XfTables tb;
    float tm;
};

__device__ __forceinline__ Chain light_chain(const Ptrs& P,
                                             const ShadeSpec& s,
                                             const ShadeLight& L,
                                             const XfTables& tb, float tm) {
    return {L.depth, s.k, in<int32_t>(P, T_L_SLOTS) + L.chain0, tb, tm};
}
__device__ __forceinline__ Link link_at(const Chain& ch, int c) {
    Link l;
    eval_link(ch.tb, ch.k, ch.slots[c], ch.tm, l.tr, l.sc, l.ro);
    return l;
}
// local -> world, innermost link first
__device__ __forceinline__ Vec from_local_point(const Chain& ch, Vec p) {
    for (int c = ch.depth - 1; c >= 0; --c) {
        const Link l = link_at(ch, c);
        p = add(rotate(l.ro, mul(p, l.sc)), l.tr);
    }
    return p;
}
__device__ __forceinline__ Vec from_local_vector(const Chain& ch, Vec v) {
    for (int c = ch.depth - 1; c >= 0; --c) {
        const Link l = link_at(ch, c);
        v = rotate(l.ro, mul(v, l.sc));
    }
    return v;
}
__device__ __forceinline__ Vec from_local_normal(const Chain& ch, Vec n) {
    for (int c = ch.depth - 1; c >= 0; --c) n = rotate(link_at(ch, c).ro, n);
    return n;
}
// world -> local, outermost link first
__device__ __forceinline__ Vec to_local_point(const Chain& ch, Vec p) {
    for (int c = 0; c < ch.depth; ++c) {
        const Link l = link_at(ch, c);
        p = divv(unrotate(l.ro, sub(p, l.tr)), l.sc);
    }
    return p;
}
__device__ __forceinline__ Vec to_local_vector(const Chain& ch, Vec v) {
    for (int c = 0; c < ch.depth; ++c) {
        const Link l = link_at(ch, c);
        v = divv(unrotate(l.ro, v), l.sc);
    }
    return v;
}

// ---- render/lights.py, each lane's chosen light
struct Tables {
    const float *rect_corner, *rect_s1, *rect_s2, *sph_center, *sph_radius;
    const float *cdf, *vrows, *mesh_total;
};

// 3 / (4 pi r r): reciprocal, then times 3
__device__ __forceinline__ float sphere_sa_pdf(float radius) {
    return rcp((kFourPi * radius) * radius) * 3.0f;
}

// _sample_rect / _sample_sphere / _sample_mesh_light: (position, pdf)
__device__ __forceinline__ Vec sample_light(const ShadeLight& L,
                                            const Chain& ch, const Tables& t,
                                            const Vec& ref, float u1,
                                            float u2, float u3, float tmin,
                                            float& pdf) {
    const bool moves = ch.depth > 0;
    if (L.kind == LIGHT_RECT) {
        const Vec corner = load3(t.rect_corner, L.idx);
        const Vec s1 = load3(t.rect_s1, L.idx), s2 = load3(t.rect_s2, L.idx);
        Vec pos = add(add(corner, muls(s1, u1)), muls(s2, u2));
        if (moves) pos = from_local_point(ch, pos);
        Vec outv = sub(ref, pos);
        const float dist = sqrtf(tclamp_min(dot(outv, outv), kTiny));
        outv = divs(outv, dist);
        Vec nrm = cross(s1, s2);
        if (moves) nrm = from_local_vector(ch, nrm);
        const float area = sqrtf(tclamp_min(dot(nrm, nrm), kTiny));
        nrm = divs(nrm, area);
        if (dot(nrm, outv) < 0.0f) nrm = neg(nrm);
        const float p = (dist * dist) /
                        tclamp_min(area * fabsf(dot(nrm, outv)), kTiny);
        pdf = p > kPdfClamp ? 0.0f : p;
        return pos;
    }
    if (L.kind == LIGHT_SPHERE) {
        const Vec center = load3(t.sph_center, L.idx);
        const float radius = t.sph_radius[L.idx];
        const Vec local_ref = moves ? to_local_point(ch, ref) : ref;
        const Vec to_center = sub(center, local_ref);
        const float dist2 = dot(to_center, to_center);
        const bool inside = dist2 < (radius * radius) * kInside;
        // inside: uniform over the sphere
        const Vec n_in = uniform_to_sphere(u1, u2);
        const Vec n_in_w = moves ? from_local_normal(ch, n_in) : n_in;
        Vec pos_in = add(muls(n_in, radius), center);
        if (moves) pos_in = from_local_point(ch, pos_in);
        const Vec to_surf = sub(ref, pos_in);
        const float pdf_in =
            (dot(to_surf, to_surf) * sphere_sa_pdf(radius)) /
            tclamp_min(fabsf(dot(normalize(to_surf), n_in_w)), kTiny);
        // outside: the cone and its verification ray, in local space
        const float sin2 = (radius * radius) / tclamp_min(dist2, kTiny);
        const float cos_theta_max = sqrtf(tclamp_min(1.0f - sin2, 0.0f));
        Vec x, y, z;
        make_coordinate_space(to_center, x, y, z);
        const Vec cone = normalize(
            from_local_frame(uniform_to_cone(u1, u2, cos_theta_max), x, y, z));
        bool did_hit;
        const float t_hit = sphere_intersect(local_ref, cone, tmin, kFar,
                                             center, radius, did_hit);
        const float th = did_hit ? t_hit : dot(to_center, cone);
        const Vec pos_out_local = add(local_ref, muls(cone, th));
        Vec n_out = normalize(sub(pos_out_local, center));
        if (moves) n_out = from_local_normal(ch, n_out);
        const Vec pos_out =
            moves ? from_local_point(ch, pos_out_local) : pos_out_local;
        const float pdf_out = uniform_cone_pdf(cos_theta_max);
        const Vec pos = sel(inside, pos_in, pos_out);
        const Vec nrm = sel(inside, n_in_w, n_out);
        const float p = inside ? pdf_in : pdf_out;
        pdf = dot(nrm, sub(ref, pos)) >= 0.0f ? p : 0.0f;
        return pos;
    }
    // a mesh light: the triangle by area (the first cumulative area of the
    // mesh's own sorted run above u3 * total, torch.searchsorted's
    // right=True), then a uniform barycentric point
    const float total = t.mesh_total[L.idx];
    const float v = u3 * total;
    const float* cdf = t.cdf + L.tri0;
    int lo = 0, hi = L.own;
    while (lo < hi) {
        const int mid = lo + ((hi - lo) >> 1);
        if (!(cdf[mid] > v))
            lo = mid + 1;
        else
            hi = mid;
    }
    const int rel = min(lo, L.n_padded - 1);
    float r[9];
    if (L.n_padded > L.own && rel >= L.own) {
        for (int j = 0; j < 9; ++j) r[j] = 0.0f;
    } else {
        const float* row = t.vrows + (long long)(L.tri0 + rel) * kRowWidth;
        for (int j = 0; j < 9; ++j) r[j] = row[j];
    }
    const Vec p0 = {r[0], r[1], r[2]}, p1 = {r[3], r[4], r[5]},
              p2 = {r[6], r[7], r[8]};
    const float s = sqrtf(u1);
    const float alpha = 1.0f - s, beta = u2 * s;
    const float gamma = (1.0f - alpha) - beta;
    Vec pos = add(add(muls(p0, alpha), muls(p1, beta)), muls(p2, gamma));
    if (moves) pos = from_local_point(ch, pos);
    Vec nrm = cross(sub(p1, p0), sub(p2, p0));
    if (moves) nrm = from_local_normal(ch, nrm);
    nrm = normalize(nrm);
    const Vec to_surf = sub(ref, pos);
    const float p =
        (dot(to_surf, to_surf) * rcp(tclamp_min(total, kTiny))) /
        tclamp_min(fabsf(dot(normalize(to_surf), nrm)), kTiny);
    pdf = dot(nrm, to_surf) >= 0.0f ? p : 0.0f;
    return pos;
}

// _hit_analytic_kind: (t, world normal, hit) of a rect or sphere light
__device__ __forceinline__ float light_hit_analytic(
    const ShadeLight& L, const Chain& ch, const Tables& t, const Vec& o,
    const Vec& d, float tmin, Vec& n_world, bool& hit) {
    const bool moves = ch.depth > 0;
    const Vec o_l = moves ? to_local_point(ch, o) : o;
    const Vec d_l = moves ? to_local_vector(ch, d) : d;
    float th;
    Vec nrm;
    if (L.kind == LIGHT_RECT) {
        th = rect_intersect(o_l, d_l, tmin, kFar, load3(t.rect_corner, L.idx),
                            load3(t.rect_s1, L.idx), load3(t.rect_s2, L.idx),
                            hit, nrm);
    } else {
        const Vec center = load3(t.sph_center, L.idx);
        th = sphere_intersect(o_l, d_l, tmin, kFar, center,
                              t.sph_radius[L.idx], hit);
        nrm = normalize(sub(add(o_l, muls(d_l, hit ? th : 0.0f)), center));
    }
    n_world = moves ? from_local_normal(ch, nrm) : nrm;
    return th;
}

// _intersect_pdf_kind: the MIS pdf of reaching the light by BRDF sampling
__device__ __forceinline__ float light_intersect_pdf(
    const ShadeLight& L, const Chain& ch, const Tables& t, const Vec& ro,
    const Vec& rd, float th, const Vec& hn) {
    const bool moves = ch.depth > 0;
    if (L.kind == LIGHT_RECT) {
        Vec s1 = load3(t.rect_s1, L.idx), s2 = load3(t.rect_s2, L.idx);
        if (moves) {
            s1 = from_local_vector(ch, s1);
            s2 = from_local_vector(ch, s2);
        }
        const Vec c = cross(s1, s2);
        const float area = sqrtf(tclamp_min(dot(c, c), kTiny));
        const float p =
            (th * th) / tclamp_min(fabsf(dot(hn, neg(rd))) * area, kTiny);
        return p > kPdfClamp ? 0.0f : p;
    }
    const Vec to_surf = sub(ro, add(ro, muls(rd, th)));
    if (L.kind == LIGHT_SPHERE) {
        const Vec center = load3(t.sph_center, L.idx);
        const float radius = t.sph_radius[L.idx];
        const Vec to_center = sub(center, moves ? to_local_point(ch, ro) : ro);
        const float dist2 = dot(to_center, to_center);
        const bool inside = dist2 < (radius * radius) * kInside;
        const float pdf_in =
            (dot(to_surf, to_surf) * sphere_sa_pdf(radius)) /
            tclamp_min(fabsf(dot(normalize(to_surf), hn)), kTiny);
        const float sin2 = (radius * radius) / tclamp_min(dist2, kTiny);
        const float cos_theta_max = sqrtf(tclamp_min(1.0f - sin2, 0.0f));
        return inside ? pdf_in : uniform_cone_pdf(cos_theta_max);
    }
    const float total = t.mesh_total[L.idx];
    return (dot(to_surf, to_surf) / tclamp_min(total, kTiny)) /
           tclamp_min(fabsf(dot(normalize(to_surf), hn)), kTiny);
}

__device__ __forceinline__ Tables tables(const Ptrs& P) {
    return {in<float>(P, T_RECT_CORNER), in<float>(P, T_RECT_S1),
            in<float>(P, T_RECT_S2),     in<float>(P, T_SPH_CENTER),
            in<float>(P, T_SPH_RADIUS),  in<float>(P, T_CDF),
            in<float>(P, T_VROWS),       in<float>(P, T_MESH_TOTAL)};
}

__device__ __forceinline__ XfTables xf_tables(const Ptrs& P) {
    return {in<float>(P, T_XF_TIMES), in<float>(P, T_XF_T),
            in<float>(P, T_XF_S), in<float>(P, T_XF_R),
            in<int32_t>(P, T_XF_NK)};
}

__device__ __forceinline__ Vec lane3(const Ptrs& P, int k, int i) {
    return {in<float>(P, k)[i], in<float>(P, k + 1)[i],
            in<float>(P, k + 2)[i]};
}

// One plane row of a [rows, N] (or [rows, nls, N]) output
__device__ __forceinline__ void put3(float* base, long long stride, int row,
                                     long long i, const Vec& v) {
    base[row * stride + i] = v.x;
    base[(row + 1) * stride + i] = v.y;
    base[(row + 2) * stride + i] = v.z;
}

__global__ void __launch_bounds__(kThreads)
bounce_prepare_kernel(const __grid_constant__ ShadeSpec spec,
                      const __grid_constant__ Ptrs P, int n) {
    const int i = blockIdx.x * kThreads + threadIdx.x;
    if (i >= n) return;
    const Tables tb = tables(P);
    const XfTables xt = xf_tables(P);
    const long long N = n;
    // the material row and the glossy exponent (_mat_lookup)
    const int32_t mat = in<int32_t>(P, L_HIT_MAT)[i];
    const int mid = max(mat, 0);
    const int kind = in<int32_t>(P, T_MAT_KIND)[mid];
    const Vec color = load3(in<float>(P, T_MAT_COLOR), mid);
    const float param = in<float>(P, T_MAT_PARAM)[mid];
    const float e =
        kind == KIND_GLOSSY ? rcp(tclamp_min(param * param, kTiny12)) : 1.0f;
    // the emission gate: camera-visible or through a pure-Dirac chain
    bool lane = in<uint8_t>(P, L_ALIVE)[i] && in<uint8_t>(P, L_HIT_VALID)[i];
    int32_t ndirac = in<int32_t>(P, L_NDIRAC)[i];
    const bool gate = lane && (spec.bounce == 0 || ndirac == spec.bounce);
    const Vec tp = lane3(P, L_TPX, i);
    const float pw = (kind == KIND_EMITTER && mat >= 0) ? param : 0.0f;
    const Vec emit = mul(tp, muls(color, pw));
    const Vec res0 = lane3(P, L_RX, i);
    const Vec res = add(res0, sel(gate, emit, Vec{0.0f, 0.0f, 0.0f}));
    lane = lane && kind != KIND_EMITTER;  // emitters end the path
    const bool is_dirac = kind == KIND_REFLECTION && lane;
    ndirac = ndirac + (is_dirac ? 1 : 0);

    const float t = in<float>(P, L_HIT_T)[i];
    const Vec o = lane3(P, L_OX, i), d = lane3(P, L_DX, i);
    const Vec position = add(o, muls(d, t));
    const Vec outgoing = neg(d);
    const Vec normal = lane3(P, L_NX, i);
    const Vec cmod = muls(color, in<float>(P, L_CMOD)[i]);
    const float* u = in<float>(P, L_U);
    const ShadeLight* lights = in<ShadeLight>(P, T_LIGHTS);
    const float tm = spec.motion ? in<float>(P, L_TIME)[i] : 0.0f;
    const float tmin = spec.tmin;
    const bool nee_lane = lane && !is_dirac;

    float* fls = out<float>(P, P_F_LS);
    int32_t* ils = out<int32_t>(P, P_I_LS);
    uint8_t* bls = out<uint8_t>(P, P_B_LS);
    const long long S = (long long)spec.nls * N;  // one [nls, N] plane
    for (int lsi = 0; lsi < spec.nls; ++lsi) {
        const long long j = lsi * N + i;
        const float* ul = u + 6LL * lsi * N + i;
        const float liu = ul[0], lsu = ul[N], lsv = ul[2 * N],
                    leu = ul[3 * N], bsu = ul[4 * N], bsv = ul[5 * N];
        const int li =
            min((int32_t)(liu * (float)spec.n_lights), spec.n_lights - 1);
        const ShadeLight L = lights[li];
        const Chain ch = light_chain(P, spec, L, xt, tm);
        float lpdf;
        const Vec lp = sample_light(L, ch, tb, position, lsu, lsv, leu, tmin,
                                    lpdf);
        // the light-sampled direction
        Vec light_in = sub(position, lp);
        const float dist = sqrtf(tclamp_min(dot(light_in, light_in), kTiny));
        light_in = divs(light_in, dist);
        float f_l, pdf_l;
        evaluate_sa(kind, e, light_in, outgoing, normal, f_l, pdf_l);
        const bool ok_l =
            nee_lane && (lpdf > 0.0f) && (f_l > 0.0f) && (pdf_l > 0.0f);
        const float tmax_l = ok_l ? dist - tmin : 0.0f;
        // the BRDF-sampled direction toward the same light
        float f_b, pdf_b;
        const Vec b_in = sample_sa(kind, e, outgoing, normal, bsu, bsv, f_b,
                                   pdf_b);
        const Vec wb = neg(b_in);
        bool ok_b = nee_lane && (pdf_b > 0.0f) && (f_b > 0.0f);
        float tmax_b;
        if (spec.analytic) {
            Vec n_l;
            bool l_hit;
            const float t_l =
                light_hit_analytic(L, ch, tb, position, wb, tmin, n_l, l_hit);
            ok_b = ok_b && l_hit;
            tmax_b = ok_b ? (l_hit ? t_l : 0.0f) - tmin : 0.0f;
            fls[F_TL * S + j] = t_l;
            put3(fls, S, F_NL, j, n_l);
        } else {
            tmax_b = ok_b ? kFar : tmin;
        }
        ils[j] = li;
        fls[F_LPDF * S + j] = lpdf;
        fls[F_FL * S + j] = f_l;
        fls[F_PDFL * S + j] = pdf_l;
        put3(fls, S, F_WL, j, neg(light_in));
        fls[F_TMAXL * S + j] = tmax_l;
        put3(fls, S, F_WB, j, wb);
        fls[F_FB * S + j] = f_b;
        fls[F_PDFB * S + j] = pdf_b;
        fls[F_TMAXB * S + j] = tmax_b;
        bls[j] = ok_l ? 1 : 0;
        bls[S + j] = ok_b ? 1 : 0;
    }
    // the continuation's BRDF sample: the draw set's last two rows
    float f_c, pdf_c;
    const float* uc = u + 6LL * spec.nls * N + i;
    const Vec incoming = sample_sa(kind, e, outgoing, normal, uc[0], uc[N],
                                   f_c, pdf_c);
    float* fl = out<float>(P, P_F_LANE);
    put3(fl, N, F_RES, i, res);
    put3(fl, N, F_POS, i, position);
    put3(fl, N, F_CMOD, i, cmod);
    put3(fl, N, F_WC, i, neg(incoming));
    fl[F_FC * N + i] = f_c;
    fl[F_PDFC * N + i] = pdf_c;
    out<int32_t>(P, P_I_LANE)[i] = ndirac;
    out<uint8_t>(P, P_B_LANE)[i] = lane ? 1 : 0;
}

__global__ void __launch_bounds__(kThreads)
bounce_resolve_kernel(const __grid_constant__ ShadeSpec spec,
                      const __grid_constant__ Ptrs P, int n) {
    const int i = blockIdx.x * kThreads + threadIdx.x;
    if (i >= n) return;
    const Tables tb = tables(P);
    const XfTables xt = xf_tables(P);
    const long long N = n;
    const long long S = (long long)spec.nls * N;
    const float* fl = in<float>(P, P_F_LANE);
    const float* fls = in<float>(P, P_F_LS);
    const int32_t* ils = in<int32_t>(P, P_I_LS);
    const uint8_t* bls = in<uint8_t>(P, P_B_LS);
    auto lane_row3 = [&](int row) {
        return Vec{fl[row * N + i], fl[(row + 1) * N + i],
                   fl[(row + 2) * N + i]};
    };
    auto ls_row3 = [&](int row, long long j) {
        return Vec{fls[row * S + j], fls[(row + 1) * S + j],
                   fls[(row + 2) * S + j]};
    };
    Vec res = lane_row3(F_RES);
    const Vec position = lane_row3(F_POS);
    const Vec cmod = lane_row3(F_CMOD);
    const Vec normal = lane3(P, L_NX, i);
    const Vec tp = lane3(P, L_TPX, i);
    const float tm = spec.motion ? in<float>(P, L_TIME)[i] : 0.0f;
    const ShadeLight* lights = in<ShadeLight>(P, T_LIGHTS);
    if (spec.nls > 0) {
        Vec acc = {0.0f, 0.0f, 0.0f};
        const uint8_t* occ = in<uint8_t>(P, Q_OCC);
        for (int lsi = 0; lsi < spec.nls; ++lsi) {
            const long long j = lsi * N + i;
            const int li = ils[j];
            const ShadeLight L = lights[li];
            const float pw = in<float>(P, T_L_POWER)[li];
            const Vec emitted = muls(load3(in<float>(P, T_L_COLOR), li), pw);
            const bool ok_b = bls[S + j] != 0;
            bool hit_light;
            float t_l;
            Vec n_l;
            if (spec.analytic) {
                hit_light = ok_b && !in<uint8_t>(P, Q_BLOCKED)[j];
                t_l = fls[F_TL * S + j];
                n_l = ls_row3(F_NL, j);
            } else {
                hit_light = ok_b && in<uint8_t>(P, Q_VALID)[j] &&
                            in<int32_t>(P, Q_SID)[j] ==
                                in<int32_t>(P, T_L_SID)[li];
                t_l = in<float>(P, Q_T)[j];
                const float* qn = in<float>(P, Q_N);
                n_l = {qn[j], qn[S + j], qn[2 * S + j]};
            }
            const float lpdf = fls[F_LPDF * S + j];
            const bool ok_l = bls[j] && !occ[j];
            const float w_l = power_heuristic(lpdf, fls[F_PDFL * S + j]);
            const float gain_l =
                ok_l ? ((fls[F_FL * S + j] *
                         fabsf(dot(ls_row3(F_WL, j), normal))) *
                        w_l) /
                           tclamp_min(lpdf, kTiny)
                     : 0.0f;
            const Vec ec = mul(emitted, cmod);
            acc = add(acc, muls(ec, gain_l));
            const Chain ch = light_chain(P, spec, L, xt, tm);
            const Vec wb = ls_row3(F_WB, j);
            const float lpdf_b =
                light_intersect_pdf(L, ch, tb, position, wb, t_l, n_l);
            const bool okb = hit_light && lpdf_b > 0.0f;
            const float pdf_b = fls[F_PDFB * S + j];
            const float w_b = power_heuristic(pdf_b, lpdf_b);
            const float gain_b =
                okb ? ((fls[F_FB * S + j] * fabsf(dot(wb, normal))) * w_b) /
                          tclamp_min(pdf_b, kTiny)
                    : 0.0f;
            acc = add(acc, muls(ec, gain_b));
        }
        res = add(res, muls(mul(tp, acc), spec.light_scale));
    }
    // the path continuation
    const bool lane = in<uint8_t>(P, P_B_LANE)[i] != 0;
    const float pdf_c = fl[F_PDFC * N + i];
    const Vec wc = lane_row3(F_WC);
    const bool cont = lane && pdf_c > 0.0f;
    const float gain_c =
        cont ? (fl[F_FC * N + i] * fabsf(dot(wc, normal))) /
                   tclamp_min(pdf_c, kTiny)
             : 1.0f;
    const Vec o = lane3(P, L_OX, i), d = lane3(P, L_DX, i);
    float* r = out<float>(P, R_F);
    put3(r, N, 0, i, res);
    put3(r, N, 3, i, sel(cont, muls(mul(tp, cmod), gain_c), tp));
    put3(r, N, 6, i, sel(cont, position, o));
    put3(r, N, 9, i, sel(cont, wc, d));
    out<uint8_t>(P, R_B)[i] = cont ? 1 : 0;
}

// The constants, and the light table wherever a lane picks a light (the
// records themselves are the scene's, built with it: render/shade.py
// light_records)
int check_spec(const ShadeSpec* s, const void* const* ptrs) {
    if (s->n_lights < 0 || s->nls < 0 || (s->nls > 0 && s->n_lights < 1) ||
        s->k < 1 || (s->nls > 0 && ptrs[T_LIGHTS] == nullptr))
        return (int)cudaErrorInvalidValue;
    return 0;
}

}  // namespace

extern "C" int rt_shade_spec_bytes() { return (int)sizeof(ShadeSpec); }
extern "C" int rt_shade_ptrs() { return (int)kPtrs; }

// One launch of bounce_prepare (resolve = 0) or bounce_resolve (resolve =
// 1) over n lanes. spec is a ShadeSpec and ptrs an array of kPtrs device
// pointers, both in host memory (types of this file's own, so passed as
// void*); a pointer the launch does not read is null (the slot table of a
// scene where no light moves).
extern "C" int rt_shade(const void* spec_ptr, const void* const* ptrs,
                        int resolve, int n, void* stream) {
    const ShadeSpec* spec = static_cast<const ShadeSpec*>(spec_ptr);
    const int bad = check_spec(spec, ptrs);
    if (bad || n < 0) return bad ? bad : (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaGetLastError();
    Ptrs P;
    for (int k = 0; k < kPtrs; ++k) P.p[k] = ptrs[k];
    const int blocks = (n + kThreads - 1) / kThreads;
    if (resolve)
        bounce_resolve_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
            *spec, P, n);
    else
        bounce_prepare_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
            *spec, P, n);
    return (int)cudaGetLastError();
}
