// analytic_fold: the analytic shapes of one query (every plane, sphere and
// rect of the scene) in one launch, closest hit or any hit, each lane
// evaluating each keyed shape's transform chain at its own time.
//
// Replaces no pallas_call: it is the reference's XLA fold over its analytic
// shapes (rayito_tpu/render/trace.py:176-387, _analytic_occluded :777).
// The port's plain twin is render/trace.py's _planes_candidate,
// _spheres_candidate, _rects_candidate and their fold in scene_intersect
// (closest hit), and _analytic_occluded (any hit): per batch of rows a
// [rows, N] test, an argmin, gathers and torch.where merges, and per keyed
// row its own batch through ops/transform.py's ~190 elementwise kernels.
// Here one thread per lane keeps all of it in registers and writes the
// folded record once.
//
// Per lane, in the plain twin's row order (every plane row, then every
// sphere row, then every rect row, ascending), the same values:
//   1. the ray in the row's local space: a row with a keyed slot in a
//      moving scene evaluates the slot's chain outermost link first
//      (eval_link, unrotate, qmul of xform.cuh, as fold_small.cu); rows of
//      one slot in a row reuse the local ray; every other row tests the
//      world ray with the identity rotation;
//   2. the row's test of ops/intersect.py in its operation order
//      (plane_intersect, sphere_intersect, rect_intersect: the q != 0
//      guard, IEEE roots, NaN-propagating minimum and maximum) with the
//      query's tmax as tcur; t is +inf on a miss, never NaN;
//   3. closest hit: the running winner changes only on a strict <, so the
//      first of tied minima wins: the lowest row, and between kinds the
//      earlier kind, which is what the batched argmin (the first minimum)
//      and the strict < of _RowFold.take and of scene_intersect's fold
//      give. Any hit: the lane stops at its first hit.
// The closest hit's record is rebuilt from the winner's local ray: a
// plane's normal with the bullseye ring measured at the local hit
// position (remainder(|p - pos| / 4, 1) > 0.5 gives color_mod 0.2), a
// sphere's normalised (o + d t) - centre, a rect's normal flipped toward
// the viewer; in a moving scene the normal leaves through the winner's
// world-from-local rotation (the identity for a static row, as the twin
// rotates it). A lane no row hits keeps the state it came in with: the
// fold's start (t = inf, id and material -1, normal 0, color_mod 1) on a
// query's first launch, the previous launch's record on a chained one.
//
// What bounds it on the H100: at the lane counts of the main path, bytes
// and instructions are of one size (chip_smoke.py counts both): ~32 bytes
// a lane in (ray, tmax, time) and 28 out (t, id, material, normal,
// color_mod); ~30-60 float instructions per row test and ~130 per link
// of a chain. Design: one thread per lane, no shared memory; the row
// list, each row's chain, the chains' slots and the kinds' counts are a
// __grid_constant__ spec (AfSpec), the shape and transform tables small device tensors read
// at uniform addresses (L1 broadcasts), so a CUDA graph holds the launch.
// Rows past the spec's limits (rows, distinct chains, chain slots) go to a
// further launch that folds into this one's outputs. Build with
// -fmad=false -prec-div=true -prec-sqrt=true: every multiply and add
// rounds on its own, divisions and square roots are IEEE, so every output
// equals the plain twin's bit for bit.
//
// Counters (tracing on; render/trace.py passes the int64 slots of
// utils/tracing.py): the row tests each lane ran, by kind (a lane of an
// any-hit query counts up to its first hit; a lane that a chained launch
// finds occluded runs none), and the lanes of the query (added by its
// first launch only), summed per block and added once per block. With
// null pointers the kernel is the uncounted instance: no add, no
// reduction.
#include <math.h>

#include "common.cuh"
#include "xform.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxRows = 128;
constexpr int kMaxChains = 32;
constexpr int kMaxSlots = 256;
constexpr int kPlane = 0;
constexpr int kSphere = 1;
constexpr int kRect = 2;
constexpr float kTiny = (float)1e-37;  // vec3.normalize's clamp
constexpr float kRingDark = (float)0.2;

struct AfChain {
    int32_t start, depth;  // slots[start ..], outermost first
};

// One launch's rows: counts and first table rows of the planes, spheres and
// rects it folds (in that order), each row's chain (an index into chains,
// -1 for the world ray), the chains' slots, and the scene's constants.
struct AfSpec {
    int32_t count[3], first[3];
    int32_t sphere_id0, rect_id0, k, motion, n_chain, n_slot;
    int8_t chain[kMaxRows];
    AfChain chains[kMaxChains];
    int32_t slots[kMaxSlots];
};

// Pointer slots of a launch (render/trace.py _AF_PTRS names them alike).
// S_*: the state a chained launch folds into (null on a query's first);
// O_*: its outputs. Closest hit reads and writes T .. CMOD, any hit OCC.
enum Ptr : int {
    T_PLN_POS, T_PLN_NORMAL, T_PLN_MAT, T_PLN_BULLSEYE,
    T_SPH_CENTER, T_SPH_RADIUS, T_SPH_MAT,
    T_RECT_CORNER, T_RECT_S1, T_RECT_S2, T_RECT_MAT,
    T_XF_TIMES, T_XF_T, T_XF_S, T_XF_R, T_XF_NK,
    L_OX, L_OY, L_OZ, L_DX, L_DY, L_DZ, L_TMAX, L_TIME,
    S_T, S_ID, S_MAT, S_N, S_CMOD, S_OCC,
    O_T, O_ID, O_MAT, O_N, O_CMOD, O_OCC,
    kPtrs
};

struct Ptrs {
    const void* p[kPtrs];
};

struct AfCounters {
    unsigned long long* tests[3];  // analytic_fold.tests.plane, .sphere, .rect
    unsigned long long* lanes;     // analytic_fold.lanes.closest or .any
};

template <typename T>
__device__ __forceinline__ const T* in(const Ptrs& P, int k) {
    return static_cast<const T*>(P.p[k]);
}

template <typename T>
__device__ __forceinline__ T* out(const Ptrs& P, int k) {
    return static_cast<T*>(const_cast<void*>(P.p[k]));
}

__device__ __forceinline__ Vec row3(const Ptrs& P, int k, int r) {
    const float* a = in<float>(P, k) + 3 * r;
    return {a[0], a[1], a[2]};
}

// ops/vec3.py dot and cross
__device__ __forceinline__ float dot3(const Vec& a, const Vec& b) {
    return (a.x * b.x + a.y * b.y) + a.z * b.z;
}

__device__ __forceinline__ Vec cross3(const Vec& a, const Vec& b) {
    return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
            a.x * b.y - a.y * b.x};
}

// o + d * t
__device__ __forceinline__ Vec along(const Vec& o, const Vec& d, float t) {
    return {o.x + d.x * t, o.y + d.y * t, o.z + d.z * t};
}

// torch.clamp_min on the card: a NaN operand comes back as it is
__device__ __forceinline__ float tclamp_min(float v, float lo) {
    return isnan(v) ? v : ::fmaxf(v, lo);
}

// vec3.normalize: v * (1 / sqrt(max(len2, 1e-37)) where len2 > 0, else 1)
__device__ __forceinline__ Vec normalize3(const Vec& v) {
    const float len2 = dot3(v, v);
    const float inv =
        len2 > 0.0f ? 1.0f / sqrtf(tclamp_min(len2, kTiny)) : 1.0f;
    return {v.x * inv, v.y * inv, v.z * inv};
}

// ops/intersect.py plane_intersect: t, +inf on a miss
__device__ __forceinline__ float plane_t(const Ptrs& P, int r, const Vec& o,
                                         const Vec& d, float tmin,
                                         float tcur) {
    const Vec pos = row3(P, T_PLN_POS, r), nrm = row3(P, T_PLN_NORMAL, r);
    const float ndd = dot3(nrm, d);
    const float t =
        (dot3(pos, nrm) - dot3(o, nrm)) / (ndd == 0.0f ? 1.0f : ndd);
    return (ndd < 0.0f && t < tcur && t >= tmin) ? t : f_inf();
}

// ops/intersect.py sphere_intersect: the nearest root in [tmin, tcur)
__device__ __forceinline__ float sphere_t(const Ptrs& P, int r,
                                          const Vec& o, const Vec& d,
                                          float tmin, float tcur) {
    const Vec c = row3(P, T_SPH_CENTER, r);
    const float rad = in<float>(P, T_SPH_RADIUS)[r];
    const Vec oc = {o.x - c.x, o.y - c.y, o.z - c.z};
    const float a = dot3(d, d);
    const float b = 2.0f * dot3(d, oc);
    const float cc = dot3(oc, oc) - rad * rad;
    const float disc = b * b - (4.0f * a) * cc;
    const float sq = sqrtf(tclamp_min(disc, 0.0f));
    const float q = b < 0.0f ? -0.5f * (b - sq) : -0.5f * (b + sq);
    const float t0 = q / a;
    const float t1 = q != 0.0f ? cc / (q == 0.0f ? 1.0f : q) : tcur;
    const float lo = nan_min(t0, t1), hi = nan_max(t0, t1);
    const bool use_lo = lo >= tmin;
    const bool use_hi = !use_lo && hi < tcur;
    const bool hit = disc >= 0.0f && lo < tcur && hi >= tmin &&
                     (use_lo || use_hi);
    return hit ? (use_lo ? lo : hi) : f_inf();
}

// rect_intersect's unit normal of rect r: normalize(cross(side1, side2))
__device__ __forceinline__ Vec rect_normal(const Ptrs& P, int r) {
    return normalize3(cross3(row3(P, T_RECT_S1, r), row3(P, T_RECT_S2, r)));
}

// ops/intersect.py rect_intersect: t, +inf on a miss
__device__ __forceinline__ float rect_t(const Ptrs& P, int r, const Vec& o,
                                        const Vec& d, float tmin,
                                        float tcur) {
    const Vec corner = row3(P, T_RECT_CORNER, r);
    const Vec s1 = row3(P, T_RECT_S1, r), s2 = row3(P, T_RECT_S2, r);
    const Vec nrm = normalize3(cross3(s1, s2));
    const float ndd = dot3(nrm, d);
    const bool nonparallel = ndd != 0.0f;
    const float t =
        (dot3(corner, nrm) - dot3(o, nrm)) / (nonparallel ? ndd : 1.0f);
    const float s1_len = sqrtf(dot3(s1, s1));
    const float s2_len = sqrtf(dot3(s2, s2));
    const float c1 = tclamp_min(s1_len, kTiny);
    const float c2 = tclamp_min(s2_len, kTiny);
    const Vec s1n = {s1.x / c1, s1.y / c1, s1.z / c1};
    const Vec s2n = {s2.x / c2, s2.y / c2, s2.z / c2};
    const Vec p = along(o, d, t);
    const Vec rel = {p.x - corner.x, p.y - corner.y, p.z - corner.z};
    const float lx = dot3(rel, s1n), ly = dot3(rel, s2n);
    const bool hit = nonparallel && t < tcur && t >= tmin && lx >= 0.0f &&
                     lx <= s1_len && ly >= 0.0f && ly <= s2_len;
    return hit ? t : f_inf();
}

// ops/transform.py ray_to_local_chain: the world ray through chain c,
// outermost link first, and the composed world-from-local rotation.
__device__ __forceinline__ void local_ray(const AfSpec& spec,
                                          const XfTables& tb, int c,
                                          float tm, const Vec& o,
                                          const Vec& d, Vec& lo, Vec& ld,
                                          Rot& rot) {
    lo = o;
    ld = d;
    rot = {1.0f, 0.0f, 0.0f, 0.0f};
    if (c < 0) return;
    const AfChain& ch = spec.chains[c];
    for (int l = 0; l < ch.depth; ++l) {
        Vec tr, sc;
        Rot ro;
        eval_link(tb, spec.k, spec.slots[ch.start + l], tm, tr, sc, ro);
        const Vec po = unrotate(ro, {lo.x - tr.x, lo.y - tr.y, lo.z - tr.z});
        const Vec pd = unrotate(ro, ld);
        lo = {po.x / sc.x, po.y / sc.y, po.z / sc.z};
        ld = {pd.x / sc.x, pd.y / sc.y, pd.z / sc.z};
        rot = l == 0 ? ro : qmul(rot, ro);
    }
}

// The running winner of a closest-hit walk: its t, kind and table row,
// and the local ray and rotation it was found with.
struct Winner {
    float t;
    int kind, row;
    Vec o, d;
    Rot rot;
};

// One kind's rows of the launch, rows r0.. of the spec's chain list; adds
// the row tests it runs to tests[kKind].
template <int kKind, bool kAnyHit>
__device__ __forceinline__ bool walk_kind(const AfSpec& spec,
                                          const Ptrs& P, const XfTables& tb,
                                          int r0, float tm, const Vec& o,
                                          const Vec& d, float tmin,
                                          float tmax, int& cur, Vec& lo,
                                          Vec& ld, Rot& lrot, Winner& w,
                                          int (&tests)[3]) {
    const int first = spec.first[kKind];
    for (int j = 0; j < spec.count[kKind]; ++j) {
        const int c = spec.chain[r0 + j];
        if (c != cur) {
            cur = c;
            local_ray(spec, tb, c, tm, o, d, lo, ld, lrot);
        }
        const int row = first + j;
        const float t =
            kKind == kPlane
                ? plane_t(P, row, lo, ld, tmin, tmax)
                : (kKind == kSphere ? sphere_t(P, row, lo, ld, tmin, tmax)
                                    : rect_t(P, row, lo, ld, tmin, tmax));
        if (kAnyHit) {
            if (t < f_inf()) {  // t is finite exactly on a hit
                tests[kKind] += j + 1;
                return true;
            }
        } else if (t < w.t) {
            w = {t, kKind, row, lo, ld, lrot};
        }
    }
    tests[kKind] += spec.count[kKind];
    return false;
}

// Lane i's fold over the launch's rows, its record or occlusion written;
// adds the row tests it runs to tests.
template <bool kAnyHit>
__device__ __forceinline__ void fold_lane(const AfSpec& spec, const Ptrs& P,
                                          float tmin, int n, int i,
                                          int (&tests)[3]) {
    const Vec o = {in<float>(P, L_OX)[i], in<float>(P, L_OY)[i],
                   in<float>(P, L_OZ)[i]};
    const Vec d = {in<float>(P, L_DX)[i], in<float>(P, L_DY)[i],
                   in<float>(P, L_DZ)[i]};
    const float tmax = in<float>(P, L_TMAX)[i];
    const float* time = in<float>(P, L_TIME);
    const float tm = time != nullptr ? time[i] : 0.0f;
    const XfTables tb = {in<float>(P, T_XF_TIMES), in<float>(P, T_XF_T),
                         in<float>(P, T_XF_S), in<float>(P, T_XF_R),
                         in<int32_t>(P, T_XF_NK)};
    const float* t_in = in<float>(P, S_T);
    const uint8_t* occ_in = in<uint8_t>(P, S_OCC);
    Winner w = {kAnyHit ? 0.0f : (t_in != nullptr ? t_in[i] : f_inf()), -1,
                -1};
    int cur = -1;  // the chain of the local ray below (-1: the world ray)
    Vec lo = o, ld = d;
    Rot lrot = {1.0f, 0.0f, 0.0f, 0.0f};
    bool occ = kAnyHit && occ_in != nullptr && occ_in[i] != 0;
    if (!occ) {
        const int r1 = spec.count[kPlane], r2 = r1 + spec.count[kSphere];
        occ = walk_kind<kPlane, kAnyHit>(spec, P, tb, 0, tm, o, d, tmin,
                                         tmax, cur, lo, ld, lrot, w,
                                         tests) ||
              walk_kind<kSphere, kAnyHit>(spec, P, tb, r1, tm, o, d, tmin,
                                          tmax, cur, lo, ld, lrot, w,
                                          tests) ||
              walk_kind<kRect, kAnyHit>(spec, P, tb, r2, tm, o, d, tmin,
                                        tmax, cur, lo, ld, lrot, w, tests);
    }
    if (kAnyHit) {
        out<uint8_t>(P, O_OCC)[i] = occ ? 1 : 0;
        return;
    }
    float* n_out = out<float>(P, O_N);
    if (w.kind < 0) {  // no row of this launch hit: the state as it came
        const float* n_in = in<float>(P, S_N);
        const bool chained = t_in != nullptr;
        out<float>(P, O_T)[i] = w.t;
        out<int32_t>(P, O_ID)[i] = chained ? in<int32_t>(P, S_ID)[i] : -1;
        out<int32_t>(P, O_MAT)[i] = chained ? in<int32_t>(P, S_MAT)[i] : -1;
        n_out[i] = chained ? n_in[i] : 0.0f;
        n_out[n + i] = chained ? n_in[n + i] : 0.0f;
        n_out[2 * n + i] = chained ? n_in[2 * n + i] : 0.0f;
        out<float>(P, O_CMOD)[i] = chained ? in<float>(P, S_CMOD)[i] : 1.0f;
        return;
    }
    Vec nrm;
    int32_t id, mat;
    float cmod = 1.0f;
    if (w.kind == kPlane) {
        nrm = row3(P, T_PLN_NORMAL, w.row);
        const Vec p = along(w.o, w.d, w.t);
        const Vec pos = row3(P, T_PLN_POS, w.row);
        const Vec rel = {p.x - pos.x, p.y - pos.y, p.z - pos.z};
        // torch.remainder(x, 1) of x >= 0 (or NaN) is fmod's exact value
        const bool ring = fmodf(sqrtf(dot3(rel, rel)) * 0.25f, 1.0f) > 0.5f;
        if (in<uint8_t>(P, T_PLN_BULLSEYE)[w.row] != 0 && ring)
            cmod = kRingDark;
        id = w.row;
        mat = in<int32_t>(P, T_PLN_MAT)[w.row];
    } else if (w.kind == kSphere) {
        const Vec p = along(w.o, w.d, w.t);
        const Vec c = row3(P, T_SPH_CENTER, w.row);
        nrm = normalize3({p.x - c.x, p.y - c.y, p.z - c.z});
        id = spec.sphere_id0 + w.row;
        mat = in<int32_t>(P, T_SPH_MAT)[w.row];
    } else {
        const Vec u = rect_normal(P, w.row);
        nrm = dot3(u, w.d) > 0.0f ? Vec{-u.x, -u.y, -u.z} : u;
        id = spec.rect_id0 + w.row;
        mat = in<int32_t>(P, T_RECT_MAT)[w.row];
    }
    if (spec.motion) nrm = rotate(w.rot, nrm);
    out<float>(P, O_T)[i] = w.t;
    out<int32_t>(P, O_ID)[i] = id;
    out<int32_t>(P, O_MAT)[i] = mat;
    n_out[i] = nrm.x;
    n_out[n + i] = nrm.y;
    n_out[2 * n + i] = nrm.z;
    out<float>(P, O_CMOD)[i] = cmod;
}

// The block's row tests by kind (every thread of the block calls it) and,
// where the query counts them here, its lanes added to the counters, one
// add each.
__device__ __forceinline__ void count_block(const int (&tests)[3], int n,
                                            const AfCounters& cnt) {
    __shared__ int part[3][kThreads / 32];
    int t[3] = {tests[0], tests[1], tests[2]};
    for (int s = 16; s > 0; s >>= 1)
        for (int k = 0; k < 3; ++k)
            t[k] += __shfl_down_sync(0xffffffffu, t[k], s);
    const int warp = threadIdx.x / 32;
    if (threadIdx.x % 32 == 0)
        for (int k = 0; k < 3; ++k) part[k][warp] = t[k];
    __syncthreads();
    if (threadIdx.x != 0) return;
    for (int k = 0; k < 3; ++k) {
        long long sum = 0;
        for (int w = 0; w < kThreads / 32; ++w) sum += part[k][w];
        atomicAdd(cnt.tests[k], (unsigned long long)sum);
    }
    if (cnt.lanes != nullptr)
        atomicAdd(cnt.lanes, (unsigned long long)min(
                                 n - (int)blockIdx.x * kThreads, kThreads));
}

template <bool kAnyHit, bool kCount>
__global__ void __launch_bounds__(kThreads)
analytic_fold_kernel(const __grid_constant__ AfSpec spec,
                     const __grid_constant__ Ptrs P, float tmin,
                     const AfCounters cnt, int n) {
    const int i = blockIdx.x * kThreads + threadIdx.x;
    int tests[3] = {0, 0, 0};
    if (i < n) fold_lane<kAnyHit>(spec, P, tmin, n, i, tests);
    if (kCount) count_block(tests, n, cnt);
}

int check_spec(const AfSpec* s, bool moving) {
    int rows = 0;
    for (int k = 0; k < 3; ++k) {
        if (s->count[k] < 0 || s->first[k] < 0)
            return (int)cudaErrorInvalidValue;
        rows += s->count[k];
    }
    if (rows < 1 || rows > kMaxRows || s->n_chain < 0 ||
        s->n_chain > kMaxChains || s->n_slot < 0 || s->n_slot > kMaxSlots ||
        s->k < 1 || (s->n_chain > 0 && !moving))
        return (int)cudaErrorInvalidValue;
    for (int r = 0; r < rows; ++r)
        if (s->chain[r] < -1 || s->chain[r] >= s->n_chain)
            return (int)cudaErrorInvalidValue;
    for (int c = 0; c < s->n_chain; ++c) {
        const AfChain& ch = s->chains[c];
        if (ch.start < 0 || ch.depth < 1 || ch.start + ch.depth > s->n_slot)
            return (int)cudaErrorInvalidValue;
    }
    return 0;
}

}  // namespace

extern "C" int rt_analytic_fold_spec_bytes() { return (int)sizeof(AfSpec); }
extern "C" int rt_analytic_fold_ptrs() { return (int)kPtrs; }

// One launch over n lanes: any_hit = 0 folds the closest hit (S_T .. S_CMOD
// in, all null on a query's first launch; O_T .. O_CMOD out, the normal as
// [3, n]), any_hit = 1 the occlusion (S_OCC in, null on the first launch;
// O_OCC out). spec is an AfSpec and ptrs an array of kPtrs device
// pointers, both in host memory (types of this file's own, so passed as
// void*); L_TIME is null for a static scene, which may have no chain.
// c_plane, c_sphere, c_rect: int64 counters to add the row tests to
// (analytic_fold.tests.<kind>), all three or none (null: the uncounted
// kernel); c_lanes: the query's lanes (analytic_fold.lanes.<query>), null
// on a chained launch and where nothing is counted.
extern "C" int rt_analytic_fold(const void* spec_ptr,
                                const void* const* ptrs, float tmin,
                                int any_hit, long long* c_plane,
                                long long* c_sphere, long long* c_rect,
                                long long* c_lanes, int n, void* stream) {
    const AfSpec* spec = static_cast<const AfSpec*>(spec_ptr);
    const int bad = check_spec(spec, ptrs[L_TIME] != nullptr);
    if (bad || n < 0) return bad ? bad : (int)cudaErrorInvalidValue;
    const bool closest_io = ptrs[O_T] != nullptr && ptrs[O_ID] != nullptr &&
                            ptrs[O_MAT] != nullptr && ptrs[O_N] != nullptr &&
                            ptrs[O_CMOD] != nullptr;
    const bool counted = c_plane != nullptr;
    if ((any_hit ? ptrs[O_OCC] == nullptr : !closest_io) ||
        (c_sphere != nullptr) != counted || (c_rect != nullptr) != counted ||
        (c_lanes != nullptr && !counted))
        return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaGetLastError();
    Ptrs P;
    for (int k = 0; k < kPtrs; ++k) P.p[k] = ptrs[k];
    const AfCounters cnt = {{(unsigned long long*)c_plane,
                             (unsigned long long*)c_sphere,
                             (unsigned long long*)c_rect},
                            (unsigned long long*)c_lanes};
    const int blocks = (n + kThreads - 1) / kThreads;
#define RT_ANALYTIC_FOLD(ANY, COUNT)                                        \
    analytic_fold_kernel<ANY, COUNT><<<blocks, kThreads, 0,                 \
                                       (cudaStream_t)stream>>>(*spec, P,    \
                                                               tmin, cnt, n)
    if (any_hit && counted)
        RT_ANALYTIC_FOLD(true, true);
    else if (any_hit)
        RT_ANALYTIC_FOLD(true, false);
    else if (counted)
        RT_ANALYTIC_FOLD(false, true);
    else
        RT_ANALYTIC_FOLD(false, false);
#undef RT_ANALYTIC_FOLD
    return (int)cudaGetLastError();
}
