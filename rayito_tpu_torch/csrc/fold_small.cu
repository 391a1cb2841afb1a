// fold_small: every tiny transformed mesh of one query (SceneData.ktab_small,
// at most 4 x 48 triangles each) in one launch, each lane evaluating each
// mesh's keyed transform chain at its own time.
//
// Replaces no pallas_call: it is the reference's loop over its tiny meshes
// (rayito_tpu/render/trace.py:628-650): per mesh the transform chain at the
// lane's time, the ray to local space and the XLA dense fold
// _brute_force_mesh (rayito_tpu/render/mesh_intersect.py:103-126). The
// port's plain twin is fold_small_query_plain (render/mesh_intersect.py):
// per mesh ops/transform.py's ~150 elementwise kernels, one [N, T]
// Möller-Trumbore (fold_small_plain) and a dozen torch.where merges. Here
// all of it stays in registers and the merged result is written once.
//
// Per lane, in ktab_small order, the same values as the plain twin:
//   1. each link of the mesh's chain, outermost first (eval_transform of
//      ops/transform.py in its operation order): the key pair at the lane's
//      time among the slot's nkeys keys, pegged to the ends; frac = (time -
//      t0) / (t1 - t0) where t1 > t0, else 0, clamped to [0, 1] (NaN kept,
//      as torch.clamp); lerp a + (b - a) * frac of translation and scale;
//      nlerp of the rotation, w1 * (1 - frac) + w2 * frac per component,
//      normalised by one IEEE reciprocal of sqrt(max(w^2 + ((x^2 + y^2) +
//      z^2), 1e-37)). A table of one key (K == 1) takes the key as it is,
//      unnormalised;
//   2. the ray to local space: (~R)(o - T) / S and (~R)d / S, with ~R v =
//      v + t w + qv x t, t = 2 (qv x v), qv = -R.v; the composed
//      world-from-local rotation rot = rot * R (Hamilton product);
//   3. Möller-Trumbore (mt_exact, common.cuh) over the mesh's real rows,
//      t >= tmin and t < min(t_best, tmax); the first of the least t (a
//      strict <, as argmin's tie rule). The rows past a mesh's count are
//      all zero, so det = 0 and the twin's padded fold never takes them;
//   4. where the mesh hit, t, prim = row0 + row, beta, gamma and rot
//      replace the best.
// Any hit: a lane stops at its first hit, since every later mesh of the
// plain twin queries it with tmax = 0 and its occlusion is already set.
//
// What bounds it on the H100: operations. Per (lane, mesh) ~120 flops and
// 7 IEEE divisions and a square root of transform per link, and per
// (lane, triangle) ~46 flops and one IEEE division at 67 TFLOP/s f32 (at
// most half of it without FMA); chip_smoke.py counts the instructions the
// warps issue from the built SASS. The bytes: one read of the rays, the
// time, tmax and the running best, one write of the merged best per lane.
// Design: one launch per query (the plain twin's loop launched ~170
// kernels per mesh); each block stages every mesh's real rows (v0, v1, v2
// of each [16]-wide tri_vert_rows row, at most 1,024 rows) in shared
// memory once, SoA, so a warp's lanes read one triangle at once (a
// broadcast); one thread per lane walks the meshes in order, each mesh's
// tests unrolled four deep so independent tests overlap. The transform
// tables stay in device memory (a few hundred bytes, L1-resident). The
// mesh list (rows, counts, chains) is a by-value kernel argument, so a
// CUDA graph holds it: the chains' links sit in one slot table of the
// launch (FoldSpec.slots, kMaxLinks), each mesh an offset and a depth into
// it, so a chain of any depth up to the table's size runs here; the
// wrapper cuts a query's launches where the table would overflow. Build
// with -fmad=false -prec-div=true -prec-sqrt=true: every multiply and add
// rounds on its own, divisions and square roots are IEEE, as in the plain
// twin.
//
// Counters (tracing on; render/mesh_intersect.py passes the int64 slots of
// utils/tracing.py): the lane-triangle tests issued (a lane of an any-hit
// query counts up to its first hit), the chain links evaluated and the
// lanes of the launch, summed per block and added once per block. With
// null pointers the kernel is the uncounted instance: no add, no
// reduction.
#include <math.h>

#include "common.cuh"
#include "xform.cuh"

namespace {

constexpr int kMaxMeshes = 64;
constexpr int kMaxRows = 1024;
constexpr int kMaxLinks = 512;
constexpr int kRowWidth = 16;  // tri_vert_rows: v0, v1, v2, then meta
constexpr int kThreads = 128;

struct FoldMesh {
    int32_t row0, count;
    int32_t link0, depth;  // slots[link0 ..], outermost first
};

struct FoldSpec {
    int32_t n_mesh, rows, k, n_link;
    FoldMesh mesh[kMaxMeshes];
    int32_t slots[kMaxLinks];
};

struct FoldCounters {
    unsigned long long* tests;  // fold_small.tests.closest or .any
    unsigned long long* links;  // fold_small.links
    unsigned long long* lanes;  // fold_small.lanes.closest or .any
};

// Lane i's fold over every mesh of the spec (v: the staged rows); adds the
// triangle tests it issues and the links it evaluates to tests and links.
template <bool kAnyHit, bool kCount>
__device__ __forceinline__ void fold_lane(
    const FoldSpec& spec, const float* v, const XfTables& tb,
    const float* __restrict__ ox_, const float* __restrict__ oy_,
    const float* __restrict__ oz_, const float* __restrict__ dx_,
    const float* __restrict__ dy_, const float* __restrict__ dz_,
    const float* __restrict__ tmax_, const float* __restrict__ time_,
    float tmin, const float* __restrict__ t_in,
    const int32_t* __restrict__ p_in, const float* __restrict__ beta_in,
    const float* __restrict__ gamma_in, const float* __restrict__ rw_in,
    const float* __restrict__ rx_in, const float* __restrict__ ry_in,
    const float* __restrict__ rz_in, const uint8_t* __restrict__ occ_in,
    float* __restrict__ t_out, int32_t* __restrict__ p_out,
    float* __restrict__ beta_out, float* __restrict__ gamma_out,
    float* __restrict__ rot_out, uint8_t* __restrict__ occ_out, int n,
    int i, int& tests, int& links) {
    const int nr = spec.rows;
    const float ox = ox_[i], oy = oy_[i], oz = oz_[i];
    const float dx = dx_[i], dy = dy_[i], dz = dz_[i];
    const float tmax = tmax_[i];
    const float tm = time_ != nullptr ? time_[i] : 0.0f;
    const bool motion = rot_out != nullptr;
    bool occ = false;
    float t_best = 0.0f, beta_best = 0.0f, gamma_best = 0.0f;
    int32_t p_best = -1;
    Rot rot_best = {1.0f, 0.0f, 0.0f, 0.0f};
    if (kAnyHit) {
        occ = occ_in[i] != 0;
    } else {
        t_best = t_in[i];
        p_best = p_in[i];
        beta_best = beta_in[i];
        gamma_best = gamma_in[i];
        if (motion) rot_best = {rw_in[i], rx_in[i], ry_in[i], rz_in[i]};
    }
    const float inf = f_inf();
    for (int m = 0, off = 0; m < spec.n_mesh; off += spec.mesh[m].count, ++m) {
        if (kAnyHit && occ) break;
        const FoldMesh& mesh = spec.mesh[m];
        float lx = ox, ly = oy, lz = oz, ex = dx, ey = dy, ez = dz;
        Rot rot = {1.0f, 0.0f, 0.0f, 0.0f};
        for (int c = 0; c < mesh.depth; ++c) {
            Vec tr, sc;
            Rot ro;
            eval_link(tb, spec.k, spec.slots[mesh.link0 + c], tm, tr, sc,
                      ro);
            const Vec po = unrotate(ro, {lx - tr.x, ly - tr.y, lz - tr.z});
            const Vec pd = unrotate(ro, {ex, ey, ez});
            lx = po.x / sc.x;
            ly = po.y / sc.y;
            lz = po.z / sc.z;
            ex = pd.x / sc.x;
            ey = pd.y / sc.y;
            ez = pd.z / sc.z;
            rot = c == 0 ? ro : qmul(rot, ro);
        }
        if (kCount) links += mesh.depth;
        const float cap = kAnyHit ? tmax : nan_min(t_best, tmax);
        const float* v0x = v + off;
        float bt = inf, bb = 0.0f, bg = 0.0f;
        int bj = -1;
#pragma unroll 4
        for (int j = 0; j < mesh.count; ++j) {
            const MtHit h = mt_exact(
                v0x[j], v0x[nr + j], v0x[2 * nr + j], v0x[3 * nr + j],
                v0x[4 * nr + j], v0x[5 * nr + j], v0x[6 * nr + j],
                v0x[7 * nr + j], v0x[8 * nr + j], lx, ly, lz, ex, ey, ez,
                tmin, cap);
            if (h.t < bt) {  // rows ascend: the first minimum
                bt = h.t;
                bj = j;
                bb = h.beta;
                bg = h.gamma;
                if (kAnyHit) break;
            }
        }
        if (kCount) tests += kAnyHit && bj >= 0 ? bj + 1 : mesh.count;
        if (bj < 0) continue;
        if (kAnyHit) {
            occ = true;
        } else {
            t_best = bt;
            p_best = mesh.row0 + bj;
            beta_best = bb;
            gamma_best = bg;
            rot_best = rot;
        }
    }
    if (kAnyHit) {
        occ_out[i] = occ ? 1 : 0;
        return;
    }
    t_out[i] = t_best;
    p_out[i] = p_best;
    beta_out[i] = beta_best;
    gamma_out[i] = gamma_best;
    if (motion) {
        rot_out[i] = rot_best.w;
        rot_out[n + i] = rot_best.x;
        rot_out[2 * n + i] = rot_best.y;
        rot_out[3 * n + i] = rot_best.z;
    }
}

// The block's tests and links (every thread of the block calls it) and
// its lanes added to the counters, one add each.
__device__ __forceinline__ void count_block(int tests, int links, int n,
                                            const FoldCounters& cnt) {
    __shared__ int part[2][kThreads / 32];
    for (int s = 16; s > 0; s >>= 1) {
        tests += __shfl_down_sync(0xffffffffu, tests, s);
        links += __shfl_down_sync(0xffffffffu, links, s);
    }
    const int warp = threadIdx.x / 32;
    if (threadIdx.x % 32 == 0) {
        part[0][warp] = tests;
        part[1][warp] = links;
    }
    __syncthreads();
    if (threadIdx.x != 0) return;
    long long t = 0, l = 0;
    for (int w = 0; w < kThreads / 32; ++w) {
        t += part[0][w];
        l += part[1][w];
    }
    const int lanes = min(n - (int)blockIdx.x * kThreads, kThreads);
    atomicAdd(cnt.tests, (unsigned long long)t);
    atomicAdd(cnt.links, (unsigned long long)l);
    atomicAdd(cnt.lanes, (unsigned long long)lanes);
}

template <bool kAnyHit, bool kCount>
__global__ void __launch_bounds__(kThreads)
fold_small_kernel(const __grid_constant__ FoldSpec spec,
                  const float* __restrict__ rows,
                  const XfTables tb, const float* __restrict__ ox_,
                  const float* __restrict__ oy_, const float* __restrict__ oz_,
                  const float* __restrict__ dx_, const float* __restrict__ dy_,
                  const float* __restrict__ dz_,
                  const float* __restrict__ tmax_,
                  const float* __restrict__ time_, float tmin,
                  const float* __restrict__ t_in,
                  const int32_t* __restrict__ p_in,
                  const float* __restrict__ beta_in,
                  const float* __restrict__ gamma_in,
                  const float* __restrict__ rw_in,
                  const float* __restrict__ rx_in,
                  const float* __restrict__ ry_in,
                  const float* __restrict__ rz_in,
                  const uint8_t* __restrict__ occ_in,
                  float* __restrict__ t_out, int32_t* __restrict__ p_out,
                  float* __restrict__ beta_out, float* __restrict__ gamma_out,
                  float* __restrict__ rot_out, uint8_t* __restrict__ occ_out,
                  const FoldCounters cnt, int n) {
    extern __shared__ float v[];  // [9][spec.rows]: v0, v1, v2 by component
    const int nr = spec.rows;
    for (int m = 0, off = 0; m < spec.n_mesh; off += spec.mesh[m].count, ++m) {
        const int cnt_m = spec.mesh[m].count;
        const float* src = rows + (long long)spec.mesh[m].row0 * kRowWidth;
        for (int e = threadIdx.x; e < cnt_m * 9; e += kThreads)
            v[(e % 9) * nr + off + e / 9] = src[(e / 9) * kRowWidth + e % 9];
    }
    __syncthreads();
    const int i = blockIdx.x * kThreads + threadIdx.x;
    int tests = 0, links = 0;
    if (i < n)
        fold_lane<kAnyHit, kCount>(
            spec, v, tb, ox_, oy_, oz_, dx_, dy_, dz_, tmax_, time_, tmin,
            t_in, p_in, beta_in, gamma_in, rw_in, rx_in, ry_in, rz_in,
            occ_in, t_out, p_out, beta_out, gamma_out, rot_out, occ_out, n,
            i, tests, links);
    if (kCount) count_block(tests, links, n, cnt);
}

}  // namespace

// One launch over n lanes; spec is a FoldSpec (a type of this file's
// own, so it is passed as void*: a C entry point keeps external linkage
// only with parameter types that have it). Closest hit: t_in, p_in, beta_in, gamma_in (and
// the rotation rw_in..rz_in with rot_out [4, n], both null for a static
// scene) in, t_out, p_out, beta_out, gamma_out out. Any hit: occ_in in,
// occ_out out (the closest-hit pointers null). time is null for a static
// scene (every mesh's chain empty). c_tests, c_links, c_lanes: int64
// counters to add to (fold_small.tests.<kind>, .links, .lanes.<kind>),
// all three or none (null: the uncounted kernel).
extern "C" int rt_fold_small(
    const void* spec_ptr, const float* rows, const float* xf_times,
    const float* xf_translate, const float* xf_scale, const float* xf_rotate,
    const int32_t* xf_nkeys, const float* ox, const float* oy,
    const float* oz, const float* dx, const float* dy, const float* dz,
    const float* tmax, const float* time, float tmin, const float* t_in,
    const int32_t* p_in, const float* beta_in, const float* gamma_in,
    const float* rw_in, const float* rx_in, const float* ry_in,
    const float* rz_in, const uint8_t* occ_in, float* t_out, int32_t* p_out,
    float* beta_out, float* gamma_out, float* rot_out, uint8_t* occ_out,
    long long* c_tests, long long* c_links, long long* c_lanes, int n,
    void* stream) {
    const FoldSpec* spec = static_cast<const FoldSpec*>(spec_ptr);
    if (spec->n_mesh < 1 || spec->n_mesh > kMaxMeshes || spec->rows < 1 ||
        spec->rows > kMaxRows || spec->k < 1 || spec->n_link < 0 ||
        spec->n_link > kMaxLinks || n < 0)
        return (int)cudaErrorInvalidValue;
    int rows_total = 0;
    for (int m = 0; m < spec->n_mesh; ++m) {
        const FoldMesh& mesh = spec->mesh[m];
        if (mesh.count < 1 || mesh.depth < 0 || mesh.link0 < 0 ||
            mesh.link0 + mesh.depth > spec->n_link ||
            (mesh.depth > 0 && time == nullptr))
            return (int)cudaErrorInvalidValue;
        rows_total += mesh.count;
    }
    const bool any_hit = occ_in != nullptr;
    const bool counted = c_tests != nullptr;
    if (rows_total != spec->rows || (any_hit ? occ_out == nullptr
                                             : t_in == nullptr ||
                                               t_out == nullptr) ||
        (c_links != nullptr) != counted || (c_lanes != nullptr) != counted)
        return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaGetLastError();
    const XfTables tb = {xf_times, xf_translate, xf_scale, xf_rotate,
                         xf_nkeys};
    const int blocks = (n + kThreads - 1) / kThreads;
    const size_t smem = sizeof(float) * 9 * spec->rows;
    const FoldCounters cnt = {(unsigned long long*)c_tests,
                              (unsigned long long*)c_links,
                              (unsigned long long*)c_lanes};
#define RT_FOLD_SMALL(ANY, COUNT)                                            \
    fold_small_kernel<ANY, COUNT><<<blocks, kThreads, smem,                  \
                                    (cudaStream_t)stream>>>(                 \
        *spec, rows, tb, ox, oy, oz, dx, dy, dz, tmax, time, tmin, t_in,     \
        p_in, beta_in, gamma_in, rw_in, rx_in, ry_in, rz_in, occ_in, t_out,  \
        p_out, beta_out, gamma_out, rot_out, occ_out, cnt, n)
    if (any_hit && counted)
        RT_FOLD_SMALL(true, true);
    else if (any_hit)
        RT_FOLD_SMALL(true, false);
    else if (counted)
        RT_FOLD_SMALL(false, true);
    else
        RT_FOLD_SMALL(false, false);
#undef RT_FOLD_SMALL
    return (int)cudaGetLastError();
}
