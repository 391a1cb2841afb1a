// fold_small: the nearest hit of one tiny mesh (at most 4 x 48 triangles)
// for every lane, by testing each lane against every triangle.
//
// Replaces no pallas_call: it is the reference's XLA dense fold
// _brute_force_mesh (rayito_tpu/render/mesh_intersect.py:103-126), one
// [N, T] Möller-Trumbore and an argmin, which the port ran as strided
// [N, T] elementwise ops (fold_small_plain in render/traverse.py). Here
// the [N, T] intermediates never leave registers.
//
// Per lane, the same values as the plain version: the test of
// ops/intersect.py in its operation order (mt_exact, common.cuh), t >=
// tmin and t < tmax[lane]; the winner is the first minimum of t over the
// triangles in row order (torch.argmin's tie rule), so a triangle replaces
// the best only when strictly nearer. The best starts at triangle 0's own
// test, so an all-miss lane returns t = INF, prim = -1 and triangle 0's
// beta and gamma, as the plain version's argmin of an all-INF row does
// (the callers read beta and gamma only where prim >= 0).
//
// What bounds it on the H100: operations, ~46 flops and one IEEE division
// per (lane, triangle) test at 67 TFLOP/s f32 (at most half of it without
// FMA); the bytes are one read of the rays and tmax and one write of four
// outputs per lane. Design: each block stages the mesh's rows (v0, v1, v2
// of each [16]-wide tri_vert_rows row, at most 192 x 9 floats) in shared
// memory once, then each thread folds one lane over them; every thread of
// a warp reads the same triangle at once (a shared-memory broadcast).
// Build with -fmad=false -prec-div=true: every multiply and add rounds on
// its own and 1 / det is IEEE, as in the plain version.
#include "common.cuh"

namespace {

constexpr int kMaxTri = 192;  // 4 clusters x 48 triangles
constexpr int kRowWidth = 16;  // tri_vert_rows: v0, v1, v2, then meta
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
fold_small_kernel(const float* __restrict__ rows, int n_tri, int tri0,
                  const float* __restrict__ ox_, const float* __restrict__ oy_,
                  const float* __restrict__ oz_, const float* __restrict__ dx_,
                  const float* __restrict__ dy_, const float* __restrict__ dz_,
                  const float* __restrict__ tmax_, float tmin,
                  float* __restrict__ t_out, int32_t* __restrict__ p_out,
                  float* __restrict__ beta_out, float* __restrict__ gamma_out,
                  int n) {
    __shared__ float v[9][kMaxTri];
    for (int e = threadIdx.x; e < n_tri * 9; e += kThreads)
        v[e % 9][e / 9] = rows[(e / 9) * kRowWidth + e % 9];
    __syncthreads();
    const int i = blockIdx.x * kThreads + threadIdx.x;
    if (i >= n) return;
    const float ox = ox_[i], oy = oy_[i], oz = oz_[i];
    const float dx = dx_[i], dy = dy_[i], dz = dz_[i];
    const float tmax = tmax_[i];
    MtHit best = mt_exact(v[0][0], v[1][0], v[2][0], v[3][0], v[4][0],
                          v[5][0], v[6][0], v[7][0], v[8][0], ox, oy, oz, dx,
                          dy, dz, tmin, tmax);
    int best_j = 0;
    for (int j = 1; j < n_tri; ++j) {
        const MtHit h = mt_exact(v[0][j], v[1][j], v[2][j], v[3][j], v[4][j],
                                 v[5][j], v[6][j], v[7][j], v[8][j], ox, oy,
                                 oz, dx, dy, dz, tmin, tmax);
        if (h.t < best.t) {
            best = h;
            best_j = j;
        }
    }
    t_out[i] = best.t;
    p_out[i] = best.t != __int_as_float(0x7f800000) ? tri0 + best_j : -1;
    beta_out[i] = best.beta;
    gamma_out[i] = best.gamma;
}

}  // namespace

extern "C" int rt_fold_small(const float* rows, int n_tri, int tri0,
                             const float* ox, const float* oy,
                             const float* oz, const float* dx,
                             const float* dy, const float* dz,
                             const float* tmax, float tmin, float* t,
                             int32_t* prim, float* beta, float* gamma, int n,
                             void* stream) {
    if (n_tri < 1 || n_tri > kMaxTri) return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaGetLastError();
    const int blocks = (n + kThreads - 1) / kThreads;
    fold_small_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        rows, n_tri, tri0, ox, oy, oz, dx, dy, dz, tmax, tmin, t, prim, beta,
        gamma, n);
    return (int)cudaGetLastError();
}
