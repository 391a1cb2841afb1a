// gather_rows_t: out[k, i] = table[idx[i], k] for a [T, K] f32 table,
// K in {16, 32} — the winner-row gather and the [N, K] -> [K, N] relayout
// in one pass.
//
// Replaces the TPU kernel _transpose_rows_kernel (rayito_tpu/render/
// pallas_traverse.py, launcher transpose_rows), which existed because XLA
// on the TPU turned a plain transpose of the gathered rows into a bitcast
// and paid a per-column unpack in every consumer. Here the gather that the
// reference left to XLA is fused in.
//
// What bounds it on the H100: memory, one 64- or 128-byte row read per
// output column (random rows of a 1.5-3 MB table at stage 6, which fits in
// L2) and K coalesced 4-byte writes. Design: one thread per output column
// reads its row with 16-byte vector loads and writes each component to its
// own output row, so the writes of a warp are contiguous. Indices are
// clamped to [0, T), as a JAX gather clamps them.
#include "common.cuh"

namespace {

template <int K>
__global__ void gather_rows_t_kernel(const float* __restrict__ table,
                                     const int32_t* __restrict__ idx,
                                     float* __restrict__ out, int n,
                                     int n_rows) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    int row = idx[i];
    row = row < 0 ? 0 : (row >= n_rows ? n_rows - 1 : row);
    const float4* src = (const float4*)(table + (long long)row * K);
#pragma unroll
    for (int q = 0; q < K / 4; ++q) {
        const float4 v = src[q];
        out[(long long)(4 * q + 0) * n + i] = v.x;
        out[(long long)(4 * q + 1) * n + i] = v.y;
        out[(long long)(4 * q + 2) * n + i] = v.z;
        out[(long long)(4 * q + 3) * n + i] = v.w;
    }
}

}  // namespace

extern "C" int rt_gather_rows_t(const float* table, const int32_t* idx,
                                float* out, int n, int n_rows, int k,
                                void* stream) {
    const int threads = 256;
    const int blocks = (n + threads - 1) / threads;
    cudaStream_t s = (cudaStream_t)stream;
    if (n == 0) return (int)cudaGetLastError();
    if (k == 16)
        gather_rows_t_kernel<16><<<blocks, threads, 0, s>>>(table, idx, out,
                                                            n, n_rows);
    else if (k == 32)
        gather_rows_t_kernel<32><<<blocks, threads, 0, s>>>(table, idx, out,
                                                            n, n_rows);
    else
        return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
}
