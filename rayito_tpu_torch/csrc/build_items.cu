// build_items: the item list of the item traversal, from the mask words.
//
// Replaces the XLA function _build_items (rayito_tpu/render/
// pallas_traverse.py), which feeds _items_kernel: per ray block its set
// clusters ascending, w-aligned by repeating the last one (a block above
// cap repeats its cap-th), packed bid << 13 | cid into one block-major
// list of maxitems + w entries, -1 past the end; the group count
// min(total, maxitems) / w, the overflow flag total > maxitems or a block
// above cap, and which blocks list anything.
//
// What bounds it on the H100: bytes, the mask words read once and the list
// written once (at the reference's budget a few hundred KB, at a budget
// that never overflows ~8 MB: 2-3 us at 3.35 TB/s), and, below that, the
// latency of the three dependent passes. So there are three small
// launches, nothing on the host between them and nothing read back:
//
//   1. count: a warp per ray block sums the popc of its words; it writes
//      the block's count, its w-aligned count and whether it is used;
//   2. scan: one CTA scans the aligned counts, any number of blocks in
//      tiles of its width, into each run's start, and writes the total,
//      the group count and the overflow flag;
//   3. write: a warp per ray block expands its words' set bits in rank
//      order (a warp scan of the words' popc gives each word its first
//      rank) into the block's run, then repeats the run's last listed
//      cluster up to the alignment; every thread also fills -1 from the
//      end of the list (min(total, maxitems)) to maxitems + w. Entries at
//      or past maxitems are never written by a run, so an overflowing list
//      is the truncated one the reference gives.
//
// Every output equals the plain version's bit for bit.
#include "common.cuh"

namespace {

constexpr int kCidBits = 13;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;

__global__ void items_count_kernel(const int32_t* __restrict__ masks,
                                   int32_t* __restrict__ count,
                                   int32_t* __restrict__ aligned,
                                   uint8_t* __restrict__ used, int n_blocks,
                                   int n_words, int w) {
    const long long blk =
        ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (blk >= n_blocks) return;  // the whole warp
    const int32_t* row = masks + blk * n_words;
    int n = 0;
    for (int k = lane; k < n_words; k += 32) n += __popc((uint32_t)row[k]);
    n = __reduce_add_sync(kFull, n);
    if (lane == 0) {
        count[blk] = n;
        aligned[blk] = (n + w - 1) / w * w;
        used[blk] = n > 0;
    }
}

// Inclusive sum over the warp's lanes.
__device__ __forceinline__ int warp_scan(int x, int lane) {
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, x, o);
        if (lane >= o) x += y;
    }
    return x;
}

__global__ void __launch_bounds__(1024) items_scan_kernel(
    const int32_t* __restrict__ count, const int32_t* __restrict__ aligned,
    int32_t* __restrict__ start, int32_t* __restrict__ total_out,
    int32_t* __restrict__ n_steps, uint8_t* __restrict__ overflow,
    int n_blocks, int maxitems, int cap, int w) {
    __shared__ int warp_sum[32];
    const int lane = threadIdx.x & 31;
    const int wid = threadIdx.x >> 5;
    const int n_warps = blockDim.x >> 5;
    int carry = 0;
    int over_cap = 0;
    for (int base = 0; base < n_blocks; base += blockDim.x) {
        const int i = base + threadIdx.x;
        const int a = i < n_blocks ? aligned[i] : 0;
        if (i < n_blocks && count[i] > cap) over_cap = 1;
        const int x = warp_scan(a, lane);
        if (lane == 31) warp_sum[wid] = x;
        __syncthreads();
        if (wid == 0) {
            const int s = warp_scan(lane < n_warps ? warp_sum[lane] : 0,
                                    lane);
            if (lane < n_warps) warp_sum[lane] = s;
        }
        __syncthreads();
        if (i < n_blocks)
            start[i] = carry + (wid > 0 ? warp_sum[wid - 1] : 0) + x - a;
        carry += warp_sum[n_warps - 1];
        __syncthreads();  // warp_sum is rewritten by the next tile
    }
    over_cap = __syncthreads_or(over_cap);
    if (threadIdx.x == 0) {
        *total_out = carry;
        *n_steps = min(carry, maxitems) / w;
        *overflow = carry > maxitems || over_cap;
    }
}

__global__ void items_write_kernel(const int32_t* __restrict__ masks,
                                   const int32_t* __restrict__ count,
                                   const int32_t* __restrict__ aligned,
                                   const int32_t* __restrict__ start,
                                   const int32_t* __restrict__ total_p,
                                   int32_t* __restrict__ items, int n_blocks,
                                   int n_words, int maxitems, int cap,
                                   int w) {
    const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long n_threads = (long long)gridDim.x * blockDim.x;
    const int lane = threadIdx.x & 31;
    const int end = min(*total_p, maxitems);
    for (long long j = end + tid; j < (long long)maxitems + w; j += n_threads)
        items[j] = -1;
    for (long long blk = tid >> 5; blk < n_blocks; blk += n_threads >> 5) {
        const int cnt = count[blk];
        if (cnt == 0) continue;  // the whole warp
        const long long s0 = start[blk];
        const int listed = min(cnt, cap);  // then repeats of the last
        const int32_t tag = (int32_t)((uint32_t)blk << kCidBits);
        const int32_t* row = masks + blk * n_words;
        int rank0 = 0, last = -1;
        for (int k0 = 0; k0 < n_words && rank0 < listed; k0 += 32) {
            const int k = k0 + lane;
            uint32_t bits = k < n_words ? (uint32_t)row[k] : 0u;
            const int n = __popc(bits);
            const int incl = warp_scan(n, lane);
            for (int r = rank0 + incl - n; bits != 0 && r < listed; ++r) {
                const int c = k * 32 + __ffs(bits) - 1;
                bits &= bits - 1;
                if (s0 + r < maxitems) items[s0 + r] = tag | c;
                if (r == listed - 1) last = c;
            }
            rank0 += __shfl_sync(kFull, incl, 31);
        }
        last = __reduce_max_sync(kFull, last);
        const int al = aligned[blk];
        for (int r = listed + lane; r < al; r += 32)
            if (s0 + r < maxitems) items[s0 + r] = tag | last;
    }
}

}  // namespace

// scratch: 3 * n_blocks + 1 int32 (count, aligned, start, total).
extern "C" int rt_build_items(const int32_t* masks, int32_t* items,
                              int32_t* n_steps, uint8_t* overflow,
                              uint8_t* used, int32_t* scratch, int n_blocks,
                              int n_words, int w, int maxitems, int cap,
                              void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    int32_t* count = scratch;
    int32_t* aligned = scratch + n_blocks;
    int32_t* start = scratch + 2 * n_blocks;
    int32_t* total = scratch + 3 * n_blocks;
    const long long warps = (long long)n_blocks * 32;
    const int count_ctas = (int)((warps + kThreads - 1) / kThreads);
    items_count_kernel<<<count_ctas, kThreads, 0, s>>>(
        masks, count, aligned, used, n_blocks, n_words, w);
    items_scan_kernel<<<1, 1024, 0, s>>>(count, aligned, start, total,
                                         n_steps, overflow, n_blocks,
                                         maxitems, cap, w);
    // enough threads for a warp per block, and up to 2^18 for the fill
    const long long fill = (long long)maxitems + w;
    const long long fill_threads = fill < (1 << 18) ? fill : 1 << 18;
    const long long want = warps > fill_threads ? warps : fill_threads;
    const int write_ctas = (int)((want + kThreads - 1) / kThreads);
    items_write_kernel<<<write_ctas, kThreads, 0, s>>>(
        masks, count, aligned, start, total, items, n_blocks, n_words,
        maxitems, cap, w);
    return (int)cudaGetLastError();
}
