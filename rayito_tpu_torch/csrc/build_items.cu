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
// latency of its dependent steps: count, scan, write. They run in one
// launch, a single pass with decoupled look-back (Merrill & Garland,
// "Single-pass Parallel Prefix Scan with Decoupled Look-back", 2016):
//
//   * every CTA takes a ticket (an atomic counter), in the order the CTAs
//     start: the first n_fill tickets are fill CTAs, the rest tiles of
//     kTile ray blocks. A CTA waits only on CTAs with a lower ticket,
//     which have started, so no wait can deadlock whatever the CTAs'
//     residency;
//   * a fill CTA writes -1 over its contiguous share of the whole list at
//     once (16-byte stores) and publishes that it is done: the fill needs
//     no total, so it runs beside the counting instead of after it;
//   * a tile counts its blocks' set bits (a warp per block, popc of its
//     words), scans their w-aligned counts in one warp, publishes its
//     aggregate (sum and whether a block is above cap), looks back over
//     its predecessors' status words 32 at a time until an inclusive
//     prefix and publishes its own. Then it waits for the fill CTAs whose
//     shares its runs cover and writes the runs over their -1s, as the
//     three-launch version's write pass did: each warp expands its
//     block's set bits in rank order (a warp scan of the words' popc)
//     into the run, then repeats the run's last listed cluster up to the
//     alignment. Entries at or past maxitems are never written by a run,
//     so an overflowing list is the reference's truncated one. The last
//     tile writes the group count and the flag.
//
// A tile is 8 blocks of 8 warps, so the runs' scattered stores spread
// over as many SMs as the three-launch version's did (32-block tiles of
// 32 warps queued them on a quarter of the SMs' store units and took
// longer than the three launches).
//
// The status words and the tickets live in a state buffer of the device
// (rt_build_items's state) that no host write resets, so a CUDA graph
// replays the launch as it is: a status word is (epoch << 2 | flag) << 32
// | payload, and a word is ready only with this launch's epoch. Every CTA
// reads the epoch (an acquire) before it takes its ticket, so the CTA that
// takes the last ticket knows every CTA of the launch has read it: it
// resets the ticket and advances the epoch (mod 2^30) for the next launch,
// which starts only after this one has ended. A word read in the next
// launch before its owner rewrites it carries an older epoch and is
// waited on.
// Launches that share the state must be ordered (one stream), as every
// launch of the port on a device is. A tile's word carries its own
// payload and is stored and loaded relaxed; a fill CTA's is a release
// that the tile acquires before its stores follow the -1s.
//
// Every output equals the plain version's bit for bit.
#include "common.cuh"

namespace {

constexpr int kCidBits = 13;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = kWarps;  // ray blocks per tile, a warp each
constexpr int kFillPerThread = 64;  // list entries a fill thread writes
constexpr uint32_t kEpochMask = (1u << 30) - 1u;
constexpr uint32_t kAggregate = 1u, kPrefix = 2u;
// state: epoch, ticket, two pad words, then one 64-bit status word per
// tile, then one per fill CTA
constexpr int kStateHead = 4;

__device__ __forceinline__ unsigned long long ld_relaxed(
    const unsigned long long* p) {
    unsigned long long v;
    asm volatile("ld.relaxed.gpu.u64 %0, [%1];"
                 : "=l"(v) : "l"(p) : "memory");
    return v;
}

__device__ __forceinline__ unsigned long long ld_acquire(
    const unsigned long long* p) {
    unsigned long long v;
    asm volatile("ld.acquire.gpu.u64 %0, [%1];"
                 : "=l"(v) : "l"(p) : "memory");
    return v;
}

__device__ __forceinline__ void st_relaxed(unsigned long long* p,
                                           unsigned long long v) {
    asm volatile("st.relaxed.gpu.u64 [%0], %1;"
                 :: "l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ void st_release(unsigned long long* p,
                                           unsigned long long v) {
    asm volatile("st.release.gpu.u64 [%0], %1;"
                 :: "l"(p), "l"(v) : "memory");
}

// payload: bit 31 a block above cap, bits 0-30 the sum of aligned counts
__device__ __forceinline__ unsigned long long status_word(uint32_t epoch,
                                                          uint32_t flag,
                                                          uint32_t payload) {
    return (unsigned long long)(epoch << 2 | flag) << 32 | payload;
}

__device__ __forceinline__ bool ready(unsigned long long v, uint32_t epoch) {
    const uint32_t hi = (uint32_t)(v >> 32);
    return (hi >> 2) == epoch && (hi & 3u) != 0u;
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

// Fill CTA f of n_fill: -1 over list vectors [f * per, (f + 1) * per) of
// 4 entries (the last CTA also the entries past the last whole vector),
// then done.
__device__ void fill_pass(int32_t* __restrict__ items,
                          unsigned long long* fill_status, uint32_t epoch,
                          int f, int n_fill, long long per, long long len) {
    const long long n_vec = len / 4;
    const long long v0 = (long long)f * per;
    const long long v1 = min(v0 + per, n_vec);
    int4* vec = (int4*)items;
    for (long long k = v0 + threadIdx.x; k < v1; k += kThreads)
        vec[k] = make_int4(-1, -1, -1, -1);
    if (f == n_fill - 1 && threadIdx.x < len - 4 * n_vec)
        items[4 * n_vec + threadIdx.x] = -1;
    __threadfence();  // every thread's -1s before the CTA's release
    __syncthreads();
    if (threadIdx.x == 0)
        st_release(&fill_status[f], status_word(epoch, kPrefix, 0u));
}

// Tile t: count, scan, look back, wait for the fill under its runs, write
// the runs; the last tile writes n_steps and overflow.
__device__ void tile_pass(const int32_t* __restrict__ masks,
                          int32_t* __restrict__ items,
                          int32_t* __restrict__ n_steps,
                          uint8_t* __restrict__ overflow,
                          uint8_t* __restrict__ used,
                          unsigned long long* status,
                          const unsigned long long* fill_status,
                          uint32_t epoch, int t, int n_tiles, int n_fill,
                          long long per, int n_blocks, int n_words, int w,
                          int maxitems, int cap) {
    __shared__ int s_count[kTile], s_start[kTile];
    __shared__ int s_prefix;
    const int lane = threadIdx.x & 31;
    const int wid = threadIdx.x >> 5;
    const long long blk0 = (long long)t * kTile;
    for (int j = wid; j < kTile; j += kWarps) {
        const long long blk = blk0 + j;
        int n = 0;
        if (blk < n_blocks) {
            const int32_t* row = masks + blk * n_words;
            for (int k = lane; k < n_words; k += 32)
                n += __popc((uint32_t)row[k]);
            n = __reduce_add_sync(kFull, n);
        }
        if (lane == 0) s_count[j] = n;
    }
    __syncthreads();
    if (wid == 0) {
        const int n = lane < kTile ? s_count[lane] : 0;
        const int a = (n + w - 1) / w * w;
        const int incl = warp_scan(a, lane);
        if (lane < kTile) {
            s_start[lane] = incl - a;
            if (blk0 + lane < n_blocks) used[blk0 + lane] = n > 0;
        }
        const uint32_t sum = (uint32_t)__shfl_sync(kFull, incl, 31);
        const uint32_t over = __any_sync(kFull, n > cap) ? 1u : 0u;
        if (lane == 0)
            st_relaxed(&status[t],
                       status_word(epoch, t ? kAggregate : kPrefix,
                                   over << 31 | sum));
        uint32_t excl = 0, over_before = 0;
        for (int base = t - 1; base >= 0; base -= 32) {
            // lane l reads tile base - l; below tile 0 reads as a prefix 0
            const int j = base - lane;
            unsigned long long v = status_word(epoch, kPrefix, 0);
            if (j >= 0) {
                do {
                    v = ld_relaxed(&status[j]);
                } while (!ready(v, epoch));
            }
            const unsigned prefixes = __ballot_sync(
                kFull, ((uint32_t)(v >> 32) & 3u) == kPrefix);
            const int last = prefixes ? __ffs(prefixes) - 1 : 31;
            const uint32_t p = lane <= last ? (uint32_t)v : 0u;
            excl += __reduce_add_sync(kFull, p & 0x7fffffffu);
            over_before |= __reduce_or_sync(kFull, p >> 31);
            if (prefixes) break;
        }
        const uint32_t over_all = over | over_before;
        if (lane == 0) {
            if (t)
                st_relaxed(&status[t], status_word(epoch, kPrefix,
                                                   over_all << 31
                                                   | (excl + sum)));
            s_prefix = (int)excl;
            if (t == n_tiles - 1) {
                const int total = (int)(excl + sum);
                *n_steps = min(total, maxitems) / w;
                *overflow = total > maxitems || over_all;
            }
        }
        // the fill CTAs whose shares hold this tile's entries (the last
        // one's share runs to the end of the list)
        const long long lo = excl;
        const long long hi = min((long long)excl + sum, (long long)maxitems);
        if (lo < hi) {
            const long long f0 = min(lo / (4 * per), n_fill - 1ll);
            const long long f1 = min((hi - 1) / (4 * per), n_fill - 1ll);
            for (long long f = f0 + lane; f <= f1; f += 32) {
                while (!ready(ld_acquire(&fill_status[f]), epoch)) {
                }
            }
        }
        __syncwarp();
    }
    __syncthreads();
    for (int j = wid; j < kTile; j += kWarps) {
        const long long blk = blk0 + j;
        const int cnt = s_count[j];
        if (blk >= n_blocks || cnt == 0) continue;  // the whole warp
        const long long s0 = (long long)s_prefix + s_start[j];
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
        const int al = (cnt + w - 1) / w * w;
        for (int r = listed + lane; r < al; r += 32)
            if (s0 + r < maxitems) items[s0 + r] = tag | last;
    }
}

__global__ void __launch_bounds__(kThreads)
build_items_kernel(const int32_t* __restrict__ masks,
                   int32_t* __restrict__ items, int32_t* __restrict__ n_steps,
                   uint8_t* __restrict__ overflow, uint8_t* __restrict__ used,
                   uint32_t* state, int n_tiles, int n_fill, long long per,
                   int n_blocks, int n_words, int w, int maxitems, int cap) {
    __shared__ uint32_t s_ticket, s_epoch;
    if (threadIdx.x == 0) {
        uint32_t epoch;
        asm volatile("ld.acquire.gpu.u32 %0, [%1];"
                     : "=r"(epoch) : "l"(state) : "memory");
        const uint32_t ticket = atomicAdd(&state[1], 1u);
        if (ticket == gridDim.x - 1) {
            // every CTA of this launch has read the epoch (before its
            // ticket): the next launch starts from ticket 0, one epoch on
            state[1] = 0u;
            state[0] = (epoch + 1u) & kEpochMask;
        }
        s_ticket = ticket;
        s_epoch = epoch;
    }
    __syncthreads();
    const int t = (int)s_ticket;
    const uint32_t epoch = s_epoch;
    unsigned long long* status = (unsigned long long*)(state + kStateHead);
    unsigned long long* fill_status = status + n_tiles;
    if (t < n_fill)
        fill_pass(items, fill_status, epoch, t, n_fill, per,
                  (long long)maxitems + w);
    else
        tile_pass(masks, items, n_steps, overflow, used, status, fill_status,
                  epoch, t - n_fill, n_tiles, n_fill, per, n_blocks, n_words,
                  w, maxitems, cap);
}

}  // namespace

// state: a device buffer of at least 4 + 2 (ceil(n_blocks / 8) + 4 SMs)
// uint32 words (the counters, then a 64-bit status word per tile and per
// fill CTA), zero before its first use and then left to the kernel;
// state_words its size. items must be 16-byte aligned.
extern "C" int rt_build_items(const int32_t* masks, int32_t* items,
                              int32_t* n_steps, uint8_t* overflow,
                              uint8_t* used, uint32_t* state,
                              long long state_words, int n_blocks,
                              int n_words, int w, int maxitems, int cap,
                              void* stream) {
    static int n_sms = 0;
    if (n_sms == 0) {
        int dev = 0;
        cudaGetDevice(&dev);
        if (cudaDeviceGetAttribute(&n_sms, cudaDevAttrMultiProcessorCount,
                                   dev) != cudaSuccess || n_sms < 1)
            n_sms = 132;
    }
    const int n_tiles = (n_blocks + kTile - 1) / kTile;
    // fill CTAs: up to 4 per SM, each a contiguous share of whole vectors
    // (64 entries a thread; 16 a thread, four times the CTAs, with a
    // second counter of finished CTAs took 1-1.5 us longer at the budget
    // that never overflows)
    const long long n_vec = ((long long)maxitems + w) / 4;
    const long long per_cta = (long long)kThreads * kFillPerThread / 4;
    const long long want = (n_vec + per_cta - 1) / per_cta;
    const long long most = 4ll * n_sms;
    const int n_fill = (int)(want < 1 ? 1 : want > most ? most : want);
    const long long per = n_vec > n_fill ? (n_vec + n_fill - 1) / n_fill : 1;
    if (n_blocks < 1 || n_words < 1 || w < 1
        || state_words < kStateHead + 2ll * (n_tiles + n_fill)
        || ((uintptr_t)state & 7u) != 0u || ((uintptr_t)items & 15u) != 0u)
        return (int)cudaErrorInvalidValue;
    build_items_kernel<<<n_tiles + n_fill, kThreads, 0,
                         (cudaStream_t)stream>>>(
        masks, items, n_steps, overflow, used, state, n_tiles, n_fill, per,
        n_blocks, n_words, w, maxitems, cap);
    return (int)cudaGetLastError();
}
