// cmj: the sample streams in native uint32, one thread per lane, in one
// kernel, cmj_draws_kernel: a draw set (every draw of one bounce, of the
// camera or of one direct-lighting pass, seeds and samples) in one
// launch. The single draws (ops/rng.py hash_combine, cmj_sample_1d and
// cmj_sample_2d, which ops/samplers.py and the tests take) run as plain
// torch ops on every device.
//
// Replaces no pallas_call: it is the reference's XLA uint32 arithmetic
// (rayito_tpu/ops/rng.py:74-205, cmj_permute's cycle walk a
// lax.while_loop at :134), which the port's plain version runs as torch
// ops (ops/rng.py cmj_draws_plain): every uint32 held in an int64 tensor,
// each wrapping multiply split into 16-bit halves, and on the card a
// host-fixed (w + 1) - num masked rounds of the walk, since a CUDA graph
// cannot hold a loop whose trip count the device decides. Here each lane
// runs its own do { round } while (x >= num), at most (w + 1) - num rounds
// after the first: the same bits as the reference's masked while_loop (a
// lane that has arrived holds its value there) and as the fixed rounds
// (the round is a bijection on [0, w]: a walk from an index in range
// visits each out-of-range value at most once, and a lane in range stays
// put).
//
// Operands: an int32 or int64 tensor (its low 32 bits, as u32() of the
// plain version takes them) with stride 1, or 0 for a one-element tensor,
// or an immediate. A draw's index is si * mul + add in uint32, so that
// the light loop's flat index si * nls + lsi needs no op of its own
// (mul 0: the immediate index add, the direct integrator's k).
// The float tail runs in the reference's operation order: u32 -> f32
// rounds to nearest (.astype(float32)), then (pidx + sx) / n and
// (ix + (iy + sx) / ny) / nx with IEEE division (-prec-div=true, no FMA).
//
// The draw set. A draw needs only (px, py, si) and the plan, not the path
// state, so one launch serves a whole set: each thread reads its lane's
// px, py and si once, computes each seed hash of the set in registers
// (never written to memory) and then every sample of that seed, each
// output one row of a [n_out, n] float32 tensor, written coalesced. The
// plan (DrawPlan) is passed by value as a __grid_constant__ parameter,
// read from the constant bank with warp-uniform indices; at most
// kMaxSeeds seeds and kMaxDraws draws, so that it and the other
// parameters stay inside the classic 4 KB of kernel parameters (static
// assert below): ops/rng.py splits a larger plan into several launches.
// Its integer divisions by the pattern sizes (the walk's final % num, 2-D
// pidx % nx and pidx / nx) are a multiply-high and shifts by a magic
// number the host computes (Granlund & Montgomery 1994, Figure 4.1:
// l = ceil(log2 d), m = floor(2^32 (2^l - d) / d) + 1, q = (t + ((n - t)
// >> min(l, 1))) >> max(l - 1, 0) with t = umulhi(n, m); their Theorem
// 4.1 proves q = floor(n / d) for every n in [0, 2^32) and every d in
// [1, 2^32), all the pattern sizes the wrappers accept).
//
// What bounds it on the H100: the instructions each lane issues (in the
// built SASS, tools/cmj_sass.py: the cycle walk's rounds after the first,
// the seed-hash operands, the samples), at one warp instruction per
// clock of each SM sub-partition; bytes are 4-8 per tensor operand and
// 4-8 per output per lane. With one lane per thread every operand is read
// and every output written once, coalesced.
#include "common.cuh"

// One uint32 operand; the layout of rng.py's ctypes Operand. Outside the
// anonymous namespace: the C entry points below take it.
struct Operand {
    const void* ptr;
    int kind;
    int stride;  // 1: one value per lane, 0: one value for every lane
    uint32_t imm;
};

// The draw plan's capacity (module comment).
constexpr int kMaxSeeds = 8;
constexpr int kMaxDraws = 64;

// A divisor of the draw set: d, its magic multiplier m and l = ceil(log2
// d) (module comment); the cycle walk's mask is 2^l - 1.
struct DrawDiv {
    uint32_t d, m, l;
};

// One draw: the 1-D sample of an nx pattern (ny.d == 0, num == nx; one
// output row) or the 2-D sample of an nx x ny pattern (num = nx ny; rows
// row and row + 1), of the index si * mul + add.
struct DrawSpec {
    DrawDiv num, nx, ny;
    uint32_t mul, add;
    int row;
};

// One seed, hash_combine of n_ops operands: operand j is the lane's px,
// py or si (2 bits of src per operand: 1, 2, 3) or imm[j] (0); its draws
// are draw[draw0, draw0 + n_draws).
struct DrawSeed {
    uint32_t imm[6];
    uint32_t src;
    int n_ops, draw0, n_draws;
};

struct DrawPlan {
    DrawSeed seed[kMaxSeeds];
    DrawSpec draw[kMaxDraws];
    int n_seeds;
};

namespace {

constexpr int kMaxOps = 6;
constexpr int kThreads = 256;
enum : int { kImm = 0, kI32 = 1, kI64 = 2 };

__device__ __forceinline__ uint32_t load_u32(const Operand& a, int i) {
    const long long k = (long long)i * a.stride;
    if (a.kind == kI32) return (uint32_t)((const int32_t*)a.ptr)[k];
    if (a.kind == kI64)
        return (uint32_t)(unsigned long long)((const long long*)a.ptr)[k];
    return a.imm;
}

// hash_combine: a Wang-hash round over an FNV-ish accumulator per operand.
__device__ __forceinline__ uint32_t hash_step(uint32_t h, uint32_t v) {
    h ^= v + 0x9E3779B9u + (h << 6) + (h >> 2);
    h = (h ^ 61u) ^ (h >> 16);
    h += h << 3;
    h ^= h >> 4;
    h *= 0x27D4EB2Du;
    h ^= h >> 15;
    return h;
}

__device__ __forceinline__ uint32_t permute_round(uint32_t x, uint32_t p,
                                                  uint32_t w) {
    x ^= p;
    x *= 0xE170893Du;
    x ^= p >> 16;
    x ^= (x & w) >> 4;
    x ^= p >> 8;
    x *= 0x0929EB3Fu;
    x ^= p >> 23;
    x ^= (x & w) >> 1;
    x *= 1u | (p >> 27);
    x *= 0x6935FA69u;
    x ^= (x & w) >> 11;
    x *= 0x74DCB303u;
    x ^= (x & w) >> 2;
    x *= 0x9E501CC3u;
    x ^= (x & w) >> 2;
    x *= 0xC860A3DFu;
    x &= w;
    x ^= x >> 5;
    return x;
}

// Avalanche hash -> canonical float in [0, 1): u32 * 2.328306e-10f.
__device__ __forceinline__ float cmj_rand_float(uint32_t i, uint32_t p) {
    i ^= p;
    i ^= i >> 17;
    i ^= i >> 10;
    i *= 0xB36534E5u;
    i ^= i >> 12;
    i ^= i >> 21;
    i *= 0x93FC4795u;
    i ^= 0xDF6E307Fu;
    i ^= i >> 17;
    i *= 1u | (p >> 18);
    return __uint2float_rn(i) * __int_as_float(0x2f7ffffd);
}

// floor(n / d) by the divisor's magic number (module comment).
__device__ __forceinline__ uint32_t div_magic(uint32_t n,
                                              const DrawDiv& d) {
    const uint32_t t = __umulhi(n, d.m);
    return (t + ((n - t) >> min(d.l, 1u))) >> (d.l ? d.l - 1u : 0u);
}

__device__ __forceinline__ uint32_t mod_magic(uint32_t n,
                                              const DrawDiv& d) {
    return n - div_magic(n, d) * d.d;
}

// The cycle-walking permutation of i in [0, num.d) (the reference's
// cmj_permute), with the divisor's mask and its magic remainder. An i in
// range arrives within (w + 1) - num more rounds; the walk stops there in
// any case, as the plain version's fixed rounds do, so an index out of
// range (whose cycle in [0, w] may hold no value below num) cannot hang a
// lane.
__device__ __forceinline__ uint32_t permute_magic(uint32_t i,
                                                  const DrawDiv& num,
                                                  uint32_t p) {
    const uint32_t w = num.l >= 32u ? 0xffffffffu : (1u << num.l) - 1u;
    i = permute_round(i, p, w);
    for (uint32_t left = w - (num.d - 1u); i >= num.d && left; --left)
        i = permute_round(i, p, w);
    return mod_magic(i + p, num);
}

__global__ void __launch_bounds__(kThreads)
cmj_draws_kernel(const __grid_constant__ DrawPlan plan, Operand px,
                 Operand py, Operand si, float* __restrict__ out, int n) {
    const int i = blockIdx.x * kThreads + threadIdx.x;
    if (i >= n) return;
    const uint32_t x = load_u32(px, i), y = load_u32(py, i);
    const uint32_t s = load_u32(si, i);
    for (int k = 0; k < plan.n_seeds; ++k) {
        const DrawSeed& sd = plan.seed[k];
        uint32_t h = 0x9E3779B9u;
        for (int j = 0; j < sd.n_ops; ++j) {
            const uint32_t c = (sd.src >> (2 * j)) & 3u;
            h = hash_step(h, c == 1u ? x : c == 2u ? y : c == 3u ? s
                                                               : sd.imm[j]);
        }
        for (int d = sd.draw0; d < sd.draw0 + sd.n_draws; ++d) {
            const DrawSpec& ds = plan.draw[d];
            const uint32_t idx = s * ds.mul + ds.add;
            float* o = out + (long long)ds.row * n + i;
            if (ds.ny.d == 0u) {
                const uint32_t pidx =
                    permute_magic(idx, ds.nx, h * 0x8FF3CD11u);
                const float sx = cmj_rand_float(pidx, h * 0xA399D265u);
                o[0] = (__uint2float_rn(pidx) + sx)
                       / __uint2float_rn(ds.nx.d);
                continue;
            }
            const uint32_t pidx =
                permute_magic(idx, ds.num, h * 0xC2D3C8FBu);
            const uint32_t q = div_magic(pidx, ds.nx);
            const uint32_t ix = permute_magic(pidx - q * ds.nx.d, ds.nx,
                                              h * 0xA511E9B3u);
            const uint32_t iy = permute_magic(q, ds.ny, h * 0x63D83595u);
            const float sx = cmj_rand_float(pidx, h * 0xA399D265u);
            const float sy = cmj_rand_float(pidx, h * 0x711AD6A5u);
            o[0] = (__uint2float_rn(ix) + (__uint2float_rn(iy) + sx)
                    / __uint2float_rn(ds.ny.d)) / __uint2float_rn(ds.nx.d);
            o[(long long)n] = (__uint2float_rn(pidx) + sy)
                              / __uint2float_rn(ds.num.d);
        }
    }
}

// the plan, the three lane operands, out and n within 4 KB of parameters
static_assert(sizeof(DrawPlan) + 3 * sizeof(Operand) + 16 <= 4096,
              "the draw plan outgrows the kernel parameter space");

}  // namespace

extern "C" int rt_cmj_plan_bytes() { return (int)sizeof(DrawPlan); }

// One launch of a draw set (plan) at n lanes: out [n_out, n] float32.
extern "C" int rt_cmj_draws(const DrawPlan* plan, const Operand* px,
                            const Operand* py, const Operand* si, float* out,
                            int n, void* stream) {
    if (plan->n_seeds < 0 || plan->n_seeds > kMaxSeeds)
        return (int)cudaErrorInvalidValue;
    for (int k = 0; k < plan->n_seeds; ++k) {
        const DrawSeed& sd = plan->seed[k];
        if (sd.n_ops < 0 || sd.n_ops > kMaxOps || sd.draw0 < 0
            || sd.n_draws < 0 || sd.draw0 + sd.n_draws > kMaxDraws)
            return (int)cudaErrorInvalidValue;
        for (int d = sd.draw0; d < sd.draw0 + sd.n_draws; ++d) {
            const DrawSpec& ds = plan->draw[d];
            if (ds.nx.d == 0u || ds.num.d == 0u || ds.row < 0)
                return (int)cudaErrorInvalidValue;
        }
    }
    if (n == 0) return (int)cudaGetLastError();
    cmj_draws_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                       (cudaStream_t)stream>>>(*plan, *px, *py, *si, out, n);
    return (int)cudaGetLastError();
}
