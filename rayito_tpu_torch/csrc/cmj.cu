// cmj: the sample streams in native uint32, one thread per lane. Two
// kernels: cmj_hash_kernel (the per-purpose seed hash, hash_combine of up
// to 6 operands) and cmj_sample_kernel (Kensler's correlated multi-jittered
// sample of an index, 1-D or 2-D).
//
// Replaces no pallas_call: it is the reference's XLA uint32 arithmetic
// (rayito_tpu/ops/rng.py:74-205, cmj_permute's cycle walk a
// lax.while_loop at :134), which the port ran as plain torch ops
// (ops/rng.py *_plain): every uint32 held in an int64 tensor, each
// wrapping multiply split into 16-bit halves, and on the card a host-fixed
// (w + 1) - num masked rounds of the walk, since a CUDA graph cannot hold
// a loop whose trip count the device decides. Here each lane runs its own
// do { round } while (x >= num), at most (w + 1) - num rounds after the
// first: the same bits as the reference's masked while_loop (a lane that
// has arrived holds its value there) and as the fixed rounds (the round is
// a bijection on [0, w]: a walk from an index in range visits each
// out-of-range value at most once, and a lane in range stays put).
//
// Operands: an int32 or int64 tensor (its low 32 bits, as u32() of the
// plain version takes them) with stride 1, or 0 for a one-element tensor,
// or an immediate. The sample's index is index * mul + add in uint32, so
// that the light loop's flat index si * nls + lsi needs no op of its own.
// The float tail runs in the reference's operation order: u32 -> f32
// rounds to nearest (.astype(float32)), then (pidx + sx) / n and
// (ix + (iy + sx) / ny) / nx with IEEE division (-prec-div=true, no FMA).
//
// What bounds it on the H100: the instructions each lane issues (in the
// built SASS, tools/cmj_sass.py: 31 per cycle-walk round after the first,
// its invariants hoisted; 24-29 per seed-hash operand; 145 per 1-D and
// 361 per 2-D sample besides those rounds), at one warp instruction per
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

namespace {

constexpr int kMaxOps = 6;
constexpr int kThreads = 256;
enum : int { kImm = 0, kI32 = 1, kI64 = 2 };

struct HashArgs {
    Operand op[kMaxOps];
    int n_ops;
};

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

// The cycle-walking permutation of i in [0, num), num >= 1. An i in range
// arrives within (w + 1) - num more rounds; the walk stops there in any
// case, as the plain version's fixed rounds do, so an index out of range
// (whose cycle in [0, w] may hold no value below num) cannot hang a lane.
__device__ __forceinline__ uint32_t cmj_permute(uint32_t i, uint32_t num,
                                                uint32_t p) {
    uint32_t w = num - 1u;
    w |= w >> 1;
    w |= w >> 2;
    w |= w >> 4;
    w |= w >> 8;
    w |= w >> 16;
    i = permute_round(i, p, w);
    for (uint32_t left = w - (num - 1u); i >= num && left; --left)
        i = permute_round(i, p, w);
    return (i + p) % num;
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

__global__ void __launch_bounds__(kThreads)
cmj_hash_kernel(HashArgs a, long long* __restrict__ out, int n) {
    const int i = blockIdx.x * kThreads + threadIdx.x;
    if (i >= n) return;
    uint32_t h = 0x9E3779B9u;
    for (int k = 0; k < a.n_ops; ++k) h = hash_step(h, load_u32(a.op[k], i));
    out[i] = (long long)h;
}

// ny == 0: the 1-D sample of an nx pattern (d1 only); else the 2-D sample
// of an nx x ny pattern.
__global__ void __launch_bounds__(kThreads)
cmj_sample_kernel(Operand index, uint32_t mul, uint32_t add, Operand perm,
                  uint32_t nx, uint32_t ny, float* __restrict__ d1,
                  float* __restrict__ d2, int n) {
    const int i = blockIdx.x * kThreads + threadIdx.x;
    if (i >= n) return;
    const uint32_t idx = load_u32(index, i) * mul + add;
    const uint32_t p = load_u32(perm, i);
    if (ny == 0) {
        const uint32_t pidx = cmj_permute(idx, nx, p * 0x8FF3CD11u);
        const float sx = cmj_rand_float(pidx, p * 0xA399D265u);
        d1[i] = (__uint2float_rn(pidx) + sx) / __uint2float_rn(nx);
        return;
    }
    const uint32_t num = nx * ny;
    const uint32_t pidx = cmj_permute(idx, num, p * 0xC2D3C8FBu);
    const uint32_t ix = cmj_permute(pidx % nx, nx, p * 0xA511E9B3u);
    const uint32_t iy = cmj_permute(pidx / nx, ny, p * 0x63D83595u);
    const float sx = cmj_rand_float(pidx, p * 0xA399D265u);
    const float sy = cmj_rand_float(pidx, p * 0x711AD6A5u);
    d1[i] = (__uint2float_rn(ix) + (__uint2float_rn(iy) + sx)
             / __uint2float_rn(ny)) / __uint2float_rn(nx);
    d2[i] = (__uint2float_rn(pidx) + sy) / __uint2float_rn(num);
}

}  // namespace

extern "C" int rt_hash_combine(const Operand* ops, int n_ops, int n,
                               long long* out, void* stream) {
    if (n_ops < 0 || n_ops > kMaxOps) return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaGetLastError();
    HashArgs a{};
    for (int k = 0; k < n_ops; ++k) a.op[k] = ops[k];
    a.n_ops = n_ops;
    cmj_hash_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                      (cudaStream_t)stream>>>(a, out, n);
    return (int)cudaGetLastError();
}

extern "C" int rt_cmj_sample(const Operand* index, uint32_t mul,
                             uint32_t add, const Operand* perm, int nx,
                             int ny, float* d1, float* d2, int n,
                             void* stream) {
    if (nx < 1 || ny < 0 || (long long)nx * (ny ? ny : 1) > 0xffffffffll)
        return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaGetLastError();
    cmj_sample_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                        (cudaStream_t)stream>>>(
        *index, mul, add, *perm, (uint32_t)nx, (uint32_t)ny, d1, d2, n);
    return (int)cudaGetLastError();
}
