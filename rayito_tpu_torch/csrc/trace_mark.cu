// trace_mark: one marker of a device span (utils/tracing.py).
//
// A span's begin and its end are each one launch of this kernel, enqueued
// in the stream between the span's kernels, so a CUDA graph that holds
// the span's work holds its markers too and every replay logs them. One
// thread takes the next slot of the device's log with an atomic add and
// writes (code, %globaltimer) there: the code names the span and whether
// this is its begin or its end, the time is the device's nanosecond
// clock. A slot past the log's end is counted but not written, so the
// host sees the overflow. The log's order is the order in which the
// markers ran, which in one stream is the order the host enqueued them.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void trace_mark_kernel(long long* __restrict__ log,
                                  int* __restrict__ cursor, int capacity,
                                  int code) {
    const int slot = atomicAdd(cursor, 1);
    if (slot >= capacity) return;
    unsigned long long now;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
    log[2 * (long long)slot] = code;
    log[2 * (long long)slot + 1] = (long long)now;
}

}  // namespace

extern "C" int rt_trace_mark(long long* log, int* cursor, int capacity,
                             int code, void* stream) {
    trace_mark_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(log, cursor,
                                                         capacity, code);
    return (int)cudaGetLastError();
}
