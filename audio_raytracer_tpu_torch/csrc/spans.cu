// Device stage markers: the spans that survive a CUDA graph's replay.
//
// A host range (record_function, NVTX) runs only while Python runs, so a
// frame replayed from a captured graph has none of its stages' ranges.
// A kernel launched at a stage's begin and end is captured like any
// other, so every replay carries it on the device's own timeline. Each
// span's begin and end marker is a one-thread kernel with a name of its
// own, art_span_<span>_begin and art_span_<span>_end (a span's dots
// written as underscores): its name alone says which stage it bounds, in
// torch.profiler's device activities as in any other trace of kernels.
//
// Beside the name each marker keeps the stage's device time without a
// profiler: per span three 64-bit words of a small buffer, the begin
// marker's %globaltimer stamp, the summed nanoseconds from begin to end,
// and the number of ends. A span's begin and end run in the order of
// their stream, so the end reads the stamp of the begin before it. The
// span names and their order are utils/profiling.py::SPANS'.

#include <cuda_runtime.h>

#define ART_SPANS(X)                                                     \
  X(frame) X(trace) X(trace_bounce) X(trace_compact) X(trace_restore)  \
  X(permeation) X(reverb) X(process) X(step_loss) X(step_backward)     \
  X(step_adam) X(map_permeation)

typedef unsigned long long u64;

__device__ __forceinline__ u64 global_ns() {
  u64 t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// w: the span's three words (stamp, nanoseconds, count).
#define ART_SPAN_KERNELS(name)                                           \
  extern "C" __global__ void art_span_##name##_begin(u64* w) {          \
    w[0] = global_ns();                                                  \
  }                                                                      \
  extern "C" __global__ void art_span_##name##_end(u64* w) {            \
    w[1] += global_ns() - w[0];                                          \
    w[2] += 1;                                                           \
  }
ART_SPANS(ART_SPAN_KERNELS)

#define ART_SPAN_ENTRY(name) \
  {(const void*)art_span_##name##_begin, (const void*)art_span_##name##_end},
static const void* const kMarkers[][2] = {ART_SPANS(ART_SPAN_ENTRY)};
static const int kSpans = (int)(sizeof(kMarkers) / sizeof(kMarkers[0]));

// The number of spans, for the binding's check against its own list.
extern "C" int span_count(int* out) {
  *out = kSpans;
  return 0;
}

// Launch span ``span``'s begin (end = 0) or end marker on ``stream``;
// ``buf`` holds 3 words per span.
extern "C" int span_mark(int span, int end, u64* buf, void* stream) {
  if (span < 0 || span >= kSpans) return (int)cudaErrorInvalidValue;
  u64* w = buf + 3 * span;
  void* args[] = {&w};
  return (int)cudaLaunchKernel(kMarkers[span][end ? 1 : 0], dim3(1),
                               dim3(1), args, 0, (cudaStream_t)stream);
}
