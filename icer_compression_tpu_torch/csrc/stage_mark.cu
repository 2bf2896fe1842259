// Stage marks of the ICER port: one one-thread kernel per stage of a device
// pass, launched at each stage boundary of the encode's and the decode's
// device passes (utils/trace.py, STAGES).
//
// No TPU kernel is replaced.  A device pass runs as one captured CUDA graph,
// and a replay runs no host code, so no host range can say which of its
// thousands of device records belongs to the context model, sort and pack,
// kernel 2 or the finalize.  A mark is a kernel of its own name in the
// graph: icer_mark<S> for stage S, so that in a profiler trace every record
// of a pass belongs to the stage that the last mark before it opened, and
// the last stage, the pass's end, closes it.
// Each mark adds one to its stage's slot of a per-device count (the
// first-use check holds that to the plain version, counts[S] += 1).
//
// Bound: one thread, one 8-byte load and store, so a mark costs its launch
// inside the graph; a pass holds at most about 20, a small part of the
// shortest pass the benchmark runs (a 1024x1024 tactical encode, ~48 ms).

#include <cuda_runtime.h>

constexpr int kStages = 8;

template <int S>
__global__ void icer_mark(unsigned long long* counts) {
  counts[S] += 1ULL;
}

template <int S>
static cudaError_t launch_mark(int stage, unsigned long long* counts,
                               cudaStream_t stream) {
  if constexpr (S < kStages) {
    if (stage == S) {
      icer_mark<S><<<1, 1, 0, stream>>>(counts);
      return cudaGetLastError();
    }
    return launch_mark<S + 1>(stage, counts, stream);
  } else {
    return cudaErrorInvalidValue;
  }
}

extern "C" int stage_mark_launch(int stage, void* counts, void* cuda_stream) {
  if (stage < 0 || stage >= kStages || counts == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_mark<0>(
      stage, static_cast<unsigned long long*>(counts),
      static_cast<cudaStream_t>(cuda_stream)));
}
