// Stage clock: one thread writes the device's %globaltimer (ns) into a ring
// of calls x stages, so the stages of a call captured into one CUDA graph
// can be timed on the device, replay after replay, without reading anything
// back during the call.
//
// This is instrumentation of the port, not the port of a TPU kernel; its
// plain version is the host-clock branch of stamp() in
// jrc_tpu_torch/utils/profiling.py, which writes the same layout.
//
// Layout: ring is (rows, 1 + stages) int64; column 0 of a row holds its call
// number (1, 2, ...), column 1 + s the time of stage s. counter holds the
// number of calls begun. Stage 0 begins a call: it advances the counter,
// takes row (counter - 1) % rows, writes the call number and its own time
// and clears the row's other stages, so a row whose call has not reached a
// stage reads 0 there. Every later stage writes into the row of the call
// begun last. The launches of one entry point run in stream order on one
// stream, so a single thread with no atomics suffices, and a replay never
// touches a row other than its own: a row is overwritten only `rows` calls
// later. A stamp before any call has begun writes nothing.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void stamp_kernel(long long* ring, unsigned long long* counter, int rows, int stages,
                             int stage) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  unsigned long long n = *counter;
  if (stage == 0) *counter = ++n;
  if (n == 0) return;
  long long* row = ring + (long long)((n - 1) % (unsigned long long)rows) * (1 + stages);
  if (stage == 0) {
    row[0] = (long long)n;
    for (int s = 1; s < stages; ++s) row[1 + s] = 0;
  }
  row[1 + stage] = (long long)t;
}

}  // namespace

// ring (rows, 1 + stages) i64, counter (1,) i64 -> one stamp of `stage`.
extern "C" int jrc_stamp(void* ring, void* counter, int rows, int stages, int stage,
                         void* stream) {
  stamp_kernel<<<1, 1, 0, (cudaStream_t)stream>>>((long long*)ring, (unsigned long long*)counter,
                                                   rows, stages, stage);
  return (int)cudaGetLastError();
}
