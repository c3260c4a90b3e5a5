// P1: row-permutation patterns of a (64, B) state, one body per variant.
//
// Replaces the Pallas TPU profiling kernel scripts/profile_shuffle.py:70
// (make, body :27), which timed candidate sublane shuffles for the Viterbi
// forward pass: STEPS steps of pm <- f(pm)·0.5 on a (64, B) float32
// state, with f one of
//   baseline    pm + 1 (no movement);
//   repeat2     y[s] = pm[s/2] + pm[32 + s/2] (the ACS butterfly's fetch);
//   interleave  y[2i] = pm[i], y[2i+1] = pm[16+i] in each half;
//   concat      the two halves swapped;
//   halves      y[s] = min(pm[s]+1, pm[s+32]+2), y[s+32] = min(pm[s]-1,
//               pm[s+32]-2) (half-plane elementwise, no movement);
//   roll8       y[s] = pm[(s - 8) mod 64].
// Plain PyTorch version: shuffle_pieces_plain in
// jrc_tpu_torch/ops/shuffle_pieces.py.
//
// On Hopper a sublane permutation is a warp shuffle. The layout is the
// half-plane one: one warp per column b, lane u holding rows u and u+32.
// Then concat and halves move nothing across lanes, and repeat2,
// interleave and roll8 take two __shfl_sync each (repeat2 adds the two
// halves in the source lane first, in the same order as the TPU body).
// What bounds it: the serial chain of STEPS dependent steps per column,
// latency; 3072 columns are 3072 warps. Exactness: -fmad=false, the same
// IEEE operations as the plain version.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
enum Variant { V_BASELINE = 0, V_REPEAT2, V_INTERLEAVE, V_CONCAT, V_HALVES, V_ROLL8 };

template <int V>
__global__ void shuffle_pieces_kernel(const float* __restrict__ x, float* __restrict__ out,
                                      int B, int steps) {
  const int col = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int u = threadIdx.x & 31;
  if (col >= B) return;  // uniform per warp
  float lo = x[(size_t)u * B + col];         // row u
  float hi = x[(size_t)(u + 32) * B + col];  // row u + 32
  for (int t = 0; t < steps; ++t) {
    float ylo, yhi;
    if (V == V_BASELINE) {
      ylo = lo + 1.0f;
      yhi = hi + 1.0f;
    } else if (V == V_REPEAT2) {
      const float q = lo + hi;  // pm[u] + pm[u+32]
      ylo = __shfl_sync(FULL, q, u >> 1);
      yhi = __shfl_sync(FULL, q, 16 + (u >> 1));
    } else if (V == V_INTERLEAVE) {
      const int src = (u >> 1) + 16 * (u & 1);
      ylo = __shfl_sync(FULL, lo, src);
      yhi = __shfl_sync(FULL, hi, src);
    } else if (V == V_CONCAT) {
      ylo = hi;
      yhi = lo;
    } else if (V == V_HALVES) {
      ylo = fminf(lo + 1.0f, hi + 2.0f);
      yhi = fminf(lo - 1.0f, hi - 2.0f);
    } else {  // V_ROLL8
      const int src = (u - 8) & 31;
      const float a = __shfl_sync(FULL, lo, src);
      const float c = __shfl_sync(FULL, hi, src);
      ylo = u >= 8 ? a : c;
      yhi = u >= 8 ? c : a;
    }
    lo = ylo * 0.5f;
    hi = yhi * 0.5f;
  }
  out[(size_t)u * B + col] = lo;
  out[(size_t)(u + 32) * B + col] = hi;
}

template <int V>
void launch(const void* x, void* out, int B, int steps, cudaStream_t stream) {
  const int threads = 128;  // 4 columns per block
  const int blocks = (B * 32 + threads - 1) / threads;
  shuffle_pieces_kernel<V><<<blocks, threads, 0, stream>>>((const float*)x, (float*)out, B, steps);
}

}  // namespace

// variant: 0 baseline, 1 repeat2, 2 interleave, 3 concat, 4 halves, 5 roll8;
// x, out (64, B) float32
extern "C" int jrc_shuffle_pieces(const void* x, void* out, int B, int steps, int variant,
                                  void* stream) {
  if (variant < 0 || variant > 5 || steps < 0) return (int)cudaErrorInvalidValue;
  if (B > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    switch (variant) {
      case V_BASELINE: launch<V_BASELINE>(x, out, B, steps, s); break;
      case V_REPEAT2: launch<V_REPEAT2>(x, out, B, steps, s); break;
      case V_INTERLEAVE: launch<V_INTERLEAVE>(x, out, B, steps, s); break;
      case V_CONCAT: launch<V_CONCAT>(x, out, B, steps, s); break;
      case V_HALVES: launch<V_HALVES>(x, out, B, steps, s); break;
      default: launch<V_ROLL8>(x, out, B, steps, s); break;
    }
  }
  return (int)cudaGetLastError();
}
