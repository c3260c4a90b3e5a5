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
// What bounds it on the H100. The 3072 columns are independent chains of
// 864 dependent steps on 64 floats. A case reads and writes the state once
// (1.6 MB, 0.5 us at 3.35 TB/s) and does 1.7e8-6.8e8 float operations
// (2.5-10.1 us at 67 TFLOP/s, the bound that jrc_tpu_torch/profiling.py
// counts). Two things sit above it:
// * movement: a row that crosses lanes is a shuffle, and the shuffle pipe
//   moves 32 lanes a clock per SM against 128 for float32 adds and
//   multiplies. One shuffled element a row and step is 3072 x 64 x 864 /
//   (132 SMs x 32) = 40 216 clocks, 20.3 us at 1980 MHz (the SM clock
//   under load and the shuffles a step in the machine code:
//   scripts/pieces_floor_cuda.py);
// * occupancy: at 2 rows a lane the 3072 columns are 3072 warps (24 an SM,
//   every scheduler busy); at 16 rows a lane they are 384 warps, at most
//   one a scheduler and three of an SM's four in use.
//
// What the design does about it. Each variant runs on the layout that moves
// least, each a template instance:
// * half-plane, 32 lanes a column, lane u holding rows u and u+32: baseline,
//   halves and concat move nothing across lanes (concat is a register swap)
//   and keep every scheduler busy. repeat2 stays here: a lane fetches the
//   values its two rows take (two shuffles; q = (pm[u] + pm[u+32])·0.5 is
//   computed once, in its source lane). No layout with more than one lane a
//   column was found that shuffles less: a shuffle brings one value to every
//   lane, and under one program for all lanes a slot whose value is the
//   lane's own in one lane comes from another lane in the others. So repeat2
//   sits on the 20.3 us shuffle floor.
// * quads, 4 lanes a column, 16 rows a lane: a lane then holds the source
//   and the destination of every row, and the permutation is register
//   moves, no shuffle. roll8: lane j holds rows 4m + j, slot m takes slot
//   m - 2. interleave rotates the low 5 bits of a row left and keeps bit 5,
//   so the rows fall into 12 cycles of 5 and 4 fixed rows: lane j holds
//   cycles 3j .. 3j+2, each in rotation order, and fixed row j; a step turns
//   each cycle by one slot.
// * The step loop is unrolled by a multiple of each permutation's order (8;
//   10 for interleave's 5-cycles), so the unrolled loop carries no register
//   move; a remainder loop takes the last steps (863 is tested).
// * The halving is folded into an fma where it rounds the same: for any
//   float a and c in {+-1, +-2}, a + c rounds to 0 or to at least 2^-24 in
//   magnitude (near -c the sum is exact by Sterbenz and a multiple of a's
//   ulp; elsewhere it is at least 0.5), so halving it is exact and
//   fma(a, 0.5, c/2), which rounds (a + c)/2 once, is the same float. min
//   commutes with that exact halving. So baseline is one fma a row and step,
//   halves four fma and two min a pair of rows. repeat2's (p + q)·0.5 stays
//   an add and a multiply: p + q may cancel to where halving rounds.
// Exactness: -fmad=false, every other operation the plain version's IEEE
// add, multiply or min, so the state equals the plain version's bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
enum Variant { V_BASELINE = 0, V_REPEAT2, V_INTERLEAVE, V_CONCAT, V_HALVES, V_ROLL8 };

__host__ __device__ constexpr int lanes_per_column(int v) {
  return v == V_INTERLEAVE || v == V_ROLL8 ? 4 : 32;
}
__host__ __device__ constexpr int unroll(int v) { return v == V_INTERLEAVE ? 10 : 8; }
__host__ __device__ constexpr int threads_per_block(int v) {
  return lanes_per_column(v) == 32 ? 128 : 32;
}

// interleave's cycles (one row of each) and fixed rows; quad lane j holds
// cycles 3j .. 3j+2 and fixed row j
__constant__ int kCycles[12] = {1, 3, 5, 7, 11, 15, 33, 35, 37, 39, 43, 47};
__constant__ int kFixed[4] = {0, 31, 32, 63};

// interleave: y[2i] = pm[i], y[2i+1] = pm[16+i] in each half, so row r goes to row rotl5(r)
__device__ __forceinline__ int rotl5(int r) { return (r & 32) | ((r << 1) & 31) | ((r >> 4) & 1); }

// the row in register slot m of lane j of a column
template <int V>
__device__ __forceinline__ int row_of(int j, int m) {
  if constexpr (lanes_per_column(V) == 32) return j + 32 * m;
  if constexpr (V == V_ROLL8) return 4 * m + j;
  if (m == 15) return kFixed[j];
  int r = kCycles[3 * j + m / 5];
  for (int k = 0; k < m % 5; ++k) r = rotl5(r);
  return r;
}

// one step pm <- f(pm)·0.5 on a lane's rows
template <int V, int R>
__device__ __forceinline__ void step(float (&r)[R], int j) {
  float y[R];
  if constexpr (V == V_BASELINE) {
#pragma unroll
    for (int m = 0; m < R; ++m) y[m] = fmaf(r[m], 0.5f, 0.5f);  // (pm + 1)·0.5
  } else if constexpr (V == V_REPEAT2) {
    const float q = (r[0] + r[1]) * 0.5f;  // rows j, j+32: the value rows 2j, 2j+1 take
    y[0] = __shfl_sync(FULL, q, j >> 1);
    y[1] = __shfl_sync(FULL, q, 16 + (j >> 1));
  } else if constexpr (V == V_CONCAT) {
    y[0] = r[1] * 0.5f;
    y[1] = r[0] * 0.5f;
  } else if constexpr (V == V_HALVES) {
    y[0] = fminf(fmaf(r[0], 0.5f, 0.5f), fmaf(r[1], 0.5f, 1.0f));    // min(a+1, b+2)·0.5
    y[1] = fminf(fmaf(r[0], 0.5f, -0.5f), fmaf(r[1], 0.5f, -1.0f));  // min(a-1, b-2)·0.5
  } else if constexpr (V == V_ROLL8) {
#pragma unroll
    for (int m = 0; m < R; ++m) y[m] = r[(m + R - 2) % R] * 0.5f;  // row 4m+j <- 4m+j-8
  } else {  // V_INTERLEAVE
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int p = 0; p < 5; ++p) y[5 * c + (p + 1) % 5] = r[5 * c + p] * 0.5f;
    y[15] = r[15] * 0.5f;
  }
#pragma unroll
  for (int m = 0; m < R; ++m) r[m] = y[m];
}

template <int V>
__global__ void __launch_bounds__(128)
shuffle_pieces_kernel(const float* __restrict__ x, float* __restrict__ out, int B, int steps) {
  constexpr int G = lanes_per_column(V), R = 64 / G, U = unroll(V);
  const int gid = blockIdx.x * blockDim.x + threadIdx.x;
  const int col = gid / G, j = gid % G;
  if (col >= B) return;  // uniform per warp where lanes shuffle (G = 32)
  float r[R];
#pragma unroll
  for (int m = 0; m < R; ++m) r[m] = x[(size_t)row_of<V>(j, m) * B + col];
  int t = 0;
  for (; t + U <= steps; t += U) {
#pragma unroll
    for (int k = 0; k < U; ++k) step<V>(r, j);
  }
  for (; t < steps; ++t) step<V>(r, j);
#pragma unroll
  for (int m = 0; m < R; ++m) out[(size_t)row_of<V>(j, m) * B + col] = r[m];
}

template <int V>
void launch(const void* x, void* out, int B, int steps, cudaStream_t stream) {
  constexpr int threads = threads_per_block(V);
  const long long total = (long long)B * lanes_per_column(V);
  const int blocks = (int)((total + threads - 1) / threads);
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
