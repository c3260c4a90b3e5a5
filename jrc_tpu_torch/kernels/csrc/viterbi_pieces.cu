// P3: the pieces of the Viterbi forward pass, one body per variant.
//
// Replaces the Pallas TPU profiling kernel
// scripts/profile_viterbi_variants.py:103 (run_variant, body make_kernel
// :36), which timed four bodies of the ACS forward pass on the same grid:
//   full      the production body;
//   nopack    no decision packing: w0 = w1 = the decision of state 0;
//   norepeat  no butterfly: each state's two candidates both start from
//             its own metric;
//   noacs     no ACS: w0 = w1 = int32(va + vb), metrics untouched.
// Only `full` decodes anything; the others exist to be timed against it.
// Plain PyTorch version: viterbi_pieces_plain in jrc_tpu_torch/ops/viterbi_pieces.py.
//
// The semantics are P3's own, not K1's: the metric starts at 1e9 except 0
// for state 0, is renormalized by pm[0] once per chunk_t steps (not by the
// min every step), and w0 packs the decisions of states 0-31 at bit s,
// w1 those of states 32-63 at bit s - 32. Inputs va, vb and outputs w0, w1
// are (T, B), time-major; pm is (64, B).
//
// What bounds it on the H100. At the profiling shape (T, B) = (864, 3072) a
// case moves va, vb in and w0, w1 out, 16 bytes a frame-step, and pm once:
// 43.3 MB, 12.9 us at 3.35 TB/s. Its float work is 64 states x (two adds and
// a compare-select) a step: 5.2e8 operations, 7.7 us at 67 TFLOP/s. So the
// roofline bound is bytes. The ACS bodies cannot come near it: the T steps of
// a frame are one serial chain, and with every frame resident (24 warps an
// SM) the least they can take is set by the schedulers' issue rate, as for
// K1 (viterbi.cu). The machine code of the full body has 19.8 warp
// instructions a frame-step in its unrolled stage: two shuffles, four fma,
// the two decisions (subtract, sign flip, compare), two mins, two ballots, a
// shared load, lane 0's shared store and two integer adds (counted by
// scripts/pieces_floor_cuda.py, with the SM clock it reads under load:
// 1980 MHz). That is 3072 x 864 x 19.8 / (528 schedulers x 1.98 GHz) =
// 50 us; nopack 15.9 (40 us), norepeat 14.0 (35 us). They run at 1.7-2.0x
// that floor (PERF.md §6). noacs is a stream of 42.5 MB, bound by bytes.
//
// What the design does about it.
// * The values are staged, off the chain. A block runs F = 8 frames, one
//   warp each (a step's row of 8 words is a whole 32-byte sector). For every
//   stage of S = 32 steps each of the block's 256 threads copies one (step,
//   frame) element of va and vb with cp.async one stage ahead (4 bytes each:
//   any B, also a B*4 off every multiple of 16; zero-filled past T and B),
//   then turns it into (s, d, d, s) = (va + vb, va - vb, ...) in a
//   double-buffered shared tile. A branch cost is -(sa*va + sb*vb) with
//   sa, sb = +-1, which is +-s or +-d exactly (round to nearest is
//   symmetric): a lane reads its costs from the tile and computes none.
// * The decisions are collected and written as tiles. Lane 0 of a warp puts
//   a step's two ballot words in a double-buffered shared tile; after the
//   stage's one barrier every thread writes one (step, frame) pair, so a
//   warp stores rows of 8 consecutive frames of w0 and of w1.
// * No select before the shuffles. Lane mapping "butterfly": lane u runs
//   butterfly u, states 2u and 2u+1 from pm[u] and pm[u+32]; butterflies
//   u < 16 keep state 2u in x and 2u+1 in y, the others the other way
//   round. Then the two metrics a lane needs sit in x of one lane and y of
//   another: two shuffles, no select. Which of the two is pm[u] flips with
//   the parity of u; a +-1 lane constant folds that into the costs and into
//   the sign of the decisions (K1's rev5 mapping does the same). With the
//   butterflies in their own order the ballot words are w0 and w1 up to an
//   interleave of their halves, done in the tile write, off the chain. The
//   other mapping without a select, "state" (lane u holds states u and
//   u+32), gives w0 and w1 as the ballots are but takes four shuffles a
//   step; it ran 4-6% slower at every chunk_t on the H100, so it was
//   dropped (PERF.md §6).
// * Renormalization without a modulo: a template on chunk_t (16, 32, 64: at
//   fixed steps of a stage, or after every other stage) and a step counter
//   for any other chunk_t and for a short last stage. The counter alone
//   costs three instructions a step (add, compare, branch: 22.9 against
//   19.8) and ran 12-17% slower on every ACS case at 16, 32 and 64 on the
//   H100, so the templates stay.
//
// Exactness: -fmad=false, no fast math. fmaf(+-1, X, m) is the add m +- X
// rounded once, as the plain version's pm + bm; the sign of a float
// difference is exact, and a tie (difference +0, -0 after the sign flip)
// keeps j = 0, the strict cand1 < cand0; the survivor is fminf of the two
// candidates. So w0, w1 and pm equal the plain version's bit for bit,
// erasures (ties) included.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int POLY_A = 0155;
constexpr int POLY_B = 0117;
constexpr int F = 8;             // frames per block, one warp each
constexpr int S = 32;            // steps per stage
constexpr int THREADS = 32 * F;  // a thread stages one element and writes one pair a stage
static_assert(S * F == THREADS, "one staged element and one decision pair per thread");
constexpr int SROW = 4 * S + 4;  // floats per frame of a stage tile: (s, d, d, s) a step, padded
constexpr int DROW = 2 * S + 4;  // words per frame of a decision tile, padded
enum Variant { V_FULL = 0, V_NOPACK = 1, V_NOREPEAT = 2, V_NOACS = 3 };
// taps 0 and 6: a state's two branches, and states 2u, 2u+1, have opposite costs
static_assert((POLY_A & 0101) == 0101 && (POLY_B & 0101) == 0101, "polys need taps 0 and 6");

__device__ __forceinline__ float tap_sign(int reg, int poly) {
  return (__popc(reg & poly) & 1) ? 1.0f : -1.0f;
}

struct Lane {
  int src1, src2;  // shuffle sources
  int off;         // where the lane's cost value sits in a step's (s, d, d, s)
  float g;         // cost sign: cost = g * value
  float godd;      // -1 where u is odd, the sign of the decisions
};

// sign and value of the branch cost of register reg: -(sa*va + sb*vb) = g * (s or d)
__device__ __forceinline__ void cost_of(int reg, float& g, bool& is_s) {
  const float sa = tap_sign(reg, POLY_A);
  g = -sa;
  is_s = sa == tap_sign(reg, POLY_B);
}

// lane u runs butterfly u: states 2u and 2u + 1 from pm[u] and pm[u + 32]
template <bool kRepeat>
__device__ __forceinline__ Lane lane_setup(int u) {
  Lane ln;
  bool is_s;
  const int odd = u & 1;
  ln.src1 = (u >> 1) + (odd ? 16 : 0);  // x of these lanes: pm[u] (even u) or pm[u+32]
  ln.src2 = (u >> 1) + (odd ? 0 : 16);  // y: the other one
  float g2u;
  cost_of(2 * u, g2u, is_s);
  ln.off = is_s ? 0 : 1;
  ln.godd = odd ? -1.0f : 1.0f;
  const float gx = (u >> 4) ? -g2u : g2u;  // x holds 2u + 1 for u >= 16: the opposite cost
  ln.g = kRepeat ? gx * ln.godd : gx;
  return ln;
}

// One step of a warp on its metrics x, y from its stage row. Lane 0 keeps the
// result: the two ballot words, or (nopack) the decision of state 0.
template <int V>
__device__ __forceinline__ uint2 acs_step(const Lane& ln, const float* row, int i, float& x,
                                          float& y) {
  const float c = row[4 * i + ln.off];
  float p, q, r, s;  // x's candidates (p, q), y's (r, s)
  bool dx, dy;
  if constexpr (V == V_NOREPEAT) {  // from the state's own metric m: m + cost, m - cost
    p = fmaf(ln.g, c, x);
    q = fmaf(-ln.g, c, x);
    r = fmaf(-ln.g, c, y);
    s = fmaf(ln.g, c, y);
    dx = q < p;
    dy = s < r;
  } else {
    const float s1 = __shfl_sync(FULL, x, ln.src1);
    const float s2 = __shfl_sync(FULL, y, ln.src2);
    // even u: p, r from pm[u] (j = 0), q, s from pm[u+32]; odd u: the other way round
    p = fmaf(ln.g, c, s1);
    q = fmaf(-ln.g, c, s2);
    r = fmaf(-ln.g, c, s1);
    s = fmaf(ln.g, c, s2);
    dx = (q - p) * ln.godd < 0.0f;
    dy = (s - r) * ln.godd < 0.0f;
  }
  x = fminf(p, q);
  y = fminf(r, s);
  if constexpr (V == V_NOPACK) return make_uint2(dx ? 1u : 0u, 0u);  // lane 0's x is state 0
  return make_uint2(__ballot_sync(FULL, dx), __ballot_sync(FULL, dy));
}

// bit i of the low half to bit 2i, bit i of the high half to bit 2i + 1
__device__ __forceinline__ uint32_t outer_shuffle(uint32_t v) {
  v = ((v & 0x0000FF00u) << 8) | ((v >> 8) & 0x0000FF00u) | (v & 0xFF0000FFu);
  v = ((v & 0x00F000F0u) << 4) | ((v >> 4) & 0x00F000F0u) | (v & 0xF00FF00Fu);
  v = ((v & 0x0C0C0C0Cu) << 2) | ((v >> 2) & 0x0C0C0C0Cu) | (v & 0xC3C3C3C3u);
  v = ((v & 0x22222222u) << 1) | ((v >> 1) & 0x22222222u) | (v & 0x99999999u);
  return v;
}

// (w0, w1) from what lane 0 kept for a step
template <int V>
__device__ __forceinline__ uint2 state_words(uint2 kept) {
  if constexpr (V == V_NOPACK) return make_uint2(kept.x, kept.x);
  // butterfly u < 16 at bit u: x = state 2u, y = 2u+1; u >= 16: x = 2u+1, y = 2u
  return make_uint2(outer_shuffle(__byte_perm(kept.x, kept.y, 0x5410)),
                    outer_shuffle(__byte_perm(kept.y, kept.x, 0x7632)));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}

template <int V, int kChunk>
__global__ void __launch_bounds__(THREADS)
acs_pieces_kernel(const float* __restrict__ va, const float* __restrict__ vb,
                  int32_t* __restrict__ w0, int32_t* __restrict__ w1, float* __restrict__ pm_out,
                  int B, int T, int chunk_t) {
  __shared__ float raw[2][THREADS];                       // the thread's va, vb as copied
  __shared__ __align__(16) float stage[2][F][SROW];       // (s, d, d, s) a step and frame
  __shared__ __align__(16) uint32_t kept[2][F][DROW];     // lane 0's two words a step
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int f0 = blockIdx.x * F;
  const int ei = tid / F, ef = tid % F;  // the (step, frame) of a stage this thread moves
  const bool in_b = f0 + ef < B;
  const int n_stages = (T + S - 1) / S;

  const Lane ln = lane_setup<V != V_NOREPEAT>(lane);
  float x = lane == 0 ? 0.0f : 1e9f;  // state 0 is lane 0's x
  float y = 1e9f;

  auto copy_in = [&](int c) {  // stage c's element, zero past T and B
    const int t = c * S + ei;
    const bool ok = in_b && t < T;
    const size_t at = ok ? (size_t)t * B + f0 + ef : 0;
    cp_async4(&raw[0][tid], va + at, ok);
    cp_async4(&raw[1][tid], vb + at, ok);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  auto convert = [&](int buf) {  // once the thread's own copy has landed
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    const float a = raw[0][tid], b = raw[1][tid];
    const float s = a + b, d = a - b;
    *reinterpret_cast<float4*>(&stage[buf][ef][4 * ei]) = make_float4(s, d, d, s);
  };
  auto renormalize = [&]() {
    const float m = __shfl_sync(FULL, x, 0);  // pm[0]
    x -= m;
    y -= m;
  };

  if (n_stages > 0) {
    copy_in(0);
    convert(0);
  }
  __syncthreads();
  int left = chunk_t;  // steps to the next renormalization where the template fixes none
  for (int c = 0; c < n_stages; ++c) {
    const int buf = c & 1;
    if (c + 1 < n_stages) copy_in(c + 1);
    const float* row = stage[buf][warp];
    uint2* keep = reinterpret_cast<uint2*>(kept[buf][warp]);
    const int t0 = c * S;
    const int n = min(S, T - t0);
    if (n == S) {
#pragma unroll
      for (int i = 0; i < S; ++i) {
        const uint2 w = acs_step<V>(ln, row, i, x, y);
        if (lane == 0) keep[i] = w;
        if (kChunk > 0 && kChunk <= S) {
          if ((i + 1) % kChunk == 0) renormalize();
        } else if (kChunk == 0 && --left == 0) {
          renormalize();
          left = chunk_t;
        }
      }
      if (kChunk > S && (c + 1) % (kChunk / S) == 0) renormalize();
    } else {  // a shorter last stage: T is a multiple of chunk_t, not of S
      int to_go = chunk_t - t0 % chunk_t;
      for (int i = 0; i < n; ++i) {
        const uint2 w = acs_step<V>(ln, row, i, x, y);
        if (lane == 0) keep[i] = w;
        if (--to_go == 0) {
          renormalize();
          to_go = chunk_t;
        }
      }
    }
    if (c + 1 < n_stages) convert(buf ^ 1);
    __syncthreads();
    const int t = t0 + ei;
    if (in_b && t < T) {
      const uint2 w = state_words<V>(reinterpret_cast<const uint2*>(kept[buf][ef])[ei]);
      const size_t at = (size_t)t * B + f0 + ef;
      w0[at] = (int32_t)w.x;
      w1[at] = (int32_t)w.y;
    }
  }
  const int frame = f0 + warp;
  if (frame < B) {
    const int rx = 2 * lane + (lane >> 4), ry = 2 * lane + 1 - (lane >> 4);
    pm_out[(size_t)rx * B + frame] = x;
    pm_out[(size_t)ry * B + frame] = y;
  }
}

// noacs: an elementwise stream, 16 bytes a thread where every pointer allows it
template <bool kVec>
__global__ void noacs_pieces_kernel(const float* __restrict__ va, const float* __restrict__ vb,
                                    int32_t* __restrict__ w0, int32_t* __restrict__ w1,
                                    float* __restrict__ pm, size_t n, int B) {
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  const size_t first = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (kVec) {
    for (size_t i = first; i < n / 4; i += stride) {
      const float4 a = reinterpret_cast<const float4*>(va)[i];
      const float4 b = reinterpret_cast<const float4*>(vb)[i];
      const int4 w = make_int4((int32_t)(a.x + b.x), (int32_t)(a.y + b.y), (int32_t)(a.z + b.z),
                               (int32_t)(a.w + b.w));
      reinterpret_cast<int4*>(w0)[i] = w;
      reinterpret_cast<int4*>(w1)[i] = w;
    }
  } else {
    for (size_t i = first; i < n; i += stride) {
      const int32_t w = (int32_t)(va[i] + vb[i]);
      w0[i] = w;
      w1[i] = w;
    }
  }
  // the metrics as they start: renormalizing by pm[0] = 0 keeps them
  for (size_t i = first; i < (size_t)64 * B; i += stride) pm[i] = i < (size_t)B ? 0.0f : 1e9f;
}

using AcsKernel = void (*)(const float*, const float*, int32_t*, int32_t*, float*, int, int, int);

template <int V>
void launch_acs(const void* va, const void* vb, void* w0, void* w1, void* pm, int B, int T,
                int chunk_t, cudaStream_t s) {
  const AcsKernel kernel = chunk_t == 16   ? &acs_pieces_kernel<V, 16>
                           : chunk_t == 32 ? &acs_pieces_kernel<V, 32>
                           : chunk_t == 64 ? &acs_pieces_kernel<V, 64>
                                           : &acs_pieces_kernel<V, 0>;
  kernel<<<(B + F - 1) / F, THREADS, 0, s>>>((const float*)va, (const float*)vb, (int32_t*)w0,
                                             (int32_t*)w1, (float*)pm, B, T, chunk_t);
}

void launch_noacs(const void* va, const void* vb, void* w0, void* w1, void* pm, int B, int T,
                  cudaStream_t s) {
  const size_t n = (size_t)T * B;
  const bool vec = n % 4 == 0 && (((uintptr_t)va | (uintptr_t)vb | (uintptr_t)w0 |
                                   (uintptr_t)w1) & 15) == 0;
  const size_t items = vec ? n / 4 : n;
  const int threads = 256;
  const size_t most = items > (size_t)64 * B ? items : (size_t)64 * B;
  const size_t want = (most + threads - 1) / threads;
  const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);  // 16 blocks an SM, then a stride
  if (vec)
    noacs_pieces_kernel<true><<<blocks, threads, 0, s>>>(
        (const float*)va, (const float*)vb, (int32_t*)w0, (int32_t*)w1, (float*)pm, n, B);
  else
    noacs_pieces_kernel<false><<<blocks, threads, 0, s>>>(
        (const float*)va, (const float*)vb, (int32_t*)w0, (int32_t*)w1, (float*)pm, n, B);
}

}  // namespace

// variant: 0 full, 1 nopack, 2 norepeat, 3 noacs; T a multiple of chunk_t
extern "C" int jrc_viterbi_pieces(const void* va, const void* vb, void* w0, void* w1, void* pm,
                                  int B, int T, int chunk_t, int variant, void* stream) {
  if (variant < 0 || variant > 3 || chunk_t <= 0 || T % chunk_t) return (int)cudaErrorInvalidValue;
  if (B > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    switch (variant) {
      case V_FULL: launch_acs<V_FULL>(va, vb, w0, w1, pm, B, T, chunk_t, s); break;
      case V_NOPACK: launch_acs<V_NOPACK>(va, vb, w0, w1, pm, B, T, chunk_t, s); break;
      case V_NOREPEAT: launch_acs<V_NOREPEAT>(va, vb, w0, w1, pm, B, T, chunk_t, s); break;
      case V_NOACS: launch_noacs(va, vb, w0, w1, pm, B, T, s); break;
    }
  }
  return (int)cudaGetLastError();
}
