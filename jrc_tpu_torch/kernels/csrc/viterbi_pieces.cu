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
// Plain PyTorch version: acs_pieces_plain in jrc_tpu_torch/ops/viterbi_pieces.py.
//
// The semantics are P3's own, not K1's: the metric starts at 1e9 except 0
// for state 0, is renormalized by pm[0] once per chunk_t steps (not by the
// min every step), and w0 packs the decisions of states 0-31 at bit s,
// w1 those of states 32-63 at bit s - 32. Inputs va, vb and outputs w0, w1
// are (T, B) (time-major, frames along the row, as the TPU kernel laid
// them), pm is (64, B).
//
// What bounds it on the H100: as K1, the T steps of a frame are a serial
// chain with tiny work per step, so latency. The layout is K1's: one warp
// per frame, lane u holding states 2u and 2u+1, whose predecessors pm[u]
// and pm[u+32] two __shfl_sync fetch (the `repeat` of the TPU body). The
// decisions are two __ballot_sync words (even and odd states), which lane
// 0 interleaves into P3's state-ordered w0/w1 (the `pack` of the TPU
// body). So `norepeat` removes exactly the two shuffles and `nopack`
// exactly the two ballots and the interleave. Exactness: -fmad=false, the
// same IEEE mul/add order as the plain version.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int POLY_A = 0155;
constexpr int POLY_B = 0117;
enum Variant { V_FULL = 0, V_NOPACK = 1, V_NOREPEAT = 2, V_NOACS = 3 };

__device__ __forceinline__ float expected_sign(int reg7, int poly) {
  return (__popc(reg7 & poly) & 1) ? 1.0f : -1.0f;
}

// the low 16 bits of x moved to the even bit positions 0, 2, ..., 30
__device__ __forceinline__ unsigned spread16(unsigned x) {
  x &= 0xffffu;
  x = (x | (x << 8)) & 0x00ff00ffu;
  x = (x | (x << 4)) & 0x0f0f0f0fu;
  x = (x | (x << 2)) & 0x33333333u;
  x = (x | (x << 1)) & 0x55555555u;
  return x;
}

template <int V>
__global__ void acs_pieces_kernel(const float* __restrict__ va, const float* __restrict__ vb,
                                  int32_t* __restrict__ w0, int32_t* __restrict__ w1,
                                  float* __restrict__ pm_out, int B, int T, int chunk_t) {
  const int frame = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (frame >= B) return;  // uniform per warp

  // sign tables of states 2u (p=0) and 2u+1 (p=1) from predecessor u + 32j
  const int u = lane;
  float sa[2][2], sb[2][2];
  for (int p = 0; p < 2; ++p)
    for (int j = 0; j < 2; ++j) {
      const int reg = ((u + 32 * j) << 1) | p;
      sa[p][j] = expected_sign(reg, POLY_A);
      sb[p][j] = expected_sign(reg, POLY_B);
    }

  float pe = (u == 0) ? 0.0f : 1e9f;  // metric of state 2u
  float po = 1e9f;                      // metric of state 2u+1
  // see viterbi.cu: each shuffle source offers the slot its readers want
  const int k = u >> 1;
  const int odd = u & 1;
  const int src1 = k + 16 * odd;
  const int src2 = k + 16 * (1 - odd);
  for (int t = 0; t < T; ++t) {
    const size_t at = (size_t)t * B + frame;
    const float a = va[at];
    const float b = vb[at];
    if (V == V_NOACS) {
      if (lane == 0) {
        const int32_t w = (int32_t)(a + b);
        w0[at] = w;
        w1[at] = w;
      }
    } else {
      float lo_e, hi_e, lo_o, hi_o;  // metrics the two candidates start from
      if (V == V_NOREPEAT) {
        lo_e = hi_e = pe;
        lo_o = hi_o = po;
      } else {
        const float s1 = __shfl_sync(FULL, lane < 16 ? pe : po, src1);
        const float s2 = __shfl_sync(FULL, lane < 16 ? po : pe, src2);
        lo_e = lo_o = odd ? s2 : s1;  // pm[u]
        hi_e = hi_o = odd ? s1 : s2;  // pm[u + 32]
      }
      // branch cost −(sa·va + sb·vb)
      const float c0e = lo_e + (-(sa[0][0] * a + sb[0][0] * b));
      const float c1e = hi_e + (-(sa[0][1] * a + sb[0][1] * b));
      const float c0o = lo_o + (-(sa[1][0] * a + sb[1][0] * b));
      const float c1o = hi_o + (-(sa[1][1] * a + sb[1][1] * b));
      const bool de = c1e < c0e;
      const bool dod = c1o < c0o;
      pe = fminf(c0e, c1e);
      po = fminf(c0o, c1o);
      if (V == V_NOPACK) {
        if (lane == 0) {
          w0[at] = de ? 1 : 0;
          w1[at] = de ? 1 : 0;
        }
      } else {
        const unsigned we = __ballot_sync(FULL, de);   // bit u: state 2u
        const unsigned wo = __ballot_sync(FULL, dod);  // bit u: state 2u+1
        if (lane == 0) {
          w0[at] = (int32_t)(spread16(we) | (spread16(wo) << 1));
          w1[at] = (int32_t)(spread16(we >> 16) | (spread16(wo >> 16) << 1));
        }
      }
    }
    if ((t + 1) % chunk_t == 0) {  // renormalize by pm[0] once per chunk
      const float m = __shfl_sync(FULL, pe, 0);
      pe = pe - m;
      po = po - m;
    }
  }
  pm_out[(size_t)(2 * u) * B + frame] = pe;
  pm_out[(size_t)(2 * u + 1) * B + frame] = po;
}

template <int V>
void launch(const void* va, const void* vb, void* w0, void* w1, void* pm, int B, int T,
            int chunk_t, cudaStream_t stream) {
  const int threads = 128;  // 4 frames per block
  const int blocks = (B * 32 + threads - 1) / threads;
  acs_pieces_kernel<V><<<blocks, threads, 0, stream>>>(
      (const float*)va, (const float*)vb, (int32_t*)w0, (int32_t*)w1, (float*)pm, B, T, chunk_t);
}

}  // namespace

// variant: 0 full, 1 nopack, 2 norepeat, 3 noacs; T a multiple of chunk_t
extern "C" int jrc_viterbi_pieces(const void* va, const void* vb, void* w0, void* w1, void* pm,
                                  int B, int T, int chunk_t, int variant, void* stream) {
  if (variant < 0 || variant > 3 || chunk_t <= 0 || T % chunk_t) return (int)cudaErrorInvalidValue;
  if (B > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    switch (variant) {
      case V_FULL: launch<V_FULL>(va, vb, w0, w1, pm, B, T, chunk_t, s); break;
      case V_NOPACK: launch<V_NOPACK>(va, vb, w0, w1, pm, B, T, chunk_t, s); break;
      case V_NOREPEAT: launch<V_NOREPEAT>(va, vb, w0, w1, pm, B, T, chunk_t, s); break;
      default: launch<V_NOACS>(va, vb, w0, w1, pm, B, T, chunk_t, s); break;
    }
  }
  return (int)cudaGetLastError();
}
