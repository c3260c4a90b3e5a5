// K1: Viterbi decoder for the K=7, rate-1/2 code (polys 0o155 / 0o117).
//
// Replaces the Pallas TPU kernels jrc_tpu/ops/viterbi_pallas.py:95
// (_fwd_kernel, forward add-compare-select) and :151 (_tb_kernel,
// traceback). Plain PyTorch version: jrc_tpu_torch/ops/viterbi.py.
//
// What bounds it on the H100: the T steps of one frame are a serial
// dependency chain, and the work per step is tiny (128 adds, 64 compares,
// a 64-way min), so the forward pass is latency-bound, not bound by bytes
// or FLOPs (3072 frames x 600 steps read 15 MB of values).
// The design keeps each step's chain short: one warp per frame, lane u
// holding output states 2u and 2u+1. Both of them read pm[u] and pm[u+32]
// (the TPU kernel's half-plane butterfly), which two __shfl_sync bring to
// the lane; the 64 decisions are two __ballot_sync words (even and odd
// states) written by lane 0; the renormalizing min is five __shfl_xor_sync.
// Warps of different frames hide each other's latency on an SM.
//
// The traceback is one thread per frame walking the decision words back
// from the first-index argmin end state; the word reads are coalesced
// across frames, the bit writes are not (a later PR can pack them).
//
// Exactness: compiled with -fmad=false and without fast math, every
// float operation is the same IEEE-rounded mul/add as in the plain
// version, with the same per-step renormalization and the strict
// cand1 < cand0 tie rule, so the bits are identical for soft inputs too.
// T is not padded: the plain version takes its end state at step T.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int POLY_A = 0155;
constexpr int POLY_B = 0117;

__device__ __forceinline__ float expected_sign(int reg7, int poly) {
  return (__popc(reg7 & poly) & 1) ? 1.0f : -1.0f;
}

// values (B, 2T) f32 → words (T, 2, B) i32, end_state (B,) i32
__global__ void viterbi_acs_kernel(const float* __restrict__ values,
                                   int32_t* __restrict__ words,
                                   int32_t* __restrict__ end_state,
                                   int B, int T) {
  const int frame = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (frame >= B) return;  // uniform per warp
  const float* v = values + (size_t)frame * 2 * T;

  // sign tables of output states 2u (p=0) and 2u+1 (p=1) from
  // predecessor u + 32j; the 7-bit register is (prev << 1) | p
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
  // state s lives in lane s>>1, slot s&1: pm[u] in lane u>>1 and
  // pm[u+32] in lane 16+(u>>1), both in slot u&1. Lanes 0-15 are read
  // only for pm[u] and lanes 16-31 only for pm[u+32], so each shuffle
  // source can offer the slot its readers want.
  const int k = u >> 1;
  const int odd = u & 1;
  const int src1 = k + 16 * odd;
  const int src2 = k + 16 * (1 - odd);
  for (int t = 0; t < T; ++t) {
    const float va = v[2 * t];
    const float vb = v[2 * t + 1];
    const float s1 = __shfl_sync(FULL, lane < 16 ? pe : po, src1);
    const float s2 = __shfl_sync(FULL, lane < 16 ? po : pe, src2);
    const float lo = odd ? s2 : s1;  // pm[u]
    const float hi = odd ? s1 : s2;  // pm[u + 32]
    // branch cost −(2e−1)·v, as −(sa·va + sb·vb)
    const float c0e = lo + (-(sa[0][0] * va + sb[0][0] * vb));
    const float c1e = hi + (-(sa[0][1] * va + sb[0][1] * vb));
    const float c0o = lo + (-(sa[1][0] * va + sb[1][0] * vb));
    const float c1o = hi + (-(sa[1][1] * va + sb[1][1] * vb));
    const bool de = c1e < c0e;
    const bool dod = c1o < c0o;
    const float ne = de ? c1e : c0e;
    const float no = dod ? c1o : c0o;
    const unsigned we = __ballot_sync(FULL, de);
    const unsigned wo = __ballot_sync(FULL, dod);
    float m = fminf(ne, no);
    for (int off = 16; off > 0; off >>= 1) m = fminf(m, __shfl_xor_sync(FULL, m, off));
    pe = ne - m;
    po = no - m;
    if (lane == 0) {
      words[((size_t)t * 2 + 0) * B + frame] = (int32_t)we;
      words[((size_t)t * 2 + 1) * B + frame] = (int32_t)wo;
    }
  }
  // first-index argmin over the 64 final metrics
  float m = fminf(pe, po);
  for (int off = 16; off > 0; off >>= 1) m = fminf(m, __shfl_xor_sync(FULL, m, off));
  const unsigned be = __ballot_sync(FULL, pe == m);
  const unsigned bo = __ballot_sync(FULL, po == m);
  if (lane == 0) {
    const int se = be ? 2 * (__ffs(be) - 1) : 64;
    const int so = bo ? 2 * (__ffs(bo) - 1) + 1 : 64;
    end_state[frame] = se < so ? se : so;
  }
}

// words (T, 2, B), end_state (B,) → bits (B, T) u8
__global__ void viterbi_traceback_kernel(const int32_t* __restrict__ words,
                                         const int32_t* __restrict__ end_state,
                                         uint8_t* __restrict__ bits, int B, int T) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  int s = end_state[b];
  uint8_t* out = bits + (size_t)b * T;
  for (int t = T - 1; t >= 0; --t) {
    const unsigned w = (unsigned)words[((size_t)t * 2 + (s & 1)) * B + b];
    const int j = (w >> (s >> 1)) & 1;
    out[t] = (uint8_t)(s & 1);
    s = (s >> 1) + 32 * j;
  }
}

}  // namespace

extern "C" int jrc_viterbi_acs(const void* values, void* words, void* end_state,
                               int B, int T, void* stream) {
  if (B > 0 && T > 0) {
    const int threads = 128;  // 4 frames per block
    const int blocks = (B * 32 + threads - 1) / threads;
    viterbi_acs_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const float*)values, (int32_t*)words, (int32_t*)end_state, B, T);
  }
  return (int)cudaGetLastError();
}

extern "C" int jrc_viterbi_traceback(const void* words, const void* end_state, void* bits,
                                     int B, int T, void* stream) {
  if (B > 0 && T > 0) {
    const int threads = 128;
    viterbi_traceback_kernel<<<(B + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)words, (const int32_t*)end_state, (uint8_t*)bits, B, T);
  }
  return (int)cudaGetLastError();
}
