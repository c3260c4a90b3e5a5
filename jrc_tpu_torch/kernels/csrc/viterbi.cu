// K1: fused Viterbi decoder for the K=7, rate-1/2 code (polys 0o155 / 0o117).
//
// Replaces both Pallas TPU kernels of the decoder: the forward
// add-compare-select pass jrc_tpu/ops/viterbi_pallas.py:95 (_fwd_kernel) and
// the traceback jrc_tpu/ops/viterbi_pallas.py:151 (_tb_kernel). One launch
// takes values (B, 2T) float32 and writes bits (B, T) uint8. Plain PyTorch
// version: jrc_tpu_torch/ops/viterbi.py (viterbi_decode_plain).
//
// What bounds it on the H100. The function must move 8T bytes of values in
// and T bytes of bits out per frame: 3072 frames x 576 steps are 15.9 MB
// (4.8 us at 3.35 TB/s). Its arithmetic is 64 states x (2 adds, a
// compare-select, a compare of the 64-way min, a subtract) = 320 float
// operations a step, 5.7e8 at (3072, 576): 8.5 us at 67 TFLOP/s. So the
// roofline bound is operations, and the kernel is far from it, because what
// limits it is the schedulers' dispatch rate. The T steps of a frame are one serial chain
// (shuffle -> add -> min -> warp min -> subtract, about 150 cycles with the
// traceback's 25), which bounds a batch that leaves the card partly empty
// (below about 1000 frames). With every frame resident (23 warps an SM at
// B = 3072) a step costs each scheduler about 28 warp-wide SASS operations
// forward and 7 back, a third of them on the half-rate pipe (min, compare,
// select): about 50 scheduler cycles per frame and step, and
// 3072 x 576 x 50 / 528 a cycle at 1.98 GHz = 0.085 ms. Measured times stand in PERF.md.
//
// What the design does about it.
// * One warp per frame, four frames a block, no block-level barrier. The
//   64 decision bits of a step never leave the chip on the shared route:
//   they are two ballot words that lane 0 stores to shared memory (16 bytes
//   per two steps), and the same warp walks them back. When the batch does
//   not fit the card that way (kGlobal), a frame keeps only a 32-step window
//   in shared memory and flushes it, 256 bytes coalesced, to a frame-major
//   scratch (B, T, 2) that the wrapper allocates; every frame is then
//   resident and the words stay in the L2; the traceback reads the windows
//   back the same way, one ahead of the walk. Same kernel, a template flag;
//   ops/viterbi_cuda.py chooses from (B, T).
// * Values come in 32 steps ahead: lane l loads the float2 of step t0+32+l
//   (one coalesced 256-byte load per warp) while the warp works on t0..t0+31
//   out of a double-buffered shared-memory stage, so no device-memory latency
//   sits on the chain.
// * Few operations per step. Lane L runs butterfly u = rev5(L): states 2u
//   and 2u+1 from pm[u] and pm[u+32]. Butterflies u < 16 keep state 2u in x
//   and 2u+1 in y, the others the other way round, so the two shuffles that
//   bring pm[u] and pm[u+32] need no select before them. Both polynomials
//   have taps 0 and 6, so a butterfly's four branch costs are +-c for one
//   c = -(sa*va + sb*vb): one multiply and one fma by +-1 lane constants.
//   The survivor is fminf of the two candidates (the value the strict
//   compare-select gives); the decision is the sign of their difference,
//   flipped by a +-1 lane constant for odd butterflies. The 64-way
//   renormalizing min is two redux.sync on the raw float bits (a signed min,
//   and an unsigned max for when a value is negative).
// * The traceback is a short integer chain. The words of a step are fetched
//   by address t, independent of the state, 16 bytes per two steps, so the
//   loads run ahead. The walk keeps the decoded bits in one register, newest
//   at bit 0: its low 6 bits are the bit-reversed state, and because
//   butterfly u ran in lane rev5(u), its low 5 bits are the position of the
//   decision in the ballot word. A step is a select, a shift and an insert.
//   The decision of step t is decoded bit t-6, so after 32 steps the register
//   holds 32 decoded bits, and lane l writes the byte of bit l (32 contiguous
//   bytes per warp). Every lane walks redundantly.
//
// Per-row extent. A caller whose rows end in erasures (the SIG-driven
// receive path pads every frame with 0.0 to one shared envelope T) may pass
// n_steps (B,) int64: row b promises 0.0 at every step >= n_steps[b]. Its
// warp then runs add-compare-select over T_b = min(n_steps[b] + 6, T) steps,
// takes the end state there and traces back from T_b, and writes the zeros
// the full-envelope decode gives at bits [T_b, T). The launch lasts as long
// as its longest row's T_b, not T. The bits are those of the full envelope:
// past n_steps[b] every branch cost is +-0, so a step's new metrics are
// minima of the old ones and the renormalizing min stays exactly 0; after 6
// such steps every state is reached from every state of step n_steps[b],
// so every metric is the minimum over all 64, exactly 0. From there every
// compare is a tie (j = 0 under the strict compare), the first-index argmin
// is state 0, and the traceback from state 0 through j = 0 stays at state 0
// and emits 0s: the full decode reaches step T_b in state 0 with zeros
// after it, which is where and how the short run starts its traceback.
// The extents are a template flag beside the route's: a launch without them
// runs the code it ran before they existed, with the parameter T as every
// loop's bound (measured on the H100, the per-row bound cost a launch
// without extents up to 3% more per step).
// With steps_ring the launch also writes, for the call its stage clock
// (stamp.cu) counts, the longest row's T_b and T into that call's row of a
// (rows, 2) ring, each as call << 32 | steps, raised by atomicMax.
//
// Exactness: compiled with -fmad=false and without fast math. Every float
// operation is the same IEEE-rounded add as in the plain version: with
// factors +-1 the fma and -(sa*va + sb*vb) round identically; the sign of a
// float difference is exact and zero only for equal operands; the min over
// 64 states is the same float (a +-0 tie changes no later compare or sum);
// renormalization every step, strict cand1 < cand0, first-index argmin end
// state. A row runs to its T_b (T without n_steps), never beyond; the
// bits past it are the zeros shown above. So the bits are identical for
// finite soft inputs, ties included.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int POLY_A = 0155;
constexpr int POLY_B = 0117;
constexpr int WARPS = 4;    // frames per block
constexpr int WINDOW = 32;  // steps per staged chunk of values / decisions
constexpr int TAIL = 6;     // erasure steps after which every path metric is 0: the memory K-1
// the +-c symmetry of a lane's four branch costs needs both end taps
static_assert((POLY_A & 0101) == 0101 && (POLY_B & 0101) == 0101, "polys need taps 0 and 6");

__device__ __forceinline__ int parity7(int x) { return __popc(x & 0177) & 1; }
__device__ __forceinline__ int rev5(int x) { return (int)(__brev((unsigned)x) >> 27); }

// min over the warp of a float, as the float: on raw bits a signed min is
// right when every value is >= +0, else the most negative value has the
// largest unsigned image
__device__ __forceinline__ float warp_min(float v) {
  const int i = __float_as_int(v);
  const int lo = __reduce_min_sync(FULL, i);
  const unsigned hi = __reduce_max_sync(FULL, (unsigned)i);
  return __int_as_float(lo >= 0 ? lo : (int)hi);
}

struct Lane {
  int src1, src2;  // shuffle sources of the two predecessor metrics
  float ga, gb;    // +-1: the lane's branch cost is cz = ga*va + gb*vb
  float godd;      // -1 where the butterfly index is odd: flips a candidates' difference
};

// One add-compare-select step of a warp. x, y: the lane's two path metrics.
// Returns the step's two decision words (identical in every lane).
__device__ __forceinline__ uint2 acs_step(const Lane& ln, float va, float vb, float& x, float& y) {
  const float s1 = __shfl_sync(FULL, x, ln.src1);
  const float s2 = __shfl_sync(FULL, y, ln.src2);
  const float cz = fmaf(ln.ga, va, ln.gb * vb);  // exact: the factors are +-1
  // even butterfly: s1 = pm[u], s2 = pm[u+32]; odd: the other way round.
  // x's candidates are (p, q), y's are (r, s); which of a pair is the
  // j = 1 branch depends on the parity, the survivor does not.
  const float p = s1 + cz, q = s2 - cz;
  const float r = s1 - cz, s = s2 + cz;
  // the sign of a float difference is exact, and -0 < 0 is false: a tie
  // keeps j = 0 for either parity (strict cand1 < cand0)
  const bool dx = (q - p) * ln.godd < 0.0f;
  const bool dy = (s - r) * ln.godd < 0.0f;
  const float nx = fminf(p, q);
  const float ny = fminf(r, s);
  const float m = warp_min(fminf(nx, ny));
  x = nx - m;
  y = ny - m;
  return make_uint2(__ballot_sync(FULL, dx), __ballot_sync(FULL, dy));
}

// One traceback step. hist holds the decoded bits, newest decision at bit 0;
// its low 6 bits are the state before the step, bit-reversed (bit 5 = state
// bit 0). The butterfly u = state >> 1 ran in lane rev5(u) = hist & 31, and
// its decision is in word x when state bits 0 and 5 are equal.
__device__ __forceinline__ unsigned tb_step(unsigned wx, unsigned wy, unsigned hist) {
  const unsigned word = ((hist ^ (hist >> 5)) & 1u) ? wy : wx;
  return (hist << 1) | ((word >> (hist & 31u)) & 1u);
}

// zeros at out[t0, t1): bytes up to a 16-byte line, then lines, then bytes
__device__ __forceinline__ void zero_bytes(uint8_t* out, int t0, int t1, int lane) {
  const int head = min(t1, t0 + (int)((16u - ((uintptr_t)(out + t0) & 15u)) & 15u));
  if (t0 + lane < head) out[t0 + lane] = 0;
  const int lines = (t1 - head) / 16;
  uint4* line = reinterpret_cast<uint4*>(out + head);
  for (int i = lane; i < lines; i += 32) line[i] = make_uint4(0u, 0u, 0u, 0u);
  const int tail = head + 16 * lines;
  if (tail + lane < t1) out[tail + lane] = 0;
}

// values (B, 2T) f32 -> bits (B, T) u8; gdec (B, T, 2) u32 scratch if kGlobal;
// n_steps (B,) if kExtents; steps_ring (rows, 2) and call_counter (1,) or NULL
template <bool kGlobal, bool kExtents>
__global__ void __launch_bounds__(WARPS * 32)
viterbi_decode_kernel(const float2* __restrict__ values, uint2* gdec,
                      uint8_t* __restrict__ bits, int B, int T,
                      const long long* __restrict__ n_steps, unsigned long long* steps_ring,
                      const unsigned long long* call_counter, int rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int frame = blockIdx.x * WARPS + warp;
  if (frame >= B) return;  // uniform per warp; there is no block-level barrier
  // the row's own extent: it runs Tb steps, the rest of T is erasures
  const int Tb = kExtents ? (int)min((long long)T, max(n_steps[frame], 0ll) + TAIL) : T;
  if (steps_ring && lane == 0) {
    const unsigned long long call = *call_counter;
    if (call > 0) {
      unsigned long long* row = steps_ring + 2 * ((call - 1) % (unsigned long long)rows);
      atomicMax(row, (call << 32) | (unsigned)Tb);
      if (frame == 0) atomicMax(row + 1, (call << 32) | (unsigned)T);
    }
  }

  const int slots = kGlobal ? WINDOW : ((T + 1) & ~1);  // even: 16-byte aligned pairs
  const size_t per_warp = (size_t)slots * sizeof(uint2) + 2 * WINDOW * sizeof(float2);
  uint2* dec = reinterpret_cast<uint2*>(smem + warp * per_warp);
  float2* stage = reinterpret_cast<float2*>(dec + slots);
  const float2* v = values + (size_t)frame * T;
  uint2* gd = kGlobal ? gdec + (size_t)frame * T : nullptr;
  uint8_t* out = bits + (size_t)frame * T;

  // the lane runs butterfly u: states 2u and 2u+1 from pm[u] and pm[u+32]
  const int u = rev5(lane);
  Lane ln;
  {
    const int odd = u & 1;
    ln.src1 = rev5((u >> 1) + (odd ? 16 : 0));
    ln.src2 = rev5((u >> 1) + (odd ? 0 : 16));
    // expected outputs of the branch pm[u] -> state 2u: register u << 1.
    // c = -(sa*va + sb*vb) with sa = ea ? +1 : -1; x holds the odd state
    // where u >= 16 (cost -c), and odd butterflies swap the candidates' roles
    const int ea = parity7((u << 1) & POLY_A);
    const int eb = parity7((u << 1) & POLY_B);
    const float flip = ((u >> 4) ^ odd) ? -1.0f : 1.0f;
    ln.ga = (ea ? -1.0f : 1.0f) * flip;
    ln.gb = (eb ? -1.0f : 1.0f) * flip;
    ln.godd = odd ? -1.0f : 1.0f;
  }

  // ---- forward: add-compare-select ----
  float x = (lane == 0) ? 0.0f : 1e9f;  // state 0 is butterfly 0's x
  float y = 1e9f;
  const int nchunks = (Tb + WINDOW - 1) / WINDOW;
  if (lane < Tb) stage[lane] = v[lane];
  __syncwarp();
  for (int c = 0; c < nchunks; ++c) {
    const int t0 = c * WINDOW;
    const int n = min(WINDOW, Tb - t0);
    const int tn = t0 + WINDOW + lane;  // this lane's step of the next chunk
    float2 nxt = make_float2(0.0f, 0.0f);
    if (tn < Tb) nxt = v[tn];
    const float2* cur = stage + (c & 1) * WINDOW;
    uint2* d = dec + (kGlobal ? 0 : t0);
    if (n == WINDOW) {
      const float4* cur2 = reinterpret_cast<const float4*>(cur);
      uint4* d2 = reinterpret_cast<uint4*>(d);
#pragma unroll 4
      for (int i = 0; i < WINDOW / 2; ++i) {  // two steps per load and store
        const float4 vv = cur2[i];
        const uint2 w0 = acs_step(ln, vv.x, vv.y, x, y);
        const uint2 w1 = acs_step(ln, vv.z, vv.w, x, y);
        if (lane == 0) d2[i] = make_uint4(w0.x, w0.y, w1.x, w1.y);
      }
    } else {
      for (int i = 0; i < n; ++i) {
        const float2 vv = cur[i];
        const uint2 w = acs_step(ln, vv.x, vv.y, x, y);
        if (lane == 0) d[i] = w;
      }
    }
    stage[((c + 1) & 1) * WINDOW + lane] = nxt;
    if (kGlobal) {
      __syncwarp();
      if (lane < n) gd[t0 + lane] = dec[lane];
    }
    __syncwarp();
  }

  // ---- end state: first-index argmin; the renormalized minimum is 0 ----
  const int state_x = 2 * u + (u >> 4);
  const int state_y = 2 * u + 1 - (u >> 4);
  const int cand = min(x == 0.0f ? state_x : 64, y == 0.0f ? state_y : 64);
  const int end_state = __reduce_min_sync(FULL, cand);
  // bit k of the end state is decoded bit Tb-1-k
  if (lane < 6 && Tb - 1 - lane >= 0) out[Tb - 1 - lane] = (uint8_t)((end_state >> lane) & 1);
  if (kExtents) zero_bytes(out, Tb, T, lane);
  unsigned hist = __brev((unsigned)end_state) >> 26;

  // ---- traceback: every lane walks. The decision taken at step t is
  // decoded bit t-6, so after the steps t0+n-1 .. t0 bits 0..n-1 of hist are
  // decoded bits t0-6 .. t0+n-7, and lane l writes bit l ----
  uint2 ahead = make_uint2(0u, 0u);
  if (kGlobal) {
    const int t0 = (nchunks - 1) * WINDOW;
    if (t0 + lane < Tb) dec[lane] = gd[t0 + lane];
    __syncwarp();
  }
  for (int c = nchunks - 1; c >= 0; --c) {
    const int t0 = c * WINDOW;
    const int n = min(WINDOW, Tb - t0);
    if (kGlobal && c > 0) ahead = gd[t0 - WINDOW + lane];
    const uint2* d = dec + (kGlobal ? 0 : t0);
    if (n == WINDOW) {
      const uint4* d2 = reinterpret_cast<const uint4*>(d);
#pragma unroll
      for (int i = WINDOW / 2 - 1; i >= 0; --i) {
        const uint4 w = d2[i];
        hist = tb_step(w.z, w.w, hist);
        hist = tb_step(w.x, w.y, hist);
      }
    } else {
      for (int i = n - 1; i >= 0; --i) hist = tb_step(d[i].x, d[i].y, hist);
    }
    const int t = t0 - 6 + lane;
    if (lane < n && t >= 0) out[t] = (uint8_t)((hist >> lane) & 1u);
    if (kGlobal) {
      __syncwarp();
      dec[lane] = ahead;
      __syncwarp();
    }
  }
}

template <bool kGlobal, bool kExtents>
cudaError_t launch(const void* values, void* scratch, void* bits, int B, int T,
                   const void* n_steps, void* steps_ring, const void* call_counter, int rows,
                   cudaStream_t stream) {
  const size_t slots = kGlobal ? WINDOW : ((T + 1) & ~1);
  const size_t smem = WARPS * (slots * sizeof(uint2) + 2 * WINDOW * sizeof(float2));
  auto kernel = viterbi_decode_kernel<kGlobal, kExtents>;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  // once per device: allow the full 227 KB of dynamic shared memory and ask
  // for the largest shared-memory carveout, so residency is not cut by L1
  static unsigned long long configured = 0;
  const unsigned long long bit = 1ull << (device & 63);
  if (!(configured & bit)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    configured |= bit;
  }
  kernel<<<(B + WARPS - 1) / WARPS, WARPS * 32, smem, stream>>>(
      (const float2*)values, (uint2*)scratch, (uint8_t*)bits, B, T, (const long long*)n_steps,
      (unsigned long long*)steps_ring, (const unsigned long long*)call_counter, rows);
  return cudaGetLastError();
}

}  // namespace

// values (B, 2T) f32 (8-byte aligned) -> bits (B, T) u8. use_global = 0 keeps
// the decisions in shared memory (needs 4 * (8 * (T rounded up to even) + 512)
// <= 232448 bytes); use_global = 1 keeps them in scratch (B, T, 2) u32.
// n_steps (B,) i64 or NULL: each row's extent (see the head of this file).
// steps_ring (rows, 2) u64 and call_counter (1,) u64, or NULL: the count of
// the longest row's T_b and of T for the current call.
extern "C" int jrc_viterbi_decode(const void* values, void* scratch, void* bits, int B, int T,
                                  int use_global, const void* n_steps, void* steps_ring,
                                  const void* call_counter, int rows, void* stream) {
  if (B <= 0 || T <= 0) return (int)cudaGetLastError();
  using Launch = cudaError_t (*)(const void*, void*, void*, int, int, const void*, void*,
                                 const void*, int, cudaStream_t);
  static constexpr Launch kLaunch[2][2] = {{launch<false, false>, launch<false, true>},
                                           {launch<true, false>, launch<true, true>}};
  return (int)kLaunch[use_global != 0][n_steps != nullptr](
      values, scratch, bits, B, T, n_steps, steps_ring, call_counter, rows, (cudaStream_t)stream);
}
