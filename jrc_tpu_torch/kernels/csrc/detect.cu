// K2: fused frame-detection front end over the IQ stream.
//
// Replaces the Pallas TPU kernel jrc_tpu/ops/detect_pallas.py:89
// (_detect_kernel). Plain PyTorch version: detect_front_end_plain in
// jrc_tpu_torch/ops/detect_cuda.py. Per sample it computes the lag-16
// autocorrelation a[n] over a 32-sample moving sum, the power over a
// 48-sample moving sum divided by 1.5, cor = |a|/p, the mask
// threshold < cor < 2, the gap-tolerant trigger (more than min_n_peaks
// mask hits in the trailing max_peak_distance samples) and the sparsify
// (no other trigger in that window); it writes a for every sample and,
// per 128-sample segment, the first trigger lane (128 = none) and the
// trigger count.
//
// What bounds it on the H100: the stream is read once (8 B/sample) and a
// written once (8 B/sample), 134 MB at the bench size, so the floor is
// ~40 us of HBM time; the ~30 elementwise passes of the shift-and-add
// moving sums are the real cost. The design keeps all of them in shared
// memory: one block per chunk of 32 segments (4096 samples) loads the chunk
// plus a left margin of whole segments covering the trigger chain's
// lookback (384 samples at fft_len=64), so no block needs another's
// results. The wrapper top-pads the stream with that margin of zeros (the
// plain version's zero history) and tail-pads to whole chunks, so the
// kernel reads no bounds. Each moving sum is the plain version's
// shift-and-add doubling chain in the same order, one pass per step with
// __syncthreads() between passes, over five ping-pong float buffers.
//
// Exactness: with -fmad=false and IEEE sqrt/div (no fast math) each value
// is the same sequence of rounded operations as the plain version, so a
// and the triggers match it exactly.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int SEG = 128;
constexpr int CHUNK_SEGS = 32;  // must match CHUNK_SEGS in ops/detect_cuda.py
constexpr int CHUNK = SEG * CHUNK_SEGS;
constexpr int THREADS = 512;

// Trailing-window sum of s over the block's local samples by binary
// shift-and-add doubling (the order of sync.moving_sum). Consumes s and t
// as scratch; returns a, which holds the sum.
__device__ float* moving_sum(float* s, float* t, float* a, int win, int L) {
  int shift = 0;
  bool have = false;
  for (int w = 1;; w *= 2) {
    if (win & w) {
      for (int i = threadIdx.x; i < L; i += blockDim.x) {
        const float part = i >= shift ? s[i - shift] : 0.0f;
        a[i] = have ? a[i] + part : part;
      }
      __syncthreads();
      shift += w;
      have = true;
    }
    if (2 * w > win) break;
    for (int i = threadIdx.x; i < L; i += blockDim.x)
      t[i] = s[i] + (i >= w ? s[i - w] : 0.0f);
    __syncthreads();
    float* tmp = s;
    s = t;
    t = tmp;
  }
  return a;
}

__global__ void __launch_bounds__(THREADS) detect_kernel(
    const float2* __restrict__ xp, float2* __restrict__ a_out,
    int32_t* __restrict__ first_out, int32_t* __restrict__ count_out, int n,
    int margin, float threshold, int min_n_peaks, int mpd, int lag, int win, int pwin) {
  extern __shared__ float smem[];
  const int L = CHUNK + margin;
  float* b0 = smem;
  float* b1 = b0 + L;
  float* b2 = b1 + L;
  float* b3 = b2 + L;
  float* b4 = b3 + L;
  uint8_t* mask = (uint8_t*)(b4 + L);
  uint8_t* trig = mask + L;
  // padded index of local sample 0; local i is stream sample base + i - margin
  const long base = (long)blockIdx.x * CHUNK;

  for (int i = threadIdx.x; i < L; i += blockDim.x) {
    const float2 v = xp[base + i];
    b0[i] = v.x;
    b1[i] = v.y;
  }
  __syncthreads();
  // c = x · conj(x delayed by lag), and |x|²
  for (int i = threadIdx.x; i < L; i += blockDim.x) {
    const float xr = b0[i], xi = b1[i];
    const float xdr = i >= lag ? b0[i - lag] : 0.0f;
    const float xdi = i >= lag ? b1[i - lag] : 0.0f;
    b2[i] = xr * xdr + xi * xdi;
    b3[i] = xi * xdr - xr * xdi;
    b4[i] = xr * xr + xi * xi;
  }
  __syncthreads();
  const float* are = moving_sum(b2, b0, b1, win, L);  // b1; b0, b2 free
  const float* aim = moving_sum(b3, b0, b2, win, L);  // b2; b0, b3 free
  const float* pws = moving_sum(b4, b0, b3, pwin, L);  // b3; b0, b4 free

  for (int i = threadIdx.x; i < L; i += blockDim.x) {
    const float p = pws[i] / 1.5f;
    const float cor = sqrtf(are[i] * are[i] + aim[i] * aim[i]) / fmaxf(p, 1e-12f);
    const bool m = (cor > threshold) && (cor < 2.0f);
    mask[i] = m;
    b0[i] = m ? 1.0f : 0.0f;
    const long g = base + i - margin;
    if (i >= margin && g < n) a_out[g] = make_float2(are[i], aim[i]);
  }
  __syncthreads();
  const float* piw = moving_sum(b0, b4, b1, mpd, L);  // b1
  for (int i = threadIdx.x; i < L; i += blockDim.x) {
    const bool tg = mask[i] && piw[i] > (float)min_n_peaks;
    trig[i] = tg;
    b2[i] = tg ? 1.0f : 0.0f;
  }
  __syncthreads();
  const float* recent = moving_sum(b2, b3, b0, mpd, L);  // b0
  for (int i = threadIdx.x; i < L; i += blockDim.x) {
    const float tf = trig[i] ? 1.0f : 0.0f;
    trig[i] = trig[i] && (recent[i] - tf == 0.0f);
  }
  __syncthreads();

  // one warp per segment: first trigger lane and count, samples ≥ n masked
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long n_seg = (n + SEG - 1) / SEG;
  for (int seg = warp; seg < CHUNK_SEGS; seg += THREADS / 32) {
    const long gseg = (long)blockIdx.x * CHUNK_SEGS + seg;
    if (gseg >= n_seg) continue;  // uniform per warp
    int first = SEG, count = 0;
    for (int q = 0; q < SEG / 32; ++q) {
      const int off = q * 32 + lane;
      const long g = gseg * SEG + off;
      const bool tg = g < n && trig[margin + seg * SEG + off];
      const unsigned bal = __ballot_sync(FULL, tg);
      if (first == SEG && bal) first = q * 32 + __ffs(bal) - 1;
      count += __popc(bal);
    }
    if (lane == 0) {
      first_out[gseg] = first;
      count_out[gseg] = count;
    }
  }
}

}  // namespace

extern "C" int jrc_detect_front_end(const void* xp, void* a, void* first, void* count,
                                    int n, int n_chunks, int margin, float threshold,
                                    int min_n_peaks, int mpd, int lag, int win, int pwin,
                                    void* stream) {
  if (n > 0) {
    const int L = CHUNK + margin;
    const size_t smem = (size_t)L * (5 * sizeof(float) + 2);
    cudaError_t err = cudaFuncSetAttribute(
        detect_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    detect_kernel<<<n_chunks, THREADS, smem, (cudaStream_t)stream>>>(
        (const float2*)xp, (float2*)a, (int32_t*)first, (int32_t*)count, n, margin,
        threshold, min_n_peaks, mpd, lag, win, pwin);
  }
  return (int)cudaGetLastError();
}
