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
// trigger count. Given the row layout of the caller's blocks, the same
// entry point then launches the trigger selection over those outputs
// (select_kernel, below; plain version: select_plain), in place of the
// sorts and the unrolled suppression scan that followed the Pallas kernel.
//
// What bounds it on the H100: bytes, 8 B/sample read and 8 B/sample of a
// written, 134 MB at the bench size. The arithmetic (three moving sums by
// shift-and-add doubling, an IEEE sqrt and a division per sample) fits
// under that only if it stays in registers, so the design keeps no sample
// in shared memory:
//  * a block owns a chunk of 4096 samples and recomputes the mask of a
//    margin before it (the trigger chain's lookback, 2·(max_peak_distance−1)
//    rounded up to whole warp rows), so blocks are independent. It reads
//    the stream itself: samples before 0 and from n on are loaded as zeros
//    (the plain version's zero history), no padded copy is made.
//  * the rows of 32 samples (sample ↔ lane) of chunk + margin are dealt
//    to the block's 8 warps in contiguous runs. A warp walks its run row
//    by row and carries, for each of the three sums and each doubling
//    level, the previous row's value in a register: "the level's value
//    `shift` samples back" is one warp shuffle of (this row | previous
//    row), or the previous row's register where shift = 32. Each warp
//    first runs ceil((max(win, pwin) − 1)/32) warm-up rows, after which its
//    sums are those of the whole stream. Every sum is the plain version's
//    chain (doubling, then the set bits of the window from the lowest) in
//    the same order, so a is exact and the three sums share every sweep.
//    Rows go two a turn so that the carries swap roles instead of moving,
//    and the next turn's samples are loaded before this turn's arithmetic. The
//    square root and the two divisions are taken only where |a|² is within
//    reach of the threshold (an exact shortcut: see `skip`).
//  * the mask of a row is one ballot word in shared memory. The counts
//    over the trailing max_peak_distance samples (mask, then trigger) are
//    __popc over those words: whole words plus two masked partial ones.
//    They equal the plain version's float moving sums exactly, because
//    every partial sum there is an integer ≤ max_peak_distance. The
//    per-segment first trigger and count read the ballot words directly.
//  * shared memory is two words per row (about 1.1 KB a block), so
//    registers alone set the occupancy.
// The doubling levels are compiled for the two numerologies (win, pwin) =
// (32, 48) and (64, 96); any other window below 128 whose set bits leave
// every shift at or below 32 runs the generic instance.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W, 2^23 samples): the kernel alone
// takes 0.078-0.084 ms, half the card's memory rate. A row costs about 125
// SASS operations a warp, issued at about half the schedulers' rate: each
// level of a sum is select, shuffle, add in a chain, and the registers leave
// 8 warps a scheduler to hide it. 128 or 512 threads a block, a chunk of 8192, more
// blocks an SM (spills), the lagged samples by shuffle, and loads without
// bounds checks for inner blocks were each measured no faster.
//
// The sc16 wire: the stream may also be int16 (re, im) pairs with a float32
// scale dq (4 B/sample read instead of 8). The kernel is a template on the
// sample type; a short2 sample is converted with __int2float_rn and
// multiplied once by dq as it is loaded (the product rounded to float32
// before anything else touches it, -fmad=false keeps it out of any later
// multiply-add), so every later operation sees exactly the plain version's
// q.to(float32) * dq and no dequantized copy of the stream is ever written.
// All offsets are in samples (pointer arithmetic on the sample type).
//
// Exactness: with -fmad=false and IEEE sqrt/div (no fast math) each value
// is the same sequence of rounded operations as the plain version, so a
// and the triggers match it exactly.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int SEG = 128;
constexpr int ROW = 32;             // samples per warp row
constexpr int CHUNK_SEGS = 32;      // must match CHUNK_SEGS in ops/detect_cuda.py
constexpr int CHUNK = SEG * CHUNK_SEGS;
constexpr int THREADS = 256;        // must match WARPS · 32 in ops/detect_cuda.py
constexpr int WARPS = THREADS / ROW;
constexpr int LEVELS = 7;           // window sums of 1, 2, ..., 64 samples

// The value `sh` samples back (0 ≤ sh ≤ 32) of a quantity of which `cur`
// is this row's and `prev` the previous row's value at this lane. (The
// shuffle takes its source lane modulo 32, so lane − sh wraps by itself.)
__device__ __forceinline__ float shifted(float cur, float prev, int sh, int lane) {
  if (sh == 0) return cur;
  if (sh == ROW) return prev;
  const float src = lane < ROW - sh ? cur : prev;
  return __shfl_sync(FULL, src, lane - sh);
}

// One stream sample as float2: an fc32 sample as it is, an sc16 sample
// dequantized (each component one rounded float32 product).
__device__ __forceinline__ float2 load_sample(const float2* p, float) { return __ldg(p); }
__device__ __forceinline__ float2 load_sample(const short2* p, float dq) {
  const short2 q = __ldg(p);
  return make_float2(__int2float_rn(q.x) * dq, __int2float_rn(q.y) * dq);
}

// A compile-time integer handed to a generic lambda.
template <int V>
struct Const {
  static constexpr int value = V;
};

// One trailing-window sum, advanced a row at a time: prev[P][l] is the
// previous row's sum over 2^l samples when this row has parity P, and this
// row's goes to prev[1 − P][l], so that two rows a turn move no register.
// step() is sync.moving_sum's chain: the doubling s ← s + (s delayed by w),
// and at each set bit of win the accumulation of s delayed by the lower set
// bits.
struct WindowSum {
  float prev[2][LEVELS];

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int l = 0; l < LEVELS; ++l) prev[0][l] = prev[1][l] = 0.0f;
  }

  template <int P>
  __device__ __forceinline__ float step(float c, int win, int lane) {
    float s = c, acc = 0.0f;
    int shift = 0;
    bool have = false;
#pragma unroll
    for (int l = 0; l < LEVELS; ++l) {
      const int w = 1 << l;
      if (w <= win) {
        if (win & w) {
          const float part = shifted(s, prev[P][l], shift, lane);
          acc = have ? acc + part : part;
          shift += w;
          have = true;
        }
        prev[1 - P][l] = s;
        if (2 * w <= win) s = s + shifted(s, prev[P][l], w, lane);
      }
    }
    return acc;
  }
};

// Set bits of the row words at local samples lo..hi (inclusive, lo ≥ 0).
__device__ __forceinline__ int count_bits(const unsigned* words, int lo, int hi) {
  if (hi < lo) return 0;
  const int wlo = lo >> 5, whi = hi >> 5;
  const unsigned top = (2u << (hi & 31)) - 1u;  // bits 0..hi&31
  if (wlo == whi) return __popc((words[wlo] >> (lo & 31)) & (top >> (lo & 31)));
  int c = __popc(words[wlo] >> (lo & 31)) + __popc(words[whi] & top);
  for (int w = wlo + 1; w < whi; ++w) c += __popc(words[w]);
  return c;
}

template <int WIN, int PWIN, typename S>
__global__ void __launch_bounds__(THREADS) detect_kernel(
    const S* __restrict__ x, float dq, float2* __restrict__ a_out,
    int32_t* __restrict__ first_out, int32_t* __restrict__ count_out, int n,
    int margin, float threshold, int min_n_peaks, int mpd, int lag, int win_rt, int pwin_rt) {
  extern __shared__ unsigned words[];
  const int win = WIN ? WIN : win_rt, pwin = PWIN ? PWIN : pwin_rt;
  const int rows = (CHUNK + margin) / ROW;
  unsigned* mask_w = words;         // ballot of the mask, one word a row
  unsigned* trig_w = words + rows;  // ballot of the gap-tolerant trigger
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // local sample i is stream sample g0 + i; the chunk starts at local `margin`
  const int g0 = (int)blockIdx.x * CHUNK - margin;

  // ---- the float stage: a, the mask words
  const int warm = ((win > pwin ? win : pwin) - 1 + ROW - 1) / ROW;
  const int r_lo = rows * warp / WARPS, r_hi = rows * (warp + 1) / WARPS;
  WindowSum sum_re, sum_im, sum_pw;
  sum_re.clear();
  sum_im.clear();
  sum_pw.clear();
  // A sample whose |a|² lies below skip · (window power)² cannot pass the
  // threshold: skip = 0.3·threshold² stands for cor < 0.83·threshold (the
  // window power is 1.5·p, and the clamp only raises p), far outside what
  // rounding moves. Such a sample, nearly every one of noise, needs neither
  // the square root nor the divisions. A threshold ≤ 0 skips nothing.
  const float skip = threshold > 0.0f ? 0.3f * threshold * threshold : -1.0f;
  const float2 zero = make_float2(0.0f, 0.0f);
  auto fetch = [&](int at) { return (at >= 0 && at < n) ? load_sample(x + at, dq) : zero; };
  // one row of stream samples g.. at this lane: xc the samples, xd those lag before
  auto do_row = [&](auto parity, int row, int g, float2 xc, float2 xd) {
    constexpr int P = decltype(parity)::value;
    // c = x · conj(x delayed by lag), and |x|²
    const float are = sum_re.template step<P>(xc.x * xd.x + xc.y * xd.y, win, lane);
    const float aim = sum_im.template step<P>(xc.y * xd.x - xc.x * xd.y, win, lane);
    const float pws = sum_pw.template step<P>(xc.x * xc.x + xc.y * xc.y, pwin, lane);
    if (row < r_lo) return;  // warm-up row: the sums only
    const float q = are * are + aim * aim;
    bool m = false;
    if (g < n && !(q < skip * (pws * pws))) {
      const float p = pws / 1.5f;
      const float cor = sqrtf(q) / fmaxf(p, 1e-12f);
      m = (cor > threshold) && (cor < 2.0f);
    }
    const unsigned bal = __ballot_sync(FULL, m);
    if (lane == 0) mask_w[row] = bal;
    if (row >= margin / ROW && g < n) a_out[g] = make_float2(are, aim);
  };
  // rows go two a turn (the sums' registers swap roles); an odd run starts
  // one warm-up row earlier. The next turn's samples are loaded first.
  int row = r_lo - warm;
  row -= (r_hi - row) & 1;
  int g = g0 + row * ROW + lane;
  float2 xa = fetch(g), da = fetch(g - lag), xb = fetch(g + ROW), db = fetch(g + ROW - lag);
  for (; row < r_hi; row += 2, g += 2 * ROW) {
    const float2 x0 = xa, d0 = da, x1 = xb, d1 = db;
    if (row + 2 < r_hi) {
      xa = fetch(g + 2 * ROW);
      da = fetch(g + 2 * ROW - lag);
      xb = fetch(g + 3 * ROW);
      db = fetch(g + 3 * ROW - lag);
    }
    do_row(Const<0>{}, row, g, x0, d0);
    do_row(Const<1>{}, row + 1, g + ROW, x1, d1);
  }
  __syncthreads();

  // ---- trigger: a mask hit with more than min_n_peaks hits in the trailing window
  for (int row = warp; row < rows; row += WARPS) {
    const unsigned mw = mask_w[row];
    unsigned bal = 0;
    if (mw) {  // uniform over the warp
      const int i = row * ROW + lane;
      const int lo = i - mpd + 1;
      const bool tg = ((mw >> lane) & 1u) && count_bits(mask_w, lo < 0 ? 0 : lo, i) > min_n_peaks;
      bal = __ballot_sync(FULL, tg);
    }
    if (lane == 0) trig_w[row] = bal;
  }
  __syncthreads();

  // ---- sparsify (no other trigger in the trailing window), then one warp a
  // segment: first trigger lane and count. Samples ≥ n carry no mask bit.
  const long long n_seg = ((long long)n + SEG - 1) / SEG;
  for (int seg = warp; seg < CHUNK_SEGS; seg += WARPS) {
    const long long gseg = (long long)blockIdx.x * CHUNK_SEGS + seg;
    if (gseg >= n_seg) continue;  // uniform per warp
    int first = SEG, count = 0;
    for (int q = 0; q < SEG / ROW; ++q) {
      const int row = margin / ROW + seg * (SEG / ROW) + q;
      const unsigned tw = trig_w[row];
      if (!tw) continue;  // uniform over the warp
      const int i = row * ROW + lane;
      const int lo = i - mpd + 1;
      const bool keep = ((tw >> lane) & 1u) && count_bits(trig_w, lo < 0 ? 0 : lo, i - 1) == 0;
      const unsigned bal = __ballot_sync(FULL, keep);
      if (first == SEG && bal) first = q * ROW + __ffs(bal) - 1;
      count += __popc(bal);
    }
    if (lane == 0) {
      first_out[gseg] = first;
      count_out[gseg] = count;
    }
  }
}

// ---- the trigger selection (K2's epilogue; plain version: select_plain in
// ops/detect_cuda.py). One block a row. The row's candidates are the
// segments' first triggers seg·128 + first over its span, in segment order,
// which is ascending order; the first K = 4·max_frames of them (the plain
// version's sort and slice) go to shared memory by an ordered ballot
// compaction that stops once K are found. The ignore_gap suppression keeps
// the first candidate and then, from each kept one, the first at least
// ignore_gap after it: every thread finds that successor of its candidates
// by binary search, then one thread walks the chain from the first
// candidate, marking each kept one, a step a kept trigger. The kept and
// owned triggers are compacted in order; the first max_frames give the
// starts and the coarse CFO atan2(a)·(1/lag), as PyTorch computes a float
// tensor over a host scalar on the card.
struct Layout {  // see detect_cuda.Rows
  long long rows, first_seg, step, pre, own, own_lo, own_len, max_frames, ignore_gap;
};

constexpr int SEL_THREADS = 1024;
constexpr int SEL_WARPS = SEL_THREADS / 32;

// This thread's place among the block's threads whose flag is set, in thread
// order; total gets their number. Every thread of the block must call it.
__device__ __forceinline__ int block_rank(bool flag, int* warp_sums, int& total) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned bal = __ballot_sync(FULL, flag);
  if (lane == 0) warp_sums[warp] = __popc(bal);
  __syncthreads();
  int before = 0, sum = 0;
  for (int w = 0; w < SEL_WARPS; ++w) {
    const int v = warp_sums[w];
    before += w < warp ? v : 0;
    sum += v;
  }
  __syncthreads();  // warp_sums is reused by the next call
  total = sum;
  return before + __popc(bal & ((1u << lane) - 1u));
}

__global__ void __launch_bounds__(SEL_THREADS) select_kernel(
    const int32_t* __restrict__ seg_first, const int32_t* __restrict__ seg_count,
    const float2* __restrict__ a, Layout L, float inv_lag, long long* __restrict__ start_out,
    float* __restrict__ cfo_out, bool* __restrict__ valid_out, long long* __restrict__ ncand_out,
    unsigned long long* ring, const unsigned long long* call_counter, int ring_rows) {
  extern __shared__ int sel[];
  const int K = 4 * (int)L.max_frames, mf = (int)L.max_frames;
  int* cand = sel;       // K candidates, ascending
  int* next = sel + K;   // each one's successor in the chain; -1 once kept
  int* kept = next + K;  // the first max_frames kept and owned
  __shared__ int warp_sums[SEL_WARPS];
  __shared__ long long warp_counts[SEL_WARPS];
  const int tid = threadIdx.x;
  const long long row = blockIdx.x;
  const long long base = L.first_seg + row * L.step;  // segments below 0 are empty
  const int span = (int)(L.pre + L.own);

  // the row's n_candidates: the triggers of its own segments
  long long c_own = 0;
  for (int j = tid; j < (int)L.own; j += SEL_THREADS) c_own += seg_count[base + L.pre + j];
  for (int o = 16; o; o >>= 1) c_own += __shfl_down_sync(FULL, c_own, o);
  if ((tid & 31) == 0) warp_counts[tid >> 5] = c_own;

  // the first K candidates, in order
  int m = 0;
  for (int j0 = 0; j0 < span && m < K; j0 += SEL_THREADS) {  // m is uniform
    const int j = j0 + tid;
    const long long s = base + j;
    int c = 0;
    bool has = false;
    if (j < span && s >= 0) {
      const int f = seg_first[s];
      has = f < SEG;
      c = (int)s * SEG + f;
    }
    int total;
    const int at = m + block_rank(has, warp_sums, total);
    if (has && at < K) cand[at] = c;
    m += total;
  }
  m = m < K ? m : K;
  __syncthreads();
  if (tid == 0) {
    long long sum = 0;
    for (int w = 0; w < SEL_WARPS; ++w) sum += warp_counts[w];
    ncand_out[row] = sum;
    if (ring) {
      const unsigned long long call = *call_counter;
      if (call > 0) {
        unsigned long long* r = ring + 2 * ((call - 1) % (unsigned long long)ring_rows);
        atomicMax(r, (call << 32) | (unsigned)m);
        atomicMax(r + 1, (call << 32) | (unsigned)K);
      }
    }
  }
  __syncthreads();

  // the suppression chain
  for (int i = tid; i < m; i += SEL_THREADS) {
    const long long target = (long long)cand[i] + L.ignore_gap;
    int lo = i + 1, hi = m;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (cand[mid] < target) lo = mid + 1;
      else hi = mid;
    }
    next[i] = lo;
  }
  __syncthreads();
  if (tid == 0) {
    for (int i = 0; i < m;) {
      const int j = next[i];
      next[i] = -1;
      i = j;
    }
  }
  __syncthreads();

  // the kept triggers inside the owned window, in order
  const long long own_lo = L.own_lo + row * L.step * SEG, own_hi = own_lo + L.own_len;
  int n_kept = 0;
  for (int i0 = 0; i0 < m && n_kept < mf; i0 += SEL_THREADS) {  // n_kept is uniform
    const int i = i0 + tid;
    const bool keep = i < m && next[i] == -1 && cand[i] >= own_lo && cand[i] < own_hi;
    int total;
    const int at = n_kept + block_rank(keep, warp_sums, total);
    if (keep && at < mf) kept[at] = cand[i];
    n_kept += total;
  }
  __syncthreads();
  for (int p = tid; p < mf; p += SEL_THREADS) {
    const long long o = row * mf + p;
    if (p < n_kept) {
      const int s = kept[p];
      const float2 v = a[s];
      start_out[o] = s;
      cfo_out[o] = atan2f(v.y, v.x) * inv_lag;
      valid_out[o] = true;
    } else {
      start_out[o] = -1;
      cfo_out[o] = 0.0f;
      valid_out[o] = false;
    }
  }
}

// Every doubling shift and every accumulation shift of a window must be ≤ 32.
bool window_fits(int win) {
  if (win < 1 || win >= (1 << LEVELS)) return false;
  int high = 1;
  while (2 * high <= win) high *= 2;
  return high <= 2 * ROW && win - high <= ROW;
}

template <typename S>
cudaError_t launch_detect(const void* x, float dq, void* a, void* first, void* count, int n,
                          int margin, float threshold, int min_n_peaks, int mpd, int lag, int win,
                          int pwin, size_t smem, cudaStream_t stream) {
  auto kernel = detect_kernel<0, 0, S>;
  if (win == 32 && pwin == 48) kernel = detect_kernel<32, 48, S>;
  if (win == 64 && pwin == 96) kernel = detect_kernel<64, 96, S>;
  kernel<<<(n + CHUNK - 1) / CHUNK, THREADS, smem, stream>>>(
      (const S*)x, dq, (float2*)a, (int32_t*)first, (int32_t*)count, n, margin, threshold,
      min_n_peaks, mpd, lag, win, pwin);
  return cudaGetLastError();
}

// The row layout's shared memory: the candidates, their successors and the kept starts.
size_t select_smem(const Layout& L) { return (size_t)(9 * L.max_frames) * sizeof(int); }

cudaError_t launch_select(const void* first, const void* count, const void* a, const Layout& L,
                          int lag, void* start, void* cfo, void* valid, void* n_cand, void* ring,
                          const void* counter, int ring_rows, cudaStream_t stream) {
  const size_t smem = select_smem(L);
  static size_t opted = 48 * 1024;  // above 48 KB a kernel must ask for its shared memory
  if (smem > opted) {
    const cudaError_t err =
        cudaFuncSetAttribute(select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    opted = smem;
  }
  select_kernel<<<(unsigned)L.rows, SEL_THREADS, smem, stream>>>(
      (const int32_t*)first, (const int32_t*)count, (const float2*)a, L, 1.0f / (float)lag,
      (long long*)start, (float*)cfo, (bool*)valid, (long long*)n_cand,
      (unsigned long long*)ring, (const unsigned long long*)counter, ring_rows);
  return cudaGetLastError();
}

}  // namespace

// x (n, 2) f32, or (n, 2) i16 with its scale dq where sc16 is set → a (n, 2)
// f32, seg_first/seg_count (ceil(n/128),) i32. margin: a multiple of 32, at
// least 2·(mpd − 1). With layout (host, the nine fields of Layout) the
// selection follows in a second launch → start (rows, max_frames) i64 (-1 =
// none), cfo (rows, max_frames) f32, valid (rows, max_frames) bool, n_cand
// (rows,) i64; with ring (ring_rows, 2) u64 and counter (1,) u64 it also
// raises the call's count to the most candidates a row fed to the chain,
// and its envelope to 4·max_frames (see utils/profiling.py). With x NULL
// the selection runs alone over a, seg_first and seg_count as given.
extern "C" int jrc_detect_front_end(const void* x, int sc16, float dq, void* a, void* first,
                                    void* count, int n, int margin, float threshold,
                                    int min_n_peaks, int mpd, int lag, int win, int pwin,
                                    const long long* layout, void* start, void* cfo, void* valid,
                                    void* n_cand, void* ring, const void* counter, int ring_rows,
                                    void* stream) {
  if (n > INT32_MAX - 2 * CHUNK || lag < 1) return (int)cudaErrorInvalidValue;  // 32-bit indices
  const size_t smem = 2 * (size_t)((CHUNK + margin) / ROW) * sizeof(unsigned);
  if (x && (!window_fits(win) || !window_fits(pwin) || mpd < 1 || margin % ROW ||
            margin < 2 * (mpd - 1) || smem > 48 * 1024))  // smem: a margin of 190 000 samples
    return (int)cudaErrorInvalidValue;
  Layout L{};
  if (layout) {
    L = Layout{layout[0], layout[1], layout[2], layout[3], layout[4],
               layout[5], layout[6], layout[7], layout[8]};
    const long long n_seg = ((long long)n + SEG - 1) / SEG;
    if (L.rows < 0 || L.rows > INT32_MAX || L.step < 0 || L.pre < 0 || L.own < 0 ||
        L.max_frames < 0 || L.ignore_gap < 0 || L.first_seg + L.pre < 0 ||
        (L.rows && L.first_seg + (L.rows - 1) * L.step + L.pre + L.own > n_seg) ||
        select_smem(L) > 227 * 1024)
      return (int)cudaErrorInvalidValue;
  }
  if (x && n > 0) {
    auto launch = sc16 ? launch_detect<short2> : launch_detect<float2>;
    const cudaError_t err = launch(x, dq, a, first, count, n, margin, threshold, min_n_peaks,
                                   mpd, lag, win, pwin, smem, (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
  }
  if (!layout || L.rows == 0) return (int)cudaGetLastError();
  return (int)launch_select(first, count, a, L, lag, start, cfo, valid, n_cand, ring, counter,
                            ring_rows, (cudaStream_t)stream);
}
