// K3: batched row gather out[b] = x[s_b : s_b + width] over a complex
// stream, with s_b clamped to [0, N - width] (dynamic-slice semantics), and
// optionally the per-row derotation fused into the store:
// out[b, k] = x[s_b + k] · exp(j · omega_b · (n0_b + k)).
//
// Replaces the Pallas TPU kernel jrc_tpu/ops/gather_pallas.py:32
// (_gather_kernel), which needed one DMA per row from a 128-aligned
// superset plus a lane roll. Plain PyTorch version: gather_rows_plain in
// jrc_tpu_torch/ops/gather_cuda.py.
//
// What bounds it on the H100: bytes. 3072 rows of 383 to 7568 complex
// samples are 9 to 186 MB read and as many written, 6 to 110 us at HBM
// bandwidth; at the two short widths the launch itself weighs as much as
// the copy. What the design does about it:
//  * one launch a call: the starts (and n0) are read as int64 or int32 as
//    they come, so the wrapper casts nothing;
//  * bytes in flight: a (row, column tile) grid of 128-thread blocks, each
//    thread issuing four independent 16-byte loads before its first store,
//    so a 60 KB row is spread over eight blocks and a 3 KB row still gives
//    the card 3072 blocks;
//  * 16-byte accesses: a row's destination is peeled by one sample where
//    it starts off a 16-byte line (odd width, odd row); the source is then
//    read as float4 where it is aligned relative to that, and as two
//    neighbouring float2 where it is not (half of all rows; the loads of a
//    warp still cover whole 32-byte sectors);
//  * the derotation costs no pass over memory: the phase is formed in
//    float32 as the plain version forms it, omega · (float(n0) + float(k)),
//    cosf and sinf are the accurate library functions (no fast math), and
//    the complex product is written with the two fused multiply-adds that
//    PyTorch's own complex multiply compiles to, re = fma(a, c, −(b·d)) and
//    im = fma(a, d, b·c). On the H100 (torch 2.11, CUDA 12.8) that makes
//    the rotated rows equal the plain version's to the last bit; the
//    wrapper still states a tolerance, since another libdevice or another
//    contraction in PyTorch would move the last bit.
// The sc16 wire: the stream may also be int16 (re, im) pairs with a float32
// scale dq. The kernel is a template on the sample type; a short2 sample is
// converted with __int2float_rn and multiplied once by dq as it is loaded
// (rounded to float32 before the rotation's explicit fmaf sees it;
// -fmad=false keeps the product out of it), so a row holds exactly the plain
// version's q.to(float32) * dq. An int16 row starts on any 4-byte boundary,
// so the sc16 instantiation keeps the destination's 16-byte stores and
// loads its two samples one by one (4 bytes each, neighbouring threads on
// neighbouring addresses); the fc32 instantiation is the code it was.
// Measured (NVIDIA H100 80GB HBM3, 700 W, 3072 rows): the kernel alone takes
// 0.005 / 0.018 / 0.052 / 0.116 ms at widths 383 / 1168 / 3328 / 7568, 94-96%
// of the byte bound from 1168 on, and 0.001-0.003 ms more with the rotation.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int UNROLL = 4;
constexpr int TILE_PAIRS = THREADS * UNROLL;  // 16-byte units (two samples) per block

__device__ __forceinline__ long long load_index(const void* p, long long i, int is64) {
  return is64 ? ((const long long*)p)[i] : (long long)((const int32_t*)p)[i];
}

// One stream sample as float2: an fc32 sample as it is, an sc16 sample
// dequantized (each component one rounded float32 product).
__device__ __forceinline__ float2 load_sample(const float2* p, float) { return __ldg(p); }
__device__ __forceinline__ float2 load_sample(const short2* p, float dq) {
  const short2 q = __ldg(p);
  return make_float2(__int2float_rn(q.x) * dq, __int2float_rn(q.y) * dq);
}

// v · exp(j · omega · (n0 + k))
__device__ __forceinline__ float2 rotate(float2 v, float omega, float n0, int k) {
  const float ph = omega * (n0 + (float)k);
  const float c = cosf(ph), s = sinf(ph);
  return make_float2(__fmaf_rn(v.x, c, -(v.y * s)), __fmaf_rn(v.x, s, v.y * c));
}

template <bool ROT, typename S>
__global__ void __launch_bounds__(THREADS) gather_rows_kernel(
    const S* __restrict__ x, float dq, const void* __restrict__ starts, int starts64,
    float2* __restrict__ out, long long n, int width, int tiles,
    const float* __restrict__ omega, const void* __restrict__ n0, int n0_kind) {
  const long long b = blockIdx.x / tiles;
  const int tile = blockIdx.x - (int)(b * tiles);
  long long s = load_index(starts, b, starts64);
  s = s < 0 ? 0 : s;
  s = s > n - width ? n - width : s;
  const S* src = x + s;
  float2* dst = out + b * width;
  float om = 0.0f, nf = 0.0f;
  if (ROT) {
    om = omega[b];
    if (n0_kind) nf = (float)load_index(n0, b, n0_kind == 2);
  }
  // d samples are peeled so that dst + d lies on a 16-byte line
  const int d = (int)(((uintptr_t)dst >> 3) & 1);
  const int n_pairs = (width - d) >> 1;
  constexpr bool FC32 = sizeof(S) == sizeof(float2);
  const bool src16 = FC32 && (((uintptr_t)(src + d)) & 15) == 0;
  const int p0 = tile * TILE_PAIRS + threadIdx.x;

  float4 v[UNROLL];
  if (src16) {
    const float4* s4 = (const float4*)(src + d);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int p = p0 + u * THREADS;
      if (p < n_pairs) v[u] = __ldg(s4 + p);
    }
  } else {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int p = p0 + u * THREADS;
      if (p < n_pairs) {
        const float2 lo = load_sample(src + d + 2 * p, dq);
        const float2 hi = load_sample(src + d + 2 * p + 1, dq);
        v[u] = make_float4(lo.x, lo.y, hi.x, hi.y);
      }
    }
  }
  float4* d4 = (float4*)(dst + d);
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const int p = p0 + u * THREADS;
    if (p < n_pairs) {
      if (ROT) {
        const float2 lo = rotate(make_float2(v[u].x, v[u].y), om, nf, d + 2 * p);
        const float2 hi = rotate(make_float2(v[u].z, v[u].w), om, nf, d + 2 * p + 1);
        v[u] = make_float4(lo.x, lo.y, hi.x, hi.y);
      }
      d4[p] = v[u];
    }
  }
  // the peeled first sample and the odd last one
  if (tile == 0 && threadIdx.x < 2) {
    const bool head = threadIdx.x == 0;
    const int k = head ? 0 : width - 1;
    if (head ? d == 1 : ((width - d) & 1)) {
      float2 e = load_sample(src + k, dq);
      if (ROT) e = rotate(e, om, nf, k);
      dst[k] = e;
    }
  }
}

template <typename S>
void launch_gather(const void* x, float dq, const void* starts, int starts64, void* out,
                   long long n, int n_rows, int width, const void* omega, const void* n0,
                   int n0_kind, cudaStream_t stream) {
  const int tiles = ((width >> 1) + TILE_PAIRS - 1) / TILE_PAIRS;
  const int per_row = tiles > 0 ? tiles : 1;
  const dim3 grid((unsigned)(n_rows * per_row));
  if (omega) {
    gather_rows_kernel<true, S><<<grid, THREADS, 0, stream>>>(
        (const S*)x, dq, starts, starts64, (float2*)out, n, width, per_row, (const float*)omega,
        n0, n0_kind);
  } else {
    gather_rows_kernel<false, S><<<grid, THREADS, 0, stream>>>(
        (const S*)x, dq, starts, starts64, (float2*)out, n, width, per_row, nullptr, nullptr, 0);
  }
}

}  // namespace

// x (n, 2) f32, or (n, 2) i16 with its scale dq where sc16 is set; starts
// (n_rows,) i64 (starts64) or i32; out (n_rows, width, 2) f32; omega
// (n_rows,) f32 or NULL for the pure gather; n0 (n_rows,) i32 (n0_kind 1) or
// i64 (2), or NULL (0) for a zero offset.
extern "C" int jrc_gather_rows(const void* x, int sc16, float dq, const void* starts,
                               int starts64, void* out, long long n, int n_rows, int width,
                               const void* omega, const void* n0, int n0_kind, void* stream) {
  if (n_rows > 0 && width > 0) {
    auto launch = sc16 ? launch_gather<short2> : launch_gather<float2>;
    launch(x, dq, starts, starts64, out, n, n_rows, width, omega, n0, n0_kind,
           (cudaStream_t)stream);
  }
  return (int)cudaGetLastError();
}
