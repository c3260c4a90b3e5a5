// P2: the pieces of the batched row gather, one body per variant.
//
// Replaces the Pallas TPU profiling kernel
// scripts/profile_gather_variants.py:72 (make, body :32), which split the
// per-row cost of the TPU gather K3 into its DMA, its lane roll and its
// write. Over a complex stream x (N,) and B starts clamped to
// [0, N - width], each row is w_out = ceil(width/128)·128 samples:
//   full          x[s : s + w_out], zeros past N (the TPU kernel read a
//                 zero-padded stream);
//   noroll        x[s0 : s0 + w_out] with s0 = (s / 128)·128, zeros past N:
//                 the aligned fetch without the roll that shifts it to s;
//   noroll_nodma  the output written without reading the input. The TPU
//                 kernel returned uninitialized scratch there; this kernel
//                 writes zeros.
// Plain PyTorch version: gather_pieces_plain in
// jrc_tpu_torch/ops/gather_pieces.py.
//
// What bounds it on the H100: bytes (3072 rows of 3328 complex samples at
// the dynamic path's shape, 82 MB in and out). Hopper needs no alignment
// for the copy, so `full` and `noroll` are the same coalesced float2 copy
// from a different start; the design is K3's (gather.cu): one block per
// row, the start clamped in the kernel, neighbouring threads on
// neighbouring samples.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANE = 128;
enum Variant { V_FULL = 0, V_NOROLL = 1, V_NOROLL_NODMA = 2 };

template <int V>
__global__ void gather_pieces_kernel(const float2* __restrict__ x,
                                     const int32_t* __restrict__ starts,
                                     float2* __restrict__ out, int n, int width, int w_out) {
  const int b = blockIdx.x;
  float2* dst = out + (size_t)b * w_out;
  if (V == V_NOROLL_NODMA) {
    for (int i = threadIdx.x; i < w_out; i += blockDim.x) dst[i] = make_float2(0.0f, 0.0f);
    return;
  }
  long s = starts[b];
  s = s < 0 ? 0 : s;
  s = s > n - width ? n - width : s;
  if (V == V_NOROLL) s = (s / LANE) * LANE;
  for (int i = threadIdx.x; i < w_out; i += blockDim.x)
    dst[i] = s + i < n ? x[s + i] : make_float2(0.0f, 0.0f);
}

}  // namespace

// variant: 0 full, 1 noroll, 2 noroll_nodma; out (n_rows, w_out) float2
extern "C" int jrc_gather_pieces(const void* x, const void* starts, void* out, int n,
                                 int n_rows, int width, int w_out, int variant, void* stream) {
  if (variant < 0 || variant > 2) return (int)cudaErrorInvalidValue;
  if (n_rows > 0 && w_out > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    const float2* xp = (const float2*)x;
    const int32_t* sp = (const int32_t*)starts;
    float2* op = (float2*)out;
    if (variant == V_FULL)
      gather_pieces_kernel<V_FULL><<<n_rows, 256, 0, s>>>(xp, sp, op, n, width, w_out);
    else if (variant == V_NOROLL)
      gather_pieces_kernel<V_NOROLL><<<n_rows, 256, 0, s>>>(xp, sp, op, n, width, w_out);
    else
      gather_pieces_kernel<V_NOROLL_NODMA><<<n_rows, 256, 0, s>>>(xp, sp, op, n, width, w_out);
  }
  return (int)cudaGetLastError();
}
