// K3: batched row gather out[b] = x[s_b : s_b + width] over a complex
// stream, with s_b clamped to [0, N - width] (dynamic-slice semantics).
//
// Replaces the Pallas TPU kernel jrc_tpu/ops/gather_pallas.py:32
// (_gather_kernel), which needed one DMA per row from a 128-aligned
// superset plus a lane roll. Plain PyTorch version: gather_rows_plain in
// jrc_tpu_torch/ops/gather_cuda.py.
//
// What bounds it on the H100: bytes. At the main path's shapes (3072 rows
// of 383 or 1168 complex samples) it moves 9 or 29 MB in and out, a few
// microseconds at HBM bandwidth, so launch overhead and the scattered row
// starts dominate. The design: one block per row, the start clamped in the
// kernel, neighbouring threads copying neighbouring float2 (re, im)
// samples so every load and store is coalesced. The CFO derotation that
// follows each call stays outside the kernel for now.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void gather_rows_kernel(const float2* __restrict__ x,
                                   const int32_t* __restrict__ starts,
                                   float2* __restrict__ out, int n, int width) {
  const int b = blockIdx.x;
  long s = starts[b];
  s = s < 0 ? 0 : s;
  s = s > n - width ? n - width : s;
  const float2* src = x + s;
  float2* dst = out + (size_t)b * width;
  for (int i = threadIdx.x; i < width; i += blockDim.x) dst[i] = src[i];
}

}  // namespace

extern "C" int jrc_gather_rows(const void* x, const void* starts, void* out,
                               int n, int n_rows, int width, void* stream) {
  if (n_rows > 0 && width > 0) {
    gather_rows_kernel<<<n_rows, 128, 0, (cudaStream_t)stream>>>(
        (const float2*)x, (const int32_t*)starts, (float2*)out, n, width);
  }
  return (int)cudaGetLastError();
}
