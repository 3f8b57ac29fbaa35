// FP32 FMA rate probe: each thread keeps R x C accumulators and does
// acc[r][c] = fma(a[r], b[c], acc[r][c]) `iters` times, an outer product
// with every operand in registers (the shape of a register-tiled matrix
// product's inner loop, without its loads).
#include <cuda_runtime.h>

namespace {

template <int R, int C>
__global__ void probe(float* out, int iters, float s) {
  float a[R], b[C], acc[R][C];
#pragma unroll
  for (int r = 0; r < R; ++r) a[r] = s * (threadIdx.x + r);
#pragma unroll
  for (int c = 0; c < C; ++c) b[c] = s * (blockIdx.x + c);
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[r][c] = 0.f;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < C; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
  }
  float t = 0.f;
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < C; ++c) t += acc[r][c];
  out[blockIdx.x * blockDim.x + threadIdx.x] = t;
}

}  // namespace

// kind 0: 8 x 8 accumulators, 1: 4 x 4, 2: 2 x 4. out holds blocks *
// threads floats.
extern "C" int probe_launch(float* out, int kind, int blocks, int threads,
                            int iters, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (kind == 0)
    probe<8, 8><<<blocks, threads, 0, s>>>(out, iters, 1e-3f);
  else if (kind == 1)
    probe<4, 4><<<blocks, threads, 0, s>>>(out, iters, 1e-3f);
  else
    probe<2, 4><<<blocks, threads, 0, s>>>(out, iters, 1e-3f);
  return (int)cudaGetLastError();
}
