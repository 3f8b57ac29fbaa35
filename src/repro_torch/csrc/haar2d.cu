// Standard-decomposition 2-D Haar transform: Z = T_H . X . T_W^T per image.
//
// Replaces: src/repro/kernels/haar2d.py:haar2d (the Pallas kernel that runs
// both dense products per block of images on the MXU so the intermediate
// never reaches HBM). The products stay dense here too: a butterfly Haar
// would round differently from the reference's matrix products.
//
// What bounds it on the H100: 2*H*W*W + 2*H*H*W fp32 flops per image
// (1.3 MFLOP at 32 x 128), about 1.3 GFLOP per pooled block of 1024
// images -- ~20 us at the 67 TFLOP/s CUDA-core fp32 rate, against ~10 us
// for the 33 MB of images read and written. So it is bound by fp32 issue
// rate, and TF32 tensor cores are off the table for parity.
//
// Design: one CTA per image. X, the intermediate Y = X . T_W^T and T_H sit
// in shared memory (2*H*W + H*H floats = 36 KB at 32 x 128); T_W^T (64 KB)
// is read through the read-only L1 path, where all CTAs of an SM share it.
// A warp covers 32 consecutive output columns of one row, so X and T_H
// reads are broadcasts and T_W^T / Y reads are coalesced, conflict-free.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
haar2d_kernel(const float* __restrict__ imgs, const float* __restrict__ th,
              const float* __restrict__ tw_t, float* __restrict__ out,
              int h, int w) {
  extern __shared__ float smem[];
  const int hw = h * w;
  float* x = smem;
  float* y = smem + hw;
  float* ths = y + hw;
  const size_t base = (size_t)blockIdx.x * hw;
  for (int i = threadIdx.x; i < hw; i += blockDim.x) x[i] = imgs[base + i];
  for (int i = threadIdx.x; i < h * h; i += blockDim.x) ths[i] = th[i];
  __syncthreads();

  // rows: y[r, v] = sum_c x[r, c] * tw[v, c]
  for (int o = threadIdx.x; o < hw; o += blockDim.x) {
    const int r = o / w;
    const int v = o - r * w;
    const float* xr = x + r * w;
    float acc = 0.f;
    for (int c = 0; c < w; ++c) acc = fmaf(xr[c], __ldg(tw_t + c * w + v), acc);
    y[o] = acc;
  }
  __syncthreads();

  // columns: z[u, v] = sum_r th[u, r] * y[r, v]
  for (int o = threadIdx.x; o < hw; o += blockDim.x) {
    const int u = o / w;
    const int v = o - u * w;
    const float* tu = ths + u * h;
    float acc = 0.f;
    for (int r = 0; r < h; ++r) acc = fmaf(tu[r], y[r * w + v], acc);
    out[base + o] = acc;
  }
}

}  // namespace

// imgs (n, h, w), th (h, h), tw_t = T_W^T (w, w) -> out (n, h, w); fp32.
extern "C" int haar2d_launch(const float* imgs, int n, int h, int w,
                             const float* th, const float* tw_t, float* out,
                             void* stream) {
  if (n > 0) {
    const size_t smem = (2 * (size_t)h * w + (size_t)h * h) * sizeof(float);
    if (smem > 48 * 1024) {
      cudaFuncSetAttribute(haar2d_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
    }
    haar2d_kernel<<<n, kThreads, smem, (cudaStream_t)stream>>>(imgs, th, tw_t,
                                                              out, h, w);
  }
  return (int)cudaGetLastError();
}
