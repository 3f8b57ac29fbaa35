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
// Design: register tiles fed from shared memory, T_W^T and T_H staged once
// per CTA with 16-byte cp.async, and a persistent grid that walks the
// images. The paper's shapes (h a multiple of 8, w of 8, 32..256 8 x 8
// tiles an image, T_W^T whole in shared memory) take haar2d_wide_kernel:
// 8 x 8 outputs a thread, 4 images at once in a CTA of 256 threads, one
// CTA an SM. Other shapes take haar2d_kernel: 4 x 4 outputs a thread, one
// image at a time, ~2 CTAs an SM, the next X landing during the column
// pass; where T_W^T does not fit (64 x 256: 256 KB) it is staged in chunks
// of c rows and each output's partial sum is kept in Y between chunks;
// sides below 4, or tensors not on 16-byte boundaries, use 1 x 1 tiles and
// 4-byte copies. Either way each output's arithmetic is the earlier
// one-output-a-thread kernel's: acc = 0, then fmaf over c ascending for Y
// and over r ascending for Z, all IEEE fp32 with no other rounding, so the
// result is bit-identical to it whatever the tiling.
//
// What separates it from its bound (NVIDIA H100 80GB HBM3, 700 W): one
// paper block takes ~0.046 ms against 0.020. Of that, the row loop takes
// ~0.025 (65% of the FP32 rate), the column loop ~0.006, the output
// stores ~0.004, and staging, barriers and the timing floor ~0.011, which
// do not overlap the loops. The FP32 pipe can do more (an 8 x 8 register
// outer product reaches 64-66 TFLOP/s at the same 8 warps an SM); taking
// every shared load out of the row loop saves only 10%, and 8 x 16 tiles,
// 12 or 16 warps an SM, a register double buffer of the operands and
// per-image barriers were each as fast or slower (PERF.md).
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSmem = 232448;      // H100: 227 KB a block

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Copy rows x cols floats from src (row stride src_ld) to shared dst (row
// stride dst_ld) with V-float cp.async copies.
template <int V>
__device__ __forceinline__ void stage(float* dst, int dst_ld,
                                      const float* src, int src_ld, int rows,
                                      int cols) {
  const int per_row = cols / V;
  for (int i = threadIdx.x; i < rows * per_row; i += blockDim.x) {
    const int r = i / per_row;
    const int k = (i - r * per_row) * V;
    if (V == 4)
      cp_async16(dst + r * dst_ld + k, src + (size_t)r * src_ld + k);
    else
      cp_async4(dst + r * dst_ld + k, src + (size_t)r * src_ld + k);
  }
}

__device__ __forceinline__ void ld4(float* v, const float* p) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void st4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
template <int V>
__device__ __forceinline__ void load(float (&v)[V], const float* p) {
  if constexpr (V == 4)
    ld4(v, p);
  else
    v[0] = *p;
}
template <int V>
__device__ __forceinline__ void store(float* p, const float (&v)[V]) {
  if constexpr (V == 4)
    st4(p, v);
  else
    *p = v[0];
}

// Tile i of a rows x cols output cut in V x V tiles: rows r0 + rs*j and
// columns c0 + k. A warp takes up to 8 column groups x 4 row groups of one
// row block, whose rows are interleaved (rs = row groups), so the warp's
// row loads fall on consecutive rows.
template <int V>
__device__ __forceinline__ void tile_of(int i, int rows, int cols, int& r0,
                                        int& rs, int& c0) {
  const int cg = cols / V;
  const int cgw = min(V == 4 ? 8 : 32, cg);
  const int rg = V == 4 ? min(4, rows / 4) : 1;
  const int cl = i % cgw;
  int q = i / cgw;
  const int g = q % rg;
  q /= rg;
  const int nch = cg / cgw;
  r0 = q / nch * V * rg + g;
  rs = rg;
  c0 = (q % nch * cgw + cl) * V;
}

// Any shape: V x V tiles (V = 4, or 1), one image at a time a CTA. X and
// T_H rows are padded by 4 floats (V = 4) so a warp's row loads hit
// distinct banks. kc: rows of T_W^T staged at a time (w when it fits
// whole).
template <int V>
__global__ void __launch_bounds__(kThreads, 2)
haar2d_kernel(const float* __restrict__ imgs, const float* __restrict__ th,
              const float* __restrict__ tw_t, float* __restrict__ out, int n,
              int h, int w, int kc) {
  extern __shared__ float4 smem4[];
  constexpr int pad = V == 4 ? 4 : 0;
  const int xld = w + pad;
  const int tld = h + pad;
  float* tw_s = reinterpret_cast<float*>(smem4);   // kc x w
  float* th_s = tw_s + kc * w;                     // h x tld
  float* x_s = th_s + h * tld;                     // h x xld
  float* y_s = x_s + h * xld;                      // h x w
  const size_t hw = (size_t)h * w;
  const bool whole = kc == w;
  const int tiles = (h / V) * (w / V);

  stage<V>(th_s, tld, th, h, h, h);
  if (whole) stage<V>(tw_s, w, tw_t, w, w, w);
  int img = blockIdx.x;
  if (img < n) stage<V>(x_s, xld, imgs + img * hw, w, h, w);
  cp_async_commit();

  for (; img < n; img += gridDim.x) {
    cp_async_wait_all();
    __syncthreads();   // X (and T_H, T_W^T) have landed; Y is free

    // rows: y[r, v] = sum_c x[r, c] * tw_t[c, v], c ascending
    for (int c0 = 0; c0 < w; c0 += kc) {
      if (!whole) {
        if (c0 > 0) __syncthreads();   // the previous chunk has been used
        stage<V>(tw_s, w, tw_t + (size_t)c0 * w, w, kc, w);
        cp_async_commit();
        cp_async_wait_all();
        __syncthreads();
      }
      for (int i = threadIdx.x; i < tiles; i += blockDim.x) {
        int r0, rs, v0;
        tile_of<V>(i, h, w, r0, rs, v0);
        float acc[V][V];
#pragma unroll
        for (int j = 0; j < V; ++j) {
          if (c0 == 0) {
#pragma unroll
            for (int q = 0; q < V; ++q) acc[j][q] = 0.f;
          } else {
            load<V>(acc[j], y_s + (r0 + rs * j) * w + v0);
          }
        }
#pragma unroll 4
        for (int c = 0; c < kc; c += V) {
          float xv[V][V];   // xv[j][k] = x[r0 + rs*j, c0 + c + k]
#pragma unroll
          for (int j = 0; j < V; ++j)
            load<V>(xv[j], x_s + (r0 + rs * j) * xld + c0 + c);
#pragma unroll
          for (int k = 0; k < V; ++k) {
            float tv[V];
            load<V>(tv, tw_s + (c + k) * w + v0);
#pragma unroll
            for (int j = 0; j < V; ++j)
#pragma unroll
              for (int q = 0; q < V; ++q)
                acc[j][q] = fmaf(xv[j][k], tv[q], acc[j][q]);
          }
        }
#pragma unroll
        for (int j = 0; j < V; ++j)
          store<V>(y_s + (r0 + rs * j) * w + v0, acc[j]);
      }
    }
    __syncthreads();   // Y is complete; X is free

    const int next = img + gridDim.x;
    if (next < n) {
      stage<V>(x_s, xld, imgs + next * hw, w, h, w);
      cp_async_commit();
    }

    // columns: z[u, v] = sum_r th[u, r] * y[r, v], r ascending
    float* dst = out + img * hw;
    for (int i = threadIdx.x; i < tiles; i += blockDim.x) {
      int u0, us, v0;
      tile_of<V>(i, h, w, u0, us, v0);
      float acc[V][V];
#pragma unroll
      for (int j = 0; j < V; ++j)
#pragma unroll
        for (int q = 0; q < V; ++q) acc[j][q] = 0.f;
#pragma unroll 4
      for (int r = 0; r < h; r += V) {
        float tv[V][V];   // tv[j][k] = th[u0 + us*j, r + k]
#pragma unroll
        for (int j = 0; j < V; ++j)
          load<V>(tv[j], th_s + (u0 + us * j) * tld + r);
#pragma unroll
        for (int k = 0; k < V; ++k) {
          float yv[V];
          load<V>(yv, y_s + (r + k) * w + v0);
#pragma unroll
          for (int j = 0; j < V; ++j)
#pragma unroll
            for (int q = 0; q < V; ++q)
              acc[j][q] = fmaf(tv[j][k], yv[q], acc[j][q]);
        }
      }
#pragma unroll
      for (int j = 0; j < V; ++j)
        store<V>(dst + (size_t)(u0 + us * j) * w + v0, acc[j]);
    }
  }
}

// The paper's shapes: 8 x 8 outputs a thread, several images a CTA.
//
// A thread's columns are kCols / 4 float4 groups at v0 + g * w / (kCols /
// 4), so that the 8 lanes of a quarter warp read 8 consecutive float4 of
// T_W^T and Y, conflict-free; its rows are r0 + RG*j. Per 4 steps of the
// contraction it loads 8 float4 of X (the same address across a quarter
// warp) and kCols of T_W^T for 32 * kCols FMAs. A CTA of 256 threads runs
// `slots` images at once (one per tiles-per-image threads) with T_W^T and
// T_H staged once; each slot's buffer of h x (w + 4) floats holds its
// image's X, then its Y (written over X once all of X has been read), then
// the slot's next X. With 4 slots a CTA, one CTA an SM covers 528 of a
// 1024-image block a round.
constexpr int kRows = 8;
constexpr int kCols = 8;
constexpr int kGroups = kCols / 4;

__global__ void __launch_bounds__(kThreads, 1)
haar2d_wide_kernel(const float* __restrict__ imgs,
                   const float* __restrict__ th,
                   const float* __restrict__ tw_t, float* __restrict__ out,
                   int n, int h, int w, int slots) {
  extern __shared__ float4 smem4[];
  const int xld = w + 4;
  const int tld = h + 4;
  float* tw_s = reinterpret_cast<float*>(smem4);   // w x w
  float* th_s = tw_s + w * w;                      // h x tld
  const int tiles = (h / kRows) * (w / kCols);
  const int g = threadIdx.x / tiles;               // slot
  const int lt = threadIdx.x - g * tiles;
  float* buf = th_s + h * tld + g * h * xld;       // h x xld
  const size_t hw = (size_t)h * w;

  // tile lt: a quarter warp takes 8 column groups of one row group
  const int cg = w / kCols;   // column groups: v0 in [0, w / kGroups) step 4
  const int cgw = min(8, cg);
  const int rg = min(4, h / kRows);
  int q = lt / cgw;
  const int grp = q % rg;
  q /= rg;
  const int nch = cg / cgw;
  const int r0 = q / nch * kRows * rg + grp;
  int vs[kGroups];   // first column of each float4 group
#pragma unroll
  for (int e = 0; e < kGroups; ++e)
    vs[e] = (q % nch * cgw + lt % cgw) * 4 + e * (w / kGroups);

  const int step = gridDim.x * slots;
  int img = blockIdx.x * slots + g;
  // T_H and T_W^T are staged by every thread, each X by its slot's threads
  stage<4>(th_s, tld, th, h, h, h);
  stage<4>(tw_s, w, tw_t, w, w, w);
  const int per_row = w / 4;
  auto stage_x = [&](int i) {
    const float* src = imgs + i * hw;
    for (int e = lt; e < h * per_row; e += tiles) {
      const int r = e / per_row;
      const int k = (e - r * per_row) * 4;
      cp_async16(buf + r * xld + k, src + (size_t)r * w + k);
    }
  };
  if (img < n) stage_x(img);
  cp_async_commit();

  for (int it = 0; blockIdx.x * slots + it * step < n; ++it, img += step) {
    cp_async_wait_all();
    __syncthreads();   // X of this round has landed
    const bool live = img < n;

    // rows: y[r, v] = sum_c x[r, c] * tw_t[c, v], c ascending
    float acc[kRows][kCols];
#pragma unroll
    for (int j = 0; j < kRows; ++j)
#pragma unroll
      for (int e = 0; e < kCols; ++e) acc[j][e] = 0.f;
    if (live) {
#pragma unroll 2
      for (int c = 0; c < w; c += 4) {
        float xv[kRows][4];   // xv[j][k] = x[r0 + rg*j, c + k]
#pragma unroll
        for (int j = 0; j < kRows; ++j)
          ld4(xv[j], buf + (r0 + rg * j) * xld + c);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          float tv[kCols];
#pragma unroll
          for (int e = 0; e < kGroups; ++e)
            ld4(tv + 4 * e, tw_s + (c + k) * w + vs[e]);
#pragma unroll
          for (int j = 0; j < kRows; ++j)
#pragma unroll
            for (int e = 0; e < kCols; ++e)
              acc[j][e] = fmaf(xv[j][k], tv[e], acc[j][e]);
        }
      }
    }
    __syncthreads();   // every X has been read: Y goes over it
    if (live) {
#pragma unroll
      for (int j = 0; j < kRows; ++j)
#pragma unroll
        for (int e = 0; e < kGroups; ++e)
          st4(buf + (r0 + rg * j) * xld + vs[e], acc[j] + 4 * e);
    }
    __syncthreads();

    // columns: z[u, v] = sum_r th[u, r] * y[r, v], r ascending
    if (live) {
#pragma unroll
      for (int j = 0; j < kRows; ++j)
#pragma unroll
        for (int e = 0; e < kCols; ++e) acc[j][e] = 0.f;
#pragma unroll 2
      for (int r = 0; r < h; r += 4) {
        float tv[kRows][4];   // tv[j][k] = th[r0 + rg*j, r + k]
#pragma unroll
        for (int j = 0; j < kRows; ++j)
          ld4(tv[j], th_s + (r0 + rg * j) * tld + r);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          float yv[kCols];
#pragma unroll
          for (int e = 0; e < kGroups; ++e)
            ld4(yv + 4 * e, buf + (r + k) * xld + vs[e]);
#pragma unroll
          for (int j = 0; j < kRows; ++j)
#pragma unroll
            for (int e = 0; e < kCols; ++e)
              acc[j][e] = fmaf(tv[j][k], yv[e], acc[j][e]);
        }
      }
      float* dst = out + img * hw;
#pragma unroll
      for (int j = 0; j < kRows; ++j)
#pragma unroll
        for (int e = 0; e < kGroups; ++e)
          st4(dst + (size_t)(r0 + rg * j) * w + vs[e], acc[j] + 4 * e);
    }
    __syncthreads();   // every Y has been read: the next X goes over it
    if (img + step < n) stage_x(img + step);
    cp_async_commit();
  }
}

// Launch the wide kernel where the shape suits it (h a multiple of 8, w of
// kCols, 32..256 tiles an image, T_W^T whole in shared memory); returns -1
// where it does not.
int launch_wide(const float* imgs, int n, int h, int w, const float* th,
                const float* tw_t, float* out, cudaStream_t stream) {
  if (h % kRows != 0 || w % kCols != 0) return -1;
  const int tiles = (h / kRows) * (w / kCols);
  if (tiles < 32 || tiles > kThreads) return -1;
  const size_t fixed = ((size_t)w * w + (size_t)h * (h + 4)) * sizeof(float);
  const size_t per_slot = (size_t)h * (w + 4) * sizeof(float);
  int slots = kThreads / tiles;
  while (slots > 0 && fixed + slots * per_slot > (size_t)kMaxSmem) slots /= 2;
  if (slots == 0) return -1;
  const size_t smem = fixed + slots * per_slot;
  const cudaError_t e = cudaFuncSetAttribute(
      haar2d_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int grid = min((n + slots - 1) / slots, sms);
  haar2d_wide_kernel<<<grid, slots * tiles, smem, stream>>>(
      imgs, th, tw_t, out, n, h, w, slots);
  return (int)cudaGetLastError();
}

template <int V>
int launch(const float* imgs, int n, int h, int w, const float* th,
           const float* tw_t, float* out, cudaStream_t stream) {
  constexpr int pad = V == 4 ? 4 : 0;
  const size_t fixed = (size_t)h * (h + pad) + (size_t)h * (w + pad) +
                       (size_t)h * w;   // T_H, X, Y floats
  const size_t avail = kMaxSmem / sizeof(float);
  if (fixed >= avail) return (int)cudaErrorInvalidValue;
  int kc = w;   // w is a power of two, so every kc divides it
  while (kc > V && (size_t)kc * w > avail - fixed) kc /= 2;
  if ((size_t)kc * w > avail - fixed) return (int)cudaErrorInvalidValue;
  const size_t smem = (fixed + (size_t)kc * w) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        haar2d_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int tiles = (h / V) * (w / V);
  const int threads = min(kThreads, (tiles + 31) / 32 * 32);
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, haar2d_kernel<V>,
                                                threads, smem);
  const int grid = (int)min((long long)n, (long long)max(per_sm, 1) * sms);
  haar2d_kernel<V><<<grid, threads, smem, stream>>>(imgs, th, tw_t, out, n,
                                                    h, w, kc);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// imgs (n, h, w), th (h, h), tw_t = T_W^T (w, w) -> out (n, h, w); fp32,
// h and w powers of two. Returns cudaGetLastError(), or
// cudaErrorInvalidValue where the image does not fit in shared memory.
extern "C" int haar2d_launch(const float* imgs, int n, int h, int w,
                             const float* th, const float* tw_t, float* out,
                             void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const cudaStream_t st = (cudaStream_t)stream;
  if (h % 4 == 0 && w % 4 == 0 && aligned16(imgs) && aligned16(th) &&
      aligned16(tw_t) && aligned16(out)) {
    const int rc = launch_wide(imgs, n, h, w, th, tw_t, out, st);
    return rc != -1 ? rc : launch<4>(imgs, n, h, w, th, tw_t, out, st);
  }
  return launch<1>(imgs, n, h, w, th, tw_t, out, st);
}
