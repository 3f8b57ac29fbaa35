// Rate probes for the Min-Max and Jaccard kernels' resources: 32-bit
// integer min/max (IMNMX), the three-input DPX min/max, population counts
// (POPC), 16-byte shared-memory loads of one
// contiguous 512-byte row a warp, and the L2 gather of a CTA-a-row walk
// over a mapping table (each thread one column, one 4-byte load a set
// bit). Every kernel writes thread 0 of block 0's clock64() span to
// cycles[0] so that the caller can turn its time into clocks. Also the
// thread block clusters the card keeps resident at a CTA's threads and
// shared memory.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kAcc = 16;   // independent accumulators a thread

// An empty asm that claims to change x: the compiler cannot fold or hoist
// the min/max that follows, and emits no instruction for it.
__device__ __forceinline__ void opaque(int& x) { asm volatile("" : "+r"(x)); }

template <bool kDpx>
__global__ void minmax_probe(int* out, long long* cycles, int iters, int s) {
  const long long t0 = clock64();
  int lo[kAcc], hi[kAcc], u[kAcc], v[kAcc];
#pragma unroll
  for (int k = 0; k < kAcc; ++k) {
    u[k] = s * (threadIdx.x + 7 * k);
    v[k] = s * (blockIdx.x + 3 * k);
    lo[k] = 0x7FFFFFFF;
    hi[k] = 0;
  }
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int k = 0; k < kAcc; ++k) {
      if (kDpx) {
        lo[k] = __vimin3_s32(lo[k], u[k], v[k]);
        hi[k] = __vimax3_s32(hi[k], u[k], v[k]);
      } else {
        lo[k] = min(lo[k], u[k]);
        hi[k] = max(hi[k], u[k]);
      }
      opaque(lo[k]);
      opaque(hi[k]);
    }
  }
  int t = 0;
#pragma unroll
  for (int k = 0; k < kAcc; ++k) t ^= lo[k] ^ hi[k];
  out[blockIdx.x * blockDim.x + threadIdx.x] = t;
  if (blockIdx.x == 0 && threadIdx.x == 0) cycles[0] = clock64() - t0;
}

// 16 independent population counts (POPC) a thread an iteration, each
// feeding the next of its chain (x += popc(x): one POPC and one IADD a
// count, so the compiler can neither fold nor hoist them): the rate the
// Jaccard kernel's two counts a word rest on.
__global__ void popc_probe(int* out, long long* cycles, int iters, int s) {
  const long long t0 = clock64();
  int x[kAcc];
#pragma unroll
  for (int k = 0; k < kAcc; ++k) x[k] = s * (threadIdx.x + 7 * k) ^ k;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int k = 0; k < kAcc; ++k) x[k] += __popc(x[k]);
  }
  int t = 0;
#pragma unroll
  for (int k = 0; k < kAcc; ++k) t ^= x[k];
  out[blockIdx.x * blockDim.x + threadIdx.x] = t;
  if (blockIdx.x == 0 && threadIdx.x == 0) cycles[0] = clock64() - t0;
}

// Each warp reads whole 512-byte rows (lane l its 16 bytes) of a 32 KB
// shared table, in a pseudo-random row order, 8 loads in flight.
__global__ void lds128_probe(int* out, long long* cycles, int iters) {
  extern __shared__ int4 tab[];          // 64 rows x 32 int4
  for (int i = threadIdx.x; i < 64 * 32; i += blockDim.x)
    tab[i] = make_int4(i, i ^ 5, i ^ 9, i ^ 3);
  __syncthreads();
  const long long t0 = clock64();
  const int lane = threadIdx.x & 31;
  int4 acc = make_int4(0, 0, 0, 0);
  unsigned r = (threadIdx.x >> 5) * 17u;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int4 x = tab[((r + 37u * k) & 63u) * 32 + lane];
      acc.x ^= x.x; acc.y ^= x.y; acc.z ^= x.z; acc.w ^= x.w;
    }
    r += 29u;
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = acc.x ^ acc.y ^ acc.z ^ acc.w;
  if (blockIdx.x == 0 && threadIdx.x == 0) cycles[0] = clock64() - t0;
}

// A CTA a row: `nnz` pseudo-random dimensions of `d` go to shared memory,
// then thread h walks them and keeps the min and max of mappings[dim, h]
// (the row path's pass 2).
__global__ void gather_probe(const int32_t* __restrict__ mappings, int d,
                             int n_hash, int nnz, int32_t* out,
                             long long* cycles) {
  extern __shared__ int idx[];
  for (int i = threadIdx.x; i < nnz; i += blockDim.x) {
    uint32_t x = blockIdx.x * 0x9E3779B9u + i * 0x85EBCA6Bu;
    x ^= x >> 15; x *= 0x2C1B3C6Du; x ^= x >> 12;
    idx[i] = (int)(x % (uint32_t)d);
  }
  __syncthreads();
  const long long t0 = clock64();
  for (int h = threadIdx.x; h < n_hash; h += blockDim.x) {
    int mn = 0x7FFFFFFF, mx = 0;
    for (int i = 0; i < nnz; ++i) {
      const int v = __ldg(mappings + (size_t)idx[i] * n_hash + h);
      mn = min(mn, v);
      mx = max(mx, v);
    }
    out[(size_t)blockIdx.x * n_hash + h] = mn ^ mx;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) cycles[0] = clock64() - t0;
}

// An empty kernel with the tiled Min-Max kernel's launch bounds, for the
// cluster occupancy query.
__global__ void __launch_bounds__(512) cluster_probe() {}

}  // namespace

// kind 0: IMNMX, 1: DPX three-input min/max. out holds blocks * threads
// ints.
extern "C" int minmax_probe_launch(int* out, long long* cycles, int kind,
                                   int blocks, int threads, int iters,
                                   void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (kind == 0)
    minmax_probe<false><<<blocks, threads, 0, st>>>(out, cycles, iters, 3);
  else
    minmax_probe<true><<<blocks, threads, 0, st>>>(out, cycles, iters, 3);
  return (int)cudaGetLastError();
}

extern "C" int popc_probe_launch(int* out, long long* cycles, int blocks,
                                 int threads, int iters, void* stream) {
  popc_probe<<<blocks, threads, 0, (cudaStream_t)stream>>>(out, cycles,
                                                           iters, 3);
  return (int)cudaGetLastError();
}

extern "C" int lds128_probe_launch(int* out, long long* cycles, int blocks,
                                   int threads, int iters, void* stream) {
  lds128_probe<<<blocks, threads, 64 * 32 * 16, (cudaStream_t)stream>>>(
      out, cycles, iters);
  return (int)cudaGetLastError();
}

// out holds rows * n_hash ints.
extern "C" int gather_probe_launch(const int32_t* mappings, int d,
                                   int n_hash, int nnz, int rows,
                                   int32_t* out, long long* cycles,
                                   void* stream) {
  const int threads = ((n_hash < 512 ? n_hash : 512) + 31) / 32 * 32;
  gather_probe<<<rows, threads, nnz * 4, (cudaStream_t)stream>>>(
      mappings, d, n_hash, nnz, out, cycles);
  return (int)cudaGetLastError();
}

// Clusters of `size` CTAs of `threads` threads and `smem` bytes of dynamic
// shared memory that the card keeps active at once
// (cudaOccupancyMaxActiveClusters), or -1 on an error.
extern "C" int max_active_clusters(int threads, int smem, int size) {
  if (cudaFuncSetAttribute(cluster_probe,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess)
    return -1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(128 * size);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = size;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = -1;
  if (cudaOccupancyMaxActiveClusters(&n, cluster_probe, &cfg) != cudaSuccess)
    return -1;
  return n;
}
