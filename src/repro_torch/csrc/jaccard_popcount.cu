// Exact Jaccard similarity of candidate pairs, gathered from the packed ring.
//
// Replaces: src/repro/kernels/jaccard_popcount.py:jaccard_popcount (the
// Pallas kernel scoring row-aligned (P, W) packed operands on the VPU).
// This kernel also does the gathers of src/repro/stream/index.py:448-452
// (verify_pairs): it takes the station's packed-fingerprint ring and the
// two ring-slot vectors, so the (P, W) operands are never materialised.
//
// What bounds it on the H100: bytes. Each pair reads two rows of W uint32
// words (1 KB each at the paper's 8192-bit fingerprints) and does 4 * W
// popc/logic ops; 4096 pairs per station read ~8 MB of scattered rows.
//
// Design: one warp per pair. Lanes read consecutive words of both rows
// (coalesced 128-byte lines), accumulate __popc(a & b) and __popc(a | b),
// and a shuffle reduction gives the two integer counts, which are exact.
// The score is an IEEE fp32 division (the build never uses fast math):
// (float)inter / (float)union, or 0 when the union is empty.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
jaccard_popcount_kernel(const uint32_t* __restrict__ pk, int ring,
                        int n_words, const int32_t* __restrict__ i1,
                        const int32_t* __restrict__ i2, int per_station,
                        int total, float* __restrict__ out) {
  const int pair = (int)((blockIdx.x * (size_t)blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (pair >= total) return;  // uniform across the warp
  const size_t station = pair / per_station;
  const uint32_t* a = pk + (station * ring + i1[pair]) * (size_t)n_words;
  const uint32_t* b = pk + (station * ring + i2[pair]) * (size_t)n_words;
  int inter = 0, uni = 0;
  for (int w = lane; w < n_words; w += 32) {
    const uint32_t x = a[w], y = b[w];
    inter += __popc(x & y);
    uni += __popc(x | y);
  }
  for (int off = 16; off > 0; off >>= 1) {
    inter += __shfl_down_sync(0xFFFFFFFFu, inter, off);
    uni += __shfl_down_sync(0xFFFFFFFFu, uni, off);
  }
  if (lane == 0) {
    out[pair] = uni > 0 ? __fdiv_rn((float)inter, (float)uni) : 0.f;
  }
}

}  // namespace

// pk (stations, ring, n_words) uint32; i1/i2 (stations, per_station) int32
// ring slots in [0, ring) -> out (stations, per_station) fp32.
extern "C" int jaccard_popcount_launch(const uint32_t* pk, int stations,
                                       int ring, int n_words,
                                       const int32_t* i1, const int32_t* i2,
                                       int per_station, float* out,
                                       void* stream) {
  const int total = stations * per_station;
  if (total > 0) {
    const int warps_per_cta = kThreads / 32;
    const int grid = (total + warps_per_cta - 1) / warps_per_cta;
    jaccard_popcount_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        pk, ring, n_words, i1, i2, per_station, total, out);
  }
  return (int)cudaGetLastError();
}
