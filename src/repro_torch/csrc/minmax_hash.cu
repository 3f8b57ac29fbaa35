// Min-Max LSH signatures and salted bucket ids from packed fingerprints.
//
// Replaces: src/repro/kernels/minmax_hash.py:minmax_sig_buckets (the Pallas
// kernel that sweeps the dense (N, D) x (D, T*f) masked min/max over the
// D grid axis in VMEM and folds signatures + bucket ids in its epilogue).
//
// What bounds it on the H100: a min/max semiring, not a product, so wgmma
// has nothing to offer; and the work is sparse -- a row has ~top_k set
// bits (400 of 8192 at the paper widths), so the dense sweep the TPU
// kernel does would be ~20x wasted compares. The needed work is 2 * nnz * H
// integer compares per row plus reading nnz mapping rows of H int32 each
// from the 13 MB mapping table, which stays resident in the 50 MB L2. The
// kernel is bound by L2 gather bandwidth and integer issue rate.
//
// Design: one CTA per fingerprint row. Pass 1 compacts the row's set-bit
// positions from its packed uint32 words into a shared-memory list
// (atomicAdd claims a run per word; the list order is irrelevant because
// min and max commute, so the result is deterministic and bit-exact).
// Pass 2: thread h walks that list and keeps min and max of mappings[d, h]
// -- a warp reads 32 consecutive int32 of one mapping row, coalesced. The
// epilogue is the reference's, in uint32: per-function hash_combine(min,
// max), the f-way fold per table from 0, then hash_combine(sig, salt) &
// (B - 1). Empty rows give min = 2^31 - 1 and max = 0, as in the reference.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kGolden = 0x9E3779B9u;

__device__ __forceinline__ uint32_t hash_combine(uint32_t a, uint32_t b) {
  return a ^ (b + kGolden + (a << 6) + (a >> 2));
}

__global__ void minmax_sig_buckets_kernel(
    const uint32_t* __restrict__ packed, int n_words,
    const int32_t* __restrict__ mappings, int n_hash,
    const uint32_t* __restrict__ salts, int n_tables, int f, int use_minmax,
    uint32_t bucket_mask, uint32_t* __restrict__ sig,
    int32_t* __restrict__ bkt) {
  extern __shared__ uint32_t smem[];
  __shared__ int n_set;
  uint32_t* per_fn = smem;
  int32_t* idx = reinterpret_cast<int32_t*>(smem + n_hash);
  const size_t row = blockIdx.x;
  if (threadIdx.x == 0) n_set = 0;
  __syncthreads();

  const uint32_t* words = packed + row * n_words;
  for (int wi = threadIdx.x; wi < n_words; wi += blockDim.x) {
    uint32_t bits = words[wi];
    if (bits) {
      int pos = atomicAdd(&n_set, __popc(bits));
      while (bits) {
        idx[pos++] = wi * 32 + (__ffs(bits) - 1);
        bits &= bits - 1;
      }
    }
  }
  __syncthreads();

  const int n = n_set;
  for (int hc = threadIdx.x; hc < n_hash; hc += blockDim.x) {
    int32_t mn = 0x7FFFFFFF, mx = 0;
    const int32_t* col = mappings + hc;
    for (int i = 0; i < n; ++i) {
      const int32_t v = __ldg(col + (size_t)idx[i] * n_hash);
      mn = min(mn, v);
      mx = max(mx, v);
    }
    per_fn[hc] = use_minmax ? hash_combine((uint32_t)mn, (uint32_t)mx)
                            : (uint32_t)mn;
  }
  __syncthreads();

  for (int t = threadIdx.x; t < n_tables; t += blockDim.x) {
    uint32_t s = 0;
    for (int q = 0; q < f; ++q) s = hash_combine(s, per_fn[t * f + q]);
    sig[row * n_tables + t] = s;
    bkt[row * n_tables + t] = (int32_t)(hash_combine(s, salts[t]) & bucket_mask);
  }
}

}  // namespace

// packed (n, n_words) uint32, mappings (n_words * 32, n_tables * f) int32,
// salts (n_tables,) uint32 -> sig (n, n_tables) uint32, bkt (n, n_tables)
// int32. n_buckets is a power of two.
extern "C" int minmax_sig_buckets_launch(const uint32_t* packed, int n,
                                         int n_words, const int32_t* mappings,
                                         const uint32_t* salts, int n_tables,
                                         int f, int use_minmax, int n_buckets,
                                         uint32_t* sig, int32_t* bkt,
                                         void* stream) {
  if (n > 0) {
    const int n_hash = n_tables * f;
    int threads = ((n_hash + 31) / 32) * 32;
    threads = threads < 32 ? 32 : (threads > 1024 ? 1024 : threads);
    const size_t smem = ((size_t)n_hash + (size_t)n_words * 32) * 4;
    if (smem > 48 * 1024) {
      cudaFuncSetAttribute(minmax_sig_buckets_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
    }
    minmax_sig_buckets_kernel<<<n, threads, smem, (cudaStream_t)stream>>>(
        packed, n_words, mappings, n_hash, salts, n_tables, f, use_minmax,
        (uint32_t)(n_buckets - 1), sig, bkt);
  }
  return (int)cudaGetLastError();
}
