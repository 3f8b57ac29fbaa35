// Min-Max LSH hashing of packed fingerprints: the raw min/max planes, and
// signatures with salted bucket ids.
//
// Replaces two Pallas kernels of src/repro/kernels/minmax_hash.py, both of
// which sweep the dense (N, D) x (D, H) masked min/max over the D grid axis
// in VMEM:
//   - minmax_hash (minmax_hash_kernel here) returns the raw (N, H) mins and
//     maxs, which lsh.signatures folds (the offline search);
//   - minmax_sig_buckets (minmax_sig_buckets_kernel here) folds signatures
//     and bucket ids in its epilogue (the block replay).
//
// What bounds them on the H100: a min/max semiring, not a product, so wgmma
// has nothing to offer; and the work is sparse -- a row has ~top_k set
// bits (400 of 8192 at the paper widths), so the dense sweep the TPU
// kernel does would be ~20x wasted compares. The needed work is 2 * nnz * H
// integer compares per row plus reading nnz mapping rows of H int32 each
// from the 13 MB mapping table, which stays resident in the 50 MB L2. The
// kernels are bound by L2 gather bandwidth and integer issue rate; the raw
// kernel also writes 2 * H int32 per row.
//
// Design: one CTA per fingerprint row; both kernels share row_minmax.
// Pass 1 compacts the row's set-bit positions from its packed uint32 words
// into a shared-memory list (atomicAdd claims a run per word; the list
// order is irrelevant because min and max commute, so the result is
// deterministic and bit-exact). Pass 2: thread h walks that list and keeps
// min and max of mappings[d, h] -- a warp reads 32 consecutive int32 of one
// mapping row, coalesced -- for each column it owns (a CTA may own more
// columns than it has threads). Empty rows give min = 2^31 - 1 and max = 0,
// as in the reference. The raw kernel stores the two planes; the signature
// epilogue is the reference's, in uint32: per-function hash_combine(min,
// max), the f-way fold per table from 0, then hash_combine(sig, salt) &
// (B - 1).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kGolden = 0x9E3779B9u;
constexpr int kMaxRawThreads = 512;

__device__ __forceinline__ uint32_t hash_combine(uint32_t a, uint32_t b) {
  return a ^ (b + kGolden + (a << 6) + (a >> 2));
}

// Passes 1 and 2 for one row, by the whole CTA: compacts the set bits of
// `words` into `idx` (shared, room for 32 * n_words entries), then calls
// emit(h, min, max) once for every mapping column h, each from the thread
// that owns it. It syncs the CTA around pass 1; a caller that reads back
// what emit wrote to shared memory syncs again first.
template <typename Emit>
__device__ __forceinline__ void row_minmax(const uint32_t* __restrict__ words,
                                           int n_words,
                                           const int32_t* __restrict__ mappings,
                                           int n_hash, int32_t* idx,
                                           int* n_set, Emit emit) {
  if (threadIdx.x == 0) *n_set = 0;
  __syncthreads();
  for (int wi = threadIdx.x; wi < n_words; wi += blockDim.x) {
    uint32_t bits = words[wi];
    if (bits) {
      int pos = atomicAdd(n_set, __popc(bits));
      while (bits) {
        idx[pos++] = wi * 32 + (__ffs(bits) - 1);
        bits &= bits - 1;
      }
    }
  }
  __syncthreads();

  const int n = *n_set;
  for (int hc = threadIdx.x; hc < n_hash; hc += blockDim.x) {
    int32_t mn = 0x7FFFFFFF, mx = 0;
    const int32_t* col = mappings + hc;
    for (int i = 0; i < n; ++i) {
      const int32_t v = __ldg(col + (size_t)idx[i] * n_hash);
      mn = min(mn, v);
      mx = max(mx, v);
    }
    emit(hc, mn, mx);
  }
}

struct StorePlanes {
  int32_t* mins;
  int32_t* maxs;
  __device__ void operator()(int hc, int32_t mn, int32_t mx) const {
    mins[hc] = mn;
    maxs[hc] = mx;
  }
};

struct CombinePerFn {
  uint32_t* per_fn;
  int use_minmax;
  __device__ void operator()(int hc, int32_t mn, int32_t mx) const {
    per_fn[hc] = use_minmax ? hash_combine((uint32_t)mn, (uint32_t)mx)
                            : (uint32_t)mn;
  }
};

__global__ void minmax_hash_kernel(const uint32_t* __restrict__ packed,
                                   int n_words,
                                   const int32_t* __restrict__ mappings,
                                   int n_hash, int32_t* __restrict__ mins,
                                   int32_t* __restrict__ maxs) {
  extern __shared__ int32_t idx[];
  __shared__ int n_set;
  const size_t row = blockIdx.x;
  row_minmax(packed + row * n_words, n_words, mappings, n_hash, idx, &n_set,
             StorePlanes{mins + row * n_hash, maxs + row * n_hash});
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
  row_minmax(packed + row * n_words, n_words, mappings, n_hash, idx, &n_set,
             CombinePerFn{per_fn, use_minmax});
  __syncthreads();

  for (int t = threadIdx.x; t < n_tables; t += blockDim.x) {
    uint32_t s = 0;
    for (int q = 0; q < f; ++q) s = hash_combine(s, per_fn[t * f + q]);
    sig[row * n_tables + t] = s;
    bkt[row * n_tables + t] = (int32_t)(hash_combine(s, salts[t]) & bucket_mask);
  }
}

template <typename Kernel>
void allow_smem(Kernel kernel, size_t smem) {
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  }
}

}  // namespace

// packed (n, n_words) uint32, mappings (n_words * 32, n_hash) int32 ->
// mins, maxs (n, n_hash) int32. Threads split the columns evenly into
// passes of at most kMaxRawThreads (H = 800 takes two columns a thread).
extern "C" int minmax_hash_launch(const uint32_t* packed, int n, int n_words,
                                  const int32_t* mappings, int n_hash,
                                  int32_t* mins, int32_t* maxs,
                                  void* stream) {
  if (n > 0 && n_hash > 0) {
    const int passes = (n_hash + kMaxRawThreads - 1) / kMaxRawThreads;
    const int per_pass = (n_hash + passes - 1) / passes;
    const int threads = ((per_pass + 31) / 32) * 32;
    const size_t smem = (size_t)n_words * 32 * 4;
    allow_smem(minmax_hash_kernel, smem);
    minmax_hash_kernel<<<n, threads, smem, (cudaStream_t)stream>>>(
        packed, n_words, mappings, n_hash, mins, maxs);
  }
  return (int)cudaGetLastError();
}

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
    allow_smem(minmax_sig_buckets_kernel, smem);
    minmax_sig_buckets_kernel<<<n, threads, smem, (cudaStream_t)stream>>>(
        packed, n_words, mappings, n_hash, salts, n_tables, f, use_minmax,
        (uint32_t)(n_buckets - 1), sig, bkt);
  }
  return (int)cudaGetLastError();
}
