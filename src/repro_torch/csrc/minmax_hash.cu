// Min-Max LSH hashing of packed fingerprints: the raw min/max planes, and
// signatures with salted bucket ids.
//
// Replaces two Pallas kernels of src/repro/kernels/minmax_hash.py, both of
// which sweep the dense (N, D) x (D, H) masked min/max over the D grid axis
// in VMEM:
//   - minmax_hash (minmax_hash_*kernel here) returns the raw (N, H) mins
//     and maxs, which lsh.signatures folds (the offline search);
//   - minmax_sig_buckets (minmax_sig_buckets_*kernel here) folds signatures
//     and bucket ids in its epilogue (the block replay).
//
// What bounds them on the H100: a min/max semiring, not a product, so wgmma
// has nothing to offer; and the work is sparse -- a row has ~top_k set
// bits (400 of 8192 at the paper widths), so the dense sweep the TPU
// kernel does would be ~20x wasted compares. The needed work is 2 * nnz * H
// integer compares: the three-input DPX min/max (VIMNMX3) take two a
// result at IMNMX's 64 results a clock an SM. Each set bit and column also
// needs one 4-byte mapping value at the thread that compares it: from L2
// that is nnz * H * 4 bytes (27 GB a station-day), from shared memory 4
// bytes a clock a bank.
//
// Two kernels, picked by the wrapper from the shapes
// (kernels/minmax_hash.py:plan).
//
// Tiled (tiled_kernel): N * H >= 2^17, D >= 4096, H a multiple of 4,
// 16-byte aligned mappings and, for signatures, 4 % f == 0 -- the paper
// widths' replay of two or more stations and offline search.
//   - A CTA owns a tile of warps * kRowsPerWarp rows (128 at the paper
//     shapes) and a slice of kCols = 128 columns. One thread streams the
//     slice through shared memory by TMA, kChunk = 128 dimensions a box,
//     kStages boxes in flight, each landing on an mbarrier; the warp that
//     finishes with a stage last refills it, so no CTA barrier paces the
//     loop. A staged value is read from L2 once a row tile: L2->SM traffic
//     is ceil(N / 128) * D * H * 4 bytes (4.4 GB a station-day).
//   - Each warp lists its rows' set bits of the chunk in dimension order
//     (a prefix count over a row's words places each word's bits), as the
//     byte offsets of their staged rows, padded to an even count by
//     repeating the last (min and max are idempotent). It builds the next
//     chunk's lists while TMA lands.
//   - Lane l owns columns 4l..4l+3 and all lanes take the same row and set
//     bit together, so a warp reads one contiguous 512-byte staged row (four
//     conflict-free wavefronts, one LDS.128 a lane); two bits take eight
//     VIMNMX3. The accumulators stay in registers: kRowsPerWarp rows x 4
//     columns x (min, max). A slice of fewer columns (the last of H = 400
//     holds 16) splits the warp into groups of g lanes, each folding
//     another row, so its idle lanes do not cost a full slice's issue.
//   - Where tiles x slices give too few CTAs to fill the card (the replay's
//     1024 rows: 8 tiles x 4 slices), `split` CTAs share a tile, each
//     walking a contiguous range of chunks; they leave their partial mins
//     and maxs in global scratch and the last to finish (an atomic counter
//     a tile, left zero) folds them in.
//   - The epilogue runs from the lane's registers: 16-byte stores of the
//     planes, or per function hash_combine(min, max), the f-way fold per
//     table from q = 0 and hash_combine(sig, salt) & (B - 1).
//   Min and max commute, so the order of the compares changes no bit: the
//   result equals the row kernel's bit for bit.
//
// Row (minmax_*_kernel): every other shape (fewer dimensions, as the smoke
// config's and dedup's 1024, where a row's few bits make its short CTA
// faster; smaller planes, as one station's replay block, whose tiles fill
// few SMs; H not a multiple of 4, f = 3, an unaligned table). One CTA per
// fingerprint row. Pass 1 compacts the
// row's set-bit positions from its packed uint32 words into a
// shared-memory list (atomicAdd claims a run per word; the list order is
// irrelevant because min and max commute). Pass 2: thread h walks that
// list and keeps min and max of mappings[d, h] -- a warp reads 32
// consecutive int32 of one mapping row from L2 -- for each column it owns.
//
// Empty rows give min = 2^31 - 1 and max = 0, as in the reference.
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kGolden = 0x9E3779B9u;
constexpr int kMaxRawThreads = 512;

__device__ __forceinline__ uint32_t hash_combine(uint32_t a, uint32_t b) {
  return a ^ (b + kGolden + (a << 6) + (a >> 2));
}

// ---------------------------------------------------------------- row path

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

// -------------------------------------------------------------- tiled path

constexpr int kCols = 128;          // columns of a slice: 32 lanes x 4
constexpr int kRowsPerWarp = 8;     // rows whose accumulators a lane holds
constexpr int kStages = 3;          // staged chunks in flight
constexpr int kChunk = 128;         // dimensions a chunk (4 words a row)
constexpr int kWords = kChunk / 32;
constexpr int kMaxWarps = 16;
constexpr int kMaxSplit = 8;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Waits for the phase of `bar` with the given parity to complete.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT%=;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// One TMA copy of the (kChunk x kCols) box at column x, dimension y of
// the mapping table into shared memory at `dst`, completing on `bar`
// (whose arrival it announces with the box's bytes). Columns past H and
// dimensions past D arrive as zeros.
__device__ __forceinline__ void tma_chunk(uint32_t dst, const CUtensorMap* map,
                                          int x, int y, uint64_t* bar,
                                          uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y),
      "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void min4(int4& a, const int4& b) {
  a.x = min(a.x, b.x); a.y = min(a.y, b.y);
  a.z = min(a.z, b.z); a.w = min(a.w, b.w);
}

__device__ __forceinline__ void max4(int4& a, const int4& b) {
  a.x = max(a.x, b.x); a.y = max(a.y, b.y);
  a.z = max(a.z, b.z); a.w = max(a.w, b.w);
}

// Bytes between two rows' set-bit lists: an entry a dimension of the
// chunk (a 2-byte offset below 64 KB) and two more, so that the rows'
// lists start in different banks.
constexpr int kListBytes = 2;
constexpr int kListStride = kListBytes * (kChunk + 2);
constexpr int kStageBytes = kChunk * kCols * 4;
static_assert(kStageBytes <= 65536 && kWords * kRowsPerWarp <= 32,
              "a chunk's offsets and words");

// One lane's four columns over one row's set bits of the chunk. `list`
// holds the byte offsets from `base` of their staged rows, two to a word,
// `pairs` words (an odd count repeats its last entry: min and max are
// idempotent).
__device__ __forceinline__ void fold_row(const char* __restrict__ base,
                                         const uint32_t* __restrict__ list,
                                         int pairs, int4& mn, int4& mx) {
#pragma unroll 2
  for (int k = 0; k < pairs; ++k) {
    const uint32_t q = list[k];
    const int4 u = *reinterpret_cast<const int4*>(base + (q & 0xFFFFu));
    const int4 v = *reinterpret_cast<const int4*>(base + (q >> 16));
    mn.x = __vimin3_s32(mn.x, u.x, v.x); mn.y = __vimin3_s32(mn.y, u.y, v.y);
    mn.z = __vimin3_s32(mn.z, u.z, v.z); mn.w = __vimin3_s32(mn.w, u.w, v.w);
    mx.x = __vimax3_s32(mx.x, u.x, v.x); mx.y = __vimax3_s32(mx.y, u.y, v.y);
    mx.z = __vimax3_s32(mx.z, u.z, v.z); mx.w = __vimax3_s32(mx.w, u.w, v.w);
  }
}

struct RawEpilogue {
  int32_t* mins;
  int32_t* maxs;
  int n_hash;
  __device__ void operator()(int row, int col, const int4& mn,
                             const int4& mx) const {
    *reinterpret_cast<int4*>(mins + (size_t)row * n_hash + col) = mn;
    *reinterpret_cast<int4*>(maxs + (size_t)row * n_hash + col) = mx;
  }
};

// A lane's four functions are 4 / F whole tables (4 % F == 0).
template <int F>
struct SigEpilogue {
  const uint32_t* salts;
  uint32_t* sig;
  int32_t* bkt;
  int n_tables;
  int use_minmax;
  uint32_t bucket_mask;
  __device__ void operator()(int row, int col, const int4& mn,
                             const int4& mx) const {
    const uint32_t lo[4] = {(uint32_t)mn.x, (uint32_t)mn.y, (uint32_t)mn.z,
                            (uint32_t)mn.w};
    const uint32_t hi[4] = {(uint32_t)mx.x, (uint32_t)mx.y, (uint32_t)mx.z,
                            (uint32_t)mx.w};
#pragma unroll
    for (int k = 0; k < 4 / F; ++k) {
      uint32_t s = 0;
#pragma unroll
      for (int q = 0; q < F; ++q) {
        const int j = k * F + q;
        s = hash_combine(s, use_minmax ? hash_combine(lo[j], hi[j]) : lo[j]);
      }
      const size_t t = (size_t)row * n_tables + col / F + k;
      sig[t] = s;
      bkt[t] = (int32_t)(hash_combine(s, salts[col / F + k]) & bucket_mask);
    }
  }
};

// grid (row tiles * split, column slices), blockDim warps * 32, dynamic
// shared memory as tiled_smem_bytes. kSplit: split > 1, `part` holds a
// partial's room for every CTA and `counters` a zero for every tile and
// slice (left zero on exit); a separate instance, so that the unsplit
// kernel's loop keeps its registers.
template <class Epilogue, bool kSplit>
__global__ void __launch_bounds__(kMaxWarps * 32)
    tiled_kernel(const uint32_t* __restrict__ packed, int n, int n_words,
                 const __grid_constant__ CUtensorMap map, int n_hash,
                 int split, int4* __restrict__ part,
                 int* __restrict__ counters, Epilogue epi) {
  extern __shared__ __align__(128) char smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages];   // a chunk has landed
  __shared__ int freed[kStages];    // warps done with a stage, cumulative
  // TMA writes 128-byte aligned shared memory
  int4* tiles = reinterpret_cast<int4*>(
      smem_raw + ((128 - (smem_addr(smem_raw) & 127)) & 127));
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int rank = blockIdx.x % split;      // its part of the dimensions
  const int row0 = (blockIdx.x / split * warps + warp) * kRowsPerWarp;
  const int col0 = blockIdx.y * kCols;
  const int quads = min(32, (n_hash - col0) >> 2);
  // g lanes (a power of two, at least the slice's quads and 32 /
  // kRowsPerWarp) take one row's quads; the warp's 32 / g groups take as
  // many rows at once, and a lane folds g * kRowsPerWarp / 32 of its
  // warp's rows. Slices whose columns fill the warp run g = 32, a row at
  // a time; the last slices of H = 400 and 800 (16 and 32 columns) g = 4
  // and 8, eight and four rows at a time.
  int g = 32 / kRowsPerWarp;
  while (g < quads) g <<= 1;
  const int per = 32 / g;                   // rows at a time
  const int steps = kRowsPerWarp / per;     // rows of a lane
  const int sub = lane / g;                 // the lane's first row
  const int q = lane - sub * g;             // and its quad
  const bool active = q < quads;
  const int n_dims = 32 * n_words;
  const int n_chunks = (n_dims + kChunk - 1) / kChunk;
  const int c_begin = (int)((long long)n_chunks * rank / split);
  const int c_end = (int)((long long)n_chunks * (rank + 1) / split);

  // staging: one thread copies a chunk by TMA; the warp that finishes
  // with a stage last refills it
  const uint32_t tiles_s = smem_addr(tiles);
  auto stage = [&](int c, int slot) {
    tma_chunk(tiles_s + slot * kStageBytes, &map, col0, c * kChunk,
              &full[slot], kStageBytes);
  };

  // lane i loads word i % kWords of the chunk for the warp's row
  // i / kWords
  const int wr = lane / kWords;
  const int wj = lane - wr * kWords;
  const bool loads = wr < kRowsPerWarp && row0 + wr < n;
  const uint32_t* wsrc = packed + (size_t)(loads ? row0 + wr : 0) * n_words;
  auto word = [&](int c) -> uint32_t {
    const int w = c * kWords + wj;
    return (loads && c < c_end && w < n_words) ? __ldg(wsrc + w) : 0u;
  };

  // the warp's set-bit lists: kRowsPerWarp rows of kListStride bytes
  // after the stages
  char* lists = reinterpret_cast<char*>(tiles) + kStages * kStageBytes +
                warp * kRowsPerWarp * kListStride;

  int4 mn[kRowsPerWarp], mx[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    mn[r] = make_int4(0x7FFFFFFF, 0x7FFFFFFF, 0x7FFFFFFF, 0x7FFFFFFF);
    mx[r] = make_int4(0, 0, 0, 0);
  }

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      freed[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int s = 0; s < kStages && c_begin + s < c_end; ++s)
      stage(c_begin + s, s);
  }
  __syncthreads();
  uint32_t wcur = word(c_begin);
  int slot = 0;                              // the stage of chunk c
  uint32_t parity = 0;                       // of its fill
  for (int c = c_begin; c < c_end; ++c) {
    const uint32_t wnext = word(c + 1);
    __syncwarp();             // the warp's lists of chunk c - 1 are read

    // each row's set bits in dimension order, as staged-row byte offsets:
    // a prefix count over the row's kWords lanes places each word's bits,
    // and the lane with the row's last bit repeats it when the count is odd
    const int own = __popc(wcur);
    int upto = own;
    for (int o = 1; o < kWords; o <<= 1) {
      const int t = __shfl_up_sync(0xFFFFFFFFu, upto, o, kWords);
      if (wj >= o) upto += t;
    }
    const int total = __shfl_sync(0xFFFFFFFFu, upto, lane | (kWords - 1));
    if (wr < kRowsPerWarp && own) {
      uint16_t* dst = reinterpret_cast<uint16_t*>(lists + wr * kListStride) +
                      (upto - own);
      uint32_t off = 0;
      for (uint32_t w = wcur; w; w &= w - 1) {
        off = (uint32_t)(32 * wj + __ffs(w) - 1) * (kCols * 4);
        *dst++ = (uint16_t)off;
      }
      if (upto == total && (total & 1)) *dst = (uint16_t)off;
    }
    int pairs[kRowsPerWarp];                 // of the lane's rows
#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j) {
      const int r = (sub + j * per) & (kRowsPerWarp - 1);
      pairs[j] = (__shfl_sync(0xFFFFFFFFu, total, r * kWords) + 1) >> 1;
    }
    __syncwarp();
    mbar_wait(&full[slot], parity);
    if (active) {
      const char* base = reinterpret_cast<const char*>(tiles) +
                         slot * kStageBytes + q * 16;
      if (g == 32) {                         // a row at a time
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r)
          fold_row(base,
                   reinterpret_cast<const uint32_t*>(lists + r * kListStride),
                   pairs[r], mn[r], mx[r]);
      } else {
#pragma unroll
        for (int j = 0; j < kRowsPerWarp; ++j)
          if (j < steps)
            fold_row(base,
                     reinterpret_cast<const uint32_t*>(
                         lists + (sub + j * per) * kListStride),
                     pairs[j], mn[j], mx[j]);
      }
    }
    if (c + kStages < c_end) {
      __syncwarp();           // every lane's reads of the stage are done
      if (lane == 0) {
        __threadfence_block();
        if (atomicAdd(&freed[slot], 1) % warps == warps - 1) {
          __threadfence_block();
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          stage(c + kStages, slot);
        }
      }
    }
    wcur = wnext;
    if (++slot == kStages) {
      slot = 0;
      parity ^= 1;
    }
  }

  if (kSplit) {
    // the tile's CTAs leave their partial mins and maxs in `part`; the
    // last to finish folds in the others' and runs the epilogue
    __shared__ int last;
    const int pair = blockIdx.x / split * gridDim.y + blockIdx.y;
    int4* mine = part + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) *
                            (warps * kRowsPerWarp * 64) +
                 warp * kRowsPerWarp * 64 + lane;
#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j) {
      mine[j * 64] = mn[j];
      mine[j * 64 + 32] = mx[j];
    }
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
      last = atomicAdd(counters + pair, 1) == split - 1;
      if (last) counters[pair] = 0;
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
    for (int p = 0; p < split; ++p) {
      if (p == rank) continue;
      const int4* other = mine + (p - rank) * (warps * kRowsPerWarp * 64);
#pragma unroll
      for (int j = 0; j < kRowsPerWarp; ++j) {
        min4(mn[j], __ldcg(other + j * 64));
        max4(mx[j], __ldcg(other + j * 64 + 32));
      }
    }
  }

  if (!active) return;
#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) {
    const int row = row0 + sub + j * per;
    if (j < steps && row < n) epi(row, col0 + 4 * q, mn[j], mx[j]);
  }
}

size_t tiled_smem_bytes(int warps) {
  return (size_t)kStages * kStageBytes +
         (size_t)warps * kRowsPerWarp * kListStride + 128;
}

template <class Epilogue>
int launch_tiled(const uint32_t* packed, int n, int n_words,
                 const int32_t* mappings, int n_hash, int warps, int split,
                 void* part, void* counters, Epilogue epi, void* stream) {
  if (warps < 1 || warps > kMaxWarps || n_hash % 4 != 0 || split < 1 ||
      split > kMaxSplit)
    return (int)cudaErrorInvalidValue;
  if (n <= 0 || n_hash <= 0) return (int)cudaGetLastError();
  if (split > 1 && (!part || !counters)) return (int)cudaErrorInvalidValue;
  const int smem = (int)tiled_smem_bytes(warps);
  const int rows = warps * kRowsPerWarp;
  // the mapping table as a TMA tensor: (D, H) int32, boxes of kChunk
  // dimensions x kCols columns
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (!encode) {
    cudaDriverEntryPointQueryResult found;
    void* fn = nullptr;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return (int)cudaErrorNotSupported;
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }
  CUtensorMap map;
  const cuuint64_t dims[2] = {(cuuint64_t)n_hash, (cuuint64_t)n_words * 32};
  const cuuint64_t strides[1] = {(cuuint64_t)n_hash * 4};
  const cuuint32_t box[2] = {kCols, kChunk};
  const cuuint32_t steps[2] = {1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_INT32, 2,
             const_cast<int32_t*>(mappings), dims, strides, box, steps,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  auto kernel = split > 1 ? tiled_kernel<Epilogue, true>
                         : tiled_kernel<Epilogue, false>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((n + rows - 1) / rows * split),
                  (unsigned)((n_hash + kCols - 1) / kCols));
  kernel<<<grid, warps * 32, smem, (cudaStream_t)stream>>>(
      packed, n, n_words, map, n_hash, split, static_cast<int4*>(part),
      static_cast<int*>(counters), epi);
  return (int)cudaGetLastError();
}

}  // namespace

// ------------------------------------------------------------ entry points

// Row path. packed (n, n_words) uint32, mappings (n_words * 32, n_hash)
// int32 -> mins, maxs (n, n_hash) int32. Threads split the columns evenly
// into passes of at most kMaxRawThreads (H = 800 takes two columns a
// thread).
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

// Row path. packed (n, n_words) uint32, mappings (n_words * 32, n_tables *
// f) int32, salts (n_tables,) uint32 -> sig (n, n_tables) uint32, bkt (n,
// n_tables) int32. n_buckets is a power of two.
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

// Tiled path, the same planes. warps (at most kMaxWarps) and split (at
// most kMaxSplit) are the wrapper's plan (kernels/minmax_hash.py:plan),
// which sizes its grid and shared memory as this file does; other values
// return cudaErrorInvalidValue. With split > 1, part has
// room for grid.x * grid.y * warps * 8 * 64 int4 and counters holds
// grid.x / split * grid.y zeros (left zero). mappings and the planes start
// on 16 bytes; n_hash is a multiple of 4.
extern "C" int minmax_hash_tiled_launch(const uint32_t* packed, int n,
                                        int n_words, const int32_t* mappings,
                                        int n_hash, int32_t* mins,
                                        int32_t* maxs, int warps, int split,
                                        void* part, void* counters,
                                        void* stream) {
  return launch_tiled(packed, n, n_words, mappings, n_hash, warps, split,
                      part, counters, RawEpilogue{mins, maxs, n_hash},
                      stream);
}

// Tiled path, the same signatures and buckets; f is 1, 2 or 4.
extern "C" int minmax_sig_buckets_tiled_launch(
    const uint32_t* packed, int n, int n_words, const int32_t* mappings,
    const uint32_t* salts, int n_tables, int f, int use_minmax,
    int n_buckets, uint32_t* sig, int32_t* bkt, int warps, int split,
    void* part, void* counters, void* stream) {
  const int n_hash = n_tables * f;
  const uint32_t mask = (uint32_t)(n_buckets - 1);
  if (f == 4)
    return launch_tiled(packed, n, n_words, mappings, n_hash, warps, split,
                        part, counters,
                        SigEpilogue<4>{salts, sig, bkt, n_tables,
                                       use_minmax, mask},
                        stream);
  if (f == 2)
    return launch_tiled(packed, n, n_words, mappings, n_hash, warps, split,
                        part, counters,
                        SigEpilogue<2>{salts, sig, bkt, n_tables,
                                       use_minmax, mask},
                        stream);
  if (f == 1)
    return launch_tiled(packed, n, n_words, mappings, n_hash, warps, split,
                        part, counters,
                        SigEpilogue<1>{salts, sig, bkt, n_tables,
                                       use_minmax, mask},
                        stream);
  return (int)cudaErrorInvalidValue;
}
