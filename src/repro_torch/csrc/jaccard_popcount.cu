// Exact Jaccard similarity of candidate pairs, gathered from the packed ring.
//
// Replaces: src/repro/kernels/jaccard_popcount.py:jaccard_popcount (the
// Pallas kernel scoring row-aligned (P, W) packed operands on the VPU),
// together with what its callers do around it: the valid mask, the ring
// modulo and the gathers of src/repro/stream/index.py:448-452
// (verify_pairs) and of src/repro/core/lsh.py:verify_jaccard, and the
// mask of the scores after. It takes the (S, P, W) ring, the two (S, M)
// id vectors, not reduced modulo P, and an optional (S, M) valid mask; a
// slot that is not valid scores 0 and reads no row (its ids may hold
// anything).
//
// What bounds it on the H100: bytes. A pair reads two rows of W words (1
// KB each at the paper's 8192-bit fingerprints) and does 2 POPC a word
// pair; 4096 pairs a station read ~8 MB of scattered rows. Measured: with
// the rows in L2 it runs at the L2's rate (~7 TB/s of row reads; the
// replay's current block, 256 rows a station, is read by ~16 pairs a
// row), from device memory at ~2 TB/s of distinct rows; more pairs in
// flight than the resident grid holds makes it slower, not faster.
//
// Design: a persistent grid sized to the warps the card keeps resident,
// so there is no second wave. A warp takes `chunk` consecutive slots (at
// most 32, fewer when the slots are few, so that every resident warp has
// some): each lane loads one slot's flag and ids (three coalesced loads
// issued together; an invalid slot's ids are loaded, never used), the
// valid slots are ranked with a ballot and their ring rows put in shared
// memory in rank order. L lanes score a pair, so a warp scores G = 32 / L
// pairs at once: lanes read 16-byte vectors of both rows (`ld.global.nc`,
// NV a lane a row, unrolled at compile time; the far row evicted from L2
// first, the current block's row last) and issue the next pair's loads
// before counting the current one. The two
// counts are exact integers reduced by shuffles within the L lanes; the
// score is an IEEE fp32 division (the build never uses fast math),
// (float)inter / (float)union, or 0 when the union is empty, stored by
// the slot's own lane. Rows whose width is not a multiple of 4 words, or
// a ring that does not start on 16 bytes, take the same kernel with
// 4-byte words (the scalar plan).
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xFFFFFFFFu;

// L2 eviction policies: the far ring rows (i1) are read once and go
// first; the current block's rows (i2) are read by many pairs and stay.
__device__ __forceinline__ uint64_t evict_first() {
  uint64_t p;
  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(p));
  return p;
}
__device__ __forceinline__ uint64_t evict_last() {
  uint64_t p;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(p));
  return p;
}

// Read-only (ld.global.nc) loads under an L2 policy.
__device__ __forceinline__ uint4 load_row(const uint4* q, uint64_t pol) {
  uint4 v;
  asm("ld.global.nc.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(q), "l"(pol));
  return v;
}
__device__ __forceinline__ uint32_t load_row(const uint32_t* q,
                                             uint64_t pol) {
  uint32_t v;
  asm("ld.global.nc.L2::cache_hint.u32 %0, [%1], %2;"
      : "=r"(v)
      : "l"(q), "l"(pol));
  return v;
}

__device__ __forceinline__ void zero(uint4& x) { x = make_uint4(0, 0, 0, 0); }
__device__ __forceinline__ void zero(uint32_t& x) { x = 0u; }

__device__ __forceinline__ void count(uint4 x, uint4 y, int& inter,
                                      int& uni) {
  inter += __popc(x.x & y.x) + __popc(x.y & y.y) + __popc(x.z & y.z) +
           __popc(x.w & y.w);
  uni += __popc(x.x | y.x) + __popc(x.y | y.y) + __popc(x.z | y.z) +
         __popc(x.w | y.w);
}

__device__ __forceinline__ void count(uint32_t x, uint32_t y, int& inter,
                                      int& uni) {
  inter += __popc(x & y);
  uni += __popc(x | y);
}

// Python's id % ring, in [0, ring).
__device__ __forceinline__ int wrap(int id, int ring) {
  const int r = id % ring;
  return r < 0 ? r + ring : r;
}

// Loads of one round of a pair: this lane's NV elements of both rows of
// the live slot `j` (ranked), or zeros where there is no such slot or the
// row has ended.
template <typename T, int L, int NV>
__device__ __forceinline__ void fetch(const T* __restrict__ pk, int vecs,
                                      const int2* rows, int j, int n_live,
                                      int round, int sub, T (&a)[NV],
                                      T (&b)[NV]) {
  const bool act = j < n_live;
  const int2 r = act ? rows[j] : make_int2(0, 0);
  const int first = round * L * NV + sub;
  const T* pa = pk + (size_t)r.x * vecs + first;
  const T* pb = pk + (size_t)r.y * vecs + first;
  const int left = vecs - first;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    if (act && k * L < left) {
      a[k] = load_row(pa + k * L, evict_first());
      b[k] = load_row(pb + k * L, evict_last());
    } else {
      zero(a[k]);
      zero(b[k]);
    }
  }
}

// T: uint4 (vector plan) or uint32_t (scalar plan); a row is `vecs` T.
template <typename T, int L, int NV>
__global__ void __launch_bounds__(kThreads)
jaccard_popcount_kernel(const T* __restrict__ pk, int ring, int vecs,
                        const int32_t* __restrict__ i1,
                        const int32_t* __restrict__ i2,
                        const uint8_t* __restrict__ valid, int per_station,
                        long long total, int chunk, float* __restrict__ out) {
  constexpr int G = 32 / L;               // pairs a warp scores at once
  constexpr int kSpan = L * NV;           // elements of a row a round reads
  __shared__ int2 rows_s[kThreads];       // a warp's live rows, by rank
  __shared__ float scores_s[kThreads];    // and their scores
  const int lane = threadIdx.x & 31;
  const int group = lane / L, sub = lane % L;
  int2* rows = rows_s + (threadIdx.x & ~31);
  float* scores = scores_s + (threadIdx.x & ~31);
  const int rounds = vecs > 0 ? (vecs + kSpan - 1) / kSpan : 1;
  const long long stride = (long long)gridDim.x * kWarps * chunk;
  for (long long base = ((long long)blockIdx.x * kWarps + (threadIdx.x >> 5))
                        * chunk;
       base < total; base += stride) {
    const bool mine = lane < chunk && base + lane < total;
    const int t = mine ? (int)(base + lane) : 0;   // total <= INT_MAX
    bool live = false;
    int id1 = 0, id2 = 0;
    if (mine) {          // the three loads go out together
      live = valid == nullptr || valid[t] != 0;
      id1 = i1[t];
      id2 = i2[t];
    }
    const unsigned mask = __ballot_sync(kFull, live);
    const int rank = __popc(mask & ((1u << lane) - 1u));
    if (live) {
      const int s = t / per_station;
      rows[rank] = make_int2(s * ring + wrap(id1, ring),
                             s * ring + wrap(id2, ring));
    }
    __syncwarp();
    const int n_live = __popc(mask);
    const int items = (n_live + G - 1) / G * rounds;   // warp-uniform
    T a[NV], b[NV];
    fetch<T, L, NV>(pk, vecs, rows, group, n_live, 0, sub, a, b);
    int step = 0, round = 0, inter = 0, uni = 0;
    for (int it = 0; it < items; ++it) {
      // the next item's loads go out before this one's counts
      const bool last = round + 1 == rounds;
      const int nstep = last ? step + 1 : step;
      const int nround = last ? 0 : round + 1;
      T na[NV], nb[NV];
      fetch<T, L, NV>(pk, vecs, rows,
                      it + 1 < items ? nstep * G + group : n_live, n_live,
                      nround, sub, na, nb);
#pragma unroll
      for (int k = 0; k < NV; ++k) count(a[k], b[k], inter, uni);
      if (last) {
#pragma unroll
        for (int off = L / 2; off > 0; off >>= 1) {
          inter += __shfl_xor_sync(kFull, inter, off);
          uni += __shfl_xor_sync(kFull, uni, off);
        }
        const int j = step * G + group;
        if (sub == 0 && j < n_live) {
          scores[j] = uni > 0 ? __fdiv_rn((float)inter, (float)uni) : 0.f;
        }
        inter = uni = 0;
      }
      step = nstep;
      round = nround;
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        a[k] = na[k];
        b[k] = nb[k];
      }
    }
    __syncwarp();
    if (mine) out[t] = live ? scores[rank] : 0.f;
    __syncwarp();
  }
}

struct Args {
  const void* pk;
  int ring, vecs;
  const int32_t* i1;
  const int32_t* i2;
  const uint8_t* valid;
  int per_station;
  long long total;
  float* out;
};

// The persistent grid: every resident warp takes a chunk of slots (a
// multiple of G, at most 32), and the grid is no larger than the card
// holds at once; more than 32 slots a resident warp take more passes.
template <typename T, int L, int NV>
int launch(const Args& x, cudaStream_t stream) {
  constexpr int G = 32 / L;
  static int resident[64];                 // CTAs the card holds, per device
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, jaccard_popcount_kernel<T, L, NV>, kThreads, 0);
    resident[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  const long long warps = (long long)resident[dev] * kWarps;
  const long long each = (x.total + warps - 1) / warps;
  const int chunk = (int)(each < 32 ? (each + G - 1) / G * G : 32);
  const long long chunks = (x.total + chunk - 1) / chunk;
  const long long ctas = (chunks + kWarps - 1) / kWarps;
  const int grid = (int)(ctas < resident[dev] ? ctas : resident[dev]);
  jaccard_popcount_kernel<T, L, NV><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x.pk), x.ring, x.vecs, x.i1, x.i2, x.valid,
      x.per_station, x.total, chunk, x.out);
  return (int)cudaGetLastError();
}

template <typename T, int L>
int launch_nv(int nv, const Args& x, cudaStream_t stream) {
  switch (nv) {
    case 1: return launch<T, L, 1>(x, stream);
    case 2: return launch<T, L, 2>(x, stream);
    case 4: return launch<T, L, 4>(x, stream);
    case 8: return launch<T, L, 8>(x, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch_lanes(int lanes, int nv, const Args& x, cudaStream_t stream) {
  switch (lanes) {
    case 4: return launch_nv<T, 4>(nv, x, stream);
    case 8: return launch_nv<T, 8>(nv, x, stream);
    case 16: return launch_nv<T, 16>(nv, x, stream);
    case 32: return launch_nv<T, 32>(nv, x, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// pk (stations, ring, n_words) int32 words; i1/i2 (stations, per_station)
// int32 ids (any value: reduced modulo ring here); valid (stations,
// per_station) bytes or NULL for all valid -> out (stations, per_station)
// fp32. The plan: `vector` reads 16-byte vectors (pk on 16 bytes, n_words
// a multiple of 4), `lanes` lanes a pair (4, 8, 16 or 32), `nv` (1, 2, 4
// or 8) loads a lane a row a round.
extern "C" int jaccard_popcount_launch(
    const void* pk, int stations, int ring, int n_words, const int32_t* i1,
    const int32_t* i2, const uint8_t* valid, int per_station, int vector,
    int lanes, int nv, float* out, void* stream) {
  const long long total = (long long)stations * per_station;
  if (total <= 0) return (int)cudaGetLastError();
  if (ring <= 0 || (long long)stations * ring > INT_MAX || total > INT_MAX ||
      (vector && (n_words % 4 != 0 || (uintptr_t)pk % 16 != 0))) {
    return (int)cudaErrorInvalidValue;
  }
  const Args x{pk, ring, vector ? n_words / 4 : n_words, i1, i2, valid,
               per_station, total, out};
  const cudaStream_t s = (cudaStream_t)stream;
  return vector ? launch_lanes<uint4>(lanes, nv, x, s)
                : launch_lanes<uint32_t>(lanes, nv, x, s);
}
