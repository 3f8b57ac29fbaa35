// The paper's §6.5 occurrence filter over a masked pair stream.
//
// Replaces no Pallas kernel: the JAX package runs the filter as four
// `jax.ops.segment_*` reductions (src/repro/core/lsh.py:occurrence_filter),
// which XLA lowers to scatters. Written by hand because the port's library
// scatters (`scatter_add_` twice, `scatter_reduce_(amax)` twice) run over
// every slot of the stream, masked or not, and the masked slots are aimed
// at fingerprint 0: the offline search's stream has t * cap * N slots
// (17.3 M a station-day at the paper's widths), nearly all masked, so each
// scatter piled ~17 M int32 atomics onto one address, which the L2 applies
// one after another (~13 ms a scatter on the H100).
//
// The function: a fingerprint that appears in more than `cap` valid pairs
// is excluded, and so is every partner of one; a pair stays valid when
// neither end is excluded, and its sim is zeroed where it does not. The
// ids of valid slots lie in [0, n_fp); a masked slot's ids are never used
// (they may hold INVALID, 2**31 - 1).
//
// What bounds it on the H100: bytes. Every slot's flag is read and its
// new flag and sim are written (6 bytes a slot), the ids and sim of the
// valid slots are read; the atomics touch only valid slots. Three passes,
// each a kernel on the caller's stream, after two memsets (the counts and
// the excluded flags):
//   1. count: `cnt[i1] += 1`, `cnt[i2] += 1` for each valid slot. Equal
//      ids of one warp are merged first (`__match_any_sync`), so a hub
//      whose pairs lie side by side (the sorted stream's idx1) costs one
//      atomic a warp, not one a pair.
//   2. mark: `excluded[i] = 1` where `cnt[i] > cap`, and for each valid
//      slot whose one end has `cnt > cap`, `excluded[other end] = 1`: all
//      stores write 1, so their order does not matter and no atomic is
//      needed.
//   3. apply: the new flag and sim of every slot; a masked slot writes
//      0 / 0 without reading its ids or sim.
// Integer atomics commute, so the result is the same bits run to run and
// equal to the plain version's. No host synchronisation.
//
// Layout: a thread takes tiles of 4 slots (a 4-byte flag word, 16-byte
// id and sim vectors), 4 tiles a block-round strided by the block, so
// every load and store of a warp is coalesced; a tile past the end, or
// pointers that are not aligned for the vector plan, take byte and word
// accesses.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSlots = 4;            // slots a tile
constexpr int kTiles = 4;            // tiles a thread a round
constexpr int kChunk = kThreads * kTiles * kSlots;   // slots a block-round
constexpr unsigned kFull = 0xFFFFFFFFu;

// the flags of the tile at slot s: byte k nonzero where slot s + k is valid
template <bool VEC>
__device__ __forceinline__ uint32_t load_flags(const uint8_t* __restrict__ v,
                                               long long s, long long m) {
  if (VEC && s + kSlots <= m) {
    return __ldg(reinterpret_cast<const unsigned int*>(v + s));
  }
  uint32_t f = 0;
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    if (s + k < m && v[s + k]) f |= 1u << (8 * k);
  }
  return f;
}

__device__ __forceinline__ bool slot(uint32_t flags, int k) {
  return ((flags >> (8 * k)) & 0xFFu) != 0;
}

// the tile's words of `p` where its flag is set (others 0)
template <bool VEC>
__device__ __forceinline__ void load_words(const int32_t* __restrict__ p,
                                           long long s, long long m,
                                           uint32_t flags, int (&x)[kSlots]) {
  if (VEC && s + kSlots <= m) {
    const int4 q = __ldg(reinterpret_cast<const int4*>(p + s));
    x[0] = q.x;
    x[1] = q.y;
    x[2] = q.z;
    x[3] = q.w;
    return;
  }
#pragma unroll
  for (int k = 0; k < kSlots; ++k) x[k] = slot(flags, k) ? p[s + k] : 0;
}

__device__ __forceinline__ bool in_range(int id, int n_fp) {
  return (unsigned)id < (unsigned)n_fp;
}

// cnt[id] += the number of lanes of `act` holding id, one atomic an id;
// every lane of `act` calls it
__device__ __forceinline__ void add_merged(int* __restrict__ cnt, int id,
                                           unsigned act, int n_fp) {
  const unsigned peers = __match_any_sync(act, id);
  if ((int)(threadIdx.x & 31) == __ffs(peers) - 1 && in_range(id, n_fp)) {
    atomicAdd(cnt + id, __popc(peers));
  }
}

// The block-rounds: round r covers slots [r * kChunk, (r + 1) * kChunk);
// thread x takes the tiles x, x + kThreads, ... of the round, loads their
// flag words together, then runs `body(s, flags)` for each tile start s
// (s < m or not, flags 0 past the end: the loop bound is block-uniform,
// so a warp's lanes meet every ballot together).
template <bool VEC, typename F>
__device__ __forceinline__ void for_tiles(const uint8_t* __restrict__ valid,
                                          long long m, F body) {
  for (long long r = blockIdx.x; r * kChunk < m; r += gridDim.x) {
    long long s[kTiles];
    uint32_t f[kTiles];
#pragma unroll
    for (int g = 0; g < kTiles; ++g) {
      s[g] = r * kChunk + ((long long)g * kThreads + threadIdx.x) * kSlots;
      f[g] = s[g] < m ? load_flags<VEC>(valid, s[g], m) : 0u;
    }
#pragma unroll
    for (int g = 0; g < kTiles; ++g) body(s[g], f[g]);
  }
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
occurrence_filter_count(const uint8_t* __restrict__ valid,
                        const int32_t* __restrict__ i1,
                        const int32_t* __restrict__ i2, long long m,
                        int n_fp, int* __restrict__ cnt) {
  for_tiles<VEC>(valid, m, [&](long long s, uint32_t flags) {
    if (__ballot_sync(kFull, flags != 0) == 0) return;
    int a[kSlots], b[kSlots];
    if (flags) {
      load_words<VEC>(i1, s, m, flags, a);
      load_words<VEC>(i2, s, m, flags, b);
    }
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      const bool v = slot(flags, k);
      const unsigned act = __ballot_sync(kFull, v);
      if (v) {
        add_merged(cnt, a[k], act, n_fp);
        add_merged(cnt, b[k], act, n_fp);
      }
    }
  });
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
occurrence_filter_mark(const uint8_t* __restrict__ valid,
                       const int32_t* __restrict__ i1,
                       const int32_t* __restrict__ i2, long long m,
                       int n_fp, int cap, const int* __restrict__ cnt,
                       uint8_t* __restrict__ excluded) {
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long all = (long long)gridDim.x * kThreads;
  for (long long i = tid; i < n_fp; i += all) {
    if (cnt[i] > cap) excluded[i] = 1;
  }
  for_tiles<VEC>(valid, m, [&](long long s, uint32_t flags) {
    if (!flags) return;
    int a[kSlots], b[kSlots];
    load_words<VEC>(i1, s, m, flags, a);
    load_words<VEC>(i2, s, m, flags, b);
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      if (!slot(flags, k) || !in_range(a[k], n_fp) ||
          !in_range(b[k], n_fp)) {
        continue;
      }
      if (cnt[b[k]] > cap) excluded[a[k]] = 1;
      if (cnt[a[k]] > cap) excluded[b[k]] = 1;
    }
  });
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
occurrence_filter_apply(const uint8_t* __restrict__ valid,
                        const int32_t* __restrict__ i1,
                        const int32_t* __restrict__ i2,
                        const int32_t* __restrict__ sim, long long m,
                        int n_fp, const uint8_t* __restrict__ excluded,
                        uint8_t* __restrict__ out_valid,
                        int32_t* __restrict__ out_sim) {
  for_tiles<VEC>(valid, m, [&](long long s, uint32_t flags) {
    if (s >= m) return;
    uint32_t keep = 0;
    int x[kSlots] = {0, 0, 0, 0};
    if (flags) {
      int a[kSlots], b[kSlots], w[kSlots];
      load_words<VEC>(i1, s, m, flags, a);
      load_words<VEC>(i2, s, m, flags, b);
      load_words<VEC>(sim, s, m, flags, w);
#pragma unroll
      for (int k = 0; k < kSlots; ++k) {
        if (slot(flags, k) && in_range(a[k], n_fp) && in_range(b[k], n_fp) &&
            !excluded[a[k]] && !excluded[b[k]]) {
          keep |= 1u << (8 * k);
          x[k] = w[k];
        }
      }
    }
    if (VEC && s + kSlots <= m) {
      *reinterpret_cast<unsigned int*>(out_valid + s) = keep;
      *reinterpret_cast<int4*>(out_sim + s) = make_int4(x[0], x[1], x[2], x[3]);
      return;
    }
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      if (s + k < m) {
        out_valid[s + k] = slot(keep, k) ? 1 : 0;
        out_sim[s + k] = x[k];
      }
    }
  });
}

// Blocks a launch: one a block-round of the stream, at most what the card
// keeps resident (the rest loop), at least one (the mark pass's
// fingerprint sweep also runs on an empty stream).
int grid_for(long long m, int n_fp) {
  static int resident[64];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return -1;
  if (resident[dev] == 0) {
    int sms = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    resident[dev] = (sms > 0 ? sms : 1) * (2048 / kThreads);
  }
  long long want = (m + kChunk - 1) / kChunk;
  const long long sweep = ((long long)n_fp + kThreads - 1) / kThreads;
  if (sweep > want) want = sweep;
  if (want > resident[dev]) want = resident[dev];
  return want > 0 ? (int)want : 1;
}

template <bool VEC>
int run(const uint8_t* valid, const int32_t* i1, const int32_t* i2,
        const int32_t* sim, long long m, int n_fp, int cap, int* cnt,
        uint8_t* excluded, uint8_t* out_valid, int32_t* out_sim,
        cudaStream_t stream) {
  const int grid = grid_for(m, n_fp);
  if (grid < 0) return (int)cudaErrorInvalidDevice;
  if (m > 0) {
    occurrence_filter_count<VEC><<<grid, kThreads, 0, stream>>>(
        valid, i1, i2, m, n_fp, cnt);
  }
  occurrence_filter_mark<VEC><<<grid, kThreads, 0, stream>>>(
      valid, i1, i2, m, n_fp, cap, cnt, excluded);
  if (m > 0) {
    occurrence_filter_apply<VEC><<<grid, kThreads, 0, stream>>>(
        valid, i1, i2, sim, m, n_fp, excluded, out_valid, out_sim);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// valid (m,) bytes, i1 / i2 / sim (m,) int32; cnt (n_fp,) int32 scratch;
// -> excluded (n_fp,) bytes, out_valid (m,) bytes, out_sim (m,) int32.
// `vector`: the flag arrays start on 4 bytes and the int32 arrays on 16
// (4-byte flag words and 16-byte vectors), else bytes and words.
extern "C" int occurrence_filter_launch(
    const uint8_t* valid, const int32_t* i1, const int32_t* i2,
    const int32_t* sim, long long m, int n_fp, int cap, int vector, int* cnt,
    uint8_t* excluded, uint8_t* out_valid, int32_t* out_sim, void* stream) {
  if (m < 0 || n_fp < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (n_fp > 0) {
    cudaMemsetAsync(cnt, 0, (size_t)n_fp * sizeof(int), s);
    cudaMemsetAsync(excluded, 0, (size_t)n_fp, s);
  }
  return vector ? run<true>(valid, i1, i2, sim, m, n_fp, cap, cnt, excluded,
                            out_valid, out_sim, s)
                : run<false>(valid, i1, i2, sim, m, n_fp, cap, cnt, excluded,
                             out_valid, out_sim, s);
}
