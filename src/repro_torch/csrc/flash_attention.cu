// Blocked causal GQA attention with an online softmax: bf16 on the tensor
// cores, fp32 on the CUDA cores.
//
// Replaces: src/repro/kernels/flash_attention.py:flash_attention (the Pallas
// kernel that keeps a (bq x bk) score tile, the running max / sum and an
// fp32 accumulator in VMEM while KV tiles stream over the sequential grid
// axis, skipping KV tiles above the causal diagonal; query head h reads kv
// head h // group through its index map).
//
// What bounds it on the H100: 4 * B * Hq * D * (allowed q-k pairs) flops --
// 43 GFLOP for the causal 2048 x 2048 prefill of 40 heads at D = 128, which
// is 0.043 ms at the 989 TFLOP/s dense bf16 tensor-core rate, against
// ~0.02 ms for the 42 MB of q, k, v and output. Scores and probabilities
// never leave the SM, K and V are read once per q tile and never expanded
// per q head, and tiles above the diagonal are never loaded.
//
// bf16 (flash_attention_mma_kernel): every product on the tensor cores with
// mma.sync.m16n8k16 (bf16 in, fp32 accumulate). One CTA of 4 warps per
// (batch, q head, 64-row q tile); each warp owns 16 q rows. Q is staged once
// through shared memory and then held in registers as A fragments
// (ldmatrix). K and V tiles of 64 keys stay bf16 in shared memory,
// XOR-swizzled so that ldmatrix / ldmatrix.trans read conflict-free, and are
// double-buffered with cp.async: tile t's V load overlaps its Q K^T, tile
// t + 1's K load overlaps its softmax and P V. The online softmax works on
// the S accumulator fragments in registers (row max over the 4 lanes of a
// quad, exp2 with scale * log2(e) folded into one multiply, m, l and the O
// accumulator fp32); P is rounded to bf16 in registers and used directly as
// the A fragments of P V, never touching shared memory. The causal / ragged
// mask is applied only on tiles that cross the diagonal or the Sk edge; the
// heaviest causal q tiles are launched first. cp.async moves 16 bytes a
// thread, so q, k, v and out must be 16-byte aligned with batch / head /
// seq strides that are multiples of 8 elements (the wrapper checks).
// Measured on an H100 80GB HBM3 (700 W): 0.187 ms for the causal 2048^2
// prefill of 40 / 8 heads at D = 128, 230 TFLOP/s, 4.3x its bound and 1.9x
// scaled_dot_product_attention (PERF.md). What separates it from its
// bound: mma.sync issues at about two thirds of the wgmma rate and the
// warps wait on ldmatrix and the softmax between products; the wgmma + TMA
// form with a producer warp is later work. An 8-warp, 128-row q tile
// measured within 1% of this one.
//
// fp32 (flash_attention_kernel): exact fp32 FMAs on the CUDA cores (the
// path the LM parity runs take; 1.98 ms at the same shape, 3.1x its fp32
// bound). One CTA of 256 threads per (batch, q head,
// 64-row q tile), looping over 64-row KV tiles. The q tile stays in shared
// memory; K and then V of a tile take turns in one shared buffer; P goes
// through shared memory between the two products. Thread (rg, cg) =
// (tid / 16, tid % 16) owns q rows rg + 16 i (i < 4) -- the same rows in
// S = Q K^T (key columns cg + 16 j) and in O += P V (D / 16 output columns)
// -- so the row max and row sum are reduced over the 16 lanes of a half
// warp with shuffles and every thread keeps its rows' m, l and accumulator
// in registers.
//
// Head sizes D = 16, 32, 64 and 128 are instantiated. At D = 16 a bf16 row
// is 32 bytes, two 16-byte chunks: a K / V tile is 128 chunks (the last
// threads of a 256-thread load idle), four rows share a 128-byte line (the
// swizzle swaps the two chunks of rows 4-7 of every 8), Q K^T is one k16
// step and P V two n8 tiles; the fp32 kernel's thread owns one output
// column of its rows.
//
// Both: rows and columns past Sq / Sk (the ragged edge) are masked in the
// kernel, for any Sq and Sk, causal with offset Sk - Sq; strided q / k / v /
// out (last dim contiguous), so the model's (B, S, H, D) activations are
// read and written without a transpose copy; one launch per call.
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------- fp32, FMA
constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;
constexpr int kRows = 4;    // q rows per thread
constexpr int kCols = 4;    // key columns per thread in S

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f(float* p, float x) { *p = x; }

struct Strides {
  long long b, h, s;  // element strides; the last dim is contiguous
};

// Stage rows [row0, row0 + kBQ) of one (b, h) slice into smem (row stride
// D + 4), zeros past n_rows.
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src,
                                      long long s_stride, int row0,
                                      int n_rows) {
  constexpr int kLd = D + 4;
  for (int i = threadIdx.x; i < kBQ * D; i += kThreads) {
    const int r = i / D;
    const int c = i - r * D;
    const int row = row0 + r;
    dst[r * kLd + c] =
        row < n_rows ? to_f(src[(long long)row * s_stride + c]) : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       float* __restrict__ lse, Strides sq_, Strides sk_,
                       Strides sv_, Strides so_, int hq, int group, int sq,
                       int sk, int causal, float scale) {
  constexpr int kLd = D + 4;          // padded row stride of q / kv tiles
  constexpr int kPLd = kBK + 4;       // padded row stride of P
  constexpr int kNC = D / 16;         // output columns per thread
  constexpr int kVec = kNC < 4 ? kNC : 4;
  constexpr int kNV = kNC / kVec;     // vectors of output columns
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* kv = qs + kBQ * kLd;
  float* ps = kv + kBK * kLd;

  const int tid = threadIdx.x;
  const int rg = tid >> 4;
  const int cg = tid & 15;
  const int qt = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / group;
  const int q0 = qt * kBQ;
  const int offset = sk - sq;

  const T* qb = q + b * sq_.b + h * sq_.h;
  const T* kb = k + b * sk_.b + hk * sk_.h;
  const T* vb = v + b * sv_.b + hk * sv_.h;
  T* ob = out + b * so_.b + h * so_.h;

  // KV tiles this q tile reads: up to the diagonal of its last real row.
  int n_tiles = (sk + kBK - 1) / kBK;
  if (causal) {
    const int last = min(q0 + kBQ, sq) - 1 + offset;
    n_tiles = last < 0 ? 0 : min(n_tiles, last / kBK + 1);
  }

  stage<T, D>(qs, qb, sq_.s, q0, sq);

  float m[kRows], l[kRows], acc[kRows][kNC];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = -1e30f;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kNC; ++c) acc[i][c] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile's P V is done with kv and ps
    stage<T, D>(kv, kb, sk_.s, k0, sk);
    __syncthreads();

    // S = Q K^T for rows rg + 16 i, key columns cg + 16 j.
    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[kRows], kvv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (rg + 16 * i) * kLd + d);
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        kvv[j] = *reinterpret_cast<const float4*>(kv + (cg + 16 * j) * kLd + d);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          s[i][j] = fmaf(qv[i].x, kvv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kvv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kvv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kvv[j].w, s[i][j]);
        }
    }

    // Online softmax over this tile, one row at a time.
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qi = q0 + rg + 16 * i + offset;
      bool ok[kCols];
      float mx = -1e30f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kj = k0 + cg + 16 * j;
        ok[j] = kj < sk && (!causal || kj <= qi);
        s[i][j] *= scale;
        if (ok[j]) mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += p;
        ps[(rg + 16 * i) * kPLd + cg + 16 * j] = p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kNC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // every thread is done with K; P is complete
    stage<T, D>(kv, vb, sv_.s, k0, sk);
    __syncthreads();

    // O += P V: rows rg + 16 i, columns e + kVec (cg + 16 n).
#pragma unroll 2
    for (int j = 0; j < kBK; j += 4) {
      float4 pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        pv[i] = *reinterpret_cast<const float4*>(ps + (rg + 16 * i) * kPLd + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* vrow = kv + (j + jj) * kLd;
#pragma unroll
        for (int n = 0; n < kNV; ++n) {
          const int c0 = kVec * (cg + 16 * n);
          float vv[kVec];
          if constexpr (kVec == 4) {
            const float4 t4 = *reinterpret_cast<const float4*>(vrow + c0);
            vv[0] = t4.x; vv[1] = t4.y; vv[2] = t4.z; vv[3] = t4.w;
          } else if constexpr (kVec == 2) {
            const float2 t2 = *reinterpret_cast<const float2*>(vrow + c0);
            vv[0] = t2.x; vv[1] = t2.y;
          } else {
            vv[0] = vrow[c0];
          }
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            const float p = jj == 0 ? pv[i].x : jj == 1 ? pv[i].y
                            : jj == 2 ? pv[i].z : pv[i].w;
#pragma unroll
            for (int e = 0; e < kVec; ++e)
              acc[i][n * kVec + e] = fmaf(p, vv[e], acc[i][n * kVec + e]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + rg + 16 * i;
    if (row >= sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-20f);
    if (lse != nullptr && cg == 0)
      lse[((long long)b * hq + h) * sq + row] =
          l[i] > 0.f ? m[i] + logf(l[i]) : -INFINITY;
    T* orow = ob + (long long)row * so_.s;
#pragma unroll
    for (int n = 0; n < kNV; ++n)
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        from_f(orow + kVec * (cg + 16 * n) + e, acc[i][n * kVec + e] * inv);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int b, int hq, int hkv, int sq, int sk,
           const long long* st, int causal, float scale,
           cudaStream_t stream) {
  constexpr int kLd = D + 4;
  const size_t smem =
      ((size_t)(kBQ + kBK) * kLd + (size_t)kBQ * (kBK + 4)) * sizeof(float);
  auto kern = flash_attention_kernel<T, D>;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  const Strides s_q{st[0], st[1], st[2]}, s_k{st[3], st[4], st[5]},
      s_v{st[6], st[7], st[8]}, s_o{st[9], st[10], st[11]};
  dim3 grid((sq + kBQ - 1) / kBQ, hq, b);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, s_q, s_k, s_v,
      s_o, hq, hq / hkv, sq, sk, causal, scale);
  return 0;
}


// ---------------------------------------------------------------- bf16, mma
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kWarps = 4;
constexpr int kBQ = 16 * kWarps;   // q rows of a CTA, 16 a warp
constexpr int kBK = 64;            // keys of a K / V tile
constexpr int kThreads = 32 * kWarps;
static_assert(kBQ == kBK, "Q is staged in one K / V tile's space");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Element offset of 16-byte chunk c of row r in a tile with D bf16 a row.
// The chunk index is XORed with the row so that the 8 rows one ldmatrix
// reads at one chunk column fall in 8 distinct 16-byte bank groups.
template <int D>
__device__ __forceinline__ int swz(int r, int c) {
  if constexpr (D / 8 >= 8) return r * D + ((c ^ (r & 7)) << 3);
  else if constexpr (D == 32)   // 2 rows a 128-byte line, 4 chunks a row
    return r * D + ((c ^ ((r >> 1) & 3)) << 3);
  else   // D = 16: 4 rows a line, 2 chunks a row; rows r and r + 4 swap
    return r * D + ((c ^ ((r >> 2) & 1)) << 3);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  // src_bytes 0 fills the 16 bytes with zeros (rows past the edge)
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c (16 x 8, fp32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col)
__device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// cp.async rows [row0, row0 + 64) of one (b, h) slice into a swizzled
// tile; rows past n_rows are zero-filled. A tile of fewer 16-byte chunks
// than threads (D = 16 under 256 threads) leaves the last threads idle.
template <int D, int NT = kThreads>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long s_stride, int row0,
                                          int n_rows) {
  constexpr int kChunks = D / 8;
  constexpr int kTotal = kBK * kChunks;
  static_assert(kTotal % NT == 0 || NT % kTotal == 0, "tile / thread split");
#pragma unroll
  for (int j = 0; j < (kTotal + NT - 1) / NT; ++j) {
    const int i = threadIdx.x + j * NT;
    if (kTotal < NT && i >= kTotal) break;
    const int r = i / kChunks;
    const int c = i % kChunks;
    const int row = row0 + r;
    const bool ok = row < n_rows;
    cp_async16(dst + swz<D>(r, c),
               ok ? src + (long long)row * s_stride + c * 8 : src,
               ok ? 16 : 0);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_mma_kernel(const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v, bf16* __restrict__ out,
                           float* __restrict__ lse, Strides sq_, Strides sk_,
                           Strides sv_, Strides so_, int group, int sq,
                           int sk, int causal, float scale_log2) {
  constexpr int kTile = kBK * D;   // elements of one K or V tile
  constexpr int kKD = D / 16;      // k16 steps of Q K^T
  constexpr int kNO = D / 8;       // n8 tiles of O
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);   // K, 2 stages
  bf16* vs = ks + 2 * kTile;                       // V, 2 stages
  bf16* qs = vs + kTile;   // Q is staged in V's second stage, free till t = 1

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int h = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;   // heaviest causal tiles first
  const int b = blockIdx.z;
  const int hk = h / group;
  const int q0 = qt * kBQ;
  const int offset = sk - sq;

  const bf16* qb = q + b * sq_.b + h * sq_.h;
  const bf16* kb = k + b * sk_.b + hk * sk_.h;
  const bf16* vb = v + b * sv_.b + hk * sv_.h;
  bf16* ob = out + b * so_.b + h * so_.h;

  // KV tiles this q tile reads: up to the diagonal of its last real row.
  int n_tiles = (sk + kBK - 1) / kBK;
  if (causal) {
    const int last = min(q0 + kBQ, sq) - 1 + offset;
    n_tiles = last < 0 ? 0 : min(n_tiles, last / kBK + 1);
  }

  load_tile<D>(qs, qb, sq_.s, q0, sq);
  cp_async_commit();
  if (n_tiles > 0) load_tile<D>(ks, kb, sk_.s, 0, sk);
  cp_async_commit();
  cp_async_wait<1>();   // Q has landed
  __syncthreads();

  // This warp's 16 q rows as A fragments, one set of 4 registers per k16.
  uint32_t qf[kKD][4];
#pragma unroll
  for (int kk = 0; kk < kKD; ++kk)
    ldsm_x4(qf[kk], qs + swz<D>(16 * warp + (lane & 15), 2 * kk + (lane >> 4)));

  // Lane (g, i) = (lane / 4, lane % 4) holds rows g and g + 8 of the warp's
  // 16: S columns / O columns 8 n + 2 i and 8 n + 2 i + 1 of each n8 tile.
  float o[kNO][4];
#pragma unroll
  for (int n = 0; n < kNO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};   // running max, log2 units
  float l[2] = {0.f, 0.f};               // this lane's part of the row sum
  const int row_g = q0 + 16 * warp + (lane >> 2);
  const int col_i = 2 * (lane & 3);
  // tiles whose last key passes this warp's first row's diagonal, or Sk
  const int diag = q0 + 16 * warp + offset;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    const bf16* kt = ks + (t & 1) * kTile;
    bf16* vt = vs + (t & 1) * kTile;
    load_tile<D>(vt, vb, sv_.s, k0, sk);
    cp_async_commit();
    cp_async_wait<1>();   // K[t] has landed
    __syncthreads();

    // S = Q K^T: 16 rows x 64 keys a warp, 8 n8 tiles.
    float s[kBK / 8][4];
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKD; ++kk) {
#pragma unroll
      for (int np = 0; np < kBK / 16; ++np) {
        uint32_t bk[4];
        ldsm_x4(bk, kt + swz<D>(16 * np + (lane & 7) + ((lane >> 4) << 3),
                                2 * kk + ((lane >> 3) & 1)));
        mma(s[2 * np], qf[kk], bk[0], bk[1]);
        mma(s[2 * np + 1], qf[kk], bk[2], bk[3]);
      }
    }

    if (t + 1 < n_tiles)
      load_tile<D>(ks + ((t + 1) & 1) * kTile, kb, sk_.s, k0 + kBK, sk);
    cp_async_commit();

    if (k0 + kBK > sk || (causal && k0 + kBK - 1 > diag)) {
#pragma unroll
      for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kj = k0 + 8 * n + col_i + (e & 1);
          const int qi = row_g + 8 * (e >> 1) + offset;
          if (kj >= sk || (causal && kj > qi)) s[n][e] = -INFINITY;
        }
    }

    // Online softmax on the fragments; rows g (e = 0, 1) and g + 8 (e = 2, 3).
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < kBK / 8; ++n)
        mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx * scale_log2);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;   // all masked
      const float alpha = exp2f(m[r] - m_use);
      m[r] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          s[n][e] = exp2f(fmaf(s[n][e], scale_log2, -m_use));
          sum += s[n][e];
        }
      l[r] = l[r] * alpha + sum;
#pragma unroll
      for (int n = 0; n < kNO; ++n) {
        o[n][2 * r] *= alpha;
        o[n][2 * r + 1] *= alpha;
      }
    }

    cp_async_wait<1>();   // V[t] has landed
    __syncthreads();

    // O += P V: P from the S fragments, rounded to bf16 in registers.
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t bv[4];
        ldsm_x4_t(bv, vt + swz<D>(16 * kk + (lane & 7) + (((lane >> 3) & 1) << 3),
                                  2 * np + (lane >> 4)));
        mma(o[2 * np], pa, bv[0], bv[1]);
        mma(o[2 * np + 1], pa, bv[2], bv[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const int row = row_g + 8 * r;
    if (row >= sq) continue;
    const float inv = 1.f / fmaxf(sum, 1e-20f);
    if (lse != nullptr && (lane & 3) == 0)   // natural log, as the fp32 path
      lse[((long long)b * gridDim.x + h) * sq + row] =
          sum > 0.f ? (m[r] + log2f(sum)) * 0.6931471805599453f : -INFINITY;
    bf16* orow = ob + (long long)row * so_.s + col_i;
#pragma unroll
    for (int n = 0; n < kNO; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n) =
          __floats2bfloat162_rn(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int b, int hq, int hkv, int sq, int sk,
           const long long* st, int causal, float scale,
           cudaStream_t stream) {
  const size_t smem = 4 * (size_t)kBK * D * sizeof(bf16);   // K, V: 2 stages
  auto kern = flash_attention_mma_kernel<D>;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  const Strides s_q{st[0], st[1], st[2]}, s_k{st[3], st[4], st[5]},
      s_v{st[6], st[7], st[8]}, s_o{st[9], st[10], st[11]};
  dim3 grid(hq, (sq + kBQ - 1) / kBQ, b);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), lse, s_q, s_k,
      s_v, s_o, hq / hkv, sq, sk, causal, scale * 1.4426950408889634f);
  return 0;
}

}  // namespace tc


// ------------------------------------------------------------ backward
//
// FlashAttention-2's backward with no floating-point atomics, so that every
// gradient is the same bits run to run (the training launcher's resume is
// bit-exact). Given the forward's output O and its per-row log-sum-exp L
// (natural log, fp32):
//   pre-pass   Dv_i = sum_d dO_id O_id
//   dK / dV    per key block, walking the group's q heads and the q tiles
//              the causal mask allows: P = exp(S * scale - L),
//              dS = P o (dO V^T - Dv), dV += P^T dO, dK += dS^T Q * scale
//   dQ         per q block, walking the key tiles the forward read:
//              dQ += dS K * scale (S and dP computed again)
// Each gradient element is summed in a fixed order: the group's q heads
// inside one CTA (or two halves of the walk added in order by a combine
// kernel), dQ by one thread. There is no Pallas backward: the reference
// differentiates XLA's layers.blocked_attention.
//
// What bounds it on the H100: the products. A backward needs 5 of (q tile x
// key tile x D) a tile pair, 10 * D flops an allowed q-k pair: 0.109 ms at
// the 989 TFLOP/s bf16 tensor rate for qwen2.5-14b's causal 2048^2 of 40 /
// 8 heads at D = 128; the separate deterministic dQ kernel computes S and
// dP again, 7 products in all. Three forms:
//   bf16, D 64 / 128 (the training path; hop:: below): wgmma with TMA
//     tiles in mbarrier rings, a producer warp and two consumer
//     warpgroups, key blocks and q blocks launched heaviest first and a
//     short dK / dV grid's walks split in two. Measured on an H100 80GB
//     HBM3 (700 W) at that shape: 0.340 ms (the pre-pass 0.026, dK / dV
//     0.165, the combine 0.017, dQ 0.139), 316 TFLOP/s of the 10 * D
//     flops, against 0.347 ms for scaled_dot_product_attention's backward
//     (PERF.md). What separates it from its bound: dQ's recomputed S and
//     dP (7 products where 5 would do), the softmax work between a
//     consumer's products, and the pre-pass and combine launches.
//   bf16, D 16 / 32: mma.sync kernels (tc:: below; 64-key tiles of 8 warps
//     for dK / dV, key tiles slowest in the grid so that the heaviest start
//     first; 4 warps a 64-row q tile for dQ).
//   fp32: exact FMAs on the CUDA cores (1.175 ms for the same heads at
//     512^2, against a 0.100 ms bound at the fp32 rate).

// Dv = rowsum(dO o O): one warp a row, lanes over D, a fixed shuffle tree.
template <typename T>
__global__ void __launch_bounds__(256)
fa_bwd_dot_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                  float* __restrict__ dvec, Strides so_, Strides sdo_,
                  int hq, int sq, int d, long long rows) {
  const long long row = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int i = (int)(row % sq);
  const long long bh = row / sq;
  const int h = (int)(bh % hq);
  const int b = (int)(bh / hq);
  const T* orow = o + b * so_.b + h * so_.h + (long long)i * so_.s;
  const T* drow = dout + b * sdo_.b + h * sdo_.h + (long long)i * sdo_.s;
  float acc = 0.f;
  for (int c = lane; c < d; c += 32)
    acc = fmaf(to_f(drow[c]), to_f(orow[c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) dvec[row] = acc;
}

// First q tile whose rows may attend to key k0 (causal offset sk - sq).
__device__ __forceinline__ int first_q_tile(int k0, int offset, int causal,
                                            int bq) {
  return causal ? max(0, k0 - offset) / bq : 0;
}

// ---------------------------------------------------------------- fp32, FMA
// Thread (rg, cg) = (tid / 16, tid % 16) owns rows rg + 16 i of the tile it
// accumulates (keys in dK / dV, queries in dQ) and columns cg + 16 j of the
// 64 x 64 score tiles, as in the forward's fp32 kernel.

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
fa_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v,
                   const float* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ dvec, float* __restrict__ dk,
                   float* __restrict__ dv, Strides sq_, Strides sk_,
                   Strides sv_, Strides sdo_, Strides sdk_, Strides sdv_,
                   int hq, int group, int sq, int sk, int causal,
                   float scale) {
  constexpr int kLd = D + 4;
  constexpr int kPLd = kBQ + 4;
  constexpr int kNC = D / 16;
  constexpr int kVec = kNC < 4 ? kNC : 4;
  constexpr int kNV = kNC / kVec;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);
  float* vs = ks + kBK * kLd;
  float* qs = vs + kBK * kLd;
  float* dos = qs + kBQ * kLd;
  float* ps = dos + kBQ * kLd;      // P^T (key rows, q columns)
  float* dss = ps + kBK * kPLd;     // dS^T
  float* ls = dss + kBK * kPLd;     // the q tile's L and Dv
  float* dl = ls + kBQ;

  const int tid = threadIdx.x;
  const int rg = tid >> 4;
  const int cg = tid & 15;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int k0 = blockIdx.x * kBK;
  const int offset = sk - sq;

  stage<float, D>(ks, k + b * sk_.b + hk * sk_.h, sk_.s, k0, sk);
  stage<float, D>(vs, v + b * sv_.b + hk * sv_.h, sv_.s, k0, sk);

  float ak[kRows][kNC], av[kRows][kNC];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < kNC; ++c) ak[i][c] = av[i][c] = 0.f;

  const int qt0 = first_q_tile(k0, offset, causal, kBQ);
  const int nqt = max(0, (sq + kBQ - 1) / kBQ - qt0);
  for (int it = 0; it < group * nqt; ++it) {
    const int h = hk * group + it / nqt;
    const int q0 = (qt0 + it % nqt) * kBQ;
    const long long bh = (long long)b * hq + h;
    __syncthreads();   // the previous tile's products are done
    stage<float, D>(qs, q + b * sq_.b + h * sq_.h, sq_.s, q0, sq);
    stage<float, D>(dos, dout + b * sdo_.b + h * sdo_.h, sdo_.s, q0, sq);
    if (tid < kBQ) {
      const bool ok = q0 + tid < sq;
      ls[tid] = ok ? lse[bh * sq + q0 + tid] : 0.f;
      dl[tid] = ok ? dvec[bh * sq + q0 + tid] : 0.f;
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T: key rows rg + 16 i, q columns cg + 16 j
    float s[kRows][kCols], dp[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      float4 kr[kRows], vr[kRows], qr[kCols], dr[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        kr[i] = *reinterpret_cast<const float4*>(ks + (rg + 16 * i) * kLd + d);
        vr[i] = *reinterpret_cast<const float4*>(vs + (rg + 16 * i) * kLd + d);
      }
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        qr[j] = *reinterpret_cast<const float4*>(qs + (cg + 16 * j) * kLd + d);
        dr[j] = *reinterpret_cast<const float4*>(dos + (cg + 16 * j) * kLd + d);
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          s[i][j] = fmaf(kr[i].x, qr[j].x, s[i][j]);
          s[i][j] = fmaf(kr[i].y, qr[j].y, s[i][j]);
          s[i][j] = fmaf(kr[i].z, qr[j].z, s[i][j]);
          s[i][j] = fmaf(kr[i].w, qr[j].w, s[i][j]);
          dp[i][j] = fmaf(vr[i].x, dr[j].x, dp[i][j]);
          dp[i][j] = fmaf(vr[i].y, dr[j].y, dp[i][j]);
          dp[i][j] = fmaf(vr[i].z, dr[j].z, dp[i][j]);
          dp[i][j] = fmaf(vr[i].w, dr[j].w, dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kj = k0 + rg + 16 * i;
        const int qi = q0 + cg + 16 * j;
        const bool ok = kj < sk && qi < sq && (!causal || kj <= qi + offset);
        const float p = ok ? expf(s[i][j] * scale - ls[cg + 16 * j]) : 0.f;
        ps[(rg + 16 * i) * kPLd + cg + 16 * j] = p;
        dss[(rg + 16 * i) * kPLd + cg + 16 * j] =
            p * (dp[i][j] - dl[cg + 16 * j]);
      }
    __syncthreads();

    // dV += P^T dO, dK += dS^T Q: key rows rg + 16 i, columns kVec (cg + 16 n)
#pragma unroll 2
    for (int j = 0; j < kBQ; j += 4) {
      float4 pv[kRows], sv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        pv[i] = *reinterpret_cast<const float4*>(ps + (rg + 16 * i) * kPLd + j);
        sv[i] = *reinterpret_cast<const float4*>(dss + (rg + 16 * i) * kPLd + j);
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* drow = dos + (j + jj) * kLd;
        const float* qrow = qs + (j + jj) * kLd;
#pragma unroll
        for (int n = 0; n < kNV; ++n) {
          const int c0 = kVec * (cg + 16 * n);
#pragma unroll
          for (int e = 0; e < kVec; ++e) {
            const float dv_ = drow[c0 + e];
            const float qv = qrow[c0 + e];
#pragma unroll
            for (int i = 0; i < kRows; ++i) {
              const float p = jj == 0 ? pv[i].x : jj == 1 ? pv[i].y
                              : jj == 2 ? pv[i].z : pv[i].w;
              const float g = jj == 0 ? sv[i].x : jj == 1 ? sv[i].y
                              : jj == 2 ? sv[i].z : sv[i].w;
              av[i][n * kVec + e] = fmaf(p, dv_, av[i][n * kVec + e]);
              ak[i][n * kVec + e] = fmaf(g, qv, ak[i][n * kVec + e]);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = k0 + rg + 16 * i;
    if (row >= sk) continue;
    float* krow = dk + b * sdk_.b + hk * sdk_.h + (long long)row * sdk_.s;
    float* vrow = dv + b * sdv_.b + hk * sdv_.h + (long long)row * sdv_.s;
#pragma unroll
    for (int n = 0; n < kNV; ++n)
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        krow[kVec * (cg + 16 * n) + e] = ak[i][n * kVec + e] * scale;
        vrow[kVec * (cg + 16 * n) + e] = av[i][n * kVec + e];
      }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
fa_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ dvec, float* __restrict__ dq,
                 Strides sq_, Strides sk_, Strides sv_, Strides sdo_,
                 Strides sdq_, int hq, int group, int sq, int sk, int causal,
                 float scale) {
  constexpr int kLd = D + 4;
  constexpr int kPLd = kBK + 4;
  constexpr int kNC = D / 16;
  constexpr int kVec = kNC < 4 ? kNC : 4;
  constexpr int kNV = kNC / kVec;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* dos = qs + kBQ * kLd;
  float* ks = dos + kBQ * kLd;
  float* vs = ks + kBK * kLd;
  float* dss = vs + kBK * kLd;      // dS (q rows, key columns)

  const int tid = threadIdx.x;
  const int rg = tid >> 4;
  const int cg = tid & 15;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / group;
  const int offset = sk - sq;
  const long long bh = (long long)b * hq + h;

  int n_tiles = (sk + kBK - 1) / kBK;
  if (causal) {
    const int last = min(q0 + kBQ, sq) - 1 + offset;
    n_tiles = last < 0 ? 0 : min(n_tiles, last / kBK + 1);
  }
  stage<float, D>(qs, q + b * sq_.b + h * sq_.h, sq_.s, q0, sq);
  stage<float, D>(dos, dout + b * sdo_.b + h * sdo_.h, sdo_.s, q0, sq);
  float lr[kRows], dr_[kRows], acc[kRows][kNC];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + rg + 16 * i;
    lr[i] = row < sq ? lse[bh * sq + row] : 0.f;
    dr_[i] = row < sq ? dvec[bh * sq + row] : 0.f;
#pragma unroll
    for (int c = 0; c < kNC; ++c) acc[i][c] = 0.f;
  }
  const float* kb = k + b * sk_.b + hk * sk_.h;
  const float* vb = v + b * sv_.b + hk * sv_.h;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();
    stage<float, D>(ks, kb, sk_.s, k0, sk);
    stage<float, D>(vs, vb, sv_.s, k0, sk);
    __syncthreads();

    float s[kRows][kCols], dp[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      float4 qr[kRows], dr[kRows], kr[kCols], vr[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        qr[i] = *reinterpret_cast<const float4*>(qs + (rg + 16 * i) * kLd + d);
        dr[i] = *reinterpret_cast<const float4*>(dos + (rg + 16 * i) * kLd + d);
      }
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        kr[j] = *reinterpret_cast<const float4*>(ks + (cg + 16 * j) * kLd + d);
        vr[j] = *reinterpret_cast<const float4*>(vs + (cg + 16 * j) * kLd + d);
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          s[i][j] = fmaf(qr[i].x, kr[j].x, s[i][j]);
          s[i][j] = fmaf(qr[i].y, kr[j].y, s[i][j]);
          s[i][j] = fmaf(qr[i].z, kr[j].z, s[i][j]);
          s[i][j] = fmaf(qr[i].w, kr[j].w, s[i][j]);
          dp[i][j] = fmaf(dr[i].x, vr[j].x, dp[i][j]);
          dp[i][j] = fmaf(dr[i].y, vr[j].y, dp[i][j]);
          dp[i][j] = fmaf(dr[i].z, vr[j].z, dp[i][j]);
          dp[i][j] = fmaf(dr[i].w, vr[j].w, dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int qi = q0 + rg + 16 * i;
        const int kj = k0 + cg + 16 * j;
        const bool ok = kj < sk && qi < sq && (!causal || kj <= qi + offset);
        const float p = ok ? expf(s[i][j] * scale - lr[i]) : 0.f;
        dss[(rg + 16 * i) * kPLd + cg + 16 * j] = p * (dp[i][j] - dr_[i]);
      }
    __syncthreads();

    // dQ += dS K: q rows rg + 16 i, columns kVec (cg + 16 n)
#pragma unroll 2
    for (int j = 0; j < kBK; j += 4) {
      float4 sv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        sv[i] = *reinterpret_cast<const float4*>(dss + (rg + 16 * i) * kPLd + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* krow = ks + (j + jj) * kLd;
#pragma unroll
        for (int n = 0; n < kNV; ++n) {
          const int c0 = kVec * (cg + 16 * n);
#pragma unroll
          for (int e = 0; e < kVec; ++e) {
            const float kv_ = krow[c0 + e];
#pragma unroll
            for (int i = 0; i < kRows; ++i) {
              const float g = jj == 0 ? sv[i].x : jj == 1 ? sv[i].y
                              : jj == 2 ? sv[i].z : sv[i].w;
              acc[i][n * kVec + e] = fmaf(g, kv_, acc[i][n * kVec + e]);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + rg + 16 * i;
    if (row >= sq) continue;
    float* qrow = dq + b * sdq_.b + h * sdq_.h + (long long)row * sdq_.s;
#pragma unroll
    for (int n = 0; n < kNV; ++n)
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        qrow[kVec * (cg + 16 * n) + e] = acc[i][n * kVec + e] * scale;
  }
}

template <int D>
int launch_bwd_f32(const float* q, const float* k, const float* v,
                   const float* dout, const float* lse, const float* dvec,
                   float* dq, float* dk, float* dv, const Strides* st, int b,
                   int hq, int hkv, int sq, int sk, int causal, float scale,
                   cudaStream_t stream, cudaEvent_t* ev) {
  constexpr int kLd = D + 4;
  const size_t smem_kv = ((size_t)4 * 64 * kLd + 2 * 64 * (64 + 4) + 2 * 64) *
                         sizeof(float);
  const size_t smem_q = ((size_t)4 * 64 * kLd + 64 * (64 + 4)) * sizeof(float);
  auto kkv = fa_bwd_dkdv_kernel<D>;
  auto kq = fa_bwd_dq_kernel<D>;
  cudaError_t e = cudaFuncSetAttribute(
      kkv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_kv);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(kq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem_q);
  if (e != cudaSuccess) return (int)e;
  // st: q, k, v, o, dO, dQ, dK, dV
  kkv<<<dim3((sk + kBK - 1) / kBK, hkv, b), kThreads, smem_kv, stream>>>(
      q, k, v, dout, lse, dvec, dk, dv, st[0], st[1], st[2], st[4], st[6],
      st[7], hq, hq / hkv, sq, sk, causal, scale);
  if (ev) {
    cudaEventRecord(ev[2], stream);
    cudaEventRecord(ev[3], stream);
  }
  kq<<<dim3((sq + kBQ - 1) / kBQ, hq, b), kThreads, smem_q, stream>>>(
      q, k, v, dout, lse, dvec, dq, st[0], st[1], st[2], st[4], st[5], hq,
      hq / hkv, sq, sk, causal, scale);
  if (ev) cudaEventRecord(ev[4], stream);
  return 0;
}

// ---------------------------------------------------------------- bf16, mma
namespace tc {

constexpr float kLog2e = 1.4426950408889634f;

// L in log2 units; a row with no key (L = -inf) gets +inf so that P = 0
__device__ __forceinline__ float lse_log2(float l) {
  return l == -INFINITY ? INFINITY : l * kLog2e;
}

// dQ: 4 warps, 16 q rows a warp, 64-key tiles double-buffered with
// cp.async. Q and dO stay in shared memory and are read as A fragments;
// S = Q K^T and dP = dO V^T read K and V as B fragments (ldmatrix); dS is
// rounded to bf16 in registers and is the A operand of dQ += dS K, which
// reads K transposed (ldmatrix.trans), as the forward reads V.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
fa_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v,
                     const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ dvec, bf16* __restrict__ dq,
                     Strides sq_, Strides sk_, Strides sv_, Strides sdo_,
                     Strides sdq_, int group, int sq, int sk, int causal,
                     float scale, float scale_log2) {
  constexpr int kTile = kBK * D;
  constexpr int kKD = D / 16;
  constexpr int kNO = D / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);   // K, 2 stages
  bf16* vs = ks + 2 * kTile;                       // V, 2 stages
  bf16* qs = vs + 2 * kTile;
  bf16* dos = qs + kTile;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int h = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;   // heaviest causal tiles first
  const int b = blockIdx.z;
  const int hk = h / group;
  const int q0 = qt * kBQ;
  const int offset = sk - sq;
  const long long bh = (long long)b * gridDim.x + h;
  const bf16* kb = k + b * sk_.b + hk * sk_.h;
  const bf16* vb = v + b * sv_.b + hk * sv_.h;

  int n_tiles = (sk + kBK - 1) / kBK;
  if (causal) {
    const int last = min(q0 + kBQ, sq) - 1 + offset;
    n_tiles = last < 0 ? 0 : min(n_tiles, last / kBK + 1);
  }
  load_tile<D>(qs, q + b * sq_.b + h * sq_.h, sq_.s, q0, sq);
  load_tile<D>(dos, dout + b * sdo_.b + h * sdo_.h, sdo_.s, q0, sq);
  if (n_tiles > 0) {
    load_tile<D>(ks, kb, sk_.s, 0, sk);
    load_tile<D>(vs, vb, sv_.s, 0, sk);
  }
  cp_async_commit();

  const int row_g = q0 + 16 * warp + (lane >> 2);
  const int col_i = 2 * (lane & 3);
  const int diag = q0 + 16 * warp + offset;
  float l2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_g + 8 * r;
    l2[r] = row < sq ? lse_log2(lse[bh * sq + row]) : 0.f;
    dl[r] = row < sq ? dvec[bh * sq + row] : 0.f;
  }
  float acc[kNO][4];
#pragma unroll
  for (int n = 0; n < kNO; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    cp_async_wait<0>();
    __syncthreads();   // tile t has landed; every warp is done with t - 1
    if (t + 1 < n_tiles) {
      load_tile<D>(ks + ((t + 1) & 1) * kTile, kb, sk_.s, k0 + kBK, sk);
      load_tile<D>(vs + ((t + 1) & 1) * kTile, vb, sv_.s, k0 + kBK, sk);
    }
    cp_async_commit();
    const bf16* kt = ks + (t & 1) * kTile;
    const bf16* vt = vs + (t & 1) * kTile;

    float s[kBK / 8][4], dp[kBK / 8][4];
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKD; ++kk) {
      uint32_t qa[4], da[4];
      ldsm_x4(qa, qs + swz<D>(16 * warp + (lane & 15), 2 * kk + (lane >> 4)));
      ldsm_x4(da, dos + swz<D>(16 * warp + (lane & 15), 2 * kk + (lane >> 4)));
#pragma unroll
      for (int np = 0; np < kBK / 16; ++np) {
        const int off = swz<D>(16 * np + (lane & 7) + ((lane >> 4) << 3),
                               2 * kk + ((lane >> 3) & 1));
        uint32_t bk[4], bv[4];
        ldsm_x4(bk, kt + off);
        ldsm_x4(bv, vt + off);
        mma(s[2 * np], qa, bk[0], bk[1]);
        mma(s[2 * np + 1], qa, bk[2], bk[3]);
        mma(dp[2 * np], da, bv[0], bv[1]);
        mma(dp[2 * np + 1], da, bv[2], bv[3]);
      }
    }
    const bool edge = k0 + kBK > sk || (causal && k0 + kBK - 1 > diag);
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float p = exp2f(fmaf(s[n][e], scale_log2, -l2[r]));
        if (edge) {
          const int kj = k0 + 8 * n + col_i + (e & 1);
          const int qi = row_g + 8 * r + offset;
          if (kj >= sk || (causal && kj > qi)) p = 0.f;
        }
        s[n][e] = p * (dp[n][e] - dl[r]);   // dS
      }

    // dQ += dS K
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t bk[4];
        ldsm_x4_t(bk, kt + swz<D>(16 * kk + (lane & 7) + (((lane >> 3) & 1) << 3),
                                  2 * np + (lane >> 4)));
        mma(acc[2 * np], pa, bk[0], bk[1]);
        mma(acc[2 * np + 1], pa, bk[2], bk[3]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_g + 8 * r;
    if (row >= sq) continue;
    bf16* orow = dq + b * sdq_.b + h * sdq_.h + (long long)row * sdq_.s + col_i;
#pragma unroll
    for (int n = 0; n < kNO; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n) = __floats2bfloat162_rn(
          acc[n][2 * r] * scale, acc[n][2 * r + 1] * scale);
  }
}

// dK / dV: 8 warps over one 64-key tile, 16 keys a warp in two groups.
// Warps 0-3 compute S^T = K Q^T, P^T = exp(S^T scale - L), hand P^T (fp32)
// to warps 4-7 through shared memory and accumulate dV += P^T dO; warps 4-7
// compute dP^T = V dO^T, dS^T = P^T o (dP^T - Dv) and accumulate
// dK += dS^T Q. K (group 0) or V (group 1) is held as A fragments for the
// whole kernel; Q, dO, L and Dv tiles are double-buffered (cp.async for Q
// and dO), walking the group's q heads and the allowed q tiles.
constexpr int kWarpsKV = 8;
constexpr int kThreadsKV = 32 * kWarpsKV;

template <int D>
__global__ void __launch_bounds__(kThreadsKV, 1)
fa_bwd_dkdv_mma_kernel(const bf16* __restrict__ q,
                       const bf16* __restrict__ k,
                       const bf16* __restrict__ v,
                       const bf16* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ dvec,
                       bf16* __restrict__ dk, bf16* __restrict__ dv,
                       Strides sq_, Strides sk_, Strides sv_, Strides sdo_,
                       Strides sdk_, Strides sdv_, int hq, int group, int sq,
                       int sk, int causal, float scale, float scale_log2) {
  constexpr int kTile = kBK * D;
  constexpr int kKD = D / 16;
  constexpr int kNO = D / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + kTile;
  bf16* qs = vs + kTile;        // 2 stages
  bf16* dos = qs + 2 * kTile;   // 2 stages
  float* pbuf = reinterpret_cast<float*>(dos + 2 * kTile);   // 4 x 32 x 32
  float* ls = pbuf + 4 * 32 * 32;   // 2 stages of 64 L (log2 units)
  float* dl = ls + 2 * kBQ;         // 2 stages of 64 Dv

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int grp = warp >> 2;   // 0: S^T, P^T, dV; 1: dP^T, dS^T, dK
  const int wk = warp & 3;
  const int hk = blockIdx.x % (hq / group);
  const int b = blockIdx.x / (hq / group);
  const int k0 = blockIdx.y * kBK;   // key tile 0 is a causal grid's heaviest
  const int offset = sk - sq;

  const int qt0 = first_q_tile(k0, offset, causal, kBQ);
  const int nqt = max(0, (sq + kBQ - 1) / kBQ - qt0);
  const int n_it = group * nqt;

  auto load_q = [&](int it, int st) {
    const int h = hk * group + it / nqt;
    const int q0 = (qt0 + it % nqt) * kBQ;
    load_tile<D, kThreadsKV>(qs + st * kTile, q + b * sq_.b + h * sq_.h,
                             sq_.s, q0, sq);
    load_tile<D, kThreadsKV>(dos + st * kTile,
                             dout + b * sdo_.b + h * sdo_.h, sdo_.s, q0, sq);
    if (tid < kBQ) {
      const long long bh = (long long)b * hq + h;
      const bool ok = q0 + tid < sq;
      ls[st * kBQ + tid] = ok ? lse_log2(lse[bh * sq + q0 + tid]) : 0.f;
      dl[st * kBQ + tid] = ok ? dvec[bh * sq + q0 + tid] : 0.f;
    }
  };

  load_tile<D, kThreadsKV>(ks, k + b * sk_.b + hk * sk_.h, sk_.s, k0, sk);
  load_tile<D, kThreadsKV>(vs, v + b * sv_.b + hk * sv_.h, sv_.s, k0, sk);
  if (n_it > 0) load_q(0, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // this warp's 16 keys of K (group 0) or V (group 1) as A fragments
  uint32_t af[kKD][4];
  const bf16* asrc = grp ? vs : ks;
#pragma unroll
  for (int kk = 0; kk < kKD; ++kk)
    ldsm_x4(af[kk], asrc + swz<D>(16 * wk + (lane & 15), 2 * kk + (lane >> 4)));

  float acc[kNO][4];
#pragma unroll
  for (int n = 0; n < kNO; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const int key_g = k0 + 16 * wk + (lane >> 2);
  const int col_i = 2 * (lane & 3);
  float4* pw = reinterpret_cast<float4*>(pbuf) + wk * 8 * 32 + lane;

  for (int it = 0; it < n_it; ++it) {
    const int st = it & 1;
    if (it > 0) {
      cp_async_wait<0>();
      __syncthreads();   // tile it has landed; tile it - 1 is done with
    }
    if (it + 1 < n_it) load_q(it + 1, st ^ 1);
    cp_async_commit();
    const int q0 = (qt0 + it % nqt) * kBQ;
    const bf16* bq = qs + st * kTile;
    const bf16* bdo = dos + st * kTile;
    const float* lt = ls + st * kBQ;
    const float* dt_ = dl + st * kBQ;

    // group 0: S^T = K Q^T; group 1: dP^T = V dO^T (16 keys x 64 queries)
    float x[kBQ / 8][4];
#pragma unroll
    for (int n = 0; n < kBQ / 8; ++n) x[n][0] = x[n][1] = x[n][2] = x[n][3] = 0.f;
    const bf16* bsrc = grp ? bdo : bq;
#pragma unroll
    for (int kk = 0; kk < kKD; ++kk) {
#pragma unroll
      for (int np = 0; np < kBQ / 16; ++np) {
        uint32_t bb[4];
        ldsm_x4(bb, bsrc + swz<D>(16 * np + (lane & 7) + ((lane >> 4) << 3),
                                  2 * kk + ((lane >> 3) & 1)));
        mma(x[2 * np], af[kk], bb[0], bb[1]);
        mma(x[2 * np + 1], af[kk], bb[2], bb[3]);
      }
    }

    if (grp == 0) {
      const bool edge = q0 + kBQ > sq || k0 + kBK > sk ||
                        (causal && k0 + 16 * wk + 15 > q0 + offset);
#pragma unroll
      for (int n = 0; n < kBQ / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * n + col_i + (e & 1);
          float p = exp2f(fmaf(x[n][e], scale_log2, -lt[c]));
          if (edge) {
            const int qi = q0 + c;
            const int kj = key_g + 8 * (e >> 1);
            if (qi >= sq || kj >= sk || (causal && kj > qi + offset)) p = 0.f;
          }
          x[n][e] = p;
        }
        pw[n * 32] = make_float4(x[n][0], x[n][1], x[n][2], x[n][3]);
      }
    }
    __syncthreads();   // P^T is in pbuf

    const bf16* bsrc2 = grp ? bq : bdo;   // B of dK += dS^T Q / dV += P^T dO
    if (grp == 1) {
#pragma unroll
      for (int n = 0; n < kBQ / 8; ++n) {
        const float4 p = pw[n * 32];
        const int c = 8 * n + col_i;
        x[n][0] = p.x * (x[n][0] - dt_[c]);
        x[n][1] = p.y * (x[n][1] - dt_[c + 1]);
        x[n][2] = p.z * (x[n][2] - dt_[c]);
        x[n][3] = p.w * (x[n][3] - dt_[c + 1]);
      }
    }
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(x[2 * kk][0], x[2 * kk][1]),
                              pack_bf16(x[2 * kk][2], x[2 * kk][3]),
                              pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]),
                              pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t bb[4];
        ldsm_x4_t(bb, bsrc2 + swz<D>(16 * kk + (lane & 7) +
                                         (((lane >> 3) & 1) << 3),
                                     2 * np + (lane >> 4)));
        mma(acc[2 * np], pa, bb[0], bb[1]);
        mma(acc[2 * np + 1], pa, bb[2], bb[3]);
      }
    }
  }
  cp_async_wait<0>();

  const float mul = grp ? scale : 1.f;
  bf16* base = grp ? dk + b * sdk_.b + hk * sdk_.h : dv + b * sdv_.b + hk * sdv_.h;
  const long long rs = grp ? sdk_.s : sdv_.s;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = key_g + 8 * r;
    if (row >= sk) continue;
    bf16* orow = base + (long long)row * rs + col_i;
#pragma unroll
    for (int n = 0; n < kNO; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n) = __floats2bfloat162_rn(
          acc[n][2 * r] * mul, acc[n][2 * r + 1] * mul);
  }
}

template <int D>
int launch_bwd(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
               const float* lse, const float* dvec, bf16* dq, bf16* dk,
               bf16* dv, const Strides* st, int b, int hq, int hkv, int sq,
               int sk, int causal, float scale, cudaStream_t stream,
               cudaEvent_t* ev) {
  const size_t tile = (size_t)kBK * D * sizeof(bf16);
  const size_t smem_kv = 6 * tile + (4 * 32 * 32 + 4 * kBQ) * sizeof(float);
  const size_t smem_q = 6 * tile;
  auto kkv = fa_bwd_dkdv_mma_kernel<D>;
  auto kq = fa_bwd_dq_mma_kernel<D>;
  cudaError_t e = cudaFuncSetAttribute(
      kkv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_kv);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(kq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem_q);
  if (e != cudaSuccess) return (int)e;
  const float sl2 = scale * kLog2e;
  kkv<<<dim3(b * hkv, (sk + kBK - 1) / kBK), kThreadsKV, smem_kv, stream>>>(
      q, k, v, dout, lse, dvec, dk, dv, st[0], st[1], st[2], st[4], st[6],
      st[7], hq, hq / hkv, sq, sk, causal, scale, sl2);
  if (ev) {
    cudaEventRecord(ev[2], stream);
    cudaEventRecord(ev[3], stream);
  }
  kq<<<dim3(hq, (sq + kBQ - 1) / kBQ, b), kThreads, smem_q, stream>>>(
      q, k, v, dout, lse, dvec, dq, st[0], st[1], st[2], st[4], st[5],
      hq / hkv, sq, sk, causal, scale, sl2);
  if (ev) cudaEventRecord(ev[4], stream);
  return 0;
}

}  // namespace tc

// ---------------------------------------------------- bf16, wgmma (D 64, 128)
//
// Three kernels:
//   prep   one warp a row: L2 = L * log2(e) (+inf for a row with no key and
//          for the padding rows up to a 128-row multiple) and Dv =
//          rowsum(dO o O) (0 on padding), two (B * Hq, Sqp) fp32 planes
//          that the other two kernels load by 16-byte bulk copies or plain
//          loads with no edge checks;
//   dK/dV  one CTA per (batch, kv head, 128-key block, split part): two
//          consumer warpgroups own 64 keys each, K and V resident in shared
//          memory; a producer warpgroup (one thread issues; setmaxnreg
//          gives its registers to the consumers, 240 a thread, so that the
//          two 64 x D fp32 accumulators and the S^T and dP^T tiles stay in
//          registers) keeps TMA loads of the group's Q and dO tiles (64
//          rows) with their L2 and Dv in a 2-stage mbarrier ring. A
//          consumer computes S^T = K Q^T and dP^T = V dO^T with wgmma (both
//          operands from shared memory), forms P^T and dS^T in registers and
//          runs dV += P^T dO and dK += dS^T Q with wgmma, A from registers
//          and B (dO, Q) read MN-major from the same tiles: no handoff
//          through shared memory between warpgroups. The group's q heads
//          and q tiles are walked in a fixed order. Key block 0 of a causal
//          grid has 16x the last one's work, and qwen2.5-14b's 8 kv heads x
//          16 key blocks are 128 CTAs on 132 SMs: when the grid is short of
//          1.5 waves each block's walk is cut in two halves summed into
//          fp32 partials, which a combine kernel adds in order, so that the
//          longest CTA halves and every SM gets work. Key blocks are
//          launched heaviest first;
//   dQ     one CTA per (batch, q head, 128-row block), heaviest first: two
//          consumer warpgroups own 64 rows each with Q and dO resident; the
//          producer warp streams 64-key K and V tiles through a 2-stage
//          ring; S and dP are recomputed (wgmma) and dQ += dS K runs with dS
//          from registers and K read MN-major.
// Tiles sit in shared memory as 64-column halves of 128-byte rows in TMA's
// 128-byte swizzle, the layout wgmma's descriptors read directly. The
// rounding points are the mma.sync kernels': P to bf16 before dV, dS to
// bf16 before its products, fp32 accumulation, bf16 outputs.
namespace hop {

using tc::bf16;
using tc::lse_log2;
using tc::pack_bf16;
using tc::smem_u32;

constexpr int kWG = 128;                          // threads of a warpgroup
constexpr int kConsumers = 2;                     // consumer warpgroups
constexpr int kThreads = kConsumers * kWG + 32;   // and one producer warp
// dK / dV: a whole producer warpgroup, so that setmaxnreg can hand its
// registers to the consumers (240 each: two 64 x D fp32 accumulators and
// the S^T and dP^T tiles)
constexpr int kThreadsKV = (kConsumers + 1) * kWG;
constexpr int kRows = 64;                         // wgmma M; a streamed tile
constexpr int kBlock = kConsumers * kRows;        // keys / rows of a CTA
constexpr int kStages = 2;                        // depth of the tile ring
constexpr int kMaxSplit = 2;

// d (64 x 64, fp32) (+)= A (64 x 16, K-major) * B (64 x 16, K-major), both
// in shared memory.
__device__ __forceinline__ void wgmma_ss64(float (&d)[32], uint64_t a,
                                           uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64, fp32) (+)= A (64 x 16, bf16 fragments in registers) *
// B (16 x 64, MN-major in shared memory).
__device__ __forceinline__ void wgmma_rs64(float (&d)[32],
                                           const uint32_t (&a)[4], uint64_t b,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// d (64 x 128, fp32) (+)= A (64 x 16, bf16 fragments in registers) *
// B (16 x 128, MN-major in shared memory).
__device__ __forceinline__ void wgmma_rs128(float (&d)[64],
                                            const uint32_t (&a)[4], uint64_t b,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, "
      "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "
      "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b) {
  if constexpr (N == 64) wgmma_rs64(d, a, b, 1);
  else wgmma_rs128(d, a, b, 1);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Pins an accumulator's registers at this point of the program, so that no
// read or write of them moves across a wgmma fence or wait.
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle.
__device__ __forceinline__ uint64_t make_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | 1ull << 62;
}
// A tile of R rows x D columns is D / 64 halves of R rows x 64 columns.
// K-major operand (64 rows from r0, the 16 columns of k step kk): rows 128
// bytes apart, 8-row groups 1024 bytes apart, the k step an offset inside
// the swizzled row.
template <int R>
__device__ __forceinline__ uint64_t desc_k(const bf16* t, int r0, int kk) {
  return make_desc(t + (kk >> 2) * R * 64 + r0 * 64 + (kk & 3) * 16, 16,
                   1024);
}
// MN-major operand: rows 16 kk .. 16 kk + 15 of the tile are the k
// dimension, its D columns the n dimension (64 columns a half, halves R *
// 128 bytes apart; 8-row groups 1024 bytes apart).
template <int R>
__device__ __forceinline__ uint64_t desc_mn(const bf16* t, int kk) {
  return make_desc(t + 16 * kk * 64, R * 128, 1024);
}

__device__ __forceinline__ void bar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(b)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void bar_wait(uint64_t* b, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT%=;\n"
      "}\n" ::"r"(smem_u32(b)),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void bar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(b))
               : "memory");
}
__device__ __forceinline__ void bar_expect(uint64_t* b, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(b)),
               "r"(bytes)
               : "memory");
}

// TMA load of one 64-column half of R rows of a (B, H, S, D) tensor;
// rows past S arrive as zeros.
__device__ __forceinline__ void tma_half(void* dst, const CUtensorMap* map,
                                         int col, int row, int h, int b,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(h),
      "r"(b), "r"(smem_u32(bar))
      : "memory");
}
template <int D, int R>
__device__ __forceinline__ void tma_tile(bf16* dst, const CUtensorMap* map,
                                         int row, int h, int b,
                                         uint64_t* bar) {
#pragma unroll
  for (int hf = 0; hf < D / 64; ++hf)
    tma_half(dst + hf * R * 64, map, 64 * hf, row, h, b, bar);
}
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The CTA's dynamic shared memory, rounded up to the 1024 bytes the
// 128-byte swizzle repeats on.
__device__ __forceinline__ unsigned char* smem_base() {
  extern __shared__ __align__(1024) unsigned char hop_smem[];
  return hop_smem + ((1024 - (smem_u32(hop_smem) & 1023)) & 1023);
}

// L2 and Dv planes (see above): one warp a padded row, 8-byte loads, a
// fixed shuffle tree.
__global__ void __launch_bounds__(256)
prep_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
            const float* __restrict__ lse, float* __restrict__ ldv,
            Strides so_, Strides sdo_, int hq, int sq, int sqp, int d,
            long long rows) {
  const long long row = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int i = (int)(row % sqp);
  const long long bh = row / sqp;
  const int h = (int)(bh % hq);
  const int b = (int)(bh / hq);
  float acc = 0.f;
  if (i < sq) {
    const bf16* orow = o + b * so_.b + h * so_.h + (long long)i * so_.s;
    const bf16* drow = dout + b * sdo_.b + h * sdo_.h + (long long)i * sdo_.s;
    for (int c = 4 * lane; c < d; c += 128) {
      const uint2 xo = *reinterpret_cast<const uint2*>(orow + c);
      const uint2 xd = *reinterpret_cast<const uint2*>(drow + c);
      const float2 o0 = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&xo.x));
      const float2 o1 = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&xo.y));
      const float2 d0 = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&xd.x));
      const float2 d1 = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&xd.y));
      acc = fmaf(d0.x, o0.x, acc);
      acc = fmaf(d0.y, o0.y, acc);
      acc = fmaf(d1.x, o1.x, acc);
      acc = fmaf(d1.y, o1.y, acc);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    ldv[row] = i < sq ? lse_log2(lse[bh * sq + i]) : INFINITY;
    ldv[rows + row] = acc;
  }
}

// Shared memory of the dK / dV kernel (bytes): K and V of the block
// resident, the Q / dO ring, the L2 / Dv ring, the barriers.
template <int D>
struct KvLayout {
  static constexpr int kKV = kBlock * D * 2;
  static constexpr int kTile = kRows * D * 2;
  static constexpr int k = 0, v = kKV, q = 2 * kKV;
  static constexpr int dout = q + kStages * kTile;
  static constexpr int l = dout + kStages * kTile;   // [2][kStages][kRows]
  static constexpr int bars = l + 2 * kStages * kRows * 4;
  static constexpr int bytes = bars + (2 * kStages + 1) * 8;
};

// Writes a warpgroup's 64 x D accumulator (rows r0 + 16 warp + g + 8 e1,
// columns 8 j + ci + e0) times mul: bf16 through strides, or fp32 to a
// dense (rows, D) plane.
template <int D>
__device__ __forceinline__ void store_acc(const float (&acc)[D / 2], int r0,
                                          int n_rows, float mul, bf16* out,
                                          long long rs, float* plane) {
  const int lane = threadIdx.x & 31;
  const int r = r0 + 16 * ((threadIdx.x % kWG) >> 5) + (lane >> 2);
  const int ci = 2 * (lane & 3);
#pragma unroll
  for (int e1 = 0; e1 < 2; ++e1) {
    const int row = r + 8 * e1;
    if (row >= n_rows) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const float x = acc[4 * j + 2 * e1] * mul;
      const float y = acc[4 * j + 2 * e1 + 1] * mul;
      if (plane != nullptr)
        *reinterpret_cast<float2*>(plane + (long long)row * D + 8 * j + ci) =
            make_float2(x, y);
      else
        *reinterpret_cast<__nv_bfloat162*>(out + row * rs + 8 * j + ci) =
            __floats2bfloat162_rn(x, y);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreadsKV, 1)
dkdv_kernel(const __grid_constant__ CUtensorMap tm_q,
            const __grid_constant__ CUtensorMap tm_k,
            const __grid_constant__ CUtensorMap tm_v,
            const __grid_constant__ CUtensorMap tm_do,
            const float* __restrict__ ldv, float* __restrict__ part,
            bf16* __restrict__ dk, bf16* __restrict__ dv, Strides sdk_,
            Strides sdv_, int bsz, int hq, int hkv, int sq, int sk, int sqp,
            int causal, int n_split, float scale, float sl2) {
  using L = KvLayout<D>;
  constexpr int kTileE = kRows * D;   // elements of a ring tile
  unsigned char* sm = smem_base();
  bf16* ks = reinterpret_cast<bf16*>(sm + L::k);
  bf16* vs = reinterpret_cast<bf16*>(sm + L::v);
  bf16* qs = reinterpret_cast<bf16*>(sm + L::q);
  bf16* dos = reinterpret_cast<bf16*>(sm + L::dout);
  float* ls = reinterpret_cast<float*>(sm + L::l);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::bars);
  uint64_t* empty = full + kStages;
  uint64_t* kvb = empty + kStages;

  const int group = hq / hkv;
  const int split = blockIdx.x % n_split;
  const int hk = (blockIdx.x / n_split) % hkv;
  const int b = blockIdx.x / n_split / hkv;
  const int k0 = blockIdx.y * kBlock;   // block 0: a causal grid's heaviest
  const int offset = sk - sq;
  const int qt0 = causal ? max(0, k0 - offset) / kRows : 0;
  const int nqt = max(0, (sq + kRows - 1) / kRows - qt0);
  const int n_all = group * nqt;
  const int per = (n_all + n_split - 1) / n_split;
  const int it0 = min(n_all, split * per);
  const int it1 = min(n_all, it0 + per);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], kConsumers * 4);   // one arrival a consumer warp
    }
    bar_init(kvb, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers * kWG) {   // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == kConsumers * kWG) {
      bar_expect(kvb, 2 * L::kKV);
      tma_tile<D, kBlock>(ks, &tm_k, k0, hk, b, kvb);
      tma_tile<D, kBlock>(vs, &tm_v, k0, hk, b, kvb);
      for (int it = it0; it < it1; ++it) {
        const int n = it - it0, s = n % kStages;
        bar_wait(&empty[s], ((n / kStages) & 1) ^ 1);
        const int h = hk * group + it / nqt;
        const int q0 = (qt0 + it % nqt) * kRows;
        bar_expect(&full[s], 2 * L::kTile + 2 * kRows * 4);
        tma_tile<D, kRows>(qs + s * kTileE, &tm_q, q0, h, b, &full[s]);
        tma_tile<D, kRows>(dos + s * kTileE, &tm_do, q0, h, b, &full[s]);
        const float* src = ldv + ((long long)b * hq + h) * sqp + q0;
        bulk_load(ls + s * kRows, src, kRows * 4, &full[s]);
        bulk_load(ls + (kStages + s) * kRows, src + (long long)bsz * hq * sqp,
                  kRows * 4, &full[s]);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int wg = threadIdx.x / kWG;
  const int warp = (threadIdx.x % kWG) >> 5;
  const int lane = threadIdx.x & 31;
  const int ci = 2 * (lane & 3);
  const int kw0 = k0 + kRows * wg;                   // the warpgroup's keys
  const int key_r = kw0 + 16 * warp + (lane >> 2);   // and key_r + 8
  float adv[D / 2], adk[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) adv[i] = adk[i] = 0.f;
  bar_wait(kvb, 0);

  for (int it = it0; it < it1; ++it) {
    const int n = it - it0, s = n % kStages;
    const int q0 = (qt0 + it % nqt) * kRows;
    bar_wait(&full[s], (n / kStages) & 1);
    if (kw0 < sk && (!causal || kw0 <= q0 + kRows - 1 + offset)) {
      const bf16* qt = qs + s * kTileE;
      const bf16* dt = dos + s * kTileE;
      const float* lt = ls + s * kRows;
      const float* dvt = ls + (kStages + s) * kRows;
      float st[32], dp[32];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss64(st, desc_k<kBlock>(ks, kRows * wg, kk),
                   desc_k<kRows>(qt, 0, kk), kk > 0);
      wg_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss64(dp, desc_k<kBlock>(vs, kRows * wg, kk),
                   desc_k<kRows>(dt, 0, kk), kk > 0);
      wg_commit();
      wg_wait<1>();
      pin(st);
      // P^T: keys key_r + 8 e1 (rows), queries q0 + 8 j + ci + e0 (columns)
      const bool edge = causal && kw0 + kRows - 1 > q0 + offset;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + ci + (e & 1);
          float p = exp2f(fmaf(st[4 * j + e], sl2, -lt[c]));
          if (edge && key_r + 8 * (e >> 1) > q0 + c + offset) p = 0.f;
          st[4 * j + e] = p;
        }
      wg_wait<0>();
      pin(dp);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[4 * j + e] =
              st[4 * j + e] * (dp[4 * j + e] - dvt[8 * j + ci + (e & 1)]);
      // P^T and dS^T rounded to bf16 as the A fragments of the k steps
      uint32_t pa[4][4], sa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          pa[kk][r] = pack_bf16(st[8 * kk + 2 * r], st[8 * kk + 2 * r + 1]);
          sa[kk][r] = pack_bf16(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1]);
        }
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<D>(adv, pa[kk], desc_mn<kRows>(dt, kk));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<D>(adk, sa[kk], desc_mn<kRows>(qt, kk));
      wg_commit();
      wg_wait<0>();
      pin(adv);
      pin(adk);
    }
    __syncwarp();
    if (lane == 0) bar_arrive(&empty[s]);
  }

  if (part != nullptr) {   // fp32 partials [2][n_split][B][Hkv][Sk][D]
    const long long plane = (long long)bsz * hkv * sk * D;
    float* pk = part + split * plane + ((long long)b * hkv + hk) * sk * D;
    store_acc<D>(adk, kw0, sk, 1.f, nullptr, 0, pk);
    store_acc<D>(adv, kw0, sk, 1.f, nullptr, 0, pk + n_split * plane);
  } else {
    store_acc<D>(adk, kw0, sk, scale, dk + b * sdk_.b + hk * sdk_.h, sdk_.s,
                 nullptr);
    store_acc<D>(adv, kw0, sk, 1.f, dv + b * sdv_.b + hk * sdv_.h, sdv_.s,
                 nullptr);
  }
}

// dK = scale * (sum of the parts), dV = sum of the parts, in part order.
__global__ void __launch_bounds__(256)
combine_kernel(const float* __restrict__ part, bf16* __restrict__ dk,
               bf16* __restrict__ dv, Strides sdk_, Strides sdv_, int hkv,
               int sk, int d, int n_split, long long plane, float scale) {
  const long long e = 2 * ((long long)blockIdx.x * blockDim.x + threadIdx.x);
  if (e >= plane) return;
  const int col = (int)(e % d);
  const long long r = e / d;
  const int row = (int)(r % sk);
  const long long bh = r / sk;
  const int hk = (int)(bh % hkv);
  const int b = (int)(bh / hkv);
  float2 sk2 = make_float2(0.f, 0.f), sv2 = make_float2(0.f, 0.f);
  for (int s = 0; s < n_split; ++s) {
    const float2 x = *reinterpret_cast<const float2*>(part + s * plane + e);
    const float2 y = *reinterpret_cast<const float2*>(
        part + (n_split + s) * plane + e);
    sk2.x += x.x; sk2.y += x.y;
    sv2.x += y.x; sv2.y += y.y;
  }
  *reinterpret_cast<__nv_bfloat162*>(dk + b * sdk_.b + hk * sdk_.h +
                                     row * sdk_.s + col) =
      __floats2bfloat162_rn(sk2.x * scale, sk2.y * scale);
  *reinterpret_cast<__nv_bfloat162*>(dv + b * sdv_.b + hk * sdv_.h +
                                     row * sdv_.s + col) =
      __floats2bfloat162_rn(sv2.x, sv2.y);
}

// Shared memory of the dQ kernel (bytes): Q and dO of the block resident,
// the K / V ring, the barriers.
template <int D>
struct QLayout {
  static constexpr int kQ = kBlock * D * 2;
  static constexpr int kTile = kRows * D * 2;
  static constexpr int q = 0, dout = kQ, k = 2 * kQ;
  static constexpr int v = k + kStages * kTile;
  static constexpr int bars = v + kStages * kTile;
  static constexpr int bytes = bars + (2 * kStages + 1) * 8;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
dq_kernel(const __grid_constant__ CUtensorMap tm_q,
          const __grid_constant__ CUtensorMap tm_k,
          const __grid_constant__ CUtensorMap tm_v,
          const __grid_constant__ CUtensorMap tm_do,
          const float* __restrict__ ldv, bf16* __restrict__ dq, Strides sdq_,
          int bsz, int hq, int hkv, int sq, int sk, int sqp, int causal,
          float scale, float sl2) {
  using L = QLayout<D>;
  constexpr int kTileE = kRows * D;
  unsigned char* sm = smem_base();
  bf16* qs = reinterpret_cast<bf16*>(sm + L::q);
  bf16* dos = reinterpret_cast<bf16*>(sm + L::dout);
  bf16* ks = reinterpret_cast<bf16*>(sm + L::k);
  bf16* vs = reinterpret_cast<bf16*>(sm + L::v);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::bars);
  uint64_t* empty = full + kStages;
  uint64_t* qb = empty + kStages;

  const int h = blockIdx.x % hq;
  const int b = blockIdx.x / hq;
  const int hk = h / (hq / hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlock;   // heaviest first
  const int offset = sk - sq;
  const int n_kt = (sk + kRows - 1) / kRows;
  // key tiles up to the diagonal of the last real row of [r0, r0 + rows)
  auto tiles = [&](int r0, int rows) {
    if (r0 >= sq) return 0;
    if (!causal) return n_kt;
    const int last = min(r0 + rows, sq) - 1 + offset;
    return last < 0 ? 0 : min(n_kt, last / kRows + 1);
  };
  const int n_tiles = tiles(q0, kBlock);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], kConsumers * 4);
    }
    bar_init(qb, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers * kWG) {
    if (threadIdx.x == kConsumers * kWG) {
      bar_expect(qb, 2 * L::kQ);
      tma_tile<D, kBlock>(qs, &tm_q, q0, h, b, qb);
      tma_tile<D, kBlock>(dos, &tm_do, q0, h, b, qb);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        bar_wait(&empty[s], ((t / kStages) & 1) ^ 1);
        bar_expect(&full[s], 2 * L::kTile);
        tma_tile<D, kRows>(ks + s * kTileE, &tm_k, t * kRows, hk, b, &full[s]);
        tma_tile<D, kRows>(vs + s * kTileE, &tm_v, t * kRows, hk, b, &full[s]);
      }
    }
    return;
  }

  const int wg = threadIdx.x / kWG;
  const int warp = (threadIdx.x % kWG) >> 5;
  const int lane = threadIdx.x & 31;
  const int ci = 2 * (lane & 3);
  const int qw0 = q0 + kRows * wg;
  const int row_r = qw0 + 16 * warp + (lane >> 2);   // and row_r + 8
  const int my_tiles = tiles(qw0, kRows);
  const long long bh = (long long)b * hq + h;
  float l2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {   // padded planes: no edge check
    l2[r] = ldv[bh * sqp + row_r + 8 * r];
    dl[r] = ldv[(long long)bsz * hq * sqp + bh * sqp + row_r + 8 * r];
  }
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  bar_wait(qb, 0);

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    bar_wait(&full[s], (t / kStages) & 1);
    if (t < my_tiles) {
      const int k0 = t * kRows;
      const bf16* kt = ks + s * kTileE;
      const bf16* vt = vs + s * kTileE;
      float st[32], dp[32];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss64(st, desc_k<kBlock>(qs, kRows * wg, kk),
                   desc_k<kRows>(kt, 0, kk), kk > 0);
      wg_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss64(dp, desc_k<kBlock>(dos, kRows * wg, kk),
                   desc_k<kRows>(vt, 0, kk), kk > 0);
      wg_commit();
      wg_wait<1>();
      pin(st);
      // P: rows row_r + 8 e1, keys k0 + 8 j + ci + e0
      const bool edge =
          k0 + kRows > sk || (causal && k0 + kRows - 1 > qw0 + offset);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2f(fmaf(st[4 * j + e], sl2, -l2[e >> 1]));
          if (edge) {
            const int kj = k0 + 8 * j + ci + (e & 1);
            if (kj >= sk || (causal && kj > row_r + 8 * (e >> 1) + offset))
              p = 0.f;
          }
          st[4 * j + e] = p;
        }
      wg_wait<0>();
      pin(dp);
      uint32_t sa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i0 = 8 * kk + 2 * r;   // rows: r & 1 picks row_r + 8
          const float d0 = dl[r & 1];
          sa[kk][r] = pack_bf16(st[i0] * (dp[i0] - d0),
                                st[i0 + 1] * (dp[i0 + 1] - d0));
        }
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<D>(acc, sa[kk], desc_mn<kRows>(kt, kk));
      wg_commit();
      wg_wait<0>();
      pin(acc);
    }
    __syncwarp();
    if (lane == 0) bar_arrive(&empty[s]);
  }
  store_acc<D>(acc, qw0, sq, scale, dq + b * sdq_.b + h * sdq_.h, sdq_.s,
               nullptr);
}

using EncodeFn = PFN_cuTensorMapEncodeTiled_v12000;

EncodeFn encoder() {
  static EncodeFn fn = nullptr;
  if (!fn) {
    cudaDriverEntryPointQueryResult found;
    void* p = nullptr;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeFn>(p);
  }
  return fn;
}

// A TMA map of a (B, H, S, D) bf16 tensor by its element strides, boxes of
// 64 columns x `rows` rows in the 128-byte swizzle; the stride of a
// length-1 axis (never stepped) is replaced by a valid one.
bool make_map(CUtensorMap* map, const void* base, int bsz, int h, int s, int d,
              Strides st, int rows) {
  const EncodeFn encode = encoder();
  if (!encode) return false;
  cuuint64_t strides[3] = {(cuuint64_t)st.s * 2, (cuuint64_t)st.h * 2,
                           (cuuint64_t)st.b * 2};
  if (s == 1) strides[0] = (cuuint64_t)d * 2;
  if (h == 1) strides[1] = strides[0] * s;
  if (bsz == 1) strides[2] = strides[1] * h;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)s, (cuuint64_t)h,
                              (cuuint64_t)bsz};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t steps[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, steps,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Rows of the L2 / Dv planes a (batch, q head) takes: Sq up to the dQ
// kernel's 128-row blocks.
int padded_rows(int sq) { return (sq + kBlock - 1) / kBlock * kBlock; }

// Parts the dK / dV walk of a key block is cut into: 2 when the grid is
// short of 1.5 waves of the card's SMs.
int n_split(int bsz, int hkv, int sk) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long ctas = (long long)bsz * hkv * ((sk + kBlock - 1) / kBlock);
  return 2 * ctas < 3LL * sms ? kMaxSplit : 1;
}

// Floats of scratch: the L2 / Dv planes, then the split's fp32 partials.
long long scratch_floats(int bsz, int hq, int hkv, int sq, int sk, int d) {
  const int ns = n_split(bsz, hkv, sk);
  return 2LL * bsz * hq * padded_rows(sq) +
         (ns > 1 ? 2LL * ns * bsz * hkv * sk * d : 0);
}

template <int D>
int launch_bwd(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
               const float* lse, const bf16* dout, bf16* dq, bf16* dk,
               bf16* dv, float* scratch, const Strides* st, int bsz, int hq,
               int hkv, int sq, int sk, int causal, float scale,
               cudaStream_t stream, cudaEvent_t* ev) {
  // st: q, k, v, o, dO, dQ, dK, dV
  const int sqp = padded_rows(sq);
  const long long rows = (long long)bsz * hq * sqp;
  CUtensorMap mq, mdo, mk, mv, mq2, mdo2, mk2, mv2;
  if (!make_map(&mq, q, bsz, hq, sq, D, st[0], kRows) ||
      !make_map(&mdo, dout, bsz, hq, sq, D, st[4], kRows) ||
      !make_map(&mk, k, bsz, hkv, sk, D, st[1], kBlock) ||
      !make_map(&mv, v, bsz, hkv, sk, D, st[2], kBlock) ||
      !make_map(&mq2, q, bsz, hq, sq, D, st[0], kBlock) ||
      !make_map(&mdo2, dout, bsz, hq, sq, D, st[4], kBlock) ||
      !make_map(&mk2, k, bsz, hkv, sk, D, st[1], kRows) ||
      !make_map(&mv2, v, bsz, hkv, sk, D, st[2], kRows))
    return (int)cudaErrorInvalidValue;
  const int ns = n_split(bsz, hkv, sk);
  float* part = ns > 1 ? scratch + 2 * rows : nullptr;
  const int smem_kv = KvLayout<D>::bytes + 1024;
  const int smem_q = QLayout<D>::bytes + 1024;
  cudaError_t e = cudaFuncSetAttribute(
      dkdv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_kv);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(
      dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_q);
  if (e != cudaSuccess) return (int)e;
  const float sl2 = scale * tc::kLog2e;
  if (ev) cudaEventRecord(ev[0], stream);
  prep_kernel<<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(
      o, dout, lse, scratch, st[3], st[4], hq, sq, sqp, D, rows);
  if (ev) cudaEventRecord(ev[1], stream);
  dkdv_kernel<D><<<dim3(bsz * hkv * ns, (sk + kBlock - 1) / kBlock),
                   kThreadsKV, smem_kv, stream>>>(
      mq, mk, mv, mdo, scratch, part, dk, dv, st[6], st[7], bsz, hq, hkv, sq,
      sk, sqp, causal, ns, scale, sl2);
  if (ev) cudaEventRecord(ev[2], stream);
  if (part != nullptr) {
    const long long plane = (long long)bsz * hkv * sk * D;
    combine_kernel<<<(unsigned)((plane / 2 + 255) / 256), 256, 0, stream>>>(
        part, dk, dv, st[6], st[7], hkv, sk, D, ns, plane, scale);
  }
  if (ev) cudaEventRecord(ev[3], stream);
  dq_kernel<D><<<dim3(bsz * hq, sqp / kBlock), kThreads, smem_q, stream>>>(
      mq2, mk2, mv2, mdo2, scratch, dq, st[5], bsz, hq, hkv, sq, sk, sqp,
      causal, scale, sl2);
  if (ev) cudaEventRecord(ev[4], stream);
  return 0;
}

}  // namespace hop

template <typename T>
int launch_d(int d, const void* q, const void* k, const void* v, void* out,
             float* lse, int b, int hq, int hkv, int sq, int sk,
             const long long* st, int causal, float scale,
             cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, out, lse, b, hq, hkv, sq, sk, st,
                                  causal, scale, stream);
    case 32: return launch<T, 32>(q, k, v, out, lse, b, hq, hkv, sq, sk, st,
                                  causal, scale, stream);
    case 64: return launch<T, 64>(q, k, v, out, lse, b, hq, hkv, sq, sk, st,
                                  causal, scale, stream);
    case 128: return launch<T, 128>(q, k, v, out, lse, b, hq, hkv, sq, sk,
                                    st, causal, scale, stream);
    default: return -1;
  }
}

int launch_bf16(int d, const void* q, const void* k, const void* v,
                void* out, float* lse, int b, int hq, int hkv, int sq,
                int sk, const long long* st, int causal, float scale,
                cudaStream_t stream) {
  switch (d) {
    case 16: return tc::launch<16>(q, k, v, out, lse, b, hq, hkv, sq, sk, st,
                                   causal, scale, stream);
    case 32: return tc::launch<32>(q, k, v, out, lse, b, hq, hkv, sq, sk, st,
                                   causal, scale, stream);
    case 64: return tc::launch<64>(q, k, v, out, lse, b, hq, hkv, sq, sk, st,
                                   causal, scale, stream);
    case 128: return tc::launch<128>(q, k, v, out, lse, b, hq, hkv, sq, sk,
                                     st, causal, scale, stream);
    default: return -1;
  }
}

template <typename T, int D>
int launch_bwd_d(const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, const float* dvec,
                 void* dq, void* dk, void* dv, const Strides* st, int b,
                 int hq, int hkv, int sq, int sk, int causal, float scale,
                 cudaStream_t stream, cudaEvent_t* ev) {
  if constexpr (sizeof(T) == 2) {
    if constexpr (D >= 64) {
      return -1;   // bf16 at D 64 / 128 runs the wgmma kernels
    } else {
      return tc::launch_bwd<D>(
          static_cast<const tc::bf16*>(q), static_cast<const tc::bf16*>(k),
          static_cast<const tc::bf16*>(v),
          static_cast<const tc::bf16*>(dout), lse, dvec,
          static_cast<tc::bf16*>(dq), static_cast<tc::bf16*>(dk),
          static_cast<tc::bf16*>(dv), st, b, hq, hkv, sq, sk, causal, scale,
          stream, ev);
    }
  } else {
    return launch_bwd_f32<D>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse,
        dvec, static_cast<float*>(dq), static_cast<float*>(dk),
        static_cast<float*>(dv), st, b, hq, hkv, sq, sk, causal, scale,
        stream, ev);
  }
}

// bf16 at D = 64 / 128 runs the wgmma kernels; fp32, and bf16 at D = 16
// and 32, the Dv pre-pass and the mma.sync / FMA kernels.
bool uses_wgmma(bool bf16_in, int d) { return bf16_in && d >= 64; }

template <typename T>
int launch_bwd_t(int d, const void* q, const void* k, const void* v,
                 const void* o, const float* lse, const void* dout, void* dq,
                 void* dk, void* dv, float* scratch, const Strides* st, int b,
                 int hq, int hkv, int sq, int sk, int causal, float scale,
                 cudaStream_t stream, cudaEvent_t* ev) {
  if (d != 16 && d != 32 && d != 64 && d != 128) return -1;
  constexpr bool kBf16 = sizeof(T) == 2;
  if (uses_wgmma(kBf16, d)) {
    using hop::bf16;
    auto c = [](const void* p) { return static_cast<const bf16*>(p); };
    auto m = [](void* p) { return static_cast<bf16*>(p); };
    if (d == 64)
      return hop::launch_bwd<64>(c(q), c(k), c(v), c(o), lse, c(dout), m(dq),
                                 m(dk), m(dv), scratch, st, b, hq, hkv, sq,
                                 sk, causal, scale, stream, ev);
    return hop::launch_bwd<128>(c(q), c(k), c(v), c(o), lse, c(dout), m(dq),
                                m(dk), m(dv), scratch, st, b, hq, hkv, sq, sk,
                                causal, scale, stream, ev);
  }
  const long long rows = (long long)b * hq * sq;
  if (ev) cudaEventRecord(ev[0], stream);
  fa_bwd_dot_kernel<T><<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), scratch, st[3],
      st[4], hq, sq, d, rows);
  if (ev) cudaEventRecord(ev[1], stream);
  switch (d) {
    case 16: return launch_bwd_d<T, 16>(q, k, v, dout, lse, scratch, dq, dk,
                                        dv, st, b, hq, hkv, sq, sk, causal,
                                        scale, stream, ev);
    case 32: return launch_bwd_d<T, 32>(q, k, v, dout, lse, scratch, dq, dk,
                                        dv, st, b, hq, hkv, sq, sk, causal,
                                        scale, stream, ev);
    case 64: return launch_bwd_d<T, 64>(q, k, v, dout, lse, scratch, dq, dk,
                                        dv, st, b, hq, hkv, sq, sk, causal,
                                        scale, stream, ev);
    default: return launch_bwd_d<T, 128>(q, k, v, dout, lse, scratch, dq, dk,
                                         dv, st, b, hq, hkv, sq, sk, causal,
                                         scale, stream, ev);
  }
}

}  // namespace

// q (B, Hq, Sq, D), k / v (B, Hkv, Sk, D), out (B, Hq, Sq, D), each given by
// its (batch, head, seq) element strides in st[3 * tensor + axis] with the
// last dim contiguous. is_bf16 selects bf16 (tensor cores; every pointer
// 16-byte aligned, every stride a multiple of 8) or fp32 for all four. lse,
// when not null, receives each row's log-sum-exp of the scaled scores
// (natural log, fp32, (B, Hq, Sq) contiguous; -inf for a row with no key).
// Returns cudaGetLastError(), or -1 for a head size it was not built for.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int is_bf16,
                                      int b, int hq, int hkv, int sq, int sk,
                                      int d, const long long* strides,
                                      int causal, float scale, float* lse,
                                      void* stream) {
  if (b == 0 || hq == 0 || sq == 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  const int rc =
      is_bf16 ? launch_bf16(d, q, k, v, out, lse, b, hq, hkv, sq, sk, strides,
                            causal, scale, s)
              : launch_d<float>(d, q, k, v, out, lse, b, hq, hkv, sq, sk,
                                strides, causal, scale, s);
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

// Floats of scratch flash_attention_bwd_launch needs for these shapes.
extern "C" long long flash_attention_bwd_scratch(int is_bf16, int b, int hq,
                                                 int hkv, int sq, int sk,
                                                 int d) {
  if (uses_wgmma(is_bf16 != 0, d))
    return hop::scratch_floats(b, hq, hkv, sq, sk, d);
  return (long long)b * hq * sq;
}

// The gradients of flash_attention_launch's output: q, k, v, o (the
// forward's output), dout (its gradient) and dq, dk, dv, each given by its
// (batch, head, seq) strides in st[3 * tensor + axis] in that order (last
// dim contiguous; bf16 tensors 16-byte aligned with strides multiples of
// 8); lse (B, Hq, Sq) fp32 from the forward; scratch holds
// flash_attention_bwd_scratch(...) floats. dk / dv sum the q heads of each
// kv head's group. Deterministic: no atomics, each gradient element is
// summed in a fixed order. events, when not null, holds 5 CUDA events that
// are recorded on the stream before the first kernel and after the Dv
// pre-pass, the dK / dV kernel, the combine kernel (after dK / dV again
// where there is none) and the dQ kernel. Returns cudaGetLastError(), or
// -1 for a head size it was not built for.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const float* lse, const void* dout, void* dq, void* dk, void* dv,
    float* scratch, int is_bf16, int b, int hq, int hkv, int sq, int sk,
    int d, const long long* strides, int causal, float scale, void* stream,
    void* const* events) {
  if (b == 0 || hq == 0 || sq == 0 || sk == 0)
    return (int)cudaGetLastError();
  Strides st[8];
  for (int i = 0; i < 8; ++i)
    st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const cudaStream_t s = (cudaStream_t)stream;
  cudaEvent_t* ev = events ? (cudaEvent_t*)events : nullptr;
  const int rc =
      is_bf16 ? launch_bwd_t<tc::bf16>(d, q, k, v, o, lse, dout, dq, dk, dv,
                                       scratch, st, b, hq, hkv, sq, sk,
                                       causal, scale, s, ev)
              : launch_bwd_t<float>(d, q, k, v, o, lse, dout, dq, dk, dv,
                                    scratch, st, b, hq, hkv, sq, sk, causal,
                                    scale, s, ev);
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
