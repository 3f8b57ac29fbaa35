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
// Both: rows and columns past Sq / Sk (the ragged edge) are masked in the
// kernel, for any Sq and Sk, causal with offset Sk - Sq; strided q / k / v /
// out (last dim contiguous), so the model's (B, S, H, D) activations are
// read and written without a transpose copy; one launch per call.
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
  else return r * D + ((c ^ ((r >> 1) & 3)) << 3);   // D = 32: 2 rows a line
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
// tile; rows past n_rows are zero-filled.
template <int D, int NT = kThreads>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long s_stride, int row0,
                                          int n_rows) {
  constexpr int kChunks = D / 8;
  static_assert(kBK * kChunks % NT == 0, "tile / thread split");
#pragma unroll
  for (int j = 0; j < kBK * kChunks / NT; ++j) {
    const int i = threadIdx.x + j * NT;
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
// FlashAttention-2's two-kernel backward, with no floating-point atomics so
// that every gradient is the same bits run to run. Given the forward's
// output O and its per-row log-sum-exp L (natural log, fp32):
//   pre-pass   Dv_i = sum_d dO_id O_id                      (B, Hq, Sq) fp32
//   dK / dV    one CTA per (batch, kv head, 64-key tile); it walks the
//              group's q heads and the q tiles the causal mask allows,
//              recomputes P = exp(S * scale - L) and accumulates
//              dV += P^T dO and dK += dS^T Q * scale, dS = P o (dO V^T - Dv)
//   dQ         one CTA per (batch, q head, 64-row q tile); it walks the key
//              tiles the forward read and accumulates dQ += dS K * scale.
// Each gradient element is summed by one thread in a fixed order, so the
// group's q heads sum into dK / dV inside one CTA. fp32 runs exact FMAs on
// the CUDA cores; bf16 runs every product on mma.sync (bf16 in, fp32
// accumulate), with P rounded to bf16 before dV = P^T dO as the forward
// rounds it before P V, and dS rounded to bf16 before its two products.
// There is no Pallas backward: the reference differentiates XLA's
// layers.blocked_attention. Work: 7 products of a (q tile x key tile x D)
// each per allowed tile pair (S and dP are computed in both kernels),
// against the 5 of a backward that accumulates dQ with atomics: 14 * D
// flops per allowed q-k pair. Measured on an H100 80GB HBM3 (700 W): 1.008
// ms for qwen2.5-14b's causal 2048^2 in bf16, against a 0.109 ms bound
// (10 * D flops a pair at the bf16 tensor rate) and 0.349 ms for
// scaled_dot_product_attention's backward (PERF.md).

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
                   cudaStream_t stream) {
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
  kq<<<dim3((sq + kBQ - 1) / kBQ, hq, b), kThreads, smem_q, stream>>>(
      q, k, v, dout, lse, dvec, dq, st[0], st[1], st[2], st[4], st[5], hq,
      hq / hkv, sq, sk, causal, scale);
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
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int k0 = blockIdx.x * kBK;
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
               int sk, int causal, float scale, cudaStream_t stream) {
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
  kkv<<<dim3((sk + kBK - 1) / kBK, hkv, b), kThreadsKV, smem_kv, stream>>>(
      q, k, v, dout, lse, dvec, dk, dv, st[0], st[1], st[2], st[4], st[6],
      st[7], hq, hq / hkv, sq, sk, causal, scale, sl2);
  kq<<<dim3(hq, (sq + kBQ - 1) / kBQ, b), kThreads, smem_q, stream>>>(
      q, k, v, dout, lse, dvec, dq, st[0], st[1], st[2], st[4], st[5],
      hq / hkv, sq, sk, causal, scale, sl2);
  return 0;
}

}  // namespace tc

template <typename T>
int launch_d(int d, const void* q, const void* k, const void* v, void* out,
             float* lse, int b, int hq, int hkv, int sq, int sk,
             const long long* st, int causal, float scale,
             cudaStream_t stream) {
  switch (d) {
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
                 cudaStream_t stream) {
  if constexpr (sizeof(T) == 2)
    return tc::launch_bwd<D>(
        static_cast<const tc::bf16*>(q), static_cast<const tc::bf16*>(k),
        static_cast<const tc::bf16*>(v), static_cast<const tc::bf16*>(dout),
        lse, dvec, static_cast<tc::bf16*>(dq), static_cast<tc::bf16*>(dk),
        static_cast<tc::bf16*>(dv), st, b, hq, hkv, sq, sk, causal, scale,
        stream);
  else
    return launch_bwd_f32<D>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse,
        dvec, static_cast<float*>(dq), static_cast<float*>(dk),
        static_cast<float*>(dv), st, b, hq, hkv, sq, sk, causal, scale,
        stream);
}

template <typename T>
int launch_bwd_t(int d, const void* q, const void* k, const void* v,
                 const void* o, const float* lse, const void* dout, void* dq,
                 void* dk, void* dv, float* dvec, const Strides* st, int b,
                 int hq, int hkv, int sq, int sk, int causal, float scale,
                 cudaStream_t stream) {
  if (d != 32 && d != 64 && d != 128) return -1;
  const long long rows = (long long)b * hq * sq;
  fa_bwd_dot_kernel<T><<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), dvec, st[3],
      st[4], hq, sq, d, rows);
  switch (d) {
    case 32: return launch_bwd_d<T, 32>(q, k, v, dout, lse, dvec, dq, dk, dv,
                                        st, b, hq, hkv, sq, sk, causal, scale,
                                        stream);
    case 64: return launch_bwd_d<T, 64>(q, k, v, dout, lse, dvec, dq, dk, dv,
                                        st, b, hq, hkv, sq, sk, causal, scale,
                                        stream);
    default: return launch_bwd_d<T, 128>(q, k, v, dout, lse, dvec, dq, dk,
                                         dv, st, b, hq, hkv, sq, sk, causal,
                                         scale, stream);
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

// The gradients of flash_attention_launch's output: q, k, v, o (the
// forward's output), dout (its gradient) and dq, dk, dv, each given by its
// (batch, head, seq) strides in st[3 * tensor + axis] in that order (last
// dim contiguous; bf16 tensors 16-byte aligned with strides multiples of
// 8); lse (B, Hq, Sq) fp32 from the forward; dvec (B, Hq, Sq) fp32 scratch.
// dk / dv sum the q heads of each kv head's group. Deterministic: no
// atomics, each gradient element is summed by one thread in a fixed order.
// Returns cudaGetLastError(), or -1 for a head size it was not built for.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const float* lse, const void* dout, void* dq, void* dk, void* dv,
    float* dvec, int is_bf16, int b, int hq, int hkv, int sq, int sk, int d,
    const long long* strides, int causal, float scale, void* stream) {
  if (b == 0 || hq == 0 || sq == 0 || sk == 0)
    return (int)cudaGetLastError();
  Strides st[8];
  for (int i = 0; i < 8; ++i)
    st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const cudaStream_t s = (cudaStream_t)stream;
  const int rc =
      is_bf16 ? launch_bwd_t<tc::bf16>(d, q, k, v, o, lse, dout, dq, dk, dv,
                                       dvec, st, b, hq, hkv, sq, sk, causal,
                                       scale, s)
              : launch_bwd_t<float>(d, q, k, v, o, lse, dout, dq, dk, dv,
                                    dvec, st, b, hq, hkv, sq, sk, causal,
                                    scale, s);
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
