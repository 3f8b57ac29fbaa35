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
                       Strides sq_, Strides sk_, Strides sv_, Strides so_,
                       int hq, int group, int sq, int sk, int causal,
                       float scale) {
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
    T* orow = ob + (long long)row * so_.s;
#pragma unroll
    for (int n = 0; n < kNV; ++n)
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        from_f(orow + kVec * (cg + 16 * n) + e, acc[i][n * kVec + e] * inv);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int hq, int hkv, int sq, int sk, const long long* st, int causal,
           float scale, cudaStream_t stream) {
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
      static_cast<const T*>(v), static_cast<T*>(out), s_q, s_k, s_v, s_o, hq,
      hq / hkv, sq, sk, causal, scale);
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
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long s_stride, int row0,
                                          int n_rows) {
  constexpr int kChunks = D / 8;
  static_assert(kBK * kChunks % kThreads == 0, "tile / thread split");
#pragma unroll
  for (int j = 0; j < kBK * kChunks / kThreads; ++j) {
    const int i = threadIdx.x + j * kThreads;
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
                           Strides sq_, Strides sk_, Strides sv_,
                           Strides so_, int group, int sq, int sk,
                           int causal, float scale_log2) {
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
    bf16* orow = ob + (long long)row * so_.s + col_i;
#pragma unroll
    for (int n = 0; n < kNO; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n) =
          __floats2bfloat162_rn(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int hq, int hkv, int sq, int sk, const long long* st, int causal,
           float scale, cudaStream_t stream) {
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
      static_cast<const bf16*>(v), static_cast<bf16*>(out), s_q, s_k, s_v,
      s_o, hq / hkv, sq, sk, causal, scale * 1.4426950408889634f);
  return 0;
}

}  // namespace tc

template <typename T>
int launch_d(int d, const void* q, const void* k, const void* v, void* out,
             int b, int hq, int hkv, int sq, int sk, const long long* st,
             int causal, float scale, cudaStream_t stream) {
  switch (d) {
    case 32: return launch<T, 32>(q, k, v, out, b, hq, hkv, sq, sk, st,
                                  causal, scale, stream);
    case 64: return launch<T, 64>(q, k, v, out, b, hq, hkv, sq, sk, st,
                                  causal, scale, stream);
    case 128: return launch<T, 128>(q, k, v, out, b, hq, hkv, sq, sk, st,
                                    causal, scale, stream);
    default: return -1;
  }
}

int launch_bf16(int d, const void* q, const void* k, const void* v,
                void* out, int b, int hq, int hkv, int sq, int sk,
                const long long* st, int causal, float scale,
                cudaStream_t stream) {
  switch (d) {
    case 32: return tc::launch<32>(q, k, v, out, b, hq, hkv, sq, sk, st,
                                   causal, scale, stream);
    case 64: return tc::launch<64>(q, k, v, out, b, hq, hkv, sq, sk, st,
                                   causal, scale, stream);
    case 128: return tc::launch<128>(q, k, v, out, b, hq, hkv, sq, sk, st,
                                     causal, scale, stream);
    default: return -1;
  }
}

}  // namespace

// q (B, Hq, Sq, D), k / v (B, Hkv, Sk, D), out (B, Hq, Sq, D), each given by
// its (batch, head, seq) element strides in st[3 * tensor + axis] with the
// last dim contiguous. is_bf16 selects bf16 (tensor cores; every pointer
// 16-byte aligned, every stride a multiple of 8) or fp32 for all four.
// Returns cudaGetLastError(), or -1 for a head size it was not built for.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int is_bf16,
                                      int b, int hq, int hkv, int sq, int sk,
                                      int d, const long long* strides,
                                      int causal, float scale, void* stream) {
  if (b == 0 || hq == 0 || sq == 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  const int rc =
      is_bf16 ? launch_bf16(d, q, k, v, out, b, hq, hkv, sq, sk, strides,
                            causal, scale, s)
              : launch_d<float>(d, q, k, v, out, b, hq, hkv, sq, sk, strides,
                                causal, scale, s);
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
