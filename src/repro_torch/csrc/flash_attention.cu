// Blocked causal GQA attention with an online softmax, fp32 arithmetic.
//
// Replaces: src/repro/kernels/flash_attention.py:flash_attention (the Pallas
// kernel that keeps a (bq x bk) score tile, the running max / sum and an
// fp32 accumulator in VMEM while KV tiles stream over the sequential grid
// axis, skipping KV tiles above the causal diagonal; query head h reads kv
// head h // group through its index map).
//
// What bounds it on the H100: 4 * B * Hq * D * (allowed q-k pairs) flops --
// 43 GFLOP for the causal 2048 x 2048 prefill of 40 heads at D = 128, which
// is 0.043 ms at the 989 TFLOP/s bf16 tensor-core rate, against ~0.02 ms
// for the 42 MB of q, k, v and output. This first version does every
// product with fp32 FMAs on the CUDA cores (67 TFLOP/s at best), so it sits
// well above that bound; tensor cores (mma.sync / wgmma on bf16 tiles) are
// later work. What the design does keep from the TPU kernel: scores and
// probabilities never leave the SM, K and V are read once per q tile and
// never expanded per q head, and tiles above the diagonal are never loaded.
//
// Design: one CTA of 256 threads per (batch, q head, 64-row q tile), looping
// over 64-row KV tiles. The q tile stays in shared memory; K and then V of a
// tile take turns in one shared buffer; P goes through shared memory between
// the two products. Thread (rg, cg) = (tid / 16, tid % 16) owns q rows
// rg + 16 i (i < 4) -- the same rows in S = Q K^T (key columns cg + 16 j)
// and in O += P V (D / 16 output columns) -- so the row max and row sum are
// reduced over the 16 lanes of a half warp with shuffles and every thread
// keeps its rows' m, l and accumulator in registers. Rows and columns past
// Sq / Sk (the ragged edge) are masked in the kernel, for any Sq and Sk.
// Strided q / k / v / out (last dim contiguous), so the model's
// (B, S, H, D) activations are read and written without a transpose copy.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

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
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

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

}  // namespace

// q (B, Hq, Sq, D), k / v (B, Hkv, Sk, D), out (B, Hq, Sq, D), each given by
// its (batch, head, seq) element strides in st[3 * tensor + axis] with the
// last dim contiguous. is_bf16 selects bf16 (else fp32) for all four.
// Returns cudaGetLastError(), or -1 for a head size it was not built for.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int is_bf16,
                                      int b, int hq, int hkv, int sq, int sk,
                                      int d, const long long* strides,
                                      int causal, float scale, void* stream) {
  if (b == 0 || hq == 0 || sq == 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  const int rc =
      is_bf16 ? launch_d<__nv_bfloat16>(d, q, k, v, out, b, hq, hkv, sq, sk,
                                        strides, causal, scale, s)
              : launch_d<float>(d, q, k, v, out, b, hq, hkv, sq, sk, strides,
                                causal, scale, s);
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
