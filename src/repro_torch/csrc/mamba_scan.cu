// Mamba1 selective scan from h0 = 0, the state kept on chip:
//   h_t = exp(dt_t * A) o h_{t-1} + xdt_t (x) B_t,   y_t = h_t . C_t
//
// Replaces: src/repro/kernels/mamba_scan.py:mamba_scan (the Pallas kernel
// that holds the (bd, N) state of a block of d_inner channels in VMEM and
// walks time with a sequential fori_loop, so only x.dt, dt, B, C, y and the
// final state touch HBM).
//
// What bounds it on the H100: the bytes. At falcon-mamba-7b's prefill shape
// (B = 1, S = 2048, Di = 8192, N = 16, fp32) it reads xdt and dt and writes
// y, 3 x 67 MB, plus the small A, B, C and h_final: ~0.06 ms at 3.35 TB/s,
// against ~2 G operations (0.03 ms at 67 T/s, one expf counted as one).
// The recurrence is sequential in time, so the parallelism is B * Di * N
// (131k lanes at that shape); each lane carries its h in a register.
//
// Design: one thread per (channel d, state n), NP = next power of two >= N
// lanes per channel inside one warp (lanes n >= N carry zeros), so
// y_t = sum_n h * C is a shuffle reduction over NP lanes. A CTA holds
// CH = 256 / NP channels (at most 64) of one batch row. Time goes in chunks
// of 32 steps: dt and xdt of the CTA's channels and B, C of the chunk are
// staged in shared memory with coalesced loads, y of the chunk is gathered
// in shared memory and written coalesced. Only dt * a is exponentiated,
// in fp32, as the model forms its decay (models/ssm.py). Inputs are fp32 or
// bf16 (one type for xdt, dt, B, C); A and h_final are fp32; y is in the
// input type.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kChunk = 32;
constexpr int kMaxCh = 64;
constexpr int kMaxN = 32;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(256)
mamba_scan_kernel(const T* __restrict__ xdt, const T* __restrict__ dt,
                  const float* __restrict__ a, const T* __restrict__ bm,
                  const T* __restrict__ cm, T* __restrict__ y,
                  float* __restrict__ h_out, int s, int di, int n, int np,
                  int ch) {
  __shared__ float dts[kChunk][kMaxCh];
  __shared__ float xs[kChunk][kMaxCh];
  __shared__ float ys[kChunk][kMaxCh];
  __shared__ float bs[kChunk][kMaxN];
  __shared__ float cs[kChunk][kMaxN];

  const int tid = threadIdx.x;
  const int c = tid / np;          // channel within the CTA
  const int lane_n = tid - c * np; // state index
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * ch;
  const int d = d0 + c;
  const bool live = d < di && lane_n < n;
  const float av = live ? a[(long long)d * n + lane_n] : 0.f;
  const long long row = (long long)b * s;   // first (b, t = 0) row
  float h = 0.f;

  for (int t0 = 0; t0 < s; t0 += kChunk) {
    const int len = min(kChunk, s - t0);
    for (int i = tid; i < kChunk * ch; i += blockDim.x) {
      const int t = i / ch;
      const int cc = i - t * ch;
      const bool in = t < len && d0 + cc < di;
      const long long g = (row + t0 + t) * di + d0 + cc;
      dts[t][cc] = in ? to_f(dt[g]) : 0.f;
      xs[t][cc] = in ? to_f(xdt[g]) : 0.f;
    }
    for (int i = tid; i < kChunk * n; i += blockDim.x) {
      const int t = i / n;
      const int nn = i - t * n;
      const long long g = (row + t0 + t) * n + nn;
      bs[t][nn] = t < len ? to_f(bm[g]) : 0.f;
      cs[t][nn] = t < len ? to_f(cm[g]) : 0.f;
    }
    __syncthreads();
    for (int t = 0; t < len; ++t) {
      float p = 0.f;
      if (live) {
        const float g = expf(dts[t][c] * av);
        h = g * h + xs[t][c] * bs[t][lane_n];
        p = h * cs[t][lane_n];
      }
      for (int o = np >> 1; o > 0; o >>= 1)
        p += __shfl_xor_sync(0xffffffffu, p, o);
      if (lane_n == 0) ys[t][c] = p;
    }
    __syncthreads();
    for (int i = tid; i < len * ch; i += blockDim.x) {
      const int t = i / ch;
      const int cc = i - t * ch;
      if (d0 + cc < di) from_f(y + (row + t0 + t) * di + d0 + cc, ys[t][cc]);
    }
    __syncthreads();  // ys, dts, xs, bs, cs are free for the next chunk
  }
  if (live) h_out[((long long)b * di + d) * n + lane_n] = h;
}

template <typename T>
void launch(const void* xdt, const void* dt, const float* a, const void* bm,
            const void* cm, void* y, float* h_out, int bsz, int s, int di,
            int n, cudaStream_t stream) {
  int np = 1;
  while (np < n) np <<= 1;
  const int ch = np >= 4 ? 256 / np : kMaxCh;
  dim3 grid((di + ch - 1) / ch, bsz);
  mamba_scan_kernel<T><<<grid, ch * np, 0, stream>>>(
      static_cast<const T*>(xdt), static_cast<const T*>(dt), a,
      static_cast<const T*>(bm), static_cast<const T*>(cm),
      static_cast<T*>(y), h_out, s, di, n, np, ch);
}

}  // namespace

// xdt / dt (B, S, Di), a (Di, N) fp32, b / c (B, S, N), all contiguous;
// is_bf16 selects bf16 (else fp32) for xdt, dt, b, c and y. Writes y
// (B, S, Di) and h_final (B, Di, N) fp32. N <= 32. Returns
// cudaGetLastError(), or -1 for N outside [1, 32].
extern "C" int mamba_scan_launch(const void* xdt, const void* dt,
                                 const float* a, const void* bm,
                                 const void* cm, void* y, float* h_out,
                                 int is_bf16, int bsz, int s, int di, int n,
                                 void* stream) {
  if (n < 1 || n > kMaxN) return -1;
  if (bsz == 0 || di == 0) return (int)cudaGetLastError();
  const cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    launch<__nv_bfloat16>(xdt, dt, a, bm, cm, y, h_out, bsz, s, di, n, st);
  else
    launch<float>(xdt, dt, a, bm, cm, y, h_out, bsz, s, di, n, st);
  return (int)cudaGetLastError();
}
