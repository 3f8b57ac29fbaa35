// Mamba1 selective scan from h0 = 0, the state kept on chip:
//   h_t = exp(dt_t * A) o h_{t-1} + xdt_t (x) B_t,   y_t = h_t . C_t
//
// Replaces: src/repro/kernels/mamba_scan.py:mamba_scan (the Pallas kernel
// that holds the (bd, N) state of a block of d_inner channels in VMEM and
// walks time with a sequential fori_loop, so only x.dt, dt, B, C, y and the
// final state touch HBM).
//
// What bounds it on the H100: the exponentials and the bytes. At
// falcon-mamba-7b's prefill shape (B = 1, S = 2048, Di = 8192, N = 16,
// fp32) it reads xdt and dt and writes y, 3 x 67 MB, plus the small A, B, C
// and h_final: ~0.060 ms at 3.35 TB/s. It takes B*S*Di*N = 268 M expf,
// each one MUFU.EX2 on the SFU, which issues 16 a clock an SM: ~0.064 ms at
// 132 SMs x 1.98 GHz; its ~2 G fp32 operations take ~0.03 ms at 67 T/s.
// The recurrence is sequential in time, so the parallelism is B * Di * N
// (131k (channel, state) pairs at that shape); h lives in registers.
//
// Design: a thread owns SPT = 4 states of one channel (LPC = N / 4 lanes a
// channel, 4 at N = 16) and a CTA 128 / LPC channels of one batch row. Time
// goes in chunks of 32 steps, double-buffered in shared memory with 16-byte
// cp.async (dt and xdt of the CTA's channels, B and C of the chunk): chunk
// k + 1 is in flight while chunk k is computed, behind one __syncthreads a
// chunk. A step reads dt and xdt (one broadcast word each) and the thread's
// 4 B and 4 C values (one 16-byte load each). The chunk loop has a
// compile-time length and is unrolled, so the exponentials, which do not
// depend on h, issue ahead of the FMA chain. y's reduction over the states
// is off that chain: each step leaves its partial sum of h * C over the
// thread's states in a register, and after the chunk the LPC lanes of a
// channel reduce all 32 steps at once by recursive halving (at LPC = 4, 16
// + 8 shuffles for 32 steps, where one shuffle tree a step took 4 x 32),
// after which each lane holds y of 32 / LPC steps and writes them.
// Only dt * a is exponentiated, in fp32, as the model forms its decay
// (models/ssm.py). Each state's arithmetic is the earlier one-lane-a-state
// kernel's, g = expf(dt * a), h = fma(g, h, xdt * b) rounded as written
// here, so h_final is bit-identical to it; y is summed in another order,
// p_n = h_n * c_n, ((p0 + p1) + p2) + p3 in a thread, then the halving
// tree across lanes. Inputs are fp32 or bf16 (one type for xdt, dt, B, C);
// A and h_final are fp32; y is in the input type. Rows that are not on
// 16-byte boundaries are staged with plain loads instead.
//
// What separates it from its bound (NVIDIA H100 80GB HBM3, 700 W): the
// prefill shape takes ~0.217 ms, 3.4x its 0.064 ms SFU bound. A step of 4
// states compiles to ~55 instructions (the libdevice expf alone is 8 a
// state, one of them the MUFU.EX2), so the issue floor is ~0.11 ms; the
// 8 warps an SM that B * Di * N / 4 threads give issue at ~0.55 a clock.
// Deeper cp.async pipelines, 16- or 64-step chunks, 2 states a thread,
// 64 or 256 threads a CTA and exponentials hoisted ahead of the recurrence
// in the source were each as fast or slower (PERF.md).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 32;     // time steps staged and reduced together
constexpr int kThreads = 128;
constexpr int kMaxN = 32;
constexpr int kSpt = 4;        // states a thread

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// V consecutive elements from shared memory, as fp32 (one load for fp32 V
// = 4, bf16 V = 4 or 2 where aligned).
template <int V>
__device__ __forceinline__ void load_vec(float (&v)[V], const float* p) {
  if constexpr (V == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else if constexpr (V == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x; v[1] = q.y;
  } else {
    v[0] = *p;
  }
}
template <int V>
__device__ __forceinline__ void load_vec(float (&v)[V],
                                         const __nv_bfloat16* p) {
  if constexpr (V == 4) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&q.x);
    const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&q.y);
    v[0] = __low2float(lo); v[1] = __high2float(lo);
    v[2] = __low2float(hi); v[3] = __high2float(hi);
  } else if constexpr (V == 2) {
    const __nv_bfloat162 q = *reinterpret_cast<const __nv_bfloat162*>(p);
    v[0] = __low2float(q); v[1] = __high2float(q);
  } else {
    v[0] = __bfloat162float(*p);
  }
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 16-byte copy of which the first `bytes` come from src, the rest zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Stage kChunk rows of ld elements: row t is src + t * src_ld, rows t >=
// len and columns >= valid are zeros. vec: 16-byte cp.async (ld * size,
// src_ld * size and src on 16-byte boundaries), else plain loads.
template <typename T>
__device__ __forceinline__ void stage(T* dst, int ld, const T* src,
                                      long long src_ld, int len, int valid,
                                      bool vec) {
  if (vec) {
    constexpr int E = 16 / sizeof(T);
    const int per_row = ld / E;
    for (int i = threadIdx.x; i < kChunk * per_row; i += blockDim.x) {
      const int t = i / per_row;
      const int k = (i - t * per_row) * E;
      const int n_el = t < len ? max(0, min(E, valid - k)) : 0;
      cp_async16(dst + t * ld + k, n_el > 0 ? src + t * src_ld + k : src,
                 n_el * (int)sizeof(T));
    }
  } else {
    for (int i = threadIdx.x; i < kChunk * ld; i += blockDim.x) {
      const int t = i / ld;
      const int k = i - t * ld;
      dst[i] = t < len && k < valid ? src[t * src_ld + k] : T{};
    }
  }
}

// One chunk's steps for the thread's SPT states: h updated in place and
// part[t] = sum over the states of h * c. Ragged: steps t >= len leave h
// and give part[t] = 0.
template <int SPT, int CH, int NP, bool kRagged, typename T>
__device__ __forceinline__ void steps(float (&h)[SPT], float (&part)[kChunk],
                                      const float (&av)[SPT], const T* dts,
                                      const T* xs, const T* bs, const T* cs,
                                      int c, int n0, int len) {
#pragma unroll
  for (int t = 0; t < kChunk; ++t) {
    if (kRagged && t >= len) {
      part[t] = 0.f;
      continue;
    }
    const float dtv = to_f(dts[t * CH + c]);
    const float xv = to_f(xs[t * CH + c]);
    float bv[SPT], cv[SPT];
    load_vec<SPT>(bv, bs + t * NP + n0);
    load_vec<SPT>(cv, cs + t * NP + n0);
    float p = 0.f;
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      const float g = expf(__fmul_rn(dtv, av[j]));
      h[j] = __fmaf_rn(g, h[j], __fmul_rn(xv, bv[j]));
      const float pj = __fmul_rn(h[j], cv[j]);
      p = j == 0 ? pj : __fadd_rn(p, pj);
    }
    part[t] = p;
  }
}

// y over the channel's lanes by recursive halving: at the level of offset
// O a lane keeps M of its steps (the upper ones if its bit O is set) and
// adds its partner's sums of them. Unrolled by the template, so part stays
// in registers.
template <int O, int M>
__device__ __forceinline__ void halve(float (&part)[kChunk], int q, int& tb) {
  if constexpr (O >= 1) {
    const bool up = (q & O) != 0;
#pragma unroll
    for (int i = 0; i < M; ++i) {
      const float send = up ? part[i] : part[i + M];
      const float keep = up ? part[i + M] : part[i];
      part[i] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, O));
    }
    if (up) tb += M;
    halve<O / 2, M / 2>(part, q, tb);
  }
}

template <typename T, int SPT, int LPC>
__global__ void __launch_bounds__(kThreads)
mamba_scan_kernel(const T* __restrict__ xdt, const T* __restrict__ dt,
                  const float* __restrict__ a, const T* __restrict__ bm,
                  const T* __restrict__ cm, T* __restrict__ y,
                  float* __restrict__ h_out, int s, int di, int n, int vec_d,
                  int vec_n) {
  constexpr int CH = kThreads / LPC;   // channels of the CTA
  constexpr int NP = SPT * LPC;        // states, padded
  constexpr int kD = kChunk * CH;
  constexpr int kN = kChunk * NP;
  constexpr int kBuf = 2 * kD + 2 * kN;
  constexpr int kOut = kChunk / LPC;   // steps of y a lane writes a chunk
  static_assert(kChunk % LPC == 0, "a chunk must split over the lanes");
  extern __shared__ float4 smem4[];
  T* const sm = reinterpret_cast<T*>(smem4);   // 2 x {dt, xdt, B, C}

  const int c = threadIdx.x / LPC;   // channel within the CTA
  const int q = threadIdx.x % LPC;   // lane within the channel
  const int n0 = q * SPT;            // first state of the thread
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * CH;
  const int d = d0 + c;
  const int valid_d = min(CH, di - d0);
  const long long row = (long long)b * s;   // first (b, t = 0) row
  float av[SPT], h[SPT];
#pragma unroll
  for (int j = 0; j < SPT; ++j) {
    av[j] = d < di && n0 + j < n ? a[(long long)d * n + n0 + j] : 0.f;
    h[j] = 0.f;
  }

  auto stage_chunk = [&](int t0, T* buf) {
    const int len = min(kChunk, s - t0);
    const long long gd = (row + t0) * di + d0;
    const long long gn = (row + t0) * n;
    stage(buf, CH, dt + gd, di, len, valid_d, vec_d);
    stage(buf + kD, CH, xdt + gd, di, len, valid_d, vec_d);
    stage(buf + 2 * kD, NP, bm + gn, n, len, n, vec_n);
    stage(buf + 2 * kD + kN, NP, cm + gn, n, len, n, vec_n);
  };

  if (s > 0) stage_chunk(0, sm);
  cp_async_commit();
  for (int t0 = 0, p = 0; t0 < s; t0 += kChunk, p ^= 1) {
    cp_async_wait_all();
    __syncthreads();   // chunk t0 has landed; the other buffer is free
    if (t0 + kChunk < s) stage_chunk(t0 + kChunk, sm + (p ^ 1) * kBuf);
    cp_async_commit();

    const T* buf = sm + p * kBuf;
    const int len = min(kChunk, s - t0);
    float part[kChunk];
    if (len == kChunk)
      steps<SPT, CH, NP, false>(h, part, av, buf, buf + kD, buf + 2 * kD,
                                buf + 2 * kD + kN, c, n0, len);
    else
      steps<SPT, CH, NP, true>(h, part, av, buf, buf + kD, buf + 2 * kD,
                               buf + 2 * kD + kN, c, n0, len);

    int tb = 0;   // first step this lane ends with
    halve<LPC / 2, kChunk / 2>(part, q, tb);
    if (d < di) {
#pragma unroll
      for (int i = 0; i < kOut; ++i)
        if (tb + i < len) from_f(y + (row + t0 + tb + i) * di + d, part[i]);
    }
  }
#pragma unroll
  for (int j = 0; j < SPT; ++j)
    if (d < di && n0 + j < n) h_out[((long long)b * di + d) * n + n0 + j] = h[j];
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T, int NP>
int launch(const void* xdt, const void* dt, const float* a, const void* bm,
           const void* cm, void* y, float* h_out, int bsz, int s, int di,
           int n, cudaStream_t stream) {
  constexpr int SPT = NP < kSpt ? NP : kSpt;
  constexpr int LPC = NP / SPT;
  constexpr int CH = kThreads / LPC;
  constexpr size_t esz = sizeof(T);
  const size_t smem = 2 * (2 * kChunk * CH + 2 * kChunk * NP) * esz;
  auto kernel = mamba_scan_kernel<T, SPT, LPC>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int vec_d = CH * esz % 16 == 0 && di * esz % 16 == 0 &&
                    aligned16(xdt) && aligned16(dt);
  const int vec_n = NP * esz % 16 == 0 && n * esz % 16 == 0 &&
                    aligned16(bm) && aligned16(cm);
  dim3 grid((di + CH - 1) / CH, bsz);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(xdt), static_cast<const T*>(dt), a,
      static_cast<const T*>(bm), static_cast<const T*>(cm),
      static_cast<T*>(y), h_out, s, di, n, vec_d, vec_n);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_n(const void* xdt, const void* dt, const float* a, const void* bm,
             const void* cm, void* y, float* h_out, int bsz, int s, int di,
             int n, cudaStream_t st) {
  if (n <= 1) return launch<T, 1>(xdt, dt, a, bm, cm, y, h_out, bsz, s, di, n, st);
  if (n <= 2) return launch<T, 2>(xdt, dt, a, bm, cm, y, h_out, bsz, s, di, n, st);
  if (n <= 4) return launch<T, 4>(xdt, dt, a, bm, cm, y, h_out, bsz, s, di, n, st);
  if (n <= 8) return launch<T, 8>(xdt, dt, a, bm, cm, y, h_out, bsz, s, di, n, st);
  if (n <= 16) return launch<T, 16>(xdt, dt, a, bm, cm, y, h_out, bsz, s, di, n, st);
  return launch<T, 32>(xdt, dt, a, bm, cm, y, h_out, bsz, s, di, n, st);
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
    return launch_n<__nv_bfloat16>(xdt, dt, a, bm, cm, y, h_out, bsz, s, di,
                                   n, st);
  return launch_n<float>(xdt, dt, a, bm, cm, y, h_out, bsz, s, di, n, st);
}
