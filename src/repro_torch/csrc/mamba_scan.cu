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

// V consecutive floats to shared memory (one 16-byte store at V = 4)
template <int V>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    p[0] = v[0];
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

template <typename T, int SPT, int LPC, bool kChunks>
__global__ void __launch_bounds__(kThreads)
mamba_scan_kernel(const T* __restrict__ xdt, const T* __restrict__ dt,
                  const float* __restrict__ a, const T* __restrict__ bm,
                  const T* __restrict__ cm, T* __restrict__ y,
                  float* __restrict__ h_out, float* __restrict__ h_chunks,
                  int s, int di, int n, int vec_d, int vec_n) {
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
    if (kChunks && d < di) {   // the state entering this chunk
      float* hc = h_chunks + (((long long)b * ((s + kChunk - 1) / kChunk) + t0 / kChunk) *
                                  di +
                              d) * n + n0;
#pragma unroll
      for (int j = 0; j < SPT; ++j)
        if (n0 + j < n) hc[j] = h[j];
    }
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

// ------------------------------------------------------------ backward
//
// The adjoint of the scan, lambda_t = dL/dh_t (h_final's gradient enters at
// the last step): walking time backwards,
//   lambda_t  += dy_t C_t
//   dxdt_t     = sum_n lambda_t B_t             (over the channel's states)
//   ddt_t      = sum_n lambda_t h_{t-1} g_t a   (g_t = exp(dt_t a))
//   da        += lambda_t h_{t-1} g_t dt_t      (over batch and time)
//   dB_t      += lambda_t xdt_t                 (over the channels)
//   dC_t      += dy_t h_t                       (over the channels)
//   lambda_{t-1} = g_t lambda_t
// There is no Pallas backward: the reference differentiates XLA's chunked
// ssm.mamba1_scan.
//
// What bounds it on the H100: at the training microbatch of
// falcon-mamba-7b, (2, 2048, 8192, 16) in fp32, the 740 MB of inputs,
// chunk states and outputs take 0.221 ms at 3.35 TB/s and the 537 M
// exponentials (one an element) 0.128 ms on the SFU; the ~20 fp32
// operations an element and the reductions over states and channels make
// it an issue-bound kernel on the SMs. Measured on an H100 80GB HBM3
// (700 W): 1.42 ms at that shape (the main kernel 1.385, the dB / dC sum
// 0.032, the da sum 0.007), 521 GB/s; what holds it there is issue: per
// step a thread of 2 states spends ~6 shuffles and ~8 shared-memory
// accesses beside its ~40 fp32 operations (PERF.md).
//
// Design. The forward kernel stores h at each 32-step chunk boundary
// (h_chunks, (B, ceil(S / 32), Di, N) fp32). A thread owns SPT = 2 states
// of one channel (LPC = N / 2 lanes a channel) and a CTA of 512 threads 64
// channels of one batch row (at N = 16), one CTA an SM. Chunks are taken in
// reverse, each as two 16-step halves. The chunk's 32 steps are recomputed
// from the stored state with the forward's exact arithmetic (expf,
// __fmul_rn, __fmaf_rn: the states are the forward's bits), h_t and
// g_t = exp(dt_t a) both kept: the first half's in shared memory (one
// 16-byte store a step a thread), the second half's in registers (64 of
// them). The adjoint walks the second half, then the first, and forms no
// exponential of its own. The chunk's dt, xdt, dy, B and C are staged with
// 16-byte cp.async into one of two buffers while the previous chunk
// computes, and the next chunk's stored state is loaded into registers
// ahead of its use. Each step reduces dxdt and ddt over the channel's
// lanes (a shuffle butterfly, one value each after log2(LPC) levels) and
// dB and dC over the warp's channels (halving 4 values to one a lane over
// the channel bits of the lane index), and leaves the warp's dB / dC in
// shared memory; once a half the CTA sums its 16 warps in order into
// per-CTA partials (B, Di / 64, S, N) and writes the half's dxdt and ddt
// rows coalesced. A second kernel sums the partials over the CTAs in order
// and da's per-batch-row partials over the batch: no floating-point
// atomics, so the gradients are the same bits run to run.
constexpr int kHalf = kChunk / 2;   // steps of a half chunk
constexpr int kBwdThreads = 512;    // threads of a backward CTA, at most
constexpr int kBwdChannels = 64;    // channels of a backward CTA (N <= 16)

// Sums the V values of v over the lanes that differ in lane-index bits O,
// O / 2, ..., LPC (the warp's channels), in a fixed butterfly: while more
// than one value is left each level halves them (a lane keeps the upper
// half if its bit O is set and adds its partner's sums of it), then plain
// butterfly levels. idx: the first value index the lane ends with; dup:
// the lane bits of the plain levels (lanes with any of them set hold a
// copy).
template <int O, int M, int LPC, int V>
__device__ __forceinline__ void chan_reduce(float (&v)[V], int lane, int& idx,
                                            int& dup) {
  if constexpr (O >= LPC && O >= 1) {
    if constexpr (M > 1) {
      const bool up = (lane & O) != 0;
#pragma unroll
      for (int i = 0; i < M / 2; ++i) {
        const float send = up ? v[i] : v[i + M / 2];
        const float keep = up ? v[i + M / 2] : v[i];
        v[i] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, O));
      }
      if (up) idx += M / 2;
      chan_reduce<O / 2, M / 2, LPC, V>(v, lane, idx, dup);
    } else {
      v[0] = __fadd_rn(v[0], __shfl_xor_sync(0xffffffffu, v[0], O));
      dup |= O;
      chan_reduce<O / 2, 1, LPC, V>(v, lane, idx, dup);
    }
  }
}

// The final value count of chan_reduce over the channel bits 16 .. LPC.
template <int LPC, int V>
__host__ __device__ constexpr int chan_left() {
  int m = V;
  for (int o = 16; o >= LPC && o >= 1; o /= 2)
    if (m > 1) m /= 2;
  return m;
}

// The backward's thread layout for NP padded states: SPT states a thread,
// LPC lanes a channel, NT threads and CH channels a CTA (64 channels, 16
// at N = 32, where a warp's reductions need twice the shared memory).
template <int NP>
struct BwdShape {
  static constexpr int SPT = NP < 2 ? NP : 2;
  static constexpr int LPC = NP / SPT;
  static constexpr int NT = LPC <= 8 ? kBwdChannels * LPC : 256;
  static constexpr int CH = NT / LPC;
};

template <typename T, int SPT, int LPC, int NT>
struct BwdLayout {
  static constexpr int CH = NT / LPC;       // channels of the CTA
  static constexpr int NP = SPT * LPC;      // states, padded
  static constexpr int NW = NT / 32;        // warps
  static constexpr int kD = kChunk * CH;    // a staged (step, channel) array
  static constexpr int kN = kChunk * NP;    // a staged (step, state) array
  static constexpr int kStage = 3 * kD + 2 * kN;       // dt, xdt, dy, B, C
  static constexpr int kHg = kHalf * NT * 2 * SPT;     // floats: h, g
  static constexpr int kRed = kHalf * NW * 2 * NP;     // floats: dB / dC
  static constexpr int kOut = 2 * kHalf * CH;          // floats: dxdt, ddt
  // bytes: the first half's h / g, the warps' dB / dC, dxdt / ddt (fp32),
  // then 2 x the staged inputs (T)
  static constexpr size_t bytes =
      (size_t)(kHg + kRed + kOut) * 4 + 2 * (size_t)kStage * sizeof(T);
};

// One step of the adjoint at row t of a half (t < kHalf): lam and dak carry
// over; the warp's dB / dC and the channel's dxdt / ddt go to red / out.
// ht, gt: h_t and g_t; hp: h_{t-1}.
template <typename T, int SPT, int LPC, int NT>
__device__ __forceinline__ void adjoint_step(
    int t, const T* dts, const T* xs, const T* dys, const T* bs,
    const T* cs, float* red, float* outx, float* outt,
    const float (&av)[SPT], const float (&ht)[SPT], const float (&gt)[SPT],
    const float (&hp)[SPT], float (&lam)[SPT], float (&dak)[SPT]) {
  using L = BwdLayout<T, SPT, LPC, NT>;
  constexpr int CH = L::CH, NP = L::NP;
  constexpr int V = 2 * SPT;
  constexpr int kLeft = chan_left<LPC, V>();
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int c = threadIdx.x / LPC;
  const int q = threadIdx.x % LPC;
  const int n0 = q * SPT;
  const float dtv = to_f(dts[t * CH + c]);
  const float xv = to_f(xs[t * CH + c]);
  const float dyv = to_f(dys[t * CH + c]);
  float bv[SPT], cv[SPT], v[V];
  load_vec<SPT>(bv, bs + t * NP + n0);
  load_vec<SPT>(cv, cs + t * NP + n0);
  float sx = 0.f, st = 0.f;
#pragma unroll
  for (int j = 0; j < SPT; ++j) {
    lam[j] = __fmaf_rn(dyv, cv[j], lam[j]);
    sx = __fmaf_rn(lam[j], bv[j], sx);
    const float dg = __fmul_rn(__fmul_rn(lam[j], hp[j]), gt[j]);
    st = __fmaf_rn(dg, av[j], st);
    dak[j] = __fmaf_rn(dg, dtv, dak[j]);
    v[j] = __fmul_rn(lam[j], xv);           // dB
    v[SPT + j] = __fmul_rn(dyv, ht[j]);     // dC
    lam[j] = __fmul_rn(gt[j], lam[j]);
  }
  // dxdt, ddt over the channel's lanes: the first level splits the two
  // (lanes with bit LPC / 2 set keep ddt), the rest add
  if constexpr (LPC > 1) {
    const bool up = (q & (LPC / 2)) != 0;
    float r = __fadd_rn(up ? st : sx,
                        __shfl_xor_sync(0xffffffffu, up ? sx : st, LPC / 2));
#pragma unroll
    for (int o = LPC / 4; o >= 1; o /= 2)
      r = __fadd_rn(r, __shfl_xor_sync(0xffffffffu, r, o));
    if (q == 0) outx[t * CH + c] = r;
    if (q == LPC / 2) outt[t * CH + c] = r;
  } else {
    outx[t * CH + c] = sx;
    outt[t * CH + c] = st;
  }
  // dB, dC over the warp's channels
  int idx = 0, dup = 0;
  chan_reduce<16, V, LPC, V>(v, lane, idx, dup);
  if ((lane & dup) == 0) {
#pragma unroll
    for (int i = 0; i < kLeft; ++i) {
      const int k = idx + i;   // value k: kind k / SPT, state n0 + k % SPT
      red[(t * L::NW + w) * 2 * NP + (k / SPT) * NP + n0 + k % SPT] = v[i];
    }
  }
}

// The first half of a chunk forward from its stored state hb: h_t, g_t of
// steps t < len to shared memory (hg[t][tid], h and g of each state), the
// state after them to hm.
template <typename T, int SPT, int LPC, int NT>
__device__ __forceinline__ void recompute_first(
    const T* dts, const T* xs, const T* bs, float* hg,
    const float (&av)[SPT], const float (&hb)[SPT], float (&hm)[SPT],
    int len) {
  using L = BwdLayout<T, SPT, LPC, NT>;
  const int c = threadIdx.x / LPC;
  const int n0 = (threadIdx.x % LPC) * SPT;
#pragma unroll
  for (int j = 0; j < SPT; ++j) hm[j] = hb[j];
#pragma unroll 4
  for (int t = 0; t < len; ++t) {
    const float dtv = to_f(dts[t * L::CH + c]);
    const float xv = to_f(xs[t * L::CH + c]);
    float bv[SPT], hgv[2 * SPT];
    load_vec<SPT>(bv, bs + t * L::NP + n0);
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      const float g = expf(__fmul_rn(dtv, av[j]));
      hm[j] = __fmaf_rn(g, hm[j], __fmul_rn(xv, bv[j]));
      hgv[2 * j] = hm[j];
      hgv[2 * j + 1] = g;
    }
    store_vec<2 * SPT>(hg + (t * NT + threadIdx.x) * 2 * SPT, hgv);
  }
}

// The adjoint of the first half (steps len - 1 .. 0) from its h, g in
// shared memory; h_{-1} is the chunk's stored state hb.
template <typename T, int SPT, int LPC, int NT>
__device__ __forceinline__ void adjoint_first(
    const T* dts, const T* xs, const T* dys, const T* bs, const T* cs,
    const float* hg, float* red, float* outx, float* outt,
    const float (&av)[SPT], const float (&hb)[SPT], float (&lam)[SPT],
    float (&dak)[SPT], int len) {
  float cur[2 * SPT];
  load_vec<2 * SPT>(cur, hg + ((len - 1) * NT + threadIdx.x) * 2 * SPT);
  for (int t = len - 1; t >= 0; --t) {
    float prev[2 * SPT] = {};
    if (t > 0) {
      load_vec<2 * SPT>(prev, hg + ((t - 1) * NT + threadIdx.x) * 2 * SPT);
    } else {
#pragma unroll
      for (int j = 0; j < SPT; ++j) prev[2 * j] = hb[j];
    }
    float ht[SPT], gt[SPT], hp[SPT];
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      ht[j] = cur[2 * j];
      gt[j] = cur[2 * j + 1];
      hp[j] = prev[2 * j];
    }
    adjoint_step<T, SPT, LPC, NT>(t, dts, xs, dys, bs, cs, red, outx, outt,
                                  av, ht, gt, hp, lam, dak);
#pragma unroll
    for (int i = 0; i < 2 * SPT; ++i) cur[i] = prev[i];
  }
}

// The second half: h_t, g_t of steps t < len recomputed from hm into
// registers, then the adjoint from t = len - 1 down to 0 (h_{-1} = hm).
template <bool kFull, typename T, int SPT, int LPC, int NT>
__device__ __forceinline__ void second_half(
    const T* dts, const T* xs, const T* dys, const T* bs, const T* cs,
    float* red, float* outx, float* outt, const float (&av)[SPT],
    const float (&hm)[SPT], float (&lam)[SPT], float (&dak)[SPT], int len) {
  using L = BwdLayout<T, SPT, LPC, NT>;
  const int c = threadIdx.x / LPC;
  const int n0 = (threadIdx.x % LPC) * SPT;
  float hh[kHalf][SPT], gg[kHalf][SPT];
  {
    float h[SPT];
#pragma unroll
    for (int j = 0; j < SPT; ++j) h[j] = hm[j];
#pragma unroll
    for (int t = 0; t < kHalf; ++t) {
      if (!kFull && t >= len) break;
      const float dtv = to_f(dts[t * L::CH + c]);
      const float xv = to_f(xs[t * L::CH + c]);
      float bv[SPT];
      load_vec<SPT>(bv, bs + t * L::NP + n0);
#pragma unroll
      for (int j = 0; j < SPT; ++j) {
        const float g = expf(__fmul_rn(dtv, av[j]));
        h[j] = __fmaf_rn(g, h[j], __fmul_rn(xv, bv[j]));
        hh[t][j] = h[j];
        gg[t][j] = g;
      }
    }
  }
#pragma unroll
  for (int t = kHalf - 1; t >= 0; --t) {
    if (!kFull && t >= len) continue;
    float ht[SPT], gt[SPT], hp[SPT];   // copies: the arrays stay registers
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      ht[j] = hh[t][j];
      gt[j] = gg[t][j];
      hp[j] = t > 0 ? hh[t > 0 ? t - 1 : 0][j] : hm[j];
    }
    adjoint_step<T, SPT, LPC, NT>(t, dts, xs, dys, bs, cs, red, outx, outt,
                                  av, ht, gt, hp, lam, dak);
  }
}

template <typename T, int SPT, int LPC, int NT>
__global__ void __launch_bounds__(NT, kBwdThreads / NT)
mamba_scan_bwd_kernel(const T* __restrict__ xdt, const T* __restrict__ dt,
                      const float* __restrict__ a, const T* __restrict__ bm,
                      const T* __restrict__ cm, const T* __restrict__ dy,
                      const float* __restrict__ dh_final,
                      const float* __restrict__ h_chunks,
                      T* __restrict__ dxdt, T* __restrict__ ddt,
                      float* __restrict__ da_part, float* __restrict__ db_part,
                      int s, int di, int n, int vec_d, int vec_n) {
  using L = BwdLayout<T, SPT, LPC, NT>;
  constexpr int CH = L::CH, NP = L::NP, NW = L::NW;
  extern __shared__ float4 smem4[];
  float* hg = reinterpret_cast<float*>(smem4);   // [kHalf][NT][2 SPT]
  float* red = hg + L::kHg;                      // [kHalf][NW][2][NP]
  float* outx = red + L::kRed;                   // [kHalf][CH]
  float* outt = outx + kHalf * CH;               // [kHalf][CH]
  T* stg0 = reinterpret_cast<T*>(outx + L::kOut);   // 2 x staged inputs

  const int tid = threadIdx.x;
  const int c = tid / LPC;
  const int q = tid % LPC;
  const int n0 = q * SPT;
  const int b = blockIdx.y;
  const int blk = blockIdx.x;
  const int d0 = blk * CH;
  const int d = d0 + c;
  const int valid_d = min(CH, di - d0);
  const int n_ck = (s + kChunk - 1) / kChunk;
  const long long row = (long long)b * s;
  float av[SPT], lam[SPT], dak[SPT], hb[SPT], hn[SPT] = {};
#pragma unroll
  for (int j = 0; j < SPT; ++j) {
    const bool ok = d < di && n0 + j < n;
    av[j] = ok ? a[(long long)d * n + n0 + j] : 0.f;
    lam[j] = ok && dh_final != nullptr
                 ? dh_final[((long long)b * di + d) * n + n0 + j] : 0.f;
    dak[j] = 0.f;
  }
  auto load_state = [&](int k, float (&h)[SPT]) {
#pragma unroll
    for (int j = 0; j < SPT; ++j)
      h[j] = d < di && n0 + j < n
                 ? h_chunks[(((long long)b * n_ck + k) * di + d) * n + n0 + j]
                 : 0.f;
  };
  auto stage_chunk = [&](int k) {
    const int t0 = k * kChunk;
    const int len = min(kChunk, s - t0);
    const long long gd = (row + t0) * di + d0;
    const long long gn = (row + t0) * n;
    T* buf = stg0 + (k & 1) * L::kStage;
    stage(buf, CH, dt + gd, di, len, valid_d, vec_d);
    stage(buf + L::kD, CH, xdt + gd, di, len, valid_d, vec_d);
    stage(buf + 2 * L::kD, CH, dy + gd, di, len, valid_d, vec_d);
    stage(buf + 3 * L::kD, NP, bm + gn, n, len, n, vec_n);
    stage(buf + 3 * L::kD + L::kN, NP, cm + gn, n, len, n, vec_n);
  };
  // the CTA's dB / dC partials and dxdt / ddt rows of the len steps from
  // t0 (after a barrier: every warp's reductions are in red / out)
  auto flush = [&](int t0, int len) {
    for (int o = tid; o < kHalf * 2 * NP; o += NT) {
      const int t = o / (2 * NP);
      const int kind = (o / NP) & 1;
      const int nn = o % NP;
      if (t < len && nn < n) {
        const float* r = red + t * NW * 2 * NP + kind * NP + nn;
        float acc = r[0];
#pragma unroll
        for (int w = 1; w < NW; ++w) acc = __fadd_rn(acc, r[w * 2 * NP]);
        db_part[(((long long)kind * gridDim.y + b) * gridDim.x + blk) * s * n +
                (long long)(t0 + t) * n + nn] = acc;
      }
    }
    for (int o = tid; o < 2 * kHalf * CH; o += NT) {
      const int kind = o / (kHalf * CH);
      const int t = (o / CH) % kHalf;
      const int cc = o % CH;
      if (t < len && cc < valid_d)
        from_f((kind ? ddt : dxdt) + (row + t0 + t) * di + d0 + cc,
               outx[o]);
    }
  };

  stage_chunk(n_ck - 1);
  cp_async_commit();
  load_state(n_ck - 1, hb);
  for (int k = n_ck - 1; k >= 0; --k) {
    cp_async_wait_all();
    __syncthreads();   // chunk k has landed; the last flush is done
    if (k > 0) {
      stage_chunk(k - 1);
      load_state(k - 1, hn);
    }
    cp_async_commit();
    const T* buf = stg0 + (k & 1) * L::kStage;
    const T* dts = buf;
    const T* xs = buf + L::kD;
    const T* dys = buf + 2 * L::kD;
    const T* bs = buf + 3 * L::kD;
    const T* cs = bs + L::kN;
    const int t0 = k * kChunk;
    const int len = min(kChunk, s - t0);
    const int len_a = min(kHalf, len);
    float hm[SPT];
    recompute_first<T, SPT, LPC, NT>(dts, xs, bs, hg, av, hb, hm, len_a);
    if (len > kHalf) {   // the second half, from registers
      constexpr int kD2 = kHalf * CH, kN2 = kHalf * NP;
      if (len == kChunk)
        second_half<true, T, SPT, LPC, NT>(
            dts + kD2, xs + kD2, dys + kD2, bs + kN2, cs + kN2, red, outx,
            outt, av, hm, lam, dak, len - kHalf);
      else
        second_half<false, T, SPT, LPC, NT>(
            dts + kD2, xs + kD2, dys + kD2, bs + kN2, cs + kN2, red, outx,
            outt, av, hm, lam, dak, len - kHalf);
      __syncthreads();
      flush(t0 + kHalf, len - kHalf);
      __syncthreads();
    }
    adjoint_first<T, SPT, LPC, NT>(dts, xs, dys, bs, cs, hg, red, outx, outt,
                                   av, hb, lam, dak, len_a);
    __syncthreads();
    flush(t0, len_a);
#pragma unroll
    for (int j = 0; j < SPT; ++j) hb[j] = hn[j];
  }
#pragma unroll
  for (int j = 0; j < SPT; ++j)
    if (d < di && n0 + j < n)
      da_part[((long long)b * di + d) * n + n0 + j] = dak[j];
}

// out[o, i] = sum over m of in[o, m, i], m in order (the partials' fixed
// reduction order); rows o >= o_split go to out2 (row o - o_split).
template <typename T>
__global__ void __launch_bounds__(256)
sum_middle_kernel(const float* __restrict__ in, T* __restrict__ out,
                  T* __restrict__ out2, int o_split, int o_n, int m_n,
                  long long i_n) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)o_n * i_n) return;
  const long long o = idx / i_n;
  const long long i = idx - o * i_n;
  const float* p = in + o * m_n * i_n + i;
  float acc = 0.f;
#pragma unroll 8
  for (int m = 0; m < m_n; ++m) acc = __fadd_rn(acc, p[m * i_n]);
  if (o < o_split) from_f(out + idx, acc);
  else from_f(out2 + (idx - o_split * i_n), acc);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T, int NP>
int launch(const void* xdt, const void* dt, const float* a, const void* bm,
           const void* cm, void* y, float* h_out, float* h_chunks, int bsz,
           int s, int di, int n, cudaStream_t stream) {
  constexpr int SPT = NP < kSpt ? NP : kSpt;
  constexpr int LPC = NP / SPT;
  constexpr int CH = kThreads / LPC;
  constexpr size_t esz = sizeof(T);
  const size_t smem = 2 * (2 * kChunk * CH + 2 * kChunk * NP) * esz;
  // serving (no h_chunks) runs an instance without the chunk stores
  auto kernel = h_chunks != nullptr ? mamba_scan_kernel<T, SPT, LPC, true>
                                    : mamba_scan_kernel<T, SPT, LPC, false>;
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
      static_cast<T*>(y), h_out, h_chunks, s, di, n, vec_d, vec_n);
  return (int)cudaGetLastError();
}

template <typename T, int NP>
int launch_bwd(const void* xdt, const void* dt, const float* a,
               const void* bm, const void* cm, const void* dy,
               const float* dh_final, const float* h_chunks, void* dxdt,
               void* ddt, float* da, void* db, void* dc, float* scratch,
               int bsz, int s, int di, int n, cudaStream_t stream,
               cudaEvent_t* ev) {
  using S = BwdShape<NP>;
  using L = BwdLayout<T, S::SPT, S::LPC, S::NT>;
  constexpr size_t esz = sizeof(T);
  const int n_blk = (di + S::CH - 1) / S::CH;
  auto kernel = mamba_scan_bwd_kernel<T, S::SPT, S::LPC, S::NT>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::bytes);
  if (e != cudaSuccess) return (int)e;
  const int vec_d = S::CH * esz % 16 == 0 && di * esz % 16 == 0 &&
                    aligned16(xdt) && aligned16(dt) && aligned16(dy);
  const int vec_n = NP * esz % 16 == 0 && n * esz % 16 == 0 &&
                    aligned16(bm) && aligned16(cm);
  // scratch: da (B, Di, N), then the dB and dC partials (2, B, n_blk, S, N)
  float* da_part = scratch;
  float* db_part = da_part + (size_t)bsz * di * n;
  if (ev) cudaEventRecord(ev[0], stream);
  kernel<<<dim3(n_blk, bsz), S::NT, L::bytes, stream>>>(
      static_cast<const T*>(xdt), static_cast<const T*>(dt), a,
      static_cast<const T*>(bm), static_cast<const T*>(cm),
      static_cast<const T*>(dy), dh_final, h_chunks, static_cast<T*>(dxdt),
      static_cast<T*>(ddt), da_part, db_part, s, di, n, vec_d, vec_n);
  if (ev) cudaEventRecord(ev[1], stream);
  const long long sn = (long long)s * n;
  sum_middle_kernel<T><<<(unsigned)((2 * bsz * sn + 255) / 256), 256, 0,
                         stream>>>(db_part, static_cast<T*>(db),
                                   static_cast<T*>(dc), bsz, 2 * bsz, n_blk,
                                   sn);
  if (ev) cudaEventRecord(ev[2], stream);
  const long long dn = (long long)di * n;
  sum_middle_kernel<float><<<(unsigned)((dn + 255) / 256), 256, 0, stream>>>(
      da_part, da, da, 1, 1, bsz, dn);
  if (ev) cudaEventRecord(ev[3], stream);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_n(const void* xdt, const void* dt, const float* a, const void* bm,
             const void* cm, void* y, float* h_out, float* hc, int bsz,
             int s, int di, int n, cudaStream_t st) {
  if (n <= 1) return launch<T, 1>(xdt, dt, a, bm, cm, y, h_out, hc, bsz, s, di, n, st);
  if (n <= 2) return launch<T, 2>(xdt, dt, a, bm, cm, y, h_out, hc, bsz, s, di, n, st);
  if (n <= 4) return launch<T, 4>(xdt, dt, a, bm, cm, y, h_out, hc, bsz, s, di, n, st);
  if (n <= 8) return launch<T, 8>(xdt, dt, a, bm, cm, y, h_out, hc, bsz, s, di, n, st);
  if (n <= 16) return launch<T, 16>(xdt, dt, a, bm, cm, y, h_out, hc, bsz, s, di, n, st);
  return launch<T, 32>(xdt, dt, a, bm, cm, y, h_out, hc, bsz, s, di, n, st);
}

#define MS_BWD_ARGS xdt, dt, a, bm, cm, dy, dhf, hc, dx, ddt, da, db, dc, \
    scratch, bsz, s, di, n, st, ev
template <typename T>
int launch_bwd_n(const void* xdt, const void* dt, const float* a,
                 const void* bm, const void* cm, const void* dy,
                 const float* dhf, const float* hc, void* dx, void* ddt,
                 float* da, void* db, void* dc, float* scratch, int bsz,
                 int s, int di, int n, cudaStream_t st, cudaEvent_t* ev) {
  if (n <= 1) return launch_bwd<T, 1>(MS_BWD_ARGS);
  if (n <= 2) return launch_bwd<T, 2>(MS_BWD_ARGS);
  if (n <= 4) return launch_bwd<T, 4>(MS_BWD_ARGS);
  if (n <= 8) return launch_bwd<T, 8>(MS_BWD_ARGS);
  if (n <= 16) return launch_bwd<T, 16>(MS_BWD_ARGS);
  return launch_bwd<T, 32>(MS_BWD_ARGS);
}
#undef MS_BWD_ARGS

}  // namespace

// Padded state count the kernels lay N out on (a power of two, N <= 32).
static int padded_state(int n) {
  int np = 1;
  while (np < n) np *= 2;
  return np;
}

// xdt / dt (B, S, Di), a (Di, N) fp32, b / c (B, S, N), all contiguous;
// is_bf16 selects bf16 (else fp32) for xdt, dt, b, c and y. Writes y
// (B, S, Di) and h_final (B, Di, N) fp32, and, when h_chunks is not null,
// the state entering each 32-step chunk, (B, ceil(S / 32), Di, N) fp32 (the
// backward's checkpoints). N <= 32. Returns cudaGetLastError(), or -1 for N
// outside [1, 32].
extern "C" int mamba_scan_launch(const void* xdt, const void* dt,
                                 const float* a, const void* bm,
                                 const void* cm, void* y, float* h_out,
                                 float* h_chunks, int is_bf16, int bsz, int s,
                                 int di, int n, void* stream) {
  if (n < 1 || n > kMaxN) return -1;
  if (bsz == 0 || di == 0) return (int)cudaGetLastError();
  const cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    return launch_n<__nv_bfloat16>(xdt, dt, a, bm, cm, y, h_out, h_chunks,
                                   bsz, s, di, n, st);
  return launch_n<float>(xdt, dt, a, bm, cm, y, h_out, h_chunks, bsz, s, di,
                         n, st);
}

// Floats of scratch mamba_scan_bwd_launch needs: da's per-batch-row
// partials and dB / dC's per-CTA partials.
extern "C" long long mamba_scan_bwd_scratch(int bsz, int s, int di, int n) {
  const int ch = padded_state(n) == 32 ? BwdShape<32>::CH : kBwdChannels;
  const long long n_blk = (di + ch - 1) / ch;
  return (long long)bsz * di * n + 2LL * bsz * n_blk * s * n;
}

// The gradients of mamba_scan_launch's y (dy, (B, S, Di) in the inputs'
// type) and h_final (dh_final, (B, Di, N) fp32, or null for zero), given
// the forward's inputs and its h_chunks: dxdt, ddt (B, S, Di) and db, dc
// (B, S, N) in the inputs' type, da (Di, N) fp32; scratch holds
// mamba_scan_bwd_scratch(...) floats. All contiguous. Deterministic (no
// atomics; fixed-order sums). events, when not null, holds 4 CUDA events
// recorded on the stream before the main kernel and after it, the dB / dC
// sum and the da sum. Returns cudaGetLastError(), or -1 for N outside
// [1, 32].
extern "C" int mamba_scan_bwd_launch(
    const void* xdt, const void* dt, const float* a, const void* bm,
    const void* cm, const void* dy, const float* dh_final,
    const float* h_chunks, void* dxdt, void* ddt, float* da, void* db,
    void* dc, float* scratch, int is_bf16, int bsz, int s, int di, int n,
    void* stream, void* const* events) {
  if (n < 1 || n > kMaxN) return -1;
  if (bsz == 0 || di == 0 || s == 0) return (int)cudaGetLastError();
  const cudaStream_t st = (cudaStream_t)stream;
  cudaEvent_t* ev = events ? (cudaEvent_t*)events : nullptr;
  if (is_bf16)
    return launch_bwd_n<__nv_bfloat16>(xdt, dt, a, bm, cm, dy, dh_final,
                                       h_chunks, dxdt, ddt, da, db, dc,
                                       scratch, bsz, s, di, n, st, ev);
  return launch_bwd_n<float>(xdt, dt, a, bm, cm, dy, dh_final, h_chunks,
                             dxdt, ddt, da, db, dc, scratch, bsz, s, di, n,
                             st, ev);
}
