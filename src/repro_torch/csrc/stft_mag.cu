// Framed, Hann-windowed STFT power spectrogram over a band of DFT bins.
//
// Replaces: src/repro/kernels/stft_mag.py:stft_mag (the Pallas kernel that
// multiplies pre-framed windows by the real/imaginary DFT matrices on the
// MXU and writes re^2 + im^2). This kernel also does the framing that
// src/repro/core/fingerprint.py:frame did before the call: it reads the
// raw waveform once and cuts the overlapping frames in shared memory, so
// the 8x overlapping (frames, frame_len) array never exists in memory.
//
// What bounds it on the H100: the work is 4 * frame_len * n_bins flops per
// frame in IEEE fp32 (tensor cores would mean TF32 and flip top-K bits
// downstream): 243 MFLOP for one paper block (4 rows x 2,168 frames x 35
// bins, frame_len 200), 0.0037 ms at the 67 TFLOP/s fp32 rate; the bytes
// are one read of the waveform and one write of the spectrogram.
//
// Design: one CTA per (tile of 36 frames, waveform row): 244 CTAs for the
// paper block, at most 2 an SM (272 CTAs of 32 frames left 8 SMs a third
// CTA and took 1.4x as long). The tile's samples, the window and the band
// DFT (re and im, 56 KB at the paper widths) are staged with cp.async, 16
// bytes a thread wherever a chunk is whole; the DFT's first 32 rows go in
// a group of their own so the products start while the rest lands, and
// the windowed samples xw[t][frame] = x * w are written to shared memory
// (frames contiguous) while the DFT is in flight. Each thread owns 4
// frames x 1 bin: per sample t one float4 of xw and the bin's re and im,
// 8 FMAs; a warp covers 4 frame groups x 8 consecutive bins, so its DFT
// loads hit distinct banks. Longer frames stage the DFT in chunks of t.
// Each output's arithmetic is the plain loop's: xw = x[t] * w[t] rounded,
// re = fma(xw, dft_r[t][k], re) for t ascending (the chunks keep the
// order), power = re * re + im * im, all IEEE fp32 with no contraction, so
// the result does not depend on the tiling and equals the earlier
// one-output-a-thread kernel's bit for bit. What separates it from its
// bound: each lane loads 6 floats from shared memory for its 8 FMAs per
// sample, so the shared-memory wavefronts (~6 a sample a warp) and not the
// FMAs set the pace, and larger thread tiles leave too few warps to hide
// the latency. Measured on an H100 80GB HBM3 (700 W): 0.0190 ms for one
// paper block, 5.2x its bound, 5.2x faster than the earlier
// one-output-a-thread kernel and 1.07x torch.matmul on pre-framed windows
// (PERF.md).
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kFrames = 36;           // frames of a CTA
constexpr int kTF = 4;                // frames a thread (one float4 of xw)
constexpr int kFG = kFrames / kTF;    // frame groups of a CTA
constexpr int kMinThreads = 128;      // 4 warps stage shared memory
constexpr int kFirstRows = 32;        // t rows staged ahead of the rest
constexpr int kMaxThreads = 512;
constexpr int kChunkBytes = 96 * 1024;   // DFT re, im and xw of one t chunk
constexpr int kSlack = 8;             // floats beyond a staged array
constexpr int kMaxSmem = 232448;      // H100: 227 KB a block

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage src[lo, hi) (global) into shared memory laid out for src[0, n):
// src[i] lands at dst + shift + i, where dst is 16-byte aligned with
// kSlack floats beyond n and shift is src's misalignment in floats, so the
// 16-byte chunks of both sides line up and most of the copy moves 16 bytes
// a thread; returns dst + shift, where src[0] lands.
__device__ __forceinline__ const float* stage(float* dst, const float* src,
                                              int lo, int hi) {
  const int shift = (int)((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
  const float* base = src - shift;   // 16-byte aligned; read only in range
  for (int j = (lo + shift) / 4 + threadIdx.x; 4 * j < hi + shift;
       j += blockDim.x) {
    const int first = 4 * j - shift;   // src index of the chunk's first float
    if (first >= lo && first + 4 <= hi) {
      cp_async16(dst + 4 * j, base + 4 * j);
    } else {
      for (int e = 0; e < 4; ++e)
        if (first + e >= lo && first + e < hi)
          cp_async4(dst + 4 * j + e, base + 4 * j + e);
    }
  }
  return dst + shift;
}

__host__ __device__ constexpr int padded(int n) {
  return (n + kSlack + 3) / 4 * 4;   // floats of a staged array's area
}

// re / im[f] += xw[t][f] * dft_r / dft_i[t] for t in [ta, tb), in t order;
// xw rows are kFrames floats, DFT rows n_bins.
__device__ __forceinline__ void accumulate(float (&re)[kTF], float (&im)[kTF],
                                           const float* xw, const float* pr,
                                           const float* pi, int n_bins,
                                           int ta, int tb) {
#pragma unroll 4
  for (int t = ta; t < tb; ++t) {
    const float cr = pr[t * n_bins];
    const float ci = pi[t * n_bins];
    const float4 x4 = *reinterpret_cast<const float4*>(xw + t * kFrames);
    const float xv[kTF] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
    for (int f = 0; f < kTF; ++f) {
      re[f] = fmaf(xv[f], cr, re[f]);
      im[f] = fmaf(xv[f], ci, im[f]);
    }
  }
}

__global__ void __launch_bounds__(kMaxThreads)
stft_mag_kernel(const float* __restrict__ wave, int n_samples,
                const float* __restrict__ window,
                const float* __restrict__ dft_r,
                const float* __restrict__ dft_i, float* __restrict__ out,
                int n_frames, int frame_len, int hop, int n_bins,
                int t_chunk) {
  extern __shared__ float4 smem4[];
  const int full = (kFrames - 1) * hop + frame_len;   // a tile's samples
  float* dr_s = reinterpret_cast<float*>(smem4);       // t_chunk x n_bins
  float* di_s = dr_s + padded(t_chunk * n_bins);
  float* xw_s = di_s + padded(t_chunk * n_bins);       // t_chunk x kFrames
  float* win_s = xw_s + padded(t_chunk * kFrames);
  float* seg_s = win_s + padded(frame_len);

  const int row = blockIdx.y;
  const int f0 = blockIdx.x * kFrames;
  const int nf = min(kFrames, n_frames - f0);
  const float* seg = stage(
      seg_s, wave + (size_t)row * n_samples + (size_t)f0 * hop, 0,
      (nf - 1) * hop + frame_len);
  const float* win = stage(win_s, window, 0, frame_len);
  cp_async_commit();

  const int items = kFG * n_bins;
  const int n_full = kFG * 8 * (n_bins / 8);   // items of whole bin octets
  const int rounds = (items + blockDim.x - 1) / blockDim.x;
  const int n_chunks = (frame_len + t_chunk - 1) / t_chunk;
  float* dst = out + ((size_t)row * n_frames + f0) * n_bins;
  const float* dr = nullptr;
  const float* di = nullptr;

  for (int rd = 0; rd < rounds; ++rd) {
    const int item = rd * blockDim.x + threadIdx.x;
    const bool active = item < items;
    // A warp takes 4 frame groups x 8 consecutive bins of one octet, so
    // its DFT loads hit distinct banks; the last, partial octet goes
    // frame group by frame group.
    int fg = 0, k = 0;
    if (active && item < n_full) {
      const int r = item % (kFG * 8);
      fg = r / 8;
      k = item / (kFG * 8) * 8 + r % 8;
    } else if (active) {
      const int r = item - n_full;
      fg = r / (n_bins % 8);
      k = n_bins / 8 * 8 + r % (n_bins % 8);
    }
    float re[kTF], im[kTF];
#pragma unroll
    for (int f = 0; f < kTF; ++f) re[f] = im[f] = 0.f;

    for (int ch = 0; ch < n_chunks; ++ch) {
      const int t0 = ch * t_chunk;
      const int tn = min(t_chunk, frame_len - t0);
      if (n_chunks > 1 || rd == 0) {
        __syncthreads();   // the previous chunk has been used
        // The first kFirstRows rows go in a group of their own, so the
        // products can start before the rest of the chunk has landed.
        const int t1 = min(tn, kFirstRows);
        const float* gr = dft_r + (size_t)t0 * n_bins;
        const float* gi = dft_i + (size_t)t0 * n_bins;
        dr = stage(dr_s, gr, 0, t1 * n_bins);
        di = stage(di_s, gi, 0, t1 * n_bins);
        cp_async_commit();
        stage(dr_s, gr, t1 * n_bins, tn * n_bins);
        stage(di_s, gi, t1 * n_bins, tn * n_bins);
        cp_async_commit();
        cp_async_wait<2>();   // seg and win have landed; the DFT may not
        __syncthreads();
        // windowed samples, frames contiguous: xw[t][fr] = x[fr][t] * w[t],
        // while the DFT chunk is still in flight
        for (int i = threadIdx.x; i < tn * kFrames; i += blockDim.x) {
          const int t = i / kFrames;
          const int fr = i - t * kFrames;
          xw_s[i] = __fmul_rn(seg[fr * hop + t0 + t], win[t0 + t]);
        }
        cp_async_wait<1>();   // the first rows have landed
        __syncthreads();
      }
      const float* xw = xw_s + fg * kTF;
      const float* pr = dr + k;
      const float* pi = di + k;
      const int t1 = min(tn, kFirstRows);
      if (active) accumulate(re, im, xw, pr, pi, n_bins, 0, t1);
      if (n_chunks > 1 || rd == 0) {
        cp_async_wait<0>();   // the rest of the chunk
        __syncthreads();
      }
      if (active) accumulate(re, im, xw, pr, pi, n_bins, t1, tn);
    }
    if (!active) continue;
#pragma unroll
    for (int f = 0; f < kTF; ++f) {
      const int fr = fg * kTF + f;
      if (fr < nf)
        dst[(size_t)fr * n_bins + k] =
            __fadd_rn(__fmul_rn(re[f], re[f]), __fmul_rn(im[f], im[f]));
    }
  }
}

}  // namespace

// wave (rows, n_samples), window (frame_len,), dft_r/dft_i (frame_len,
// n_bins) -> out (rows, n_frames, n_bins); all fp32, contiguous. Returns
// cudaGetLastError(), or cudaErrorInvalidValue when the tile's samples do
// not fit in shared memory (a hop above 1,042 samples at the paper widths).
extern "C" int stft_mag_launch(const float* wave, int rows, int n_samples,
                               const float* window, const float* dft_r,
                               const float* dft_i, float* out, int n_frames,
                               int frame_len, int hop, int n_bins,
                               void* stream) {
  if (rows > 0 && n_frames > 0 && n_bins > 0) {
    int t_chunk = kChunkBytes / ((2 * n_bins + kFrames) * (int)sizeof(float));
    t_chunk = t_chunk < 1 ? 1 : (t_chunk > frame_len ? frame_len : t_chunk);
    const size_t smem =
        (2 * (size_t)padded(t_chunk * n_bins) + padded(t_chunk * kFrames) +
         padded(frame_len) + padded((kFrames - 1) * hop + frame_len)) *
        sizeof(float);
    if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
      cudaFuncSetAttribute(stft_mag_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
    }
    const int items = kFG * n_bins;
    int threads = (items + 31) / 32 * 32;
    threads = threads < kMinThreads ? kMinThreads
              : threads > kMaxThreads ? kMaxThreads : threads;
    const dim3 grid((n_frames + kFrames - 1) / kFrames, rows);
    stft_mag_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
        wave, n_samples, window, dft_r, dft_i, out, n_frames, frame_len, hop,
        n_bins, t_chunk);
  }
  return (int)cudaGetLastError();
}
