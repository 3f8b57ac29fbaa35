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
// downstream), about 60 MFLOP per station-block at the paper widths, and
// the bytes are one read of the waveform and one write of the spectrogram.
// Both are microseconds; the kernel is latency- and L1-bound in practice.
//
// Design: one CTA per (tile of 64 frames, waveform row). The tile's sample
// span and the window go to shared memory; each thread owns (frame, bin)
// outputs and accumulates re and im with fp32 FMAs over the frame, reading
// the DFT columns through the read-only L1 path (neighbouring threads read
// neighbouring bins). No atomics, no synchronisation with the host.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFramesPerCta = 64;

__global__ void __launch_bounds__(kThreads)
stft_mag_kernel(const float* __restrict__ wave, int n_samples,
                const float* __restrict__ window,
                const float* __restrict__ dft_r,
                const float* __restrict__ dft_i, float* __restrict__ out,
                int n_frames, int frame_len, int hop, int n_bins) {
  extern __shared__ float smem[];
  const int row = blockIdx.y;
  const int f0 = blockIdx.x * kFramesPerCta;
  const int nf = min(kFramesPerCta, n_frames - f0);
  const int span = (nf - 1) * hop + frame_len;
  float* seg = smem;
  float* win = smem + (kFramesPerCta - 1) * hop + frame_len;

  const float* src = wave + (size_t)row * n_samples + (size_t)f0 * hop;
  for (int i = threadIdx.x; i < span; i += blockDim.x) seg[i] = src[i];
  for (int i = threadIdx.x; i < frame_len; i += blockDim.x) win[i] = window[i];
  __syncthreads();

  float* dst = out + ((size_t)row * n_frames + f0) * n_bins;
  for (int o = threadIdx.x; o < nf * n_bins; o += blockDim.x) {
    const int f = o / n_bins;
    const int k = o - f * n_bins;
    const float* x = seg + f * hop;
    float re = 0.f, im = 0.f;
    for (int t = 0; t < frame_len; ++t) {
      const float xw = x[t] * win[t];
      re = fmaf(xw, __ldg(dft_r + t * n_bins + k), re);
      im = fmaf(xw, __ldg(dft_i + t * n_bins + k), im);
    }
    dst[o] = __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im));
  }
}

}  // namespace

// wave (rows, n_samples), window (frame_len,), dft_r/dft_i (frame_len,
// n_bins) -> out (rows, n_frames, n_bins); all fp32, contiguous.
extern "C" int stft_mag_launch(const float* wave, int rows, int n_samples,
                               const float* window, const float* dft_r,
                               const float* dft_i, float* out, int n_frames,
                               int frame_len, int hop, int n_bins,
                               void* stream) {
  if (rows > 0 && n_frames > 0) {
    const size_t smem =
        ((size_t)(kFramesPerCta - 1) * hop + 2 * (size_t)frame_len) *
        sizeof(float);
    if (smem > 48 * 1024) {
      cudaFuncSetAttribute(stft_mag_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
    }
    const dim3 grid((n_frames + kFramesPerCta - 1) / kFramesPerCta, rows);
    stft_mag_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        wave, n_samples, window, dft_r, dft_i, out, n_frames, frame_len, hop,
        n_bins);
  }
  return (int)cudaGetLastError();
}
