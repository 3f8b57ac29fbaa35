"""STFT power spectrogram: framing + Hann window + DFT + |.|^2.

The CUDA kernel (``csrc/stft_mag.cu``) replaces the Pallas kernel
``repro/kernels/stft_mag.py:stft_mag`` and fuses the framing that the
reference does before the call, so both versions here take the raw
waveform and the hop. It is IEEE fp32 on the CUDA cores (TF32 would flip
top-K bits downstream): a CTA stages 36 frames of one row, the window and
the band DFT in shared memory with ``cp.async``, writes the windowed
samples there once, and each thread accumulates 4 frames × 1 bin. Every
output's arithmetic (rounded x·w, fp32 FMAs in t order, re² + im²) is
fixed, so the result does not depend on the tiling. It is bound by its
fp32 operations (0.0037 ms for one paper block) and takes 0.0190 ms there
on an H100 80GB HBM3 at 700 W, paced by shared-memory loads (PERF.md).
``plain`` is the PyTorch version of the same function;
``kernels.ops.stft_mag`` picks between them by device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build


def n_frames(n_samples: int, frame_len: int, hop: int) -> int:
    return max(0, (n_samples - frame_len) // hop + 1)


def plain(wave: torch.Tensor, window: torch.Tensor, dft_r: torch.Tensor,
          dft_i: torch.Tensor, hop: int) -> torch.Tensor:
    """wave (R, T), window (L,), dft_r/dft_i (L, K) → (R, n_frames, K)."""
    frame_len = window.shape[0]
    nf = n_frames(wave.shape[-1], frame_len, hop)
    frames = wave[:, :(nf - 1) * hop + frame_len].unfold(-1, frame_len, hop)
    xw = frames * window
    re = torch.matmul(xw, dft_r)
    im = torch.matmul(xw, dft_i)
    return re * re + im * im


def launch(wave: torch.Tensor, window: torch.Tensor, dft_r: torch.Tensor,
           dft_i: torch.Tensor, hop: int, out: torch.Tensor) -> None:
    """Launch the CUDA kernel on the current stream (no synchronisation)."""
    lib = _build.load("stft_mag")
    fn = lib.stft_mag_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    rows, n_samples = wave.shape
    rc = fn(wave.data_ptr(), rows, n_samples, window.data_ptr(),
            dft_r.data_ptr(), dft_i.data_ptr(), out.data_ptr(), out.shape[1],
            window.shape[0], hop, dft_r.shape[1],
            torch.cuda.current_stream(wave.device).cuda_stream)
    _build.check(rc, "stft_mag")
