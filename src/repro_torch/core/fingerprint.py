"""Fingerprint extraction (paper §5): waveform → binary fingerprints.

PyTorch counterpart of ``repro.core.fingerprint``. Chain (Figure 3):
spectrogram → banded spectral images → 2-D Haar wavelet → median/MAD
normalization (sampled, §5.2) → top-K most anomalous coefficients → sign
binarization (2 bits per coefficient).

Every function takes a leading batch of waveform rows (stations), so a
station pool is one call. The spectrogram and the Haar transform go
through ``kernels.ops`` (CUDA kernels for CUDA tensors, plain PyTorch for
CPU tensors). The pooling product ``spec @ pool`` is a plain
``torch.matmul``; callers on the card keep TF32 off
(``torch.backends.cuda.matmul.allow_tf32 = False``, PyTorch's default).
``FingerprintConfig(time_domain_bandpass=True)`` puts a windowed-sinc FIR
bandpass (``bandpass``, a ``conv1d`` with TF32 off) in front of the
spectrogram, as the reference does.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import utils
from repro_torch.kernels import ops
from repro_torch.kernels.ref import dft_matrices


@dataclasses.dataclass(frozen=True)
class FingerprintConfig:
    """Defaults give the paper's 8192-dim fingerprints at 100 Hz.

    The fields are the reference's; ``use_pallas`` is accepted and ignored
    (the tensor's device decides which code runs).
    """

    fs: float = 100.0
    stft_len: int = 200          # 2 s analysis window
    stft_hop: int = 25           # 0.25 s hop
    band_lo_hz: float = 3.0
    band_hi_hz: float = 20.0
    time_domain_bandpass: bool = False
    bp_taps: int = 255
    img_freq: int = 32           # freq bins after pooling (power of two)
    img_time: int = 128          # spectrogram frames per image (power of two)
    img_hop: int = 8             # frames between fingerprints (2 s lag)
    top_k: int = 400             # most anomalous wavelet coefficients kept
    mad_sample_rate: float = 0.1  # §5.2 MAD-via-sampling
    use_pallas: bool = False

    @property
    def n_rfft(self) -> int:
        return self.stft_len // 2 + 1

    @property
    def band_bins(self) -> tuple[int, int]:
        """[lo, hi) rfft bin range kept by the band filter."""
        lo = int(math.ceil(self.band_lo_hz * self.stft_len / self.fs))
        hi = int(math.floor(self.band_hi_hz * self.stft_len / self.fs)) + 1
        lo = max(0, min(lo, self.n_rfft - 1))
        hi = max(lo + 1, min(hi, self.n_rfft))
        return lo, hi

    @property
    def n_coeff(self) -> int:
        return self.img_freq * self.img_time

    @property
    def fp_dim(self) -> int:
        return 2 * self.n_coeff  # sign encoding: 2 bits / coefficient

    @property
    def window_samples(self) -> int:
        return (self.img_time - 1) * self.stft_hop + self.stft_len

    @property
    def lag_samples(self) -> int:
        return self.img_hop * self.stft_hop

    def n_fingerprints(self, n_samples: int) -> int:
        nf = self.n_frames(n_samples)
        return max(0, (nf - self.img_time) // self.img_hop + 1)

    def n_frames(self, n_samples: int) -> int:
        return max(0, (n_samples - self.stft_len) // self.stft_hop + 1)

    @property
    def overlap_fingerprints(self) -> int:
        return self.img_time // self.img_hop

    @property
    def halo_samples(self) -> int:
        return self.window_samples - self.lag_samples

    def block_samples(self, n_fingerprints: int) -> int:
        return (n_fingerprints - 1) * self.lag_samples + self.window_samples


# ---------------------------------------------------------------------------
# framing + optional time-domain bandpass
# ---------------------------------------------------------------------------


def frame(x: torch.Tensor, frame_len: int, hop: int) -> torch.Tensor:
    """(..., T) → (..., n_frames, frame_len) strided framing via gather
    (``stft_mag`` frames its rows itself; this is the reference's
    helper)."""
    n = max(0, (x.shape[-1] - frame_len) // hop + 1)
    idx = (torch.arange(n, device=x.device)[:, None] * hop
           + torch.arange(frame_len, device=x.device)[None, :])
    return x[..., idx]


def bandpass_kernel(cfg: FingerprintConfig) -> np.ndarray:
    """Windowed-sinc FIR bandpass taps (no scipy dependency)."""
    nt = cfg.bp_taps
    t = np.arange(nt) - (nt - 1) / 2.0

    def lp(fc):
        h = np.sinc(2 * fc / cfg.fs * t) * (2 * fc / cfg.fs)
        return h * np.hamming(nt)
    h = lp(cfg.band_hi_hz) - lp(cfg.band_lo_hz)
    return h.astype(np.float32)


def bandpass(x: torch.Tensor, cfg: FingerprintConfig) -> torch.Tensor:
    """(..., T) → (..., max(T, taps)): ``jnp.convolve(x, taps, "same")``
    row by row. ``conv1d`` correlates, so the taps go in flipped; the full
    convolution is cut to numpy's "same" window (centred, starting at
    (min(T, taps) - 1) // 2). cuDNN runs with TF32 off here, whatever the
    global setting."""
    taps = torch.as_tensor(bandpass_kernel(cfg), device=x.device)
    k, t = taps.numel(), x.shape[-1]
    rows = x.reshape(-1, 1, t).to(torch.float32)
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        full = F.conv1d(rows, taps.flip(0).view(1, 1, k), padding=k - 1)
    n, start = max(t, k), (min(t, k) - 1) // 2
    return full[:, 0, start:start + n].reshape(*x.shape[:-1], n)


# ---------------------------------------------------------------------------
# spectrogram + spectral images
# ---------------------------------------------------------------------------


def _pool_matrix(n_in: int, n_out: int) -> np.ndarray:
    """Average-pooling matrix (n_in, n_out) with near-equal bin spans."""
    edges = np.linspace(0, n_in, n_out + 1)
    m = np.zeros((n_in, n_out), np.float32)
    for j in range(n_out):
        lo, hi = edges[j], edges[j + 1]
        for i in range(int(np.floor(lo)), int(np.ceil(hi))):
            w = min(hi, i + 1) - max(lo, i)
            if w > 0:
                m[i, j] = w
    m /= m.sum(axis=0, keepdims=True)
    return m


_CONSTS: dict = {}


def _consts(cfg: FingerprintConfig, device) -> dict:
    """Window, band-cut DFT columns and pooling matrix on ``device``."""
    key = (cfg.stft_len, cfg.band_bins, cfg.img_freq, str(device))
    c = _CONSTS.get(key)
    if c is None:
        lo, hi = cfg.band_bins
        dr, di = dft_matrices(cfg.stft_len, cfg.n_rfft)
        c = _CONSTS[key] = {
            "window": torch.as_tensor(
                np.hanning(cfg.stft_len).astype(np.float32), device=device),
            "dft_r": torch.as_tensor(np.ascontiguousarray(dr[:, lo:hi]),
                                     device=device),
            "dft_i": torch.as_tensor(np.ascontiguousarray(di[:, lo:hi]),
                                     device=device),
            "pool": torch.as_tensor(_pool_matrix(hi - lo, cfg.img_freq),
                                    device=device),
        }
    return c


def spectrogram(x: torch.Tensor, cfg: FingerprintConfig) -> torch.Tensor:
    """(R, T) waveforms → (R, n_frames, banded_bins) power spectrograms
    (a 1-D waveform gives (n_frames, banded_bins)); with
    ``time_domain_bandpass`` the rows are bandpassed first."""
    if cfg.time_domain_bandpass:
        x = bandpass(x, cfg)
    c = _consts(cfg, x.device)
    rows = x.reshape(-1, x.shape[-1]).to(torch.float32).contiguous()
    spec = ops.stft_mag(rows, c["window"], c["dft_r"], c["dft_i"],
                        cfg.stft_hop)
    return spec.reshape(*x.shape[:-1], *spec.shape[1:])


def spectral_images(spec: torch.Tensor,
                    cfg: FingerprintConfig) -> torch.Tensor:
    """(..., n_frames, B) spectrograms → (..., n_images, img_freq, img_time)."""
    pooled = torch.matmul(spec, _consts(cfg, spec.device)["pool"])
    n_frames = spec.shape[-2]
    n_img = (n_frames - cfg.img_time) // cfg.img_hop + 1
    idx = (torch.arange(n_img, device=spec.device)[:, None] * cfg.img_hop
           + torch.arange(cfg.img_time, device=spec.device)[None, :])
    imgs = pooled[..., idx, :]          # (..., n_img, img_time, img_freq)
    return imgs.transpose(-1, -2)


# ---------------------------------------------------------------------------
# wavelet + MAD normalization (§5.2) + top-K binarization
# ---------------------------------------------------------------------------


def wavelet_coeffs(imgs: torch.Tensor, cfg: FingerprintConfig) -> torch.Tensor:
    """(..., N, F, T) → (..., N, F*T) Haar coefficients."""
    f, t = imgs.shape[-2:]
    flat = imgs.reshape(-1, f, t).contiguous()
    return ops.haar2d(flat).reshape(*imgs.shape[:-2], f * t)


def _median0(x: torch.Tensor) -> torch.Tensor:
    """Median over dim 0 as ``jnp.median`` takes it: the midpoint of the
    two middle values when the count is even."""
    s = torch.sort(x, dim=0).values
    n = x.shape[0]
    return (s[(n - 1) // 2] + s[n // 2]) * 0.5


def mad_stats(coeffs: torch.Tensor, sample_rate: float,
              rows: torch.Tensor | None = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Median + MAD per coefficient, estimated from a row sample (§5.2).

    ``sample_rate >= 1`` uses every row (the exact two-pass statistics).
    Otherwise ``rows`` names the sampled rows: the reference draws them
    with ``jax.random.choice``, which torch cannot reproduce, so the
    caller draws them (``core.detect`` uses a seeded CPU generator).
    """
    if sample_rate >= 1.0:
        sample = coeffs
    else:
        if rows is None:
            raise ValueError("mad_stats with sample_rate < 1 needs rows")
        sample = coeffs[rows.to(coeffs.device)]
    med = _median0(sample)
    mad = _median0(torch.abs(sample - med[None, :]))
    return med, mad


def sample_rows(n: int, sample_rate: float, seed: int) -> torch.Tensor:
    """The rows ``mad_stats`` samples: ``max(2, round(n * rate))`` distinct
    rows from a CPU generator seeded ``seed``."""
    m = max(2, int(round(n * sample_rate)))
    g = torch.Generator().manual_seed(int(seed))
    return torch.randperm(n, generator=g)[:m]


def mad_normalize(coeffs: torch.Tensor, med: torch.Tensor,
                  mad: torch.Tensor) -> torch.Tensor:
    """(..., N, C) with (..., C) statistics → normalized coefficients."""
    return (coeffs - med[..., None, :]) / (mad[..., None, :] + 1e-9)


def topk_binarize(z: torch.Tensor, cfg: FingerprintConfig) -> torch.Tensor:
    """Keep top-K |z| per row (ties at the K-th value included); encode
    signs as 2 bits: even positions = kept and > 0, odd = kept and < 0."""
    a = torch.abs(z)
    kth = torch.topk(a, cfg.top_k, dim=-1).values[..., -1:]
    mask = a >= kth
    inter = torch.stack([mask & (z > 0), mask & (z < 0)], dim=-1)
    return inter.reshape(*z.shape[:-1], 2 * z.shape[-1])


# ---------------------------------------------------------------------------
# end-to-end
# ---------------------------------------------------------------------------


def coeffs_from_waveform(x: torch.Tensor,
                         cfg: FingerprintConfig) -> torch.Tensor:
    """(..., T) waveforms → (..., N, n_coeff) raw Haar coefficients."""
    return wavelet_coeffs(spectral_images(spectrogram(x, cfg), cfg), cfg)


def binarize_coeffs(coeffs: torch.Tensor, cfg: FingerprintConfig,
                    med_mad: tuple[torch.Tensor, torch.Tensor]
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., N, n_coeff) + (med, mad) → (bits bool (..., N, fp_dim),
    packed int32 (..., N, fp_dim // 32) holding uint32 words)."""
    bits = topk_binarize(mad_normalize(coeffs, *med_mad), cfg)
    return bits, utils.pack_bits(bits)


def fingerprints_from_waveform(
    x: torch.Tensor, cfg: FingerprintConfig, *,
    med_mad: tuple[torch.Tensor, torch.Tensor] | None = None,
    rows: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Waveform (T,) → (fingerprints bool (N, fp_dim), packed int32)."""
    coeffs = coeffs_from_waveform(x, cfg)
    if med_mad is None:
        med_mad = mad_stats(coeffs, cfg.mad_sample_rate, rows)
    return binarize_coeffs(coeffs, cfg, med_mad)
